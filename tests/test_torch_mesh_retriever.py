"""``MeshRetriever`` (``chamjax_torch/retrieval/local.py``): the retriever
contract over a placed ``ShardedIVF``, and the RALM and tik-tok loops
serving from it unchanged, against the JAX package on the CPU.

Counterparts of ``tests/test_mesh_retriever.py`` (one a test, in its
order), then the multi-chip RAG step on CPU positions: tensor-parallel
parameters at dp 2 × tp 2 over a ``MeshRetriever`` with the batch over
``dp`` and the lists over ``lists`` (8 positions, the JAX package's
``dryrun_multichip`` layout).  Both packages take the same index (the JAX
package's, carried over) and parameters (``models/convert.py``).
Tolerance: distances rtol 1e-4 / atol 1e-3 (the reference test's), ids
equal up to the order of ties; tokens equal.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from chamjax.config import IndexConfig, ModelConfig, SearchConfig
from chamjax.data import synthetic_dataset
from chamjax.index import build_ivfpq
from chamjax.models import init_decoder
from chamjax.parallel import make_mesh as j_make_mesh
from chamjax.parallel import shard_index as j_shard_index
from chamjax.parallel.sharded_search import place_sharded as j_place
from chamjax.retrieval.local import MeshRetriever as JMeshRetriever

from chamjax_torch import config as tconfig
from chamjax_torch.eval import tie_mismatches
from chamjax_torch.index.ivf import PackedIVF as TPackedIVF
from chamjax_torch.models.convert import decoder_from_numpy
from chamjax_torch.parallel import (make_mesh, place_sharded,
                                    shard_decoder_params, shard_index,
                                    shard_kv_cache)
from chamjax_torch.retrieval import MeshRetriever
from chamjax_torch.searcher import IVFSearcher
from chamjax_torch.serving.ralm import RalmDecoder
from chamjax_torch.serving.tiktok import TikTokDecoder


def carry(idx) -> TPackedIVF:
    return TPackedIVF.from_arrays(
        dataclasses.asdict(idx.cfg), centroids=idx.centroids,
        codebooks=idx.codebooks, codes=idx.codes, ids=idx.ids,
        list_start=idx.list_start, list_len=idx.list_len, ntotal=idx.ntotal,
        opq_R=idx.opq_R)


def n(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def held(d, i, dw, iw, rtol=1e-4, atol=1e-3):
    d, dw = n(d), n(dw)
    i, iw = n(i).astype(np.int64), n(iw).astype(np.int64)
    np.testing.assert_allclose(d, dw, rtol=rtol, atol=atol)
    bad = tie_mismatches(d, i, dw, iw, rtol=rtol, atol=atol)
    assert not bad, bad


def tsc(scfg):
    return tconfig.SearchConfig(**dataclasses.asdict(scfg))


def tcfg(cfg):
    return tconfig.ModelConfig(**dataclasses.asdict(cfg))


def f32_tree(p):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), p)


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_dataset(nb=16000, nq=8, nt=8000, d=32, seed=9,
                           n_clusters=64)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=32, nlist=64, m=8,
                                         list_pad=128),
                      xt=ds.xt, kmeans_iters=4, pq_iters=4)
    t_idx = carry(idx)
    jm = j_make_mesh((("lists", 4),), devices=jax.devices()[:4])
    jsh = j_place(j_shard_index(idx, 4, tile_seg=256), jm)
    mesh = make_mesh((("lists", 4),), devices=["cpu"] * 4)
    sh = place_sharded(shard_index(t_idx, 4, tile_seg=256), mesh)
    return ds, idx, t_idx, (jm, jsh), (mesh, sh)


LOOP_CFG = ModelConfig(model_type="decoder", embed_dim=32, ffn_embed_dim=64,
                       layers=2, attention_heads=2, vocab_size=64,
                       max_seq_len=16, retrieval_interval=2, k=5,
                       dtype="float32")
LOOP_SCFG = SearchConfig(nprobe=4, k=5, seg=256, seg_group=2)


def test_mesh_retriever_matches_single(setup):
    ds, idx, t_idx, (jm, jsh), (mesh, sh) = setup
    scfg = SearchConfig(nprobe=8, k=10, seg=256, seg_group=2,
                        use_approx_topk=False)
    r = MeshRetriever(sh, mesh, t_idx.list_len, tsc(scfg))
    res = r.retrieve(ds.xq, nprobe=8, k=10)
    assert res.ids.dtype == np.int64 and res.dists.shape == (8, 10)
    jr = JMeshRetriever(jsh, jm, idx.list_len, scfg)
    assert (r.seg, r.windows, r.group) == (jr.seg, jr.windows, jr.group)
    jres = jr.retrieve(ds.xq, nprobe=8, k=10)
    held(res.dists, res.ids, jres.dists, jres.ids)
    single = IVFSearcher(t_idx, tconfig.SearchConfig(
        nprobe=8, k=10, backend="seg", use_approx_topk=False), device="cpu")
    held(res.dists, res.ids, *single.search(ds.xq))
    # an nprobe override resizes the window budget as the reference's
    res16 = r.retrieve(ds.xq, nprobe=16, k=10)
    jres16 = jr.retrieve(ds.xq, nprobe=16, k=10)
    held(res16.dists, res16.ids, jres16.dists, jres16.ids)


def test_mesh_retriever_device_path_in_ralm_loop(setup):
    """Decode plus the mesh-sharded retrieval through ``retrieve_device``:
    the port's ``RalmDecoder`` runs unchanged over the mesh tier."""
    from chamjax.serving.ralm import RalmDecoder as JRalmDecoder
    ds, idx, t_idx, (jm, jsh), (mesh, sh) = setup
    jp = init_decoder(jax.random.PRNGKey(0), LOOP_CFG)
    jloop = JRalmDecoder(jp, LOOP_CFG,
                         JMeshRetriever(jsh, jm, idx.list_len, LOOP_SCFG),
                         batch_size=4, retrieval_interval=2, nprobe=4, k=5)
    jloop.batch_inference(6)
    params = decoder_from_numpy(f32_tree(jp), tcfg(LOOP_CFG), device="cpu")
    r = MeshRetriever(sh, mesh, t_idx.list_len, tsc(LOOP_SCFG))
    loop = RalmDecoder(params, tcfg(LOOP_CFG), r, batch_size=4,
                       retrieval_interval=2, nprobe=4, k=5)
    assert loop._device_path
    loop.batch_inference(6)
    assert loop.step_count == 6
    ids = n(loop.last_result.ids)
    assert ids.shape == (4, 5) and (ids >= 0).all()
    np.testing.assert_array_equal(n(loop.tokens), np.asarray(jloop.tokens))
    held(loop.last_result.dists, loop.last_result.ids,
         np.asarray(jloop.last_result.dists),
         np.asarray(jloop.last_result.ids))


def test_mesh_retriever_tiktok_fused(setup):
    from chamjax.serving.tiktok import TikTokDecoder as JTikTok
    ds, idx, t_idx, (jm, jsh), (mesh, sh) = setup
    jp = init_decoder(jax.random.PRNGKey(1), LOOP_CFG)
    jtt = JTikTok(jp, LOOP_CFG, JMeshRetriever(jsh, jm, idx.list_len,
                                               LOOP_SCFG),
                  batch_size=2, retrieval_interval=2, nprobe=4, k=5)
    jtt.batch_inference(6)
    params = decoder_from_numpy(f32_tree(jp), tcfg(LOOP_CFG), device="cpu")
    r = MeshRetriever(sh, mesh, t_idx.list_len, tsc(LOOP_SCFG))
    tt = TikTokDecoder(params, tcfg(LOOP_CFG), r, batch_size=2,
                       retrieval_interval=2, nprobe=4, k=5)
    assert tt._device_path
    tt.batch_inference(6)
    for name, st in tt.states.items():
        js = jtt.states[name]
        assert st.step >= 6 and st.last_result is not None
        np.testing.assert_array_equal(n(st.tokens), np.asarray(js.tokens))
        held(st.last_result.dists, st.last_result.ids,
             np.asarray(js.last_result.dists), np.asarray(js.last_result.ids))


# ---------------------------------------------------------------------------
# the multi-chip RAG step: dp × tp × lists on CPU positions
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def rag_mesh(setup):
    """dp 2 × tp 2 × lists 2 (8 positions) and the index sharded over its
    ``lists`` axis, with a ``MeshRetriever`` over ``batch_axis="dp"``."""
    ds, idx, t_idx, _, _ = setup
    mesh = make_mesh((("dp", 2), ("tp", 2), ("lists", 2)),
                     devices=["cpu"] * 8)
    sh = place_sharded(shard_index(t_idx, 2, tile_seg=256), mesh)
    scfg = dataclasses.replace(LOOP_SCFG, use_approx_topk=False)
    r = MeshRetriever(sh, mesh, t_idx.list_len, tsc(scfg), batch_axis="dp")
    single = IVFSearcher(t_idx, tsc(dataclasses.replace(scfg,
                                                         backend="seg")),
                         device="cpu")
    return mesh, r, single


class Recorder:
    def __init__(self, inner):
        self.inner, self.queries = inner, None

    def retrieve_device(self, queries, nprobe, k):
        self.queries = queries.clone()
        return self.inner.retrieve_device(queries, nprobe, k)


def test_multichip_rag_step_matches_unsharded(setup, rag_mesh):
    """``RalmDecoder`` with tensor-parallel parameters over the 2-D mesh
    retriever, at interval 1: every token equals the unsharded loop's over
    the single-device search, and the last fused retrieval equals
    ``IVFSearcher.search`` on the same hidden states up to ties."""
    from chamjax_torch.retrieval import LocalRetriever
    ds, idx, t_idx, _, _ = setup
    mesh, r, single = rag_mesh
    cfg = dataclasses.replace(tcfg(LOOP_CFG), retrieval_interval=1)
    params = decoder_from_numpy(
        f32_tree(init_decoder(jax.random.PRNGKey(2), LOOP_CFG)), cfg,
        device="cpu")
    rec = Recorder(r)
    tp = RalmDecoder(shard_decoder_params(params, mesh), cfg, rec,
                     batch_size=4, retrieval_interval=1, nprobe=4, k=5)
    tp.cache = shard_kv_cache(tp.cache, mesh)
    ref = RalmDecoder(params, cfg, LocalRetriever(t_idx, single.scfg,
                                                  device="cpu"),
                      batch_size=4, retrieval_interval=1, nprobe=4, k=5)
    for _ in range(6):
        tp.single_step()
        ref.single_step()
        np.testing.assert_array_equal(n(tp.tokens), n(ref.tokens))
    d, i = single.search(n(rec.queries), nprobe=4, k=5)
    held(tp.last_result.dists, tp.last_result.ids, d, i)
    held(tp.last_result.dists, tp.last_result.ids,
         ref.last_result.dists, ref.last_result.ids)


def test_multichip_tiktok_matches_unsharded(setup, rag_mesh):
    """``TikTokDecoder`` with tensor-parallel parameters over the mesh
    retriever (each state's cache sharded): each state's tokens and last
    retrieval equal the unsharded tik-tok loop's over the same retriever."""
    mesh, r, _ = rag_mesh
    cfg = dataclasses.replace(tcfg(LOOP_CFG), retrieval_interval=1)
    params = decoder_from_numpy(
        f32_tree(init_decoder(jax.random.PRNGKey(5), LOOP_CFG)), cfg,
        device="cpu")
    loops = []
    for p in (params, shard_decoder_params(params, mesh)):
        tt = TikTokDecoder(p, cfg, r, batch_size=4, retrieval_interval=1,
                           nprobe=4, k=5)
        if p is not params:
            for st in tt.states.values():
                st.cache = shard_kv_cache(st.cache, mesh)
        tt.batch_inference(5)
        loops.append(tt)
    for name, st in loops[1].states.items():
        want = loops[0].states[name]
        np.testing.assert_array_equal(n(st.tokens), n(want.tokens))
        held(st.last_result.dists, st.last_result.ids,
             want.last_result.dists, want.last_result.ids)
