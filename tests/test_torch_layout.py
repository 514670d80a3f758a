"""chamjax_torch: the index layout carried across from chamjax, the shared
npz format, the synthetic corpus, and the package rules (no jax, no
chamjax; entry points run on the card unless asked for the CPU)."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from chamjax.config import IndexConfig
from chamjax.data import synthetic_dataset
from chamjax.index import build_ivfpq
from chamjax.index.ivf import PackedIVF
from chamjax.searcher import DeviceIVF

import chamjax_torch.data as tdata
from chamjax_torch.config import IndexConfig as TIndexConfig
from chamjax_torch.config import SearchConfig as TSearchConfig
from chamjax_torch.eval import recall_at_k as t_recall_at_k
from chamjax_torch.index.ivf import PackedIVF as TPackedIVF
from chamjax_torch.searcher import DeviceIVF as TDeviceIVF
from chamjax_torch.searcher import IVFSearcher as TIVFSearcher

REPO = Path(__file__).resolve().parents[1]


def carry(idx) -> TPackedIVF:
    """chamjax PackedIVF → chamjax_torch PackedIVF, without a file."""
    return TPackedIVF.from_arrays(
        dataclasses.asdict(idx.cfg), centroids=idx.centroids,
        codebooks=idx.codebooks, codes=idx.codes, ids=idx.ids,
        list_start=idx.list_start, list_len=idx.list_len, ntotal=idx.ntotal,
        opq_R=idx.opq_R)


@pytest.fixture(scope="module")
def jax_index():
    ds = synthetic_dataset(nb=6000, nq=8, nt=3000, d=32, seed=9,
                           n_clusters=32)
    idx = build_ivfpq(ds.xb, IndexConfig(dim=32, nlist=24, m=8, list_pad=64,
                                         opq=True),
                      xt=ds.xt, kmeans_iters=3, pq_iters=3)
    return ds, idx


@pytest.mark.parametrize("tile_seg", [0, 128, 256])
def test_from_packed_matches_chamjax(jax_index, tile_seg):
    _ds, idx = jax_index
    want = DeviceIVF.from_packed(idx, tile_seg=tile_seg)
    got = TDeviceIVF.from_packed(carry(idx), device="cpu", tile_seg=tile_seg)
    for name in ("centroids", "codebooks", "codes_t", "ids", "list_start",
                 "list_len", "opq_R"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    if tile_seg:
        np.testing.assert_array_equal(got.codes_tiled.numpy(),
                                      np.asarray(want.codes_tiled))
        assert got.codes_tiled.dtype == torch.uint8
    else:
        assert got.codes_tiled is None and want.codes_tiled is None
    assert got.ids.dtype == torch.int32 and got.codes_t.dtype == torch.uint8


def test_tiled_repack_coordinates(jax_index):
    """Mirror of test_scan_seg.py::test_tiled_repack_coordinates: every
    (list, row) pair is intact in the tiled twin."""
    _ds, idx = jax_index
    seg = 128
    dev = TDeviceIVF.from_packed(carry(idx), device="cpu", tile_seg=seg)
    starts = dev.list_start.numpy()
    assert np.all(starts % seg == 0)
    codes_t, tiled, ids = (dev.codes_t.numpy(), dev.codes_tiled.numpy(),
                           dev.ids.numpy())
    for li in range(idx.cfg.nlist):
        ln = int(idx.list_len[li])
        so, sn = int(idx.list_start[li]), int(starts[li])
        np.testing.assert_array_equal(ids[sn:sn + ln], idx.ids[so:so + ln])
        np.testing.assert_array_equal(codes_t[:, sn:sn + ln],
                                      idx.codes[so:so + ln].T)
        for r in range(0, ln, 37):
            t, off = (sn + r) // seg, (sn + r) % seg
            np.testing.assert_array_equal(tiled[t, :, off],
                                          idx.codes[so + r])


def _assert_same_index(a, b):
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)
    for name in ("centroids", "codebooks", "codes", "ids", "list_start",
                 "list_len", "opq_R"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.ntotal == b.ntotal


def test_npz_chamjax_to_torch(jax_index, tmp_path):
    _ds, idx = jax_index
    path = str(tmp_path / "jax_idx.npz")
    idx.save(path)
    got = TPackedIVF.load(path)
    assert isinstance(got.cfg, TIndexConfig)
    _assert_same_index(got, idx)


def test_npz_torch_to_chamjax(jax_index, tmp_path):
    _ds, idx = jax_index
    path = str(tmp_path / "torch_idx.npz")
    carry(idx).save(path)
    _assert_same_index(PackedIVF.load(path), idx)


def test_npz_roundtrip_without_opq(tmp_path):
    t = TPackedIVF.from_arrays(
        dataclasses.asdict(TIndexConfig(dim=8, nlist=2, m=2)),
        centroids=np.zeros((2, 8), np.float32),
        codebooks=np.zeros((2, 256, 4), np.float32),
        codes=np.zeros((128, 2), np.uint8), ids=np.full(128, -1, np.int32),
        list_start=np.array([0, 64], np.int32),
        list_len=np.array([0, 0], np.int32), ntotal=0)
    path = str(tmp_path / "empty.npz")
    t.save(path)
    back = PackedIVF.load(path)
    assert back.opq_R is None
    _assert_same_index(TPackedIVF.load(path), back)


def test_synthetic_dataset_bit_identical():
    for kw in (dict(n_clusters=16), dict(n_clusters=0),
               dict(n_clusters=8, spectrum_tau=4.0)):
        a = synthetic_dataset(nb=500, nq=7, nt=300, d=16, seed=11, **kw)
        b = tdata.synthetic_dataset(nb=500, nq=7, nt=300, d=16, seed=11, **kw)
        for part in ("xb", "xq", "xt"):
            np.testing.assert_array_equal(getattr(a, part), getattr(b, part))
        assert b.d == 16 and b.nb == 500


def test_recall_at_k_matches_chamjax():
    from chamjax.eval import recall_at_k
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 50, (20, 10))
    gt = rng.integers(0, 50, (20, 10))
    for k in (1, 5, 10):
        for mode in ("nn", "intersection"):
            assert t_recall_at_k(ids, gt, k, mode) == recall_at_k(
                ids, gt, k, mode)


# ---------------------------------------------------------------------------
# package rules
# ---------------------------------------------------------------------------


def test_import_leaves_jax_out():
    code = ("import sys, chamjax_torch, chamjax_torch.searcher, "
            "chamjax_torch.index, chamjax_torch.data, chamjax_torch.eval, "
            "chamjax_torch.ops.scan_seg_block, chamjax_torch.ops.scan_pallas, "
            "chamjax_torch.ops.scan_seg_multi, chamjax_torch.streamed, "
            "chamjax_torch.utils.cuda_lib, chamjax_torch.index.factory, "
            "chamjax_torch.index.ondisk, chamjax_torch.index.imi, "
            "chamjax_torch.index.sizing, chamjax_torch.index.device_build, "
            "chamjax_torch.data.hard, "
            "chamjax_torch.benchmarks.ralm_device_bench, "
            "chamjax_torch.parallel, chamjax_torch.parallel.sharded_model, "
            "chamjax_torch.parallel.sharded_search, chamjax_torch.entry, "
            "chamjax_torch.utils.collectives, "
            "chamjax_torch.retrieval.local, chamjax_torch.config, "
            "chamjax_torch.utils, chamjax_torch.utils.results, "
            "chamjax_torch.utils.energy, chamjax_torch.eval.diagnose, "
            "chamjax_torch.benchmarks.profiling_stages, "
            "chamjax_torch.native; "
            "bad = sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'chamjax' "
            "or m.startswith('chamjax.')); print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


_IMPORT = re.compile(
    r"^\s*(?:import|from)\s+(jax|optax|chamjax)(?:[.\s,]|$)", re.M)


def test_ir_rag_hf_adapter_leave_jax_optax_chamjax_out():
    """The retrieval-quality path (``ir``, ``rag``, ``serving.hf_adapter``)
    imports neither jax, optax nor chamjax: training is torch autograd and
    ``torch.optim.Adam``."""
    code = ("import sys, chamjax_torch.ir, chamjax_torch.ir.ann, "
            "chamjax_torch.ir.models, chamjax_torch.ir.rerank, "
            "chamjax_torch.ir.synth, chamjax_torch.ir.train, "
            "chamjax_torch.rag, chamjax_torch.rag.pipeline, "
            "chamjax_torch.rag.vector_store, chamjax_torch.rag.loaders, "
            "chamjax_torch.serving.hf_adapter, chamjax_torch.models.convert; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'optax', 'chamjax')); print(bad); sys.exit(bool(bad))")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_source_imports_jax_or_chamjax():
    files = sorted((REPO / "chamjax_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        hits = _IMPORT.findall(f.read_text())
        assert not hits, f"{f} imports {hits}"


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_card_or_explicit_cpu(jax_index, no_card):
    from chamjax_torch.data import compute_ground_truth
    from chamjax_torch.index import build_ivfpq as t_build
    ds, idx = jax_index
    t = carry(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TIVFSearcher(t, TSearchConfig(nprobe=4, k=5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TDeviceIVF.from_packed(t)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        compute_ground_truth(ds.xb, ds.xq, k=5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build(ds.xb, TIndexConfig(dim=32, nlist=8, m=8), xt=ds.xt)
    from chamjax_torch.benchmarks.profiling_stages import (flagship_index,
                                                           synthetic_index)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        synthetic_index(4096, 32, 8, 8, 512, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagship_index(4096, 32, 8, 8, 512, True)
    # the HF classes refuse before they load a checkpoint (or transformers)
    from chamjax_torch.ir.dense import HFEncoder
    from chamjax_torch.ir.rerank import HFCrossEncoder
    from chamjax_torch.ir.train import QueryGenerator
    for cls in (HFEncoder, HFCrossEncoder, QueryGenerator):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls("/nonexistent/checkpoint")
    # the explicit CPU request works
    s = TIVFSearcher(t, TSearchConfig(nprobe=4, k=5), device="cpu")
    d, i = s.search(ds.xq)
    assert d.shape == (8, 5) and i.dtype == np.int64
