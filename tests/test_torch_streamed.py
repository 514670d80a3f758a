"""The host-streamed tier: chamjax_torch's HostStreamedSearcher (on the
CPU, where the staged scans run their plain versions) against chamjax's
HostStreamedSearcher and against the port's resident searcher, on
``tests/test_streamed.py``'s index shape, for ``tiled`` True and False."""

import dataclasses

import numpy as np
import pytest

from chamjax.config import IndexConfig, SearchConfig
from chamjax.data import synthetic_dataset
from chamjax.data.ground_truth import compute_ground_truth
from chamjax.index import build_ivfpq
from chamjax.streamed import HostStreamedSearcher

from chamjax_torch import streamed as tstreamed
from chamjax_torch.config import SearchConfig as TSearchConfig
from chamjax_torch.eval import recall_at_k, tie_mismatches
from chamjax_torch.searcher import IVFSearcher as TIVFSearcher
from chamjax_torch.utils import cuda_lib

from test_torch_search import carry, compare, same_up_to_ties

BASE = dict(nprobe=8, k=10, use_approx_topk=False)


@pytest.fixture(scope="module")
def ds():
    return synthetic_dataset(nb=20000, nq=16, nt=8000, d=32, seed=11,
                             n_clusters=64)


@pytest.fixture(scope="module")
def index(ds):
    cfg = IndexConfig(dim=32, nlist=64, m=8, list_pad=64)
    idx = build_ivfpq(ds.xb, cfg, xt=ds.xt, kmeans_iters=6, pq_iters=6)
    return idx, carry(idx)


@pytest.fixture(scope="module")
def gt(ds):
    return compute_ground_truth(ds.xb, ds.xq, k=10)[0]


@pytest.mark.parametrize("lut_bf16", [False, True])
@pytest.mark.parametrize("tiled", [True, False])
def test_streamed_matches_chamjax(ds, index, gt, tiled, lut_bf16):
    """Dists, ids up to the order of ties, and R@10 against chamjax."""
    idx, tidx = index
    kw = dict(BASE, tiled=tiled, lut_bf16=lut_bf16)
    d_j, i_j = HostStreamedSearcher(idx, SearchConfig(**kw)).search(ds.xq)
    cuda_lib.launch_counts.clear()
    st = tstreamed.HostStreamedSearcher(tidx, TSearchConfig(**kw),
                                        device="cpu")
    d_t, i_t = st.search(ds.xq)
    assert sum(cuda_lib.launch_counts.values()) == 0   # CPU: plain path
    assert i_t.dtype == np.int64 and d_t.shape == (16, 10)
    compare(d_j, i_j, d_t, i_t, gt)


@pytest.mark.parametrize("tiled", [True, False])
def test_streamed_matches_resident(ds, index, gt, tiled):
    _idx, tidx = index
    kw = dict(BASE, tiled=tiled)
    d_r, i_r = TIVFSearcher(tidx, TSearchConfig(**kw),
                            device="cpu").search(ds.xq)
    d_s, i_s = tstreamed.HostStreamedSearcher(
        tidx, TSearchConfig(**kw), device="cpu").search(ds.xq)
    same_up_to_ties(d_s, i_s, d_r, i_r, rtol=1e-4, atol=1e-4)
    assert recall_at_k(i_s, gt, 10) == recall_at_k(i_r, gt, 10)


@pytest.mark.parametrize("shift", ["row", "window"])
def test_wrong_position_map_is_caught(ds, index, monkeypatch, shift):
    """The comparison against chamjax has teeth: a position → window → row
    map that is off by one row or one window fails it."""
    idx, tidx = index
    d_j, i_j = HostStreamedSearcher(idx, SearchConfig(**BASE)).search(ds.xq)
    st = tstreamed.HostStreamedSearcher(tidx, TSearchConfig(**BASE),
                                        device="cpu")
    right = st._map_ids
    step = 1 if shift == "row" else st.seg
    monkeypatch.setattr(st, "_map_ids", lambda d, pos, starts: right(
        d, np.minimum(pos + step, st.windows * st.seg - 1), starts))
    d_t, i_t = st.search(ds.xq)
    np.testing.assert_allclose(d_t, d_j, rtol=1e-5, atol=1e-5)
    assert tie_mismatches(d_t, i_t, d_j, i_j, rtol=1e-5, atol=1e-5)


def test_streamed_tiled_equals_flat(ds, index):
    _idx, tidx = index
    d_t, i_t = tstreamed.HostStreamedSearcher(
        tidx, TSearchConfig(**BASE, tiled=True), device="cpu").search(ds.xq)
    d_f, i_f = tstreamed.HostStreamedSearcher(
        tidx, TSearchConfig(**BASE, tiled=False), device="cpu").search(ds.xq)
    same_up_to_ties(d_t, i_t, d_f, i_f)


@pytest.mark.parametrize("tiled", [True, False])
def test_pipelined_equals_sequential(ds, index, tiled):
    """Two staging buffers in turn, three batches of two sizes: every
    result equals the sequential search exactly."""
    _idx, tidx = index
    st = tstreamed.HostStreamedSearcher(tidx, TSearchConfig(**BASE,
                                                            tiled=tiled),
                                        device="cpu")
    batches = [ds.xq[:8], ds.xq[8:], ds.xq[3:7]]
    piped = st.search_pipelined(batches)
    assert len(piped) == 3
    for q, (d_p, i_p) in zip(batches, piped):
        d_s, i_s = st.search(q)
        np.testing.assert_array_equal(d_p, d_s)
        np.testing.assert_array_equal(i_p, i_s)
    assert st.search_pipelined([]) == []


def test_reused_buffer_stale_bytes_are_not_read(ds, index):
    """A staging buffer keeps an earlier batch's bytes past each window's
    length; a search after another equals the same search on a fresh
    searcher."""
    _idx, tidx = index
    cfg = TSearchConfig(**BASE)
    st = tstreamed.HostStreamedSearcher(tidx, cfg, device="cpu")
    st.search(ds.xq[::-1])
    d, i = st.search(ds.xq)
    d_f, i_f = tstreamed.HostStreamedSearcher(tidx, cfg,
                                              device="cpu").search(ds.xq)
    np.testing.assert_array_equal(d, d_f)
    np.testing.assert_array_equal(i, i_f)


def test_stage_cuts_windows_at_the_tail(index):
    """Every window takes ``seg`` rows from its start; a window at the end
    of the packed array is cut there (rows ``[s, min(s + seg, n_pad))``)
    and its length never reaches past it."""
    _idx, tidx = index
    st = tstreamed.HostStreamedSearcher(tidx, TSearchConfig(**BASE),
                                        device="cpu")
    n_pad, seg = st.n_pad, st.seg
    starts = np.array([[0, n_pad - seg // 3, 64, n_pad - 1]], np.int32)
    slab = st._stage(starts, np.ones_like(starts)).numpy()
    assert slab.shape == (4, seg, tidx.cfg.m)
    for w, s in enumerate(starts[0]):
        e = min(int(s) + seg, n_pad)
        np.testing.assert_array_equal(slab[w, :e - s], tidx.codes[s:e])


def test_int64_ids_no_copy(ds, index):
    """An int64 id array is the searcher's only id storage and comes back
    as is."""
    _idx, tidx = index
    ids64 = np.asarray(tidx.ids, np.int64)
    idx64 = dataclasses.replace(tidx, ids=ids64)
    st = tstreamed.HostStreamedSearcher(idx64, TSearchConfig(**BASE),
                                        device="cpu")
    assert st.ids is ids64
    assert not any(isinstance(v, np.ndarray) and v is not ids64
                   and v.shape == ids64.shape for v in vars(st).values())
    d, i = st.search(ds.xq)
    d_r, i_r = tstreamed.HostStreamedSearcher(
        tidx, TSearchConfig(**BASE), device="cpu").search(ds.xq)
    np.testing.assert_array_equal(d, d_r)
    np.testing.assert_array_equal(i, i_r)


def test_read_only_memmap_codes_and_ids(ds, index, tmp_path):
    _idx, tidx = index
    np.save(tmp_path / "codes.npy", tidx.codes)
    np.save(tmp_path / "ids.npy", np.asarray(tidx.ids, np.int64))
    codes = np.load(tmp_path / "codes.npy", mmap_mode="r")
    ids = np.load(tmp_path / "ids.npy", mmap_mode="r")
    assert isinstance(codes, np.memmap) and not codes.flags.writeable
    mm = dataclasses.replace(tidx, codes=codes, ids=ids)
    st = tstreamed.HostStreamedSearcher(mm, TSearchConfig(**BASE),
                                        device="cpu")
    st.warm()
    assert st.codes is codes and st.ids is ids
    d, i = st.search(ds.xq)
    d_r, i_r = tstreamed.HostStreamedSearcher(
        tidx, TSearchConfig(**BASE), device="cpu").search(ds.xq)
    np.testing.assert_array_equal(d, d_r)
    np.testing.assert_array_equal(i, i_r)


def test_coarse_cand_matches_exact(ds, index):
    _idx, tidx = index
    d_e, i_e = tstreamed.HostStreamedSearcher(
        tidx, TSearchConfig(**BASE, coarse_cand=0),
        device="cpu").search(ds.xq)
    d_2, i_2 = tstreamed.HostStreamedSearcher(
        tidx, TSearchConfig(**BASE, coarse_cand=32),
        device="cpu").search(ds.xq)
    np.testing.assert_array_equal(d_2, d_e)
    np.testing.assert_array_equal(i_2, i_e)


def test_seg_group_zero_ok(ds, index):
    idx, tidx = index
    kw = dict(BASE, seg_group=0)
    st = tstreamed.HostStreamedSearcher(tidx, TSearchConfig(**kw),
                                        device="cpu")
    assert st.group == 1
    assert st.windows == HostStreamedSearcher(idx,
                                              SearchConfig(**kw)).windows
    d, _i = st.search(ds.xq[:4])
    assert np.isfinite(d).all()


def test_rejects_nbits_not_8_and_warns_on_lane_l1(index):
    _idx, tidx = index
    idx4 = dataclasses.replace(tidx, cfg=dataclasses.replace(tidx.cfg,
                                                             nbits=4))
    with pytest.raises(ValueError, match="nbits"):
        tstreamed.HostStreamedSearcher(idx4, TSearchConfig(**BASE),
                                       device="cpu")
    with pytest.warns(UserWarning, match="lane_l1"):
        tstreamed.HostStreamedSearcher(tidx, TSearchConfig(**BASE,
                                                           lane_l1=True),
                                       device="cpu")
