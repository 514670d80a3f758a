"""The on-disk populate and load of the port (``chamjax_torch/index/
ondisk.py``) against the JAX package's, on the CPU: the files each package
writes load in the other; the host and device populates write byte-equal
``codes.raw``/``ids.raw`` from the same quantizers (and the JAX package's
bytes); a ``HostStreamedSearcher`` over the memmaps answers as the
in-memory index does."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chamjax.config import IndexConfig
from chamjax.data import synthetic_dataset
from chamjax.index import factory as jf
from chamjax.index import ondisk as jod

from chamjax_torch.config import IndexConfig as TIndexConfig
from chamjax_torch.config import SearchConfig as TSearchConfig
from chamjax_torch.eval import tie_mismatches
from chamjax_torch.index import factory as tf
from chamjax_torch.index import ondisk as tod
from chamjax_torch.searcher import IVFSearcher
from chamjax_torch.streamed import HostStreamedSearcher

CFG = IndexConfig(dim=32, nlist=16, m=8, list_pad=64)


@pytest.fixture(scope="module")
def setup():
    ds = synthetic_dataset(nb=10_000, nq=16, nt=4000, d=32, seed=7,
                           n_clusters=32)
    tq_j = jf.train_quantizers(ds.xt, CFG, kmeans_iters=4, pq_iters=4)
    tq_t = tf.TrainedQuantizers(cfg=TIndexConfig(**dataclasses.asdict(CFG)),
                                centroids=tq_j.centroids,
                                codebooks=tq_j.codebooks)
    return ds, tq_j, tq_t


def raw(path, name):
    with open(os.path.join(path, name), "rb") as f:
        return f.read()


def assert_same_index(a, b):
    for name in ("codes", "ids", "list_start", "list_len", "centroids",
                 "codebooks"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
    assert a.ntotal == b.ntotal
    assert dataclasses.asdict(a.cfg) == dataclasses.asdict(b.cfg)


def test_files_load_in_the_other_package(setup, tmp_path):
    """Each package's on-disk index loads in the other: the same arrays,
    and the port's ``codes``/``ids`` are read-only memmaps."""
    ds, tq_j, tq_t = setup
    p_j = jod.populate_on_disk(ds.xb, tq_j, str(tmp_path / "j"), chunk=3000)
    p_t = tod.populate_on_disk(ds.xb, tq_t, str(tmp_path / "t"), chunk=3000,
                               device="cpu")
    from_j, from_t = tod.load_ondisk(p_j), jod.load_ondisk(p_t)
    assert isinstance(from_j.codes, np.memmap) and not from_j.codes.flags[
        "WRITEABLE"]
    assert_same_index(from_j, jod.load_ondisk(p_j))
    assert_same_index(tod.load_ondisk(p_t), from_t)
    for name in ("codes.raw", "ids.raw"):
        assert raw(p_t, name) == raw(p_j, name), name


def test_host_and_device_populate_write_equal_bytes(setup, tmp_path):
    """``populate_on_disk`` and ``populate_on_disk_device`` (a streamed
    draw, chunks of 3000 rows and a tail) write byte-equal code and id
    files from the same quantizers, equal to the JAX host populate's, and
    both equal the in-memory ``populate`` as lists (as sets of rows)."""
    ds, tq_j, tq_t = setup
    host = tod.populate_on_disk(ds.xb, tq_t, str(tmp_path / "h"), chunk=3000,
                                id_offset=5, device="cpu")
    dev = tod.populate_on_disk_device(
        lambda s, c: torch.from_numpy(ds.xb[s:s + c].copy()), ds.nb, tq_t,
        str(tmp_path / "d"), chunk=3000, id_offset=5, device="cpu")
    ref = jod.populate_on_disk(ds.xb, tq_j, str(tmp_path / "j"), chunk=3000,
                               id_offset=5)
    xb_d = jnp.asarray(ds.xb)
    ref_dev = jod.populate_on_disk_device(
        lambda s, c: xb_d[s:s + c], ds.nb, tq_j, str(tmp_path / "jd"),
        chunk=3000, id_offset=5)
    for name in ("codes.raw", "ids.raw"):
        assert raw(dev, name) == raw(host, name), name
        assert raw(host, name) == raw(ref, name), name
        assert raw(dev, name) == raw(ref_dev, name), name
    disk = tod.load_ondisk(host)
    mem = tf.populate(ds.xb, tq_t, id_offset=5, device="cpu")
    np.testing.assert_array_equal(disk.list_len, mem.list_len)
    np.testing.assert_array_equal(disk.list_start, mem.list_start)
    for li in range(CFG.nlist):
        s, ln = int(mem.list_start[li]), int(mem.list_len[li])
        np.testing.assert_array_equal(np.sort(disk.ids[s:s + ln]),
                                      np.sort(mem.ids[s:s + ln]))


def test_streamed_searcher_over_memmaps_answers_as_in_memory(setup,
                                                              tmp_path):
    """``HostStreamedSearcher`` over ``load_ondisk``'s memmaps gives the
    in-memory index's answers (f32 LUTs): distances rtol 1e-5, ids equal up
    to the order of ties."""
    ds, _, tq_t = setup
    disk = tod.load_ondisk(tod.populate_on_disk(
        ds.xb, tq_t, str(tmp_path / "od"), chunk=4096, device="cpu"))
    mem = tf.populate(ds.xb, tq_t, device="cpu")
    scfg = TSearchConfig(nprobe=8, k=10, seg=128, use_approx_topk=False)
    d_s, i_s = HostStreamedSearcher(disk, scfg, device="cpu").search(ds.xq)
    d_m, i_m = IVFSearcher(mem, scfg, device="cpu").search(ds.xq)
    np.testing.assert_allclose(d_s, d_m, rtol=1e-5, atol=1e-5)
    assert not tie_mismatches(d_s, i_s, d_m, i_m, rtol=1e-5, atol=1e-5)
    assert (i_s[:, 0] >= 0).all()


def test_balanced_populate_on_disk_warns(tmp_path):
    """The chunked assigner is nearest-cell only: a balanced config warns
    (in both packages) instead of dropping the cap silently."""
    ds = synthetic_dataset(nb=4000, nq=4, nt=2000, d=16, seed=3,
                           n_clusters=16)
    cfg = TIndexConfig(dim=16, nlist=16, m=4, balanced=True)
    tq = tf.train_quantizers(ds.xt, cfg, kmeans_iters=2, pq_iters=2,
                             device="cpu")
    with pytest.warns(UserWarning, match="balanced"):
        tod.populate_on_disk(ds.xb, tq, str(tmp_path / "od"), device="cpu")
