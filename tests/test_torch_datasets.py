"""The port's dataset I/O (``chamjax_torch/data/datasets.py``) against
chamjax's on the CPU: every file of ``tests/golden/`` (written byte by byte
by ``tests/golden/make_golden.py``, not by either package's writers) read
through both packages into equal arrays, the writers' bytes, and
``load_dataset`` / ``load_real_dataset`` on the same specs."""

import os
import shutil

import numpy as np
import pytest

from chamjax.data import datasets as jd

from chamjax_torch import native as tnative
from chamjax_torch.data import datasets as td

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def golden(name: str) -> str:
    return os.path.join(GOLDEN, name)


def both(fn: str, *args, **kw):
    got = getattr(td, fn)(*args, **kw)
    want = getattr(jd, fn)(*args, **kw)
    assert type(got) is type(want), fn
    assert got.dtype == want.dtype and got.shape == want.shape, fn
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    return got


READS = [
    ("read_fvecs", "golden.fvecs", {}),
    ("mmap_fvecs", "golden.fvecs", {}),
    ("read_ivecs", "golden.ivecs", {}),
    ("read_bvecs", "golden.bvecs", {}),
    ("mmap_bvecs", "golden.bvecs", {}),
    ("read_ivecs", "golden_gt1000.ivecs", {}),
    ("read_fbin", "golden.fbin", {}),
    ("read_fbin", "golden.fbin", dict(start=1, count=1)),
    ("read_ibin", "golden.ibin", {}),
    ("read_ibin", "golden.ibin", dict(start=1)),
    ("read_spacev_i8bin", "golden_spacev.bin", {}),
    ("read_spacev_i8bin", "golden_spacev.bin", dict(start=2, count=1)),
    ("mmap_spacev_i8bin", "golden_spacev.bin", {}),
    ("mmap_raw_f32", "golden_sbert_d384.f32", dict(dim=384)),
]


@pytest.mark.parametrize("fn,name,kw", READS,
                         ids=[f"{f}-{n}-{i}" for i, (f, n, _) in
                              enumerate(READS)])
def test_golden_file_equal_chamjax(fn, name, kw):
    both(fn, golden(name), **kw)


def test_golden_values():
    """The published layouts' values, as make_golden.py writes them."""
    np.testing.assert_array_equal(
        td.read_fvecs(golden("golden.fvecs")),
        np.array([[1.5, -2.0, 0.25, 3.0], [0.0, 1.0, 2.0, 3.0],
                  [-1.0, -0.5, 0.5, 1.0]], np.float32))
    np.testing.assert_array_equal(td.read_ivecs(golden("golden.ivecs")),
                                  [[7, 8, 9], [100, 200, 300]])
    gt = td.read_ivecs(golden("golden_gt1000.ivecs"))
    assert gt.shape == (3, 1000)
    np.testing.assert_array_equal(gt[2], 2_000_000 + np.arange(1000))
    np.testing.assert_array_equal(td.read_ibin(golden("golden.ibin")),
                                  [[10, 11], [20, 21], [30, 31]])
    x = td.read_spacev_i8bin(golden("golden_spacev.bin"))
    np.testing.assert_array_equal(x.ravel(),
                                  np.arange(20, dtype=np.int8) - 64)
    m = td.mmap_raw_f32(golden("golden_sbert_d384.f32"), dim=384)
    np.testing.assert_allclose(np.asarray(m).ravel(),
                               np.arange(768, dtype=np.float32) / 7.0)


@pytest.mark.parametrize("fn,name", [("read_fvecs", "golden.fvecs"),
                                     ("read_ivecs", "golden.ivecs"),
                                     ("read_bvecs", "golden.bvecs")])
def test_vecs_readers_native_and_numpy_paths(fn, name, monkeypatch):
    """The vecs readers go through ``native.read_vecs``; where the library
    cannot build, the numpy reader gives the same array."""
    want = getattr(jd, fn)(golden(name))
    np.testing.assert_array_equal(getattr(td, fn)(golden(name)), want)

    def unavailable():
        raise tnative.NativeUnavailable("no g++")

    monkeypatch.setattr(tnative, "load", unavailable)
    got = getattr(td, fn)(golden(name))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_writers_write_chamjax_bytes(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    i = rng.integers(0, 1 << 30, (5, 3)).astype(np.int32)
    for fn, arr in (("write_fvecs", x), ("write_ivecs", i),
                    ("write_fbin", x)):
        getattr(td, fn)(str(tmp_path / "t"), arr)
        getattr(jd, fn)(str(tmp_path / "j"), arr)
        assert (tmp_path / "t").read_bytes() == (tmp_path / "j").read_bytes()
    np.testing.assert_array_equal(td.read_fbin(str(tmp_path / "t")), x)


def test_load_real_dataset_explicit_spec():
    """A ``base=...,query=...,gt=...`` spec over the golden files: the same
    Dataset as chamjax's, base materialised as f32, no learn file → a base
    prefix."""
    spec = (f"base={golden('golden.bvecs')},query={golden('golden.fvecs')},"
            f"gt={golden('golden.ivecs')}")
    # the golden base and query differ in width: only shapes and dtypes of
    # the loaded parts matter to the loader
    t, j = td.load_real_dataset(spec), jd.load_real_dataset(spec)
    for part in ("xb", "xq", "xt", "gt"):
        np.testing.assert_array_equal(getattr(t, part), getattr(j, part))
        assert getattr(t, part).dtype == getattr(j, part).dtype
    assert t.xb.dtype == np.float32 and t.xb.shape == (2, 6)
    np.testing.assert_array_equal(t.xt, t.xb)
    with pytest.warns(UserWarning, match="truncates"):
        cut = td.load_real_dataset(spec, max_nb=1, max_nq=2)
    assert cut.gt is None and cut.xb.shape == (1, 6) and cut.xq.shape[0] == 2


def test_load_real_dataset_directory(tmp_path):
    """A directory in the reference's naming: base, query, learn and a
    ground truth under ``gnd/`` are found by name, as chamjax finds them."""
    shutil.copy(golden("golden.fbin"), tmp_path / "toy_base.fbin")
    shutil.copy(golden("golden.fbin"), tmp_path / "toy_query.fbin")
    shutil.copy(golden("golden.fvecs"), tmp_path / "toy_learn.fvecs")
    (tmp_path / "gnd").mkdir()
    shutil.copy(golden("golden.ibin"), tmp_path / "gnd" / "idx_toy.ibin")
    t, j = (td.load_real_dataset(str(tmp_path)),
            jd.load_real_dataset(str(tmp_path)))
    for part in ("xb", "xq", "xt", "gt"):
        np.testing.assert_array_equal(getattr(t, part), getattr(j, part))
    np.testing.assert_array_equal(t.xb, [[1, 2, 3], [4, 5, 6]])
    assert t.gt.shape == (3, 2)
    with pytest.raises(FileNotFoundError):
        td.load_real_dataset(str(tmp_path / "absent"))
    with pytest.raises(FileNotFoundError, match="query"):
        td.load_real_dataset(f"base={golden('golden.fbin')}")
    with pytest.raises(ValueError, match="extension"):
        td.load_real_dataset(f"base={golden('golden.ivecs')},"
                             f"query={golden('golden.fbin')}")


def test_load_dataset_synthesises_and_caches(tmp_path):
    """No files on disk: the same draw as chamjax's, cached under
    ``syn_cache`` and read back from there; known names keep their dim."""
    kw = dict(max_nb=300, nq=5, nt=100, n_clusters=8, seed=3)
    t = td.load_dataset("SYN1M", data_dir=str(tmp_path / "t"), **kw)
    j = jd.load_dataset("SYN1M", data_dir=str(tmp_path / "j"), **kw)
    for part in ("xb", "xq", "xt"):
        np.testing.assert_array_equal(getattr(t, part), getattr(j, part))
    assert t.xb.shape == (300, 128)
    cached = list((tmp_path / "t" / "syn_cache").iterdir())
    assert len(cached) == 1
    again = td.load_dataset("SYN1M", data_dir=str(tmp_path / "t"), **kw)
    np.testing.assert_array_equal(again.xb, t.xb)
    with pytest.raises(ValueError, match="fixed dim"):
        td.load_dataset("Deep1M", d=128)


def test_load_dataset_reads_the_bigann_layout(tmp_path):
    """``SIFT<n>M`` with a ``bigann/`` directory reads the files."""
    root = tmp_path / "bigann"
    (root / "gnd").mkdir(parents=True)
    for name in ("bigann_base.bvecs", "bigann_learn.bvecs",
                 "bigann_query.bvecs"):
        shutil.copy(golden("golden.bvecs"), root / name)
    shutil.copy(golden("golden.ivecs"), root / "gnd" / "idx_1M.ivecs")
    t = td.load_dataset("SIFT1M", data_dir=str(tmp_path))
    j = jd.load_dataset("SIFT1M", data_dir=str(tmp_path))
    for part in ("xb", "xq", "xt", "gt"):
        np.testing.assert_array_equal(getattr(t, part), getattr(j, part))
        assert getattr(t, part).dtype == getattr(j, part).dtype
    assert t.xb.dtype == np.float32 and t.xb.shape == (2, 6)
