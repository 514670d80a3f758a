"""Dataset I/O and synthetic corpora: the port's copy of
``chamjax/data/datasets.py``.

- TexMex ``.fvecs`` / ``.bvecs`` / ``.ivecs`` readers (through
  ``chamjax_torch.native.read_vecs``, as in the reference) and writers,
  with memmap variants; big-ANN ``.fbin`` / ``.ibin``, SPACEV ``i8bin`` and
  headerless f32 files;
- ``synthetic_dataset``: pure numpy with the same draws in the same order,
  so both packages build bit-identical corpora from the same arguments;
- ``load_dataset`` (the on-disk bigann layout, else a cached synthetic
  draw) and ``load_real_dataset`` (a directory or a ``base=...`` spec).

- ``synthetic_dataset_device``: the clustered corpus drawn on the device
  from the JAX package's threefry streams (``chamjax_torch.random``), so
  both packages draw the same corpus from the same arguments.
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from chamjax_torch import native
from chamjax_torch import random as jr
from chamjax_torch.utils.device import resolve_device
from chamjax_torch.utils.precision import fp32_matmul


# ---------------------------------------------------------------------------
# TexMex .fvecs / .bvecs / .ivecs: each record = int32 dim header + payload.
# ---------------------------------------------------------------------------


def _read_vecs(path: str, dtype, item_bytes: int) -> np.ndarray:
    # native path (a sequential fread into a contiguous buffer,
    # chamjax_torch/native/src/chamnet.cpp); numpy where it cannot build
    try:
        elem = {np.float32: "f", np.uint8: "b", np.int32: "i"}[dtype]
        return native.read_vecs(path, elem)
    except (native.NativeUnavailable, OSError):
        pass
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size == 0:
        return np.empty((0, 0), dtype=dtype)
    dim = int(np.frombuffer(raw[:4], dtype=np.int32)[0])
    rec = 4 + dim * item_bytes
    assert raw.size % rec == 0, f"{path}: size {raw.size} not multiple of {rec}"
    n = raw.size // rec
    mat = raw.reshape(n, rec)[:, 4:]
    return mat.view(dtype).reshape(n, dim).copy()


def read_fvecs(path: str) -> np.ndarray:
    return _read_vecs(path, np.float32, 4)


def read_ivecs(path: str) -> np.ndarray:
    return _read_vecs(path, np.int32, 4)


def read_bvecs(path: str) -> np.ndarray:
    return _read_vecs(path, np.uint8, 1)


def _mmap_vecs(path: str, dtype, item_bytes: int) -> np.ndarray:
    with open(path, "rb") as f:
        dim = int(np.frombuffer(f.read(4), dtype=np.int32)[0])
    rec = 4 + dim * item_bytes
    size = os.path.getsize(path)
    assert size % rec == 0
    mm = np.memmap(path, dtype=np.uint8, mode="r", shape=(size // rec, rec))
    return mm[:, 4:].view(dtype).reshape(size // rec, dim)


def mmap_fvecs(path: str) -> np.ndarray:
    return _mmap_vecs(path, np.float32, 4)


def mmap_bvecs(path: str) -> np.ndarray:
    return _mmap_vecs(path, np.uint8, 1)


def write_fvecs(path: str, x: np.ndarray) -> None:
    x = np.ascontiguousarray(x, dtype=np.float32)
    n, d = x.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = x.view(np.int32)
    out.tofile(path)


def write_ivecs(path: str, x: np.ndarray) -> None:
    x = np.ascontiguousarray(x, dtype=np.int32)
    n, d = x.shape
    out = np.empty((n, d + 1), dtype=np.int32)
    out[:, 0] = d
    out[:, 1:] = x
    out.tofile(path)


# ---------------------------------------------------------------------------
# big-ANN .fbin / .ibin: int32 n, int32 dim, then row-major payload.
# ---------------------------------------------------------------------------


def read_fbin(path: str, start: int = 0, count: Optional[int] = None) -> np.ndarray:
    with open(path, "rb") as f:
        n, d = (int(v) for v in np.frombuffer(f.read(8), dtype=np.int32))
        # int(d): numpy-2 NEP-50 keeps n*d / start*d*4 as int32 scalars,
        # which silently WRAP past 2^31 (100M x 96 f32 already overflows)
        n = n - start
        if count is not None:
            n = min(n, count)
        f.seek(8 + start * d * 4)
        return np.fromfile(f, dtype=np.float32, count=n * d).reshape(n, d)


def read_ibin(path: str, start: int = 0, count: Optional[int] = None) -> np.ndarray:
    with open(path, "rb") as f:
        n, d = (int(v) for v in np.frombuffer(f.read(8), dtype=np.int32))
        n = n - start
        if count is not None:
            n = min(n, count)
        f.seek(8 + start * d * 4)
        return np.fromfile(f, dtype=np.int32, count=n * d).reshape(n, d)


def write_fbin(path: str, x: np.ndarray) -> None:
    x = np.ascontiguousarray(x, dtype=np.float32)
    with open(path, "wb") as f:
        np.asarray(x.shape, dtype=np.int32).tofile(f)
        x.tofile(f)


def read_spacev_i8bin(path: str, start: int = 0,
                      count: Optional[int] = None) -> np.ndarray:
    """SPACEV1B/SPTAG .bin: [int32 n][int32 d][int8 row-major]
    (reference ``datasets.py`` ``read_spacev_int8bin``)."""
    with open(path, "rb") as f:
        n, d = np.frombuffer(f.read(8), dtype=np.int32)
        n = int(n) - start
        if count is not None:
            n = min(n, count)
        f.seek(8 + start * int(d))
        return np.fromfile(f, dtype=np.int8, count=n * int(d)).reshape(n, d)


def mmap_spacev_i8bin(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        n, d = (int(v) for v in np.frombuffer(f.read(8), dtype=np.int32))
    return np.memmap(path, dtype=np.int8, mode="r", offset=8,
                     shape=(n, d))


def mmap_raw_f32(path: str, dim: int) -> np.ndarray:
    """Headerless row-major float32 (the reference's SBERT d=384 / GNN
    d=256 / Journal d=100 files, ``datasets.py`` ``mmap_bvecs_SBERT``...)."""
    size = os.path.getsize(path)
    rec = dim * 4
    assert size % rec == 0, f"{path}: size {size} not a multiple of {rec}"
    return np.memmap(path, dtype=np.float32, mode="r",
                     shape=(size // rec, dim))


# ---------------------------------------------------------------------------
# Synthetic corpora (deterministic).
# ---------------------------------------------------------------------------


@dataclass
class Dataset:
    name: str
    xb: np.ndarray        # (nb, d) float32 — database vectors
    xq: np.ndarray        # (nq, d) float32 — query vectors
    xt: np.ndarray        # (nt, d) float32 — training vectors
    gt: Optional[np.ndarray] = None   # (nq, k) int — ground-truth neighbour ids

    @property
    def d(self) -> int:
        return self.xb.shape[1]

    @property
    def nb(self) -> int:
        return self.xb.shape[0]


def synthetic_dataset(
    name: str = "SYN",
    nb: int = 100_000,
    nq: int = 1000,
    nt: int = 50_000,
    d: int = 128,
    seed: int = 0,
    n_clusters: int = 0,
    rank: Optional[int] = None,
    spectrum_tau: float = 0.0,
) -> Dataset:
    """Deterministic synthetic dataset.

    ``n_clusters > 0`` draws vectors around cluster centers near a rank-
    ``rank`` (default d//4) manifold, so IVF and PQ recall curves are
    meaningful; ``0`` gives iid normal vectors.  ``spectrum_tau > 0`` makes
    the within-cluster spectrum decay as ``exp(-j / tau)``.
    """
    rng = np.random.default_rng(seed)
    if n_clusters > 0:
        rank = rank or max(4, d // 4)
        centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 4.0
        proj = rng.standard_normal((rank, d)).astype(np.float32) / np.sqrt(rank)
        if spectrum_tau > 0:
            lam = np.exp(-np.arange(rank, dtype=np.float32) / spectrum_tau)
            lam *= np.sqrt(rank / np.sum(lam * lam))
            proj = proj * lam[:, None]

        def draw(n, salt):
            r = np.random.default_rng(seed + salt)
            asg = r.integers(0, n_clusters, size=n)
            z = r.standard_normal((n, rank)).astype(np.float32)
            noise = r.standard_normal((n, d)).astype(np.float32) * 0.05
            return (centers[asg] + z @ proj + noise).astype(np.float32)

        xb, xt, xq = draw(nb, 1), draw(nt, 2), draw(nq, 3)
    else:
        xb = rng.standard_normal((nb, d)).astype(np.float32)
        xt = rng.standard_normal((nt, d)).astype(np.float32)
        xq = rng.standard_normal((nq, d)).astype(np.float32)
    return Dataset(name=name, xb=xb, xq=xq, xt=xt)


def clustered_rows(d: int, n_clusters: int, seed: int, *,
                   rank: Optional[int] = None, spectrum_tau: float = 0.0,
                   device=None):
    """The clustered family of ``synthetic_dataset_device`` on ``device``:
    centres (scale 4) and a rank-``rank`` projection (default ``d // 4``)
    from ``split(key(seed))``, then ``rows(k, n)``, ``n`` rows from key
    ``k`` split three ways (cluster ids, the latent normal, 0.05 noise):
    ``centers[asg] + z @ proj + noise``, the product in float32 with TF32
    off.  ``spectrum_tau > 0`` scales latent component ``j`` by
    ``exp(-j / tau)`` (energy kept).  Returns ``(key, rows)``."""
    dev = resolve_device(device)
    rank = rank or max(4, d // 4)
    key = jr.key(seed)
    k_c, k_p = jr.split(key)
    centers = jr.normal(k_c, (n_clusters, d), scale=4.0, device=dev)
    proj = jr.normal(k_p, (rank, d), device=dev) / float(
        np.float32(np.sqrt(rank)))
    if spectrum_tau > 0:
        lam = torch.exp(-torch.arange(rank, dtype=torch.float32, device=dev)
                        / spectrum_tau)
        lam = lam * torch.sqrt(rank / torch.sum(lam * lam))
        proj = proj * lam[:, None]

    @fp32_matmul()
    def rows(k, n: int) -> torch.Tensor:
        k1, k2, k3 = jr.split(k, 3)
        asg = jr.randint(k1, (n,), 0, n_clusters, device=dev)
        z = jr.normal(k2, (n, rank), device=dev)
        noise = jr.normal(k3, (n, d), scale=0.05, device=dev)
        return centers[asg.long()] + torch.matmul(z, proj) + noise

    return key, rows


def synthetic_dataset_device(
    name: str = "SYN",
    nb: int = 100_000,
    nq: int = 1000,
    nt: int = 50_000,
    d: int = 128,
    seed: int = 0,
    n_clusters: int = 4096,
    rank: Optional[int] = None,
    chunk: int = 1 << 20,
    parts: Tuple[str, ...] = ("xb", "xt", "xq"),
    to_host: bool = True,
    spectrum_tau: float = 0.0,
    device=None,
) -> Dataset:
    """Clustered synthetic corpus drawn on ``device`` (the card unless
    given ``"cpu"``): the JAX package's ``synthetic_dataset_device``, draw
    for draw (:func:`clustered_rows`).  Each split is drawn in
    ``chunk``-row chunks, chunk ``i`` from ``fold_in(fold_in(key, salt),
    i)``, salt 1 (``xb``), 2 (``xt``) or 3 (``xq``), so each split is drawn
    alone (``parts``; the others are ``None``).  ``to_host=False`` leaves
    the splits on the device."""
    key, rows = clustered_rows(d, n_clusters, seed, rank=rank,
                               spectrum_tau=spectrum_tau, device=device)

    def draw(n: int, salt: int):
        base = jr.fold_in(key, salt)
        chunks = [rows(jr.fold_in(base, i), min(chunk, n - i))
                  for i in range(0, n, chunk)]
        out = chunks[0] if len(chunks) == 1 else torch.cat(chunks)
        return out.cpu().numpy() if to_host else out

    xb = draw(nb, 1) if "xb" in parts else None
    xt = draw(nt, 2) if "xt" in parts else None
    xq = draw(nq, 3) if "xq" in parts else None
    return Dataset(name=name, xb=xb, xq=xq, xt=xt)


_KNOWN = {
    # name: (d, default nb) — loaders for on-disk TexMex/bigann layouts.
    "SIFT1M": (128, 1_000_000),
    # synthetic stand-ins (no real TexMex data in this environment): same
    # dims/sizes as their SIFT namesakes so cached index artifacts under
    # data/indexes/SYN* reproduce bit-identically (draws depend only on
    # nb/d/seed/n_clusters, not the name)
    "SYN1M": (128, 1_000_000),
    "SYN10M": (128, 10_000_000),
    "SIFT10M": (128, 10_000_000),
    "SIFT100M": (128, 100_000_000),
    "Deep1M": (96, 1_000_000),
    "Deep10M": (96, 10_000_000),
    "RALM-S": (512, None),
    "RALM-L": (1024, None),
}


def load_dataset(dbname: str, data_dir: str = "data", **syn_kwargs) -> Dataset:
    """Load a named dataset from ``data_dir`` if present, else synthesize.

    On-disk layout follows the reference conventions
    (``Faiss_experiments/datasets.py``): ``bigann/`` holds
    ``bigann_{base,learn}.bvecs`` + ``bigann_query.bvecs`` + ``gnd/idx_*M.ivecs``;
    ``deep1b/`` holds ``{base,learn,query}.fvecs``.  If files are missing the
    dataset is synthesized deterministically at the right dim (clustered),
    sized by the dbname's scale suffix — capped for tractability.
    """
    if dbname.startswith("SIFT") and os.path.isdir(os.path.join(data_dir, "bigann")):
        nM = int(dbname[4:].rstrip("M"))
        root = os.path.join(data_dir, "bigann")
        xb = mmap_bvecs(os.path.join(root, "bigann_base.bvecs"))[: nM * 10**6]
        xt = mmap_bvecs(os.path.join(root, "bigann_learn.bvecs"))
        xq = read_bvecs(os.path.join(root, "bigann_query.bvecs"))
        gt_path = os.path.join(root, "gnd", f"idx_{nM}M.ivecs")
        gt = read_ivecs(gt_path) if os.path.exists(gt_path) else None
        return Dataset(dbname, np.asarray(xb, np.float32), xq.astype(np.float32),
                       np.asarray(xt[:10**6], np.float32), gt)
    if dbname in _KNOWN:
        d, nb = _KNOWN[dbname]
        if "d" in syn_kwargs and syn_kwargs["d"] != d:
            raise ValueError(
                f"load_dataset: {dbname!r} has fixed dim {d}; a d="
                f"{syn_kwargs['d']} override would silently not apply")
        syn_kwargs.pop("d", None)
    else:
        d, nb = syn_kwargs.pop("d", 128), None
    nb = min(nb or 100_000, syn_kwargs.pop("max_nb", 1_000_000))
    kw = dict(nb=nb, d=d, n_clusters=256)
    kw.update(syn_kwargs)
    # disk cache: the deterministic synthesis is minutes of host RNG at
    # 1M+ rows; the draw is keyed by its parameters, not the name
    ckey = "_".join(f"{k}{kw[k]}" for k in sorted(kw))
    cpath = os.path.join(data_dir, "syn_cache", f"{ckey}.npz")
    if os.path.exists(cpath):
        z = np.load(cpath)        # uncompressed zip: ~seconds at 1M rows
        return Dataset(name=dbname, xb=z["xb"], xq=z["xq"], xt=z["xt"])
    ds = synthetic_dataset(name=dbname, **kw)
    try:
        os.makedirs(os.path.dirname(cpath), exist_ok=True)
        np.savez(cpath, xb=ds.xb, xq=ds.xq, xt=ds.xt)
    except OSError:
        pass                      # read-only or full disk: stay in-memory
    return ds


# ---------------------------------------------------------------------------
# Real-dataset resolution: one spec string →
# Dataset, covering the TexMex (`*.bvecs`/`*.fvecs` + gnd `*.ivecs`) and
# big-ANN (`*.fbin`/`*.ibin`) conventions of the reference
# (`Faiss_experiments/datasets.py:13-199`).
# ---------------------------------------------------------------------------


def _load_vec_file(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".bvecs":
        return mmap_bvecs(path)
    if ext == ".fvecs":
        return mmap_fvecs(path)
    if ext == ".fbin":
        return read_fbin(path)
    if ext == ".i8bin":
        return mmap_spacev_i8bin(path)
    raise ValueError(f"unsupported vector file extension: {path}")


def _load_gt_file(path: str) -> np.ndarray:
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ivecs":
        return read_ivecs(path)
    if ext == ".ibin":
        return read_ibin(path)
    raise ValueError(f"unsupported ground-truth file extension: {path}")


def load_real_dataset(spec: str, max_nb: Optional[int] = None,
                      max_nq: Optional[int] = None,
                      name: str = "real",
                      max_materialize_bytes: int = 16 << 30) -> Dataset:
    """Resolve a dataset spec to on-disk files.

    ``spec`` is either

    - a **directory** laid out in the reference's conventions: files whose
      names contain ``base`` / ``query`` / ``learn`` (TexMex ``bigann_*``,
      deep1b, big-ANN), plus a ground-truth ``.ivecs``/``.ibin`` whose name
      contains ``gnd``/``groundtruth``/``gt``/``idx``; or
    - an explicit ``base=PATH[,query=PATH][,learn=PATH][,gt=PATH]`` list.

    Missing ``learn`` falls back to a base prefix; missing ``query`` raises
    (a benchmark without queries is meaningless); missing ``gt`` returns
    ``gt=None`` (callers compute exact GT).  Vectors load lazily via mmap
    where the format allows; the base is converted to a contiguous float32
    array only when that expansion fits ``max_materialize_bytes`` (default
    16 GiB) — above it ``xb`` stays the on-disk-dtype mmap view (e.g.
    uint8 for bvecs) and callers must slice/stream it themselves
    (``build_ivfpq_device``'s draw function, ``index/ondisk.py``), or pass
    ``max_nb`` to bound the load.  A file-supplied ground truth is dropped
    (``gt=None`` → callers recompute exact GT) whenever ``max_nb``
    truncates the base, since the file's neighbor ids reference rows that
    no longer exist in the truncated corpus."""
    import glob as _glob

    paths = {}
    if "=" in spec:
        for part in spec.split(","):
            k, _, v = part.partition("=")
            paths[k.strip()] = v.strip()
    else:
        if not os.path.isdir(spec):
            raise FileNotFoundError(f"dataset spec is not a directory: {spec}")
        cand = sorted(
            _glob.glob(os.path.join(spec, "**", "*"), recursive=True))
        for p in cand:
            low = os.path.basename(p).lower()
            ext = os.path.splitext(low)[1]
            if ext in (".bvecs", ".fvecs", ".fbin", ".i8bin"):
                for role in ("base", "query", "learn"):
                    if role in low and role not in paths:
                        paths[role] = p
            elif ext in (".ivecs", ".ibin"):
                if any(t in low or t in p.lower()
                       for t in ("gnd", "groundtruth", "gt", "idx")):
                    paths.setdefault("gt", p)
    if "base" not in paths:
        raise FileNotFoundError(f"no base vectors found in spec {spec!r}")
    if "query" not in paths:
        raise FileNotFoundError(f"no query vectors found in spec {spec!r}")

    xb = _load_vec_file(paths["base"])
    full_rows = xb.shape[0]
    if max_nb:
        xb = xb[:max_nb]
    xq = _load_vec_file(paths["query"])
    if max_nq:
        xq = xq[:max_nq]
    if "learn" in paths:
        xt = _load_vec_file(paths["learn"])
    else:
        xt = xb[: max(1, min(len(xb), 100_000))]
    gt = _load_gt_file(paths["gt"]) if "gt" in paths else None
    if gt is not None and max_nb and max_nb < full_rows:
        # the file's neighbor ids may point past the truncated corpus —
        # recomputed exact GT is the only honest recall anchor here
        warnings.warn(
            f"max_nb={max_nb} truncates the base ({full_rows} rows); "
            "dropping the file ground truth (callers recompute exact GT)",
            stacklevel=2)
        gt = None
    f32_bytes = int(xb.shape[0]) * int(xb.shape[1]) * 4
    if f32_bytes <= max_materialize_bytes:
        xb = np.ascontiguousarray(xb, np.float32)
    elif xb.dtype != np.float32:
        # keep the mmap view — a 1B bvecs base would expand 128 GB u8 →
        # 512 GB f32 and OOM the host; stream/slice (and cast per chunk)
        # at use sites instead.  Warn loudly: a consumer that feeds
        # ``ds.xb`` whole into k-means/distance math would propagate
        # integer codes or OOM on the implicit cast.
        warnings.warn(
            f"base stays an on-disk {xb.dtype} mmap "
            f"({f32_bytes / 2**30:.1f} GiB f32 > max_materialize_bytes); "
            "cast per chunk at use sites — do not pass ds.xb whole into "
            "f32 math", stacklevel=2)
    xq = np.ascontiguousarray(xq, np.float32)
    xt = np.ascontiguousarray(xt, np.float32)
    return Dataset(name=name, xb=xb, xq=xq, xt=xt, gt=gt)
