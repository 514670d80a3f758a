"""Product quantization: codebook training, encode/decode, OPQ rotation
(the port of ``chamjax/index/pq.py``).

All M sub-quantizers train at once: one batched fp32 matmul per Lloyd
iteration over the ``(M, n, dsub)`` subspace view.  The subsample and the
initial codewords are drawn with numpy's generator exactly as the JAX
package draws them.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from chamjax_torch.utils.device import as_f32, resolve_device
from chamjax_torch.utils.precision import fp32_matmul


def _sub_scores(xs: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """xs (M, n, dsub), cent (M, ksub, dsub) → (M, n, ksub) ``2x·c - ||c||²``."""
    cn = torch.sum(cent * cent, dim=2)
    return 2.0 * torch.bmm(xs, cent.transpose(1, 2)) - cn[:, None, :]


def _to_subspaces(x: torch.Tensor, m: int) -> torch.Tensor:
    """(n, d) → (M, n, dsub)."""
    n, d = x.shape
    return x.reshape(n, m, d // m).permute(1, 0, 2).contiguous()


def _pq_lloyd_sums(xs: torch.Tensor, cent: torch.Tensor, ksub: int,
                   chunk: int = 1 << 16):
    """One Lloyd assignment + accumulation for all M subspaces at once →
    ``(sums (M, ksub, dsub), counts (M, ksub))``."""
    m, n, dsub = xs.shape
    sums = torch.zeros((m * ksub, dsub), dtype=torch.float32,
                       device=xs.device)
    counts = torch.zeros((m * ksub,), dtype=torch.float32, device=xs.device)
    base = (torch.arange(m, device=xs.device) * ksub)[:, None]
    for i in range(0, n, chunk):
        xc = xs[:, i:i + chunk]
        a = torch.argmax(_sub_scores(xc, cent), dim=2) + base   # (M, c)
        sums.index_add_(0, a.reshape(-1), xc.reshape(-1, dsub))
        counts.index_add_(0, a.reshape(-1),
                          torch.ones(a.numel(), device=xs.device))
    return sums.reshape(m, ksub, dsub), counts.reshape(m, ksub)


@fp32_matmul()
def train_pq(
    x,
    m: int,
    nbits: int = 8,
    iters: int = 20,
    seed: int = 0,
    max_train: int = 1 << 18,
    device=None,
) -> np.ndarray:
    """Train PQ codebooks. Returns ``(m, 2**nbits, d//m) float32`` numpy."""
    dev = resolve_device(device)
    ksub = 1 << nbits
    n, d = x.shape
    assert d % m == 0
    rng = np.random.default_rng(seed)
    if n > max_train:
        sel = np.sort(rng.choice(n, size=max_train, replace=False))
        x = x[torch.from_numpy(sel).to(x.device)] if isinstance(
            x, torch.Tensor) else x[sel]
        n = max_train
    xs = _to_subspaces(as_f32(x, dev), m)            # (M, n, dsub)
    idx = rng.choice(n, size=min(ksub, n), replace=False)
    cent = xs[:, torch.from_numpy(np.sort(idx)).to(dev), :].cpu().numpy()
    if cent.shape[1] < ksub:
        pad = rng.standard_normal(
            (m, ksub - cent.shape[1], d // m)).astype(np.float32)
        cent = np.concatenate([cent, pad], axis=1)
    cent_dev = torch.from_numpy(np.ascontiguousarray(cent)).to(dev)
    for _ in range(iters):
        sums, counts = _pq_lloyd_sums(xs, cent_dev, ksub)
        counts_np = counts.cpu().numpy()
        new_cent = sums.cpu().numpy() / np.maximum(counts_np, 1.0)[..., None]
        # re-seed empty codewords per subspace from the heaviest codeword
        for mm in range(m):
            empty = np.where(counts_np[mm] == 0)[0]
            if empty.size:
                heavy = np.argsort(-counts_np[mm])[:empty.size]
                jit = rng.standard_normal(
                    (empty.size, d // m)).astype(np.float32)
                new_cent[mm, empty] = new_cent[mm, heavy] + jit * 1e-3
        cent_dev = torch.from_numpy(new_cent.astype(np.float32)).to(dev)
    return cent_dev.cpu().numpy()


def pq_encode_tensor(x: torch.Tensor, codebooks: torch.Tensor,
                     chunk: int = 1 << 16) -> torch.Tensor:
    """Device-side encode: (n, d) f32 tensor → (n, m) uint8 tensor on the
    same device.  Runs inside the caller's ``fp32_matmul``."""
    m = codebooks.shape[0]
    out = torch.empty((x.shape[0], m), dtype=torch.uint8, device=x.device)
    for i in range(0, x.shape[0], chunk):
        xs = _to_subspaces(x[i:i + chunk], m)
        out[i:i + xs.shape[1]] = torch.argmax(
            _sub_scores(xs, codebooks), dim=2).T.to(torch.uint8)
    return out


@fp32_matmul()
def pq_encode(x, codebooks, chunk: int = 1 << 18, device=None) -> np.ndarray:
    """Encode rows of ``x`` → ``(n, m) uint8`` numpy codes (chunked)."""
    dev = resolve_device(device)
    cb = as_f32(codebooks, dev)
    m = codebooks.shape[0]
    out = np.empty((x.shape[0], m), np.uint8)
    for i in range(0, x.shape[0], chunk):
        xi = as_f32(x[i:i + chunk], dev)
        out[i:i + xi.shape[0]] = pq_encode_tensor(xi, cb).cpu().numpy()
    return out


def pq_decode(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """codes (n, m) uint8 → reconstructed (n, d) float32."""
    m, ksub, dsub = codebooks.shape
    picked = codebooks[np.arange(m)[None, :], codes.astype(np.int64)]
    return picked.reshape(codes.shape[0], m * dsub)


def _eig_alloc_init(x: np.ndarray, m: int) -> np.ndarray:
    """Eigenvalue-allocation OPQ init: PCA-rotate, then greedily deal
    eigen-directions (descending eigenvalue) to the subspace with the
    smallest eigenvalue *product*, so each of the M codebooks faces equal
    variance."""
    d = x.shape[1]
    dsub = d // m
    cov = np.cov(x.astype(np.float64), rowvar=False)
    w, v = np.linalg.eigh(cov)                    # ascending
    w, v = w[::-1], v[:, ::-1]                    # descending
    logs = np.log(np.maximum(w, 1e-12))
    buckets = [[] for _ in range(m)]
    sums = np.zeros(m)
    for j in range(d):
        for b in np.argsort(sums):
            if len(buckets[b]) < dsub:
                buckets[b].append(j)
                sums[b] += logs[j]
                break
    perm = [j for b in buckets for j in b]
    return np.ascontiguousarray(v[:, perm], np.float32)


def train_opq(
    x: np.ndarray,
    m: int,
    nbits: int = 8,
    outer_iters: int = 8,
    pq_iters: int = 8,
    seed: int = 0,
    max_train: int = 1 << 17,
    init: str = "eig",
    device=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """OPQ: alternate PQ training with an orthogonal-Procrustes rotation
    update.  ``init``: ``"eig"`` (eigenvalue allocation) or ``"random"``.

    The rotation algebra (``x @ R``, the SVD) runs in numpy on the host, as
    in the JAX package; PQ training and encoding run on ``device``.

    Returns ``(R (d, d) float32, codebooks (m, 2**nbits, d//m))``; apply as
    ``x @ R`` before encoding/search.
    """
    rng = np.random.default_rng(seed)
    n, d = x.shape
    if n > max_train:
        x = x[np.sort(rng.choice(n, size=max_train, replace=False))]
    x = np.ascontiguousarray(x, np.float32)
    if init == "eig":
        R = _eig_alloc_init(x, m)
    else:
        A = rng.standard_normal((d, d)).astype(np.float32)
        Q, _ = np.linalg.qr(A)
        R = Q.astype(np.float32)
    for _ in range(outer_iters):
        xr = x @ R
        codebooks = train_pq(xr, m, nbits=nbits, iters=pq_iters, seed=seed,
                             device=device)
        xhat = pq_decode(pq_encode(xr, codebooks, device=device), codebooks)
        # Procrustes: argmin_R ||x R - xhat||_F, R orthogonal.
        u, _, vt = np.linalg.svd(x.T @ xhat)
        R = (u @ vt).astype(np.float32)
    # final codebooks consistent with final R
    codebooks = train_pq(x @ R, m, nbits=nbits, iters=pq_iters, seed=seed,
                         device=device)
    return R, codebooks
