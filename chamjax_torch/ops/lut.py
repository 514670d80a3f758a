"""ADC lookup-table construction as one batched fp32 einsum (the port of
``chamjax/ops/lut.py``): per (query, probe) the residual
``r = q - centroid`` and, for every sub-quantizer m and codeword j,
``LUT[j, m] = ||r_m - cb[m, j]||²``."""

from __future__ import annotations

import torch

from chamjax_torch.utils.precision import fp32_matmul


@fp32_matmul()
def build_luts(
    queries: torch.Tensor,      # (b, d) float32
    centroids: torch.Tensor,    # (nlist, d) float32
    codebooks: torch.Tensor,    # (m, ksub, dsub) float32
    list_ids: torch.Tensor,     # (b, nprobe) int32
    by_residual: bool = True,
) -> torch.Tensor:
    """Returns LUTs ``(b, nprobe, ksub, m) float32`` — the JAX package's
    layout (``ops/scan_seg.py::prepare_luts`` turns it into the kernel's)."""
    b, d = queries.shape
    m, ksub, dsub = codebooks.shape
    nprobe = list_ids.shape[1]
    if by_residual:
        r = queries[:, None, :] - centroids[list_ids.long()]   # (b, p, d)
    else:
        r = queries[:, None, :].expand(b, nprobe, d)
    rs = r.reshape(b, nprobe, m, dsub)
    cross = torch.einsum("bpmd,mjd->bpjm", rs, codebooks)
    rn = torch.sum(rs * rs, dim=-1)                              # (b, p, m)
    cbn = torch.sum(codebooks * codebooks, dim=-1)              # (m, ksub)
    return rn[:, :, None, :] - 2.0 * cross + cbn.T[None, None, :, :]
