"""Analytical performance model for IVF-PQ search and RALM serving on an
NVIDIA card (the port of ``chamjax/perf_model.py``, function for function,
with the same names and arithmetic).

The rooflines are a Hopper card's: HBM bandwidth bounds the PQ-code scan,
the tensor cores (bf16) bound the coarse scan, fp32 outside the tensor
cores bounds LUT construction (TF32 stays off on this path), and NVLink
bounds the all-gather merge of per-shard top-k.

Kernel efficiencies are measured on the card, never carried over from a
TPU: a constant that no measurement has set yet is ``None``, and every
model that needs it raises a ``ValueError`` naming it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class GpuSpec:
    """Per-card hardware parameters (dense rates, no sparsity)."""

    name: str = "H100 SXM"
    hbm_gbps: float = 3350.0       # HBM bandwidth, GB/s
    bf16_tflops: float = 989.0     # tensor cores, bf16
    f32_tflops: float = 67.0       # fp32 outside the tensor cores
    # 32-bit integer add, logic and shift, and the FMA pipe's IMAD: 64
    # lanes an SM a clock each (half the fp32 lanes), 132 SMs at the
    # 1.98 GHz of the fp32 figure
    int32_tops: float = 16.73
    smem_kb: float = 227.0         # shared memory one block can use
    nvlink_gbps: float = 450.0     # NVLink, each way


# NVIDIA's data sheets and the Hopper white paper, at the 700 W limit
H100 = GpuSpec()
H200 = GpuSpec(name="H200 SXM", hbm_gbps=4800.0)


def roofline_ms(nbytes: float, flops: float, spec: GpuSpec = H100,
                tflops: float = 0.0) -> Tuple[float, str]:
    """Least time for a kernel on ``spec``: ``nbytes`` of device memory
    traffic over the HBM rate against ``flops`` over ``tflops`` (default
    the fp32 rate).  Returns ``(ms, "bytes" | "operations")``, whichever
    is larger."""
    t_bytes = nbytes / (spec.hbm_gbps * 1e9) * 1e3
    t_ops = flops / ((tflops or spec.f32_tflops) * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Vector search components
# ---------------------------------------------------------------------------

def scan_bytes_per_query(dbsize: int, nlist: int, nprobe: int, m: int
                         ) -> float:
    """HBM bytes touched per query by the PQ-code scan: nprobe/nlist ·
    dbsize rows (uniform lists) of m code bytes each."""
    rows = dbsize * nprobe / nlist
    return rows * m


def scan_qps_roofline(dbsize: int, nlist: int, nprobe: int, m: int,
                      spec: GpuSpec = H100, efficiency: float = 1.0
                      ) -> float:
    """Bandwidth-bound QPS ceiling for the PQ scan on one card:
    ``QPS = BW / (nprobe/nlist · dbsize · m)``."""
    return efficiency * spec.hbm_gbps * 1e9 / scan_bytes_per_query(
        dbsize, nlist, nprobe, m)


def lut_flops_per_query(nprobe: int, m: int, dsub: int, ksub: int = 256
                        ) -> float:
    """LUT construction FLOPs: nprobe · ksub · m · dsub MACs."""
    return 2.0 * nprobe * ksub * m * dsub


def coarse_flops_per_query(nlist: int, dim: int) -> float:
    """Coarse quantizer scan: one (1 x dim) @ (dim x nlist) matmul."""
    return 2.0 * nlist * dim


# Measured efficiencies on the card, as a share of ``H100.hbm_gbps``.
#   - segmented ADC scan (adc_scan_segments_multi): code GB/s / 3350 GB/s
#     of ``seg_bf16`` / ``seg_f32`` in
#     ``python -m chamjax_torch.benchmarks.kernel_roofline`` at its default
#     shape (16M x m16 slab, bW=4096, group 8, random windows), seg 2048,
#     runlen 0: the median of three runs on an NVIDIA H100 80GB HBM3 at its
#     700 W limit, 35.26% (34.04-35.42) packed and 33.14% (32.29-33.42)
#     f32 (PERF.md, kernel study; each run its own build and machine).
SCAN_EFF_BF16 = 0.3526
SCAN_EFF_F32 = 0.3314
#   - selection over the (b, W·seg) f32 distances, and the coarse probe
#     selection over the (b, nlist) scores by full top-k / two-stage
#     shortlist: ``benchmarks/profiling_stages.implied_efficiencies`` of the
#     stage profile (``profile_stages``, device times by ``event_ms``) over
#     the 1M flagship's index in ``chip_smoke.py``'s stages line (b=128,
#     nlist 4096, nprobe 32, seg 512, W 48) on an NVIDIA H100 80GB HBM3 at
#     700 W: topk 0.1013 ms, coarse 0.0661, coarse2 0.0817 (PERF.md §6).
#     The port's selection is exact ``torch.topk`` at any recall target, so
#     both targets take the one figure.
SELECT_EFF_LOW_RT = 0.0371
SELECT_EFF_HIGH_RT = 0.0371
COARSE_SELECT_EFF_SORT = 0.0095
COARSE_SELECT_EFF_2STAGE = 0.0077


def _measured(name: str) -> float:
    value = globals()[name]
    if value is None:
        raise ValueError(f"chamjax_torch.perf_model.{name} is not measured "
                         f"on the card yet")
    return value


def padded_rows_per_query(dbsize: int, nlist: int, nprobe: int,
                          seg: int = 2048, windows: int = 0,
                          headroom: float = 1.2) -> float:
    """Rows the segmented kernel touches per query, window padding
    included: ``windows x seg`` when the window budget is given, else a
    uniform-list estimate (each probe covers ~avg_len/seg + 0.5 segments,
    x ``headroom``)."""
    if windows:
        return float(windows * seg)
    avg_len = dbsize / nlist
    segs_per_probe = avg_len / seg + 0.5
    return nprobe * max(1.0, segs_per_probe * headroom) * seg


def search_latency_model(dbsize: int, nlist: int, nprobe: int, m: int,
                         dim: int, batch: int, spec: GpuSpec = H100,
                         scan_efficiency: float = 0.0,
                         mxu_efficiency: float = 0.5,
                         lut_bf16: bool = True,
                         recall_target: float = 0.9,
                         seg: int = 2048, windows: int = 0,
                         coarse_2stage: bool = True) -> dict:
    """Per-batch latency decomposition (seconds) of the search: coarse
    matmul + probe selection, LUT construction, the scan over padded rows,
    and selection over the padded distances.  ``scan_efficiency=0`` picks
    the measured value for the LUT mode; raises ``ValueError`` where an
    efficiency it needs is not measured yet."""
    ksub = 256
    dsub = dim // m
    if not scan_efficiency:
        scan_efficiency = _measured("SCAN_EFF_BF16" if lut_bf16
                                    else "SCAN_EFF_F32")
    sel_eff = _measured("SELECT_EFF_LOW_RT" if recall_target <= 0.9
                        else "SELECT_EFF_HIGH_RT")
    rows_pad = padded_rows_per_query(dbsize, nlist, nprobe, seg=seg,
                                     windows=windows)
    t_coarse = batch * coarse_flops_per_query(nlist, dim) / (
        mxu_efficiency * spec.bf16_tflops * 1e12)
    csel_eff = _measured("COARSE_SELECT_EFF_2STAGE" if coarse_2stage
                         else "COARSE_SELECT_EFF_SORT")
    t_coarse += batch * nlist * 4 / (csel_eff * spec.hbm_gbps * 1e9)
    t_lut = batch * lut_flops_per_query(nprobe, m, dsub, ksub) / (
        mxu_efficiency * spec.f32_tflops * 1e12)
    t_scan = batch * rows_pad * m / (
        scan_efficiency * spec.hbm_gbps * 1e9)
    t_select = batch * rows_pad * 4 / (sel_eff * spec.hbm_gbps * 1e9)
    total = t_coarse + t_lut + t_scan + t_select
    return {
        "t_coarse_s": t_coarse, "t_lut_s": t_lut, "t_scan_s": t_scan,
        "t_select_s": t_select,
        "t_total_s": total, "qps": batch / total,
        "scan_fraction": t_scan / total,
    }


def sharded_merge_bytes(k: int, n_shards: int, batch: int,
                        id_bytes: int = 8, dist_bytes: int = 4) -> float:
    """Bytes for all-gathering per-shard top-k before the final merge."""
    return batch * k * n_shards * (id_bytes + dist_bytes)


def merge_all_gather_time(k: int, n_list_shards: int, batch_local: int,
                          spec: GpuSpec = H100, id_bytes: int = 4,
                          dist_bytes: int = 4,
                          ici_efficiency: float = 0.7) -> float:
    """Seconds for the top-k merge all-gather along the ``lists`` axis: on
    a ring every card forwards each of the other ``S-1`` contributions of
    ``b_local · k`` dists + ids once, over NVLink (one direction).
    ``ici_efficiency`` (the JAX package's name) derates the link for
    small messages."""
    payload = batch_local * k * (id_bytes + dist_bytes)
    return payload * (n_list_shards - 1) / (
        ici_efficiency * spec.nvlink_gbps * 1e9)


def mesh_search_model(dbsize: int, nlist: int, nprobe: int, m: int,
                      dim: int, batch: int, n_list_shards: int,
                      dp: int = 1, k: int = 100, spec: GpuSpec = H100,
                      **latency_kw) -> dict:
    """Predicted QPS for a ``(data=dp, lists=S)`` mesh of cards: the
    one-card latency model over ``dbsize/S`` rows and ``batch/dp``
    queries, plus the ``lists``-axis merge."""
    b_local = max(1, batch // max(dp, 1))
    per_chip = search_latency_model(
        max(1, dbsize // n_list_shards), nlist, nprobe, m, dim, b_local,
        spec=spec, **latency_kw)
    t_merge = merge_all_gather_time(k, n_list_shards, b_local, spec=spec)
    total = per_chip["t_total_s"] + t_merge
    return {
        **{f"per_chip_{k_}": v for k_, v in per_chip.items()},
        "t_merge_s": t_merge,
        "merge_fraction": t_merge / total,
        "t_total_s": total,
        "qps": batch / total,
    }


# ---------------------------------------------------------------------------
# RALM serving components
# ---------------------------------------------------------------------------

def decoder_step_flops(embed_dim: int, ffn_dim: int, layers: int,
                       batch: int, kv_len: int) -> float:
    """FLOPs for one incremental decode step: qkv+out projections (4·d²)
    + FFN (2·d·ffn) + attention over the KV cache (2·d·kv_len), x2 for
    MAC→FLOP."""
    per_token = layers * (2.0 * (4 * embed_dim ** 2 + 2 * embed_dim * ffn_dim
                                 + 2 * embed_dim * kv_len))
    return batch * per_token


def decoder_step_latency(embed_dim: int, ffn_dim: int, layers: int,
                         batch: int, kv_len: int, spec: GpuSpec = H100,
                         dtype_bytes: int = 2) -> dict:
    """Incremental decoding streams every weight from HBM each step;
    returns the memory and the compute bound and the larger of the two."""
    weight_bytes = layers * (4 * embed_dim ** 2 + 2 * embed_dim * ffn_dim
                             ) * dtype_bytes
    kv_bytes = 2 * layers * batch * kv_len * embed_dim * dtype_bytes
    t_mem = (weight_bytes + kv_bytes) / (spec.hbm_gbps * 1e9)
    t_flops = decoder_step_flops(embed_dim, ffn_dim, layers, batch, kv_len
                                 ) / (spec.bf16_tflops * 1e12)
    t = max(t_mem, t_flops)
    return {"t_mem_s": t_mem, "t_flops_s": t_flops, "t_step_s": t,
            "tokens_per_sec": batch / t}


def ralm_throughput_model(model: dict, dbsize: int, nlist: int, nprobe: int,
                          m: int, dim: int, batch: int,
                          retrieval_interval: int = 1, tiktok: bool = True,
                          spec: GpuSpec = H100) -> dict:
    """Tokens/sec for the RALM loop: a decode step plus a retrieval every
    ``retrieval_interval`` steps; tik-tok overlaps the two, so the step
    takes max(decode, retrieval/interval) instead of the sum."""
    dec = decoder_step_latency(model["embed_dim"], model["ffn_embed_dim"],
                               model["layers"], batch,
                               kv_len=model.get("max_seq_len", 512) // 2,
                               spec=spec)
    ret = search_latency_model(dbsize, nlist, nprobe, m, dim, batch,
                               spec=spec)
    per_step_ret = ret["t_total_s"] / retrieval_interval
    if tiktok:
        t_step = max(dec["t_step_s"], per_step_ret)
    else:
        t_step = dec["t_step_s"] + per_step_ret
    return {"t_decode_s": dec["t_step_s"], "t_retrieval_s": ret["t_total_s"],
            "t_step_s": t_step, "tokens_per_sec": batch / t_step,
            "overlap_gain": (dec["t_step_s"] + per_step_ret) / t_step}
