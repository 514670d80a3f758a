"""Index, search and model configuration: the port's copy of the
dataclasses of ``chamjax/config.py`` that the IVF-PQ query path and the
RALM serving path read, and of ``MODEL_PRESETS``.

Field names and defaults are identical to the JAX package's, so an index's
saved ``cfg`` (the ``repr`` of ``dataclasses.asdict``) loads in either
package.  The mesh, service and YAML parts wait for the slices that need
them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class IndexConfig:
    """Static shape/config of an IVF-PQ index (Faiss keys such as
    ``"OPQ16,IVF4096,PQ16"``)."""

    dim: int = 128           # D  — vector dimensionality
    nlist: int = 1024        # number of IVF cells
    m: int = 16              # M  — PQ sub-quantizers
    nbits: int = 8           # bits per PQ code (256-entry LUTs when 8)
    opq: bool = False        # learned orthogonal rotation before PQ
    by_residual: bool = True # PQ encodes residual to coarse centroid
    # Packed-layout padding: each inverted list padded to a multiple of this
    # many rows.
    list_pad: int = 128
    # Capacity-balanced assignment: cap each list at
    # ceil(ntotal/nlist * balance_factor); boundary points displace to their
    # next-nearest cell with room.  balance_hard makes the cap exact via a
    # widening candidate retry (see index/kmeans.py::assign_balanced).
    balanced: bool = False
    balance_factor: float = 1.3
    balance_hard: bool = False
    # Balanced-Lloyd knobs of the device-side build
    # (index/device_build.py): training iterations, the split deadband, and
    # the corpus parts rebalanced under the remaining capacity (0 = auto).
    balance_train_iters: int = 12
    balance_deadband: float = 1.25
    balance_parts: int = 0
    # Inverted multi-index: nlist = 4^imi.  0 = plain IVF (index/imi.py,
    # built through index/factory.py).
    imi: int = 0

    @property
    def ksub(self) -> int:
        return 1 << self.nbits

    @property
    def dsub(self) -> int:
        assert self.dim % self.m == 0, (self.dim, self.m)
        return self.dim // self.m

    @property
    def key(self) -> str:
        """Faiss-style index key string."""
        prefix = f"OPQ{self.m}," if self.opq else ""
        coarse = f"IMI2x{self.imi}" if self.imi else f"IVF{self.nlist}"
        return f"{prefix}{coarse},PQ{self.m}"


@dataclass(frozen=True)
class SearchConfig:
    """Per-searcher static parameters."""

    nprobe: int = 32
    k: int = 100
    batch_size: int = 32
    # Static scan length per probed list for the "xla" backend (rows);
    # IVFSearcher sizes it with ``PackedIVF.suggest_scan_len``.
    scan_len: int = 4096
    # Probes processed per step of the "xla" backend's scan loop.
    probe_chunk: int = 8
    # Approximate selection in the JAX package; the port always selects
    # exactly (torch.topk), so these two are accepted and do not lower
    # recall.
    use_approx_topk: bool = True
    approx_recall_target: float = 0.9
    # Distance compute dtype ("float32" | "bfloat16").
    dtype: str = "float32"
    # Scan backend: "seg" (segmented window scan, a CUDA kernel), "pallas"
    # (padded-window scan of scan_len rows per probe, a CUDA kernel) or
    # "xla" (plain torch gather scan).
    backend: str = "seg"
    # DMA chunk of the JAX package's "pallas" kernel; 0 = auto.  Carried,
    # not needed by the CUDA kernel.
    tile: int = 0
    # Segmented backend: static per-query window budget (0 = auto-sized from
    # the index's list-length distribution, IVFSearcher._auto_windows).
    scan_windows: int = 0
    # Segmented backend: rows per window (0 = cost-model auto,
    # ``searcher.auto_seg``; a 128-multiple ≤ ops.scan_seg.MAX_SEG).
    seg: int = 0
    # Windows per group of the window permutation (slot-major order).
    seg_group: int = 8
    # Packed-bf16 ADC LUTs: entries rounded to bf16, sums in fp32.
    lut_bf16: bool = True
    # Approximate probe selection in the JAX package; exact in the port.
    coarse_approx: bool = False
    # Two-stage coarse scan shortlist width (-1 = auto at nlist ≥ 32768 and
    # nprobe ≥ 8, 0 = off, >0 = explicit width).
    coarse_cand: int = -1
    # Hierarchical selection width in the JAX package; selection is exact
    # in the port, so it does not change results.
    select_l1: int = 0
    # Per-(window, lane) min reduction inside the ADC kernel (seg backend,
    # seg_group > 1): selection sees W·128 candidates instead of W·seg.
    lane_l1: bool = False
    # Seg backend: codes seg-tiled ((n_tiles, m, seg), every list on a tile
    # boundary) as a second device copy; False scans the flat layout alone
    # (less device memory).  The host-streamed tier reads it too.
    tiled: bool = True


@dataclass(frozen=True)
class ModelConfig:
    """Transformer shape, mirroring ``experiments/config/{Dec-S,...}.yaml``."""

    model_type: str = "decoder"      # "decoder" | "encoder-decoder" | "llama"
    embed_dim: int = 512
    ffn_embed_dim: int = 2048
    layers: int = 24
    attention_heads: int = 8
    encoder_layers: int = 2          # enc-dec only
    vocab_size: int = 50000
    max_seq_len: int = 512
    dtype: str = "bfloat16"
    # llama family only (RMSNorm + rotary + SwiGLU, optional GQA)
    kv_heads: int = 0                # 0 → = attention_heads (MHA)
    rope_theta: float = 10000.0
    # retrieval plumbing
    retrieval_interval: int = 1
    retrieval_token_len: int = 64    # enc-dec: tokens per retrieved doc
    k: int = 10                      # neighbours per retrieval


# Model presets matching the reference experiment shapes
# (``experiments/config/{Dec-S,Dec-L,EncDec-S,EncDec-L}.yaml``) and the
# llama family at the same scales, plus the canonical 7B shape.
MODEL_PRESETS: Dict[str, ModelConfig] = {
    "Dec-S": ModelConfig(model_type="decoder", embed_dim=512,
                         ffn_embed_dim=2048, layers=24, attention_heads=8),
    "Dec-L": ModelConfig(model_type="decoder", embed_dim=1024,
                         ffn_embed_dim=4096, layers=96, attention_heads=16),
    "EncDec-S": ModelConfig(model_type="encoder-decoder", embed_dim=512,
                            ffn_embed_dim=2048, layers=24, attention_heads=8,
                            encoder_layers=2, retrieval_interval=8, k=10),
    "EncDec-L": ModelConfig(model_type="encoder-decoder", embed_dim=1024,
                            ffn_embed_dim=4096, layers=96, attention_heads=16,
                            encoder_layers=2, retrieval_interval=8, k=10),
    "Llama-S": ModelConfig(model_type="llama", embed_dim=512,
                           ffn_embed_dim=1408, layers=24, attention_heads=8,
                           kv_heads=4),
    "Llama-L": ModelConfig(model_type="llama", embed_dim=1024,
                           ffn_embed_dim=2816, layers=96, attention_heads=16,
                           kv_heads=4),
    "Llama-7B": ModelConfig(model_type="llama", embed_dim=4096,
                            ffn_embed_dim=11008, layers=32,
                            attention_heads=32, kv_heads=32,
                            vocab_size=32000, max_seq_len=512),
}
