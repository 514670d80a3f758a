"""The yardstick's arithmetic: the operations and bytes a cell's work needs,
counted from its shapes and data, and the card's published peaks.

Counts follow the workload, not any kernel's inputs: each weight, each
cached K/V position held and each cross K/V entry is read once a step,
each new K/V column written once; a search reads the codes of the lists it
probes once (their union over the batch) and its tables once.  Operations
are split by the precision the configuration computes them in (matmuls
with weights in bfloat16; attention scores, the coarse and LUT GEMMs and
the ADC sums in float32, TF32 off).  The least time of some work is the
larger of its operations over the peak of their precision and its bytes
over the memory bandwidth.  Nothing here imports torch.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES_S = 3.35e12

Work = Tuple[Counter, float]      # (operations by precision, bytes)

BF16, F32 = 2, 4                  # bytes an element


def least_s(ops: Counter, nbytes: float) -> float:
    """The least time for ``ops`` and ``nbytes`` at the published peaks."""
    t_ops = sum(n / PEAK_FLOPS[p] for p, n in ops.items())
    return max(t_ops, nbytes / PEAK_BYTES_S)


def _layer_weights(d: int, f: int) -> int:
    """Elements of one self-attention + FFN layer: wqkv, wo, w1, w2, the
    two norms' scales and biases, b1 and b2."""
    return 3 * d * d + d * d + 2 * d * f + 4 * d + f + d


def decoder_step(m: Dict, b: int, held: int, cross_len: int = 0) -> Work:
    """One decode step of ``b`` rows at ``held`` cached positions (the
    positions < idx), with cross-attention over ``cross_len`` positions
    when > 0: every layer, the output head, the K/V column written."""
    d, f, L, V = (m["embed_dim"], m["ffn_embed_dim"], m["layers"],
                  m["vocab_size"])
    ops = Counter()
    ops["bf16"] += 2 * b * L * (4 * d * d + 2 * d * f) + 2 * b * d * V
    keys = held + 1                                  # the cache and itself
    ops["f32"] += 2 * b * L * d * keys               # scores
    ops["bf16"] += 2 * b * L * d * keys              # probabilities · V
    w = L * _layer_weights(d, f) + d * V + 2 * d     # layers, head, ln_f
    nbytes = (w + 2 * b * d) * BF16                  # + embedding, position
    nbytes += 2 * L * b * held * d * BF16            # K and V read
    nbytes += 2 * L * b * d * BF16                   # the new column
    nbytes += b * V * BF16                           # logits
    if cross_len:
        ops["bf16"] += 2 * b * L * 2 * d * d         # wq, wo
        ops["f32"] += 2 * b * L * d * cross_len
        ops["bf16"] += 2 * b * L * d * cross_len
        nbytes += L * (2 * d * d + 2 * d) * BF16     # wq, wo, its norm
        nbytes += 2 * L * b * cross_len * d * BF16   # cross K and V read
    return ops, nbytes


def encoder(m: Dict, b: int, s: int) -> Work:
    """A bidirectional encoder pass over ``b`` × ``s`` tokens."""
    d, f, L = m["embed_dim"], m["ffn_embed_dim"], m["encoder_layers"]
    ops = Counter()
    ops["bf16"] += 2 * b * s * L * (4 * d * d + 2 * d * f)
    ops["f32"] += 2 * b * L * s * s * d
    ops["bf16"] += 2 * b * L * s * s * d
    nbytes = (L * _layer_weights(d, f) + 2 * d) * BF16
    nbytes += (b * s * d + s * d) * BF16             # embeddings, positions
    return ops, nbytes


def cross_refill(m: Dict, b: int, s: int) -> Work:
    """An encoder-decoder retrieval step's model work: the query encoder
    over the current token, the encoder over the ``s`` retrieved tokens
    and every layer's cross K/V over its output, written once."""
    d, L = m["embed_dim"], m["layers"]
    q_ops, q_bytes = encoder(m, b, 1)
    e_ops, e_bytes = encoder(m, b, s)
    ops = q_ops + e_ops
    ops["bf16"] += 2 * b * s * L * d * 2 * d
    nbytes = q_bytes + e_bytes + L * 2 * d * d * BF16
    nbytes += 2 * L * b * s * d * BF16
    return ops, nbytes


def search_batch(ix: Dict, b: int, rows_probed: int, union_rows: int,
                 k: int) -> Work:
    """An IVF-PQ search of ``b`` queries: the coarse GEMM against every
    centroid, the residual LUTs of each query's probes, one add a
    sub-quantizer for each of the ``rows_probed`` rows its probes hold;
    the codes of the ``union_rows`` rows of the lists probed, the
    centroids, the codebooks, the queries and the results."""
    d, nlist, m, nprobe = ix["dim"], ix["nlist"], ix["m"], ix["nprobe"]
    ksub = 1 << ix["nbits"]
    ops = Counter()
    ops["f32"] += 2 * b * d * nlist                  # coarse
    ops["f32"] += 2 * b * nprobe * ksub * d          # LUTs
    ops["f32"] += rows_probed * m                    # ADC sums
    nbytes = union_rows * m                          # 8-bit codes
    nbytes += (nlist * d + ksub * d + b * d) * F32
    nbytes += b * k * (F32 + 4)                      # distances, ids
    return ops, nbytes


def scan(ix: Dict, b: int, rows_probed: int, union_rows: int,
         lut_bytes: int) -> Work:
    """The ADC scan of a search: one add a sub-quantizer for each probed
    row; the probed lists' codes once and each query's tables for its
    probes at ``lut_bytes`` an entry."""
    m, nprobe = ix["m"], ix["nprobe"]
    ksub = 1 << ix["nbits"]
    ops = Counter({"f32": rows_probed * m})
    nbytes = union_rows * m + b * nprobe * m * ksub * lut_bytes
    return ops, nbytes
