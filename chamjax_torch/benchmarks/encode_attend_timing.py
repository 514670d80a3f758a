"""Time the encoder's attention kernel (``chamjax_torch/csrc/
encode_attend.cu``, ``ops/encode_attend.py::attend``) at EncDec-S's
shapes: 64 rows, 8 heads of 64, bfloat16, q, k and v the strided views of
one fused (64, s, 1536) QKV product.

Rows: the refill's encoder over 512 retrieved tokens a row (no length, as
the refill calls it), the same with a length a row spread from 0 to 512
(a key-padded batch), and the retrieval step's query encoder (s = 1).
Each row sweeps the two encoder layers' QKV products, one launch a layer,
so that each layer's inputs come from device memory (2 x 100 MB against
the 50 MB L2), and reports the ms a launch of:

- the kernel (``kernel_variants.event_ms`` over the sweep: device time);
- its bound (``bounds.encode_attend_bound``: q, the held keys' K and V
  and the output at 3.35 TB/s, against the scores' and p·V's flops at the
  bf16 tensor-core rate);
- its plain version (``attend_reference``, the encoder's arithmetic
  before the kernel: the float32 casts, the einsums, the (b, h, s, s)
  float32 scores, the masked softmax);
- ``torch.nn.functional.scaled_dot_product_attention`` over (b, h, s, hd)
  copies of the same values (a boolean mask where rows have lengths): the
  library's yardstick only, which the port never calls.

Before it is timed, each row's kernel output is held against the float64
attention of the same values: no farther than twice the plain version's
largest distance plus one bfloat16 ulp (``max_ulps``).

    python -m chamjax_torch.benchmarks.encode_attend_timing [--out FILE]

Needs the card and the CUDA toolkit; prints one JSON line a row and the
card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from chamjax_torch.benchmarks.bounds import encode_attend_bound
from chamjax_torch.benchmarks.kernel_variants import event_ms
from chamjax_torch.ops import encode_attend as ea
from chamjax_torch.utils import cuda_lib
from chamjax_torch.utils.device import card_description

LAYERS, B, HEADS, HEAD_DIM = 2, 64, 8, 64
ROWS = (("refill", 512, False), ("refill ragged", 512, True),
        ("query", 1, False))


def max_ulps(x, q, k, v, valid_len: Optional[torch.Tensor]) -> float:
    """The largest distance of ``x`` from the float64 attention of the
    same values, in bfloat16 ulps at the exact value (2^-6 below it), over
    the rows that hold a key."""
    hd, tk = q.shape[-1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.double(), k.double()) * hd ** -0.5
    if valid_len is not None:
        past = torch.arange(tk, device=q.device) >= valid_len.reshape(-1, 1)
        s = s.masked_fill(past[:, None, None, :], float("-inf"))
    truth = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1),
                         v.double())
    held = ~truth.isnan()
    ulp = torch.exp2(torch.floor(torch.log2(
        truth[held].abs().clamp_min(2.0 ** -6))) - 7)
    return float(((x[held].double() - truth[held]).abs() / ulp).max())


def run(dev, layers: int = LAYERS) -> List[Dict]:
    """The rows, each held against float64 before it is timed; raises where
    the kernel is farther from it than twice the plain version plus one
    ulp."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for name, s, ragged in ROWS:
        qkv = [torch.randn((B, s, 3 * HEADS * HEAD_DIM), generator=g,
                           device=dev, dtype=torch.bfloat16)
               for _ in range(layers)]
        views = [tuple(t.reshape(B, s, HEADS, HEAD_DIM)
                       for t in x.chunk(3, dim=-1)) for x in qkv]
        vl = None
        if ragged:
            vl = (torch.arange(B, device=dev) * s // (B - 1)).to(torch.int32)
            vl = vl[torch.randperm(B, generator=g, device=dev)]
        held = s if vl is None else float(vl.float().mean())
        # the library's layout: heads before positions, contiguous
        lib_in = [tuple(t.transpose(1, 2).contiguous() for t in w)
                  for w in views]
        mask = (None if vl is None else
                (torch.arange(s, device=dev) < vl[:, None])[:, None, None])

        def sweep(fn):
            return lambda: [fn(*w) for w in views]

        kernel = sweep(lambda q, k, v: ea.attend(q, k, v, vl))
        plain = sweep(lambda q, k, v: ea.attend_reference(q, k, v, vl))

        def library():
            return [F.scaled_dot_product_attention(*w, attn_mask=mask)
                    for w in lib_in]

        q, k, v = views[0]
        ulps = max_ulps(ea.attend(q, k, v, vl), q, k, v, vl)
        plain_ulps = max_ulps(ea.attend_reference(q, k, v, vl), q, k, v, vl)
        if ulps > 2 * plain_ulps + 1:
            raise AssertionError(f"encode_attend {name}: {ulps:.2f} ulps "
                                 f"from float64, plain {plain_ulps:.2f}")
        bound_ms, bound_by = encode_attend_bound(B, s, held, HEADS, HEAD_DIM,
                                                 2)
        before = cuda_lib.launch_counts["encode_attend"]
        ms = event_ms(kernel, launches=5, reps=9) / layers
        launches = cuda_lib.launch_counts["encode_attend"] - before
        rows.append(dict(
            attention=name, s=s, held_mean=held, b=B, heads=HEADS,
            head_dim=HEAD_DIM, dtype="bfloat16", max_ulps=ulps,
            plain_max_ulps=plain_ulps, ms=ms, bound_ms=bound_ms,
            bound_by=bound_by, roofline_pct=100 * bound_ms / ms,
            plain_ms=event_ms(plain, launches=2, reps=3) / layers,
            library_ms=event_ms(library, launches=5, reps=9) / layers,
            library="torch.nn.functional.scaled_dot_product_attention "
                    "((b, h, s, hd) copies; a boolean mask where rows have "
                    "lengths)",
            launches=launches))
        del qkv, views, lib_in
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("encode_attend_timing: needs an NVIDIA card", file=sys.stderr)
        return 1
    for name, text in cuda_lib.build(("encode_attend",)).items():
        print(f"nvcc {name}: {text.strip()}", flush=True)
    lines = [json.dumps(r) for r in run(torch.device("cuda", 0))]
    lines.append(json.dumps(dict(card=card_description())))
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
