"""Time the decode step's attention kernel (``chamjax_torch/csrc/
decode_attend.cu``, ``ops/decode_attend.py::attend``) at the Dec-S step's
shapes: 64 rows, 8 heads of 64, bfloat16, a 512-position cache.

Rows: the self-attention at 128, 256 and 511 held positions with the
current token as one more key (the 0-d ``idx`` of ``decoder_step``), and
the cross-attention over a full 512-position retrieved context (EncDec-S,
no length).  Each row sweeps a (24, 64, 512, 8, 64) history as the step
does, one launch a layer, so every layer's K and V come from device memory
(48 layers' 1.6 GB against the 50 MB L2), and reports the ms a launch of:

- the kernel (``kernel_variants.event_ms`` over the sweep: device time);
- its bound (``bounds.decode_attend_bound``: the held bytes at 3.35 TB/s);
- its plain version (``attend_reference``, the step's arithmetic before
  the kernel: the float32 casts, the einsums and the masked softmax);
- ``torch.nn.functional.scaled_dot_product_attention`` over the held
  positions of a (b, h, T, hd) copy of the history, without the current
  token: the library's yardstick only, which the port never calls.

Before it is timed, each row's kernel output is held against the float64
attention of the same values: at most 1 bfloat16 ulp (``max_ulps``).

    python -m chamjax_torch.benchmarks.decode_attend_timing [--out FILE]

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

from chamjax_torch.benchmarks.bounds import decode_attend_bound
from chamjax_torch.benchmarks.kernel_variants import event_ms
from chamjax_torch.ops import decode_attend as da
from chamjax_torch.utils import cuda_lib
from chamjax_torch.utils.device import card_description

LAYERS, B, T, HEADS, HEAD_DIM = 24, 64, 512, 8, 64
ROWS = ((128, True), (256, True), (511, True), (None, False))


def max_ulps(got, q, k, v, n: Optional[int], self_kv) -> float:
    """The largest distance of ``got`` from the float64 attention of the
    same values, in bfloat16 ulps at the exact value (2^-6 below it)."""
    hd = q.shape[-1]
    held = k.shape[1] if n is None else n
    kk, vv = k[:, :held].double(), v[:, :held].double()
    if self_kv is not None:
        kk = torch.cat([kk, self_kv[0].double()], dim=1)
        vv = torch.cat([vv, self_kv[1].double()], dim=1)
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q.double(), kk)
                      * hd ** -0.5, dim=-1)
    truth = torch.einsum("bhqk,bkhd->bqhd", p, vv)
    ulp = torch.exp2(torch.floor(torch.log2(
        truth.abs().clamp_min(2.0 ** -6))) - 7)
    return float(((got.double() - truth).abs() / ulp).max())


def run(dev, layers: int = LAYERS) -> List[Dict]:
    """The rows, each held against float64 before it is timed; raises where
    the kernel is off by more than 1 ulp."""
    g = torch.Generator(device=dev).manual_seed(0)
    shape = (layers, B, T, HEADS, HEAD_DIM)
    k, v = (torch.randn(shape, generator=g, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    q, kh, vh = (torch.randn((B, 1, HEADS, HEAD_DIM), generator=g,
                             device=dev, dtype=torch.bfloat16)
                 for _ in range(3))
    # the library's layout: heads before positions, each layer contiguous
    ks, vs = (t.transpose(2, 3).contiguous() for t in (k, v))
    qs = q.transpose(1, 2)
    rows = []
    for n, own in ROWS:
        length = (None if n is None
                  else torch.tensor(n, dtype=torch.int32, device=dev))
        skv = (kh, vh) if own else None
        held = T if n is None else n

        def sweep(fn):
            return lambda: [fn(l) for l in range(layers)]

        kernel = sweep(lambda l: da.attend(q, k[l], v[l], length, skv))
        plain = sweep(lambda l: da.attend_reference(q, k[l], v[l], length,
                                                    skv))
        library = sweep(lambda l: F.scaled_dot_product_attention(
            qs, ks[l][:, :, :held], vs[l][:, :, :held]))
        ulps = max_ulps(da.attend(q, k[0], v[0], length, skv), q, k[0],
                        v[0], n, skv)
        if ulps > 1.0:
            raise AssertionError(f"decode_attend held {held}: {ulps:.2f} "
                                 f"ulps from float64")
        bound_ms, bound_by = decode_attend_bound(B, held, HEADS, HEAD_DIM, 2,
                                                 own)
        before = cuda_lib.launch_counts["decode_attend"]
        ms = event_ms(kernel, launches=5, reps=9) / layers
        launches = cuda_lib.launch_counts["decode_attend"] - before
        rows.append(dict(
            attention="self" if own else "cross", held=held, b=B,
            heads=HEADS, head_dim=HEAD_DIM, dtype="bfloat16", max_ulps=ulps,
            ms=ms, bound_ms=bound_ms, bound_by=bound_by,
            roofline_pct=100 * bound_ms / ms,
            plain_ms=event_ms(plain, launches=2, reps=3) / layers,
            library_ms=event_ms(library, launches=5, reps=9) / layers,
            library="torch.nn.functional.scaled_dot_product_attention "
                    "(held positions, no current token)",
            launches=launches))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_attend_timing: needs an NVIDIA card", file=sys.stderr)
        return 1
    for name, text in cuda_lib.build(("decode_attend",)).items():
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
