"""Time the block's junction kernels (``chamjax_torch/csrc/block_norm.cu``,
``ops/block_norm.py::add_ln`` and ``bias_gelu``) at the shapes of the Dec-S
and EncDec-S paths, bfloat16:

- ``add_ln`` with ``delta`` (the junction after an attention) at 64 x 512
  (a decode step's rows) and 32,768 x 512 (the refill's encoder: 64 rows
  of 512 tokens);
- ``bias_gelu`` at 64 x 2048 and 32,768 x 2048 (the FFN's hidden rows).

Each row reports the ms a launch of:

- the kernel (``kernel_variants.event_ms``: device time, launches back to
  back);
- its bound (``bounds.add_ln_bound`` / ``bias_gelu_bound``: the rows read
  and written once at 3.35 TB/s);
- its plain version (``add_ln_reference`` / ``bias_gelu_reference``: the
  chain of PyTorch kernels the path ran before);
- for ``add_ln``, ``x + delta`` then ``torch.nn.functional.layer_norm``:
  the library's yardstick only (it rounds once where the chain rounds
  three times), which the port never calls.

Before it is timed, each row's kernel output is held against its plain
version: ``x_new`` and the GELU bit for bit, ``y`` within one bf16 ulp of
the chain (``y_off_bar``), and the share of ``y``'s values that differ from
the chain (the order of the float32 sums) reported.

    python -m chamjax_torch.benchmarks.block_norm_timing [--out FILE]

Needs the card and the CUDA toolkit; prints one JSON line a row and the
card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List

import torch
import torch.nn.functional as F

from chamjax_torch.benchmarks.bounds import add_ln_bound, bias_gelu_bound
from chamjax_torch.benchmarks.kernel_variants import event_ms
from chamjax_torch.ops import block_norm as bn
from chamjax_torch.utils import cuda_lib
from chamjax_torch.utils.device import card_description

D, FFN = 512, 2048
ROWS = (64, 32768)
# below a normalised value of 2^-16 the float32 statistics' last bits show
STATS_FLOOR = 2.0 ** -16


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |v| (float32 values)."""
    return torch.exp2(torch.floor(torch.log2(v.abs().clamp_min(
        torch.finfo(torch.bfloat16).tiny))) - 7)


def normalised(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """The plain chain's normalised rows of ``x`` (bf16), rounded."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def y_off_bar(y: torch.Tensor, want_x: torch.Tensor, scale: torch.Tensor,
              want_y: torch.Tensor) -> int:
    """How many of ``add_ln``'s ``y`` values lie further from the plain
    chain's ``want_y`` (over rows ``want_x``) than one bf16 ulp of the
    chain's normalised value carried through its scale (plus the
    statistics' floor), one of the scaled value and one of ``y``: the only
    difference allowed is the order of the float32 sums."""
    n = normalised(want_x).float()
    ns = (n.to(torch.bfloat16) * scale).float()
    y, w = y.float(), want_y.float()
    tol = (scale.float().abs() * (bf16_ulp(n) + STATS_FLOOR) + bf16_ulp(ns)
           + bf16_ulp(torch.maximum(y.abs(), w.abs())))
    return int(((y - w).abs() > tol).sum())


def _row(kernel, plain, library, name, rows, width, bound):
    before = cuda_lib.launch_counts[name]
    launches = 50 if rows <= 64 else 10
    ms = event_ms(kernel, launches=launches, reps=9)
    out = dict(kernel=name, rows=rows, width=width, dtype="bfloat16", ms=ms,
               bound_ms=bound[0], bound_by=bound[1],
               roofline_pct=100 * bound[0] / ms,
               plain_ms=event_ms(plain, launches=launches, reps=5),
               launches=cuda_lib.launch_counts[name] - before)
    if library is not None:
        out.update(library_ms=event_ms(library, launches=launches, reps=9),
                   library="x + delta, then torch.nn.functional.layer_norm")
    return out


def run(dev) -> List[Dict]:
    """The rows, each held against its plain version before it is timed;
    raises where ``x_new`` or the GELU is not bit-equal."""
    g = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape, s=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * s).to(
            torch.bfloat16)

    out = []
    for rows in ROWS:
        x, delta = draw(rows, D, s=3.0), draw(rows, D)
        scale, shift = draw(D), draw(D)
        got = bn.add_ln(x, delta, None, scale, shift)
        want = bn.add_ln_reference(x, delta, None, scale, shift)
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"add_ln {rows} x {D}: x_new differs")
        off = y_off_bar(got[1], want[0], scale, want[1])
        if off:
            raise AssertionError(f"add_ln {rows} x {D}: {off} values of y "
                                 f"past one ulp of the chain")
        differ = float((got[1] != want[1]).float().mean())
        row = _row(lambda: bn.add_ln(x, delta, None, scale, shift),
                   lambda: bn.add_ln_reference(x, delta, None, scale, shift),
                   lambda: F.layer_norm(x + delta, (D,), scale, shift),
                   "add_ln", rows, D, add_ln_bound(rows, D, True, False))
        out.append(dict(row, y_values_differing=differ))
    for rows in ROWS:
        h, b = draw(rows, FFN, s=3.0), draw(FFN)
        if not torch.equal(bn.bias_gelu(h, b), bn.bias_gelu_reference(h, b)):
            raise AssertionError(f"bias_gelu {rows} x {FFN}: differs")
        out.append(_row(lambda: bn.bias_gelu(h, b),
                        lambda: bn.bias_gelu_reference(h, b), None,
                        "bias_gelu", rows, FFN, bias_gelu_bound(rows, FFN)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("block_norm_timing: needs an NVIDIA card", file=sys.stderr)
        return 1
    for name, text in cuda_lib.build(("block_norm",)).items():
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
