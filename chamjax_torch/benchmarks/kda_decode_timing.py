"""Time the KDA decode kernel (``chamjax_torch/csrc/kda_decode.cu``,
``ops/kda_decode.py::step``) at the Kimi-Linear-48B-A3B step's shapes: 64
rows, 32 heads, a 128 x 128 float32 state a row and head.

The kernel sweeps the 20 KDA layers' states (20, 64, 32, 128, 128), one
launch a layer as the step makes them (a layer's state is 134 MB, so every
launch reads it from device memory, not the 50 MB L2), and the line
reports the ms a launch of:

- the kernel (``kernel_variants.event_ms`` over the sweep: device time);
- its bound (``bounds.kda_decode_bound``: the state read and written once
  at 3.35 TB/s, with q, k, v, alpha, beta and o);
- its plain version (``step_reference``: the decay, the two einsums and
  the update as separate passes over the state);
- the yardstick: one in-place multiply of the state by a scalar
  (``torch.Tensor.mul_``), the library's rate for the same bytes read and
  written, which the port never calls.

Before it is timed, the kernel's first 16 steps on layer 0 are held
against the recurrence in float64: the state within 1e-5 of its largest
entry, o within 2^-8 of its largest (bfloat16).

    python -m chamjax_torch.benchmarks.kda_decode_timing [--out FILE]

Needs the card and the CUDA toolkit; prints one JSON line and the card.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict

import torch

from chamjax_torch.benchmarks.bounds import kda_decode_bound
from chamjax_torch.benchmarks.kernel_variants import event_ms
from chamjax_torch.ops import kda_decode as kd
from chamjax_torch.utils import cuda_lib
from chamjax_torch.utils.device import card_description

LAYERS, B, HEADS, K = 20, 64, 32, kd.HEAD_DIM


def _inputs(g, dev):
    q = torch.nn.functional.normalize(
        torch.randn(B, HEADS, K, generator=g, device=dev), dim=-1) * K ** -0.5
    k = torch.nn.functional.normalize(
        torch.randn(B, HEADS, K, generator=g, device=dev), dim=-1)
    v = torch.randn(B, HEADS, K, generator=g, device=dev)
    alpha = torch.exp(-0.05 * torch.rand(B, HEADS, K, generator=g,
                                         device=dev))
    beta = torch.rand(B, HEADS, generator=g, device=dev)
    return q, k, v, alpha, beta


def accuracy(dev, steps: int = 16) -> Dict[str, float]:
    """The kernel's state and o over ``steps`` steps against float64, each
    over its largest magnitude; raises past 1e-5 and 2^-8."""
    g = torch.Generator(device=dev).manual_seed(1)
    state = torch.randn(B, HEADS, K, K, generator=g, device=dev)
    S = state.double()
    o_err = 0.0
    for _ in range(steps):
        q, k, v, alpha, beta = _inputs(g, dev)
        o = kd.step(state, q, k, v, alpha, beta).double()
        S = S * alpha.double()[..., None]
        u = beta.double()[..., None] * (v.double() - torch.einsum(
            "bhk,bhkv->bhv", k.double(), S))
        S = S + k.double()[..., None] * u[..., None, :]
        want = torch.einsum("bhk,bhkv->bhv", q.double(), S)
        o_err = max(o_err, float((o - want).abs().max() / want.abs().max()))
    s_err = float((state.double() - S).abs().max() / S.abs().max())
    if s_err > 1e-5 or o_err > 2.0 ** -8:
        raise AssertionError(f"kda_decode: state {s_err:.2e}, o {o_err:.2e} "
                             f"of the largest from float64")
    return {"state_rel_err": s_err, "o_rel_err": o_err}


def run(dev, layers: int = LAYERS) -> Dict:
    """The kernel's row, held against float64 before it is timed."""
    errs = accuracy(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    states = torch.randn(layers, B, HEADS, K, K, generator=g, device=dev)
    q, k, v, alpha, beta = _inputs(g, dev)

    def sweep(fn):
        return lambda: [fn(l) for l in range(layers)]

    kernel = sweep(lambda l: kd.step(states[l], q, k, v, alpha, beta))
    plain = sweep(lambda l: kd.step_reference(states[l], q, k, v, alpha,
                                              beta, torch.bfloat16))
    library = sweep(lambda l: states[l].mul_(1.0))
    bound_ms, bound_by = kda_decode_bound(B * HEADS, K)
    before = cuda_lib.launch_counts["kda_decode"]
    ms = event_ms(kernel, launches=3, reps=5) / layers
    launches = cuda_lib.launch_counts["kda_decode"] - before
    library_ms = event_ms(library, launches=3, reps=5) / layers
    return dict(
        b=B, heads=HEADS, head_dim=K, state="float32", **errs, ms=ms,
        bound_ms=bound_ms, bound_by=bound_by,
        roofline_pct=100 * bound_ms / ms,
        plain_ms=event_ms(plain, launches=1, reps=3) / layers,
        library_ms=library_ms,
        library="torch.Tensor.mul_ in place over the state (the same "
                "bytes read and written)",
        library_roofline_pct=100 * bound_ms / library_ms, launches=launches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kda_decode_timing: needs an NVIDIA card", file=sys.stderr)
        return 1
    for name, text in cuda_lib.build(("kda_decode",)).items():
        print(f"nvcc {name}: {text.strip()}", flush=True)
    lines = [json.dumps(run(torch.device("cuda", 0))),
             json.dumps(dict(card=card_description()))]
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
