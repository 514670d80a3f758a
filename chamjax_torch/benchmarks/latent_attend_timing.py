"""Time the latent attention kernel (``chamjax_torch/csrc/
latent_attend.cu``, ``ops/latent_attend.py::attend``) at the
Moonlight-16B-A3B step's shapes: 64 rows, 16 heads, 576-wide latents
(512 of them the values), bfloat16, a 7680-position cache.

Rows: 128, 2048, 7168 and 7679 held positions with the current token as
one more (the 0-d ``idx`` of ``mla_moe_step``).  Each row sweeps a (4,
64, 7680, 576) cache, one launch a layer as the step makes them (a layer
is 566 MB, so every launch reads its latents from device memory, not the
50 MB L2), and reports the ms a launch of:

- the kernel (``kernel_variants.event_ms`` over the sweep: device time);
- its bound (``bounds.latent_attend_bound``: the held bytes at 3.35 TB/s);
- its plain version (``attend_reference``: the float32 scores, softmax
  and p·V over every position, masked);
- ``torch.nn.functional.scaled_dot_product_attention`` over the held
  positions, the 16 heads as 16 queries of one head (the latents as K,
  their first 512 values as V), without the current token: the library's
  yardstick only, which the port never calls.

Before it is timed, each row's kernel output is held against the float64
attention of the same values: off by at most 2^-7 of the largest value
(the kernel rounds the probabilities to bfloat16, 2^-9 of each, for its
tensor-core p·V, and the output to bfloat16).

With ``--kimi``, the same rows at the Kimi-Linear-48B-A3B step's shapes:
32 heads (two 16-row tiles of the MMA in a CTA of 8 warps) over a
16,896-position cache, 128, 8192, 16,384 and 16,895 held.

    python -m chamjax_torch.benchmarks.latent_attend_timing [--kimi] [--out FILE]

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

from chamjax_torch.benchmarks.bounds import latent_attend_bound
from chamjax_torch.benchmarks.kernel_variants import event_ms
from chamjax_torch.ops import latent_attend as la
from chamjax_torch.utils import cuda_lib
from chamjax_torch.utils.device import card_description

LAYERS, B, T, HEADS = 4, 64, 7680, 16
LATENT, V_DIM = la.LATENT, la.V_DIM
SCALE = 192 ** -0.5
HELD = (128, 2048, 7168, 7679)
KIMI = dict(heads=32, cache=16896, held=(128, 8192, 16384, 16895))


def rel_err(got, q, lat, held: int, own) -> float:
    """The largest distance of ``got`` from the float64 attention of the
    same values, over the largest value attended."""
    kk = torch.cat([lat[:, :held], own[:, None]], dim=1).double()
    p = torch.softmax(torch.einsum("bhd,btd->bht", q.double(), kk) * SCALE,
                      dim=-1)
    truth = torch.einsum("bht,btc->bhc", p, kk[..., :V_DIM])
    return float((got.double() - truth).abs().max()
                 / kk[..., :V_DIM].abs().max())


def run(dev, layers: int = LAYERS, heads: int = HEADS, cache: int = T,
        held_rows=HELD) -> List[Dict]:
    """The rows, each held against float64 before it is timed; raises where
    the kernel is off by more than 2^-7 of the largest value."""
    g = torch.Generator(device=dev).manual_seed(0)
    lat = torch.randn((layers, B, cache, LATENT), generator=g, device=dev,
                      dtype=torch.bfloat16)
    q = torch.randn((B, heads, LATENT), generator=g, device=dev,
                    dtype=torch.bfloat16) * 3
    own = torch.randn((B, LATENT), generator=g, device=dev,
                      dtype=torch.bfloat16)
    rows = []
    for held in held_rows:
        idx = torch.tensor(held, dtype=torch.int32, device=dev)

        def sweep(fn):
            return lambda: [fn(l) for l in range(layers)]

        kernel = sweep(lambda l: la.attend(q, lat[l], idx, own, SCALE))
        plain = sweep(lambda l: la.attend_reference(q, lat[l], idx, own,
                                                    SCALE))
        library = sweep(lambda l: F.scaled_dot_product_attention(
            q[:, None], lat[l][:, None, :held],
            lat[l][:, None, :held, :V_DIM], scale=SCALE))
        err = rel_err(la.attend(q, lat[0], idx, own, SCALE), q, lat[0],
                      held, own)
        if err > 2.0 ** -7:
            raise AssertionError(f"latent_attend held {held}: {err:.2e} "
                                 f"of the largest value from float64")
        bound_ms, bound_by = latent_attend_bound(B, held, heads, LATENT,
                                                 V_DIM, 2, True)
        before = cuda_lib.launch_counts["latent_attend"]
        ms = event_ms(kernel, launches=3, reps=5) / layers
        launches = cuda_lib.launch_counts["latent_attend"] - before
        rows.append(dict(
            held=held, b=B, heads=heads, latent=LATENT, v_dim=V_DIM,
            dtype="bfloat16", chunks=la.cluster_size(B, dev.index, heads),
            rel_err=err, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
            roofline_pct=100 * bound_ms / ms,
            plain_ms=event_ms(plain, launches=1, reps=3) / layers,
            library_ms=event_ms(library, launches=3, reps=5) / layers,
            library=f"torch.nn.functional.scaled_dot_product_attention "
                    f"({heads} queries of one head, held positions, no "
                    f"current token)",
            launches=launches))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kimi", action="store_true",
                    help="Kimi-Linear-48B-A3B's shapes (32 heads, 16,896 "
                         "positions)")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("latent_attend_timing: needs an NVIDIA card", file=sys.stderr)
        return 1
    for name, text in cuda_lib.build(("latent_attend",)).items():
        print(f"nvcc {name}: {text.strip()}", flush=True)
    shapes = ({"heads": KIMI["heads"], "cache": KIMI["cache"],
               "held_rows": KIMI["held"]} if args.kimi else {})
    lines = [json.dumps(r) for r in run(torch.device("cuda", 0), **shapes)]
    lines.append(json.dumps(dict(card=card_description())))
    print("\n".join(lines), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
