"""Recall-loss decomposition for IVF-PQ search (the port of
``chamjax/eval/diagnose.py``).

Answers "*why* did recall stop at X?" by classifying every missed
ground-truth neighbour into the stage that lost it:

- ``probe``     — its inverted list was not among the ``nprobe`` probed
  cells (coarse-quantizer loss; more probes would help);
- ``window``    — its list was probed but the static window budget W
  truncated the scan before reaching it (raise ``windows``/headroom);
- ``quant``     — it was scanned, but its ADC distance ranks beyond k
  (PQ reconstruction loss; more PQ bytes / OPQ would help);
- ``select``    — its ADC distance ranks within k yet it was not returned.
  The port's selection is exact, so only ADC ties at the k-th distance
  and the order of a float sum can put an item here.

It runs on the index's device (probe selection, window expansion, the
reach test as one broadcast, the ADC of the ground-truth rows) and pulls
only the (b, at) outcome arrays to the host.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from chamjax_torch.ops.coarse import select_probes
from chamjax_torch.ops.lut import build_luts
from chamjax_torch.ops.scan_seg import expand_windows
from chamjax_torch.searcher import DeviceIVF, _rotate, resolve_coarse_cand


def _adc_of_rows(index: DeviceIVF, q: torch.Tensor, rows: torch.Tensor,
                 lists_of_rows: torch.Tensor, by_residual: bool = True
                 ) -> torch.Tensor:
    """ADC distance of specific packed rows. q (b, d); rows (b, g) int64
    positions into the packed arrays; lists_of_rows (b, g) their cells."""
    codes = index.codes_t[:, rows]                    # (m, b, g)
    luts = build_luts(q, index.centroids, index.codebooks,
                      lists_of_rows, by_residual=by_residual)  # (b,g,256,m)
    g = codes.permute(1, 2, 0).long()                           # (b, g, m)
    lut_bgm = torch.gather(luts, 2, g[:, :, None, :])[:, :, 0, :]
    return torch.sum(lut_bgm, dim=-1)


def recall_diagnosis(
    index: DeviceIVF,
    queries: np.ndarray,          # (b, d)
    gt_ids: np.ndarray,           # (b, kg) int64 ground-truth neighbours
    result_ids: np.ndarray,       # (b, k) returned ids
    result_dists: np.ndarray,     # (b, k) returned ADC distances
    *,
    nprobe: int,
    windows: int,
    seg: int,
    group: int = 1,
    at: int = 10,
    by_residual: bool = True,
    coarse_approx: bool = False,
    coarse_cand: int = 0,
) -> Dict[str, float]:
    """Fractions of gt@``at`` items by outcome:
    ``found`` + ``probe`` + ``window`` + ``quant`` + ``select`` = 1.

    ``coarse_cand`` must mirror the setting the diagnosed search ran with,
    or misses of a shortlist-dropped probe are misclassified.  The port's
    probe selection is exact, so ``coarse_approx`` (kept for the JAX
    package's signature) does not change the probe set."""
    dev = index.centroids.device
    gt = gt_ids[:, :at].astype(np.int64)
    gt_d = torch.from_numpy(np.ascontiguousarray(gt)).to(dev)

    # packed row position + owning list of every ground-truth id
    ids = index.ids.long()
    valid = ids >= 0
    inv = torch.full((int(ids[valid].max()) + 1,), -1, dtype=torch.int64,
                     device=dev)
    inv[ids[valid]] = torch.nonzero(valid)[:, 0]
    rows = inv[gt_d]                                      # (b, at)
    # padding rows belong to the gap after their list; gt rows are real
    list_of = torch.searchsorted(index.list_start.long(), rows,
                                 right=True) - 1

    q = _rotate(index, torch.from_numpy(
        np.ascontiguousarray(queries, np.float32)).to(dev))
    # resolve -1 (auto) the same way every search tier does, so passing
    # the searcher's SearchConfig value verbatim reproduces its probe set
    coarse_cand = resolve_coarse_cand(
        coarse_cand, int(index.centroids.shape[0]), nprobe)
    probe_ids, _ = select_probes(q, index.centroids, nprobe,
                                 coarse_cand=coarse_cand,
                                 use_approx=coarse_approx)
    probed = (probe_ids.long()[:, None, :] == list_of[:, :, None]).any(-1)

    # window reach: mirror expand_windows' probe-major packing exactly —
    # including the group round-up the grouped scans apply
    # (windows = ceil(W/group)*group), or a gt row scanned in the
    # rounded-up tail would be misreported as window loss
    windows = -(-windows // max(group, 1)) * max(group, 1)
    starts_w, lens_w, _, _ = expand_windows(
        probe_ids, index.list_start, index.list_len, windows=windows,
        seg=seg)
    # a gt row is reachable iff some window [start, start+len) contains it
    s = starts_w.long()[:, None, :]
    e = s + lens_w.long()[:, None, :]
    reach = ((rows[:, :, None] >= s) & (rows[:, :, None] < e)).any(-1)

    # ADC distance of gt rows (true quantized rank proxy): compare against
    # the kth returned distance
    adc = _adc_of_rows(index, q, rows, list_of, by_residual=by_residual)
    probed, reach, adc = (t.cpu().numpy() for t in (probed, reach, adc))
    kth = result_dists[:, -1][:, None]

    found = (result_ids[:, :, None] == gt[:, None, :]).any(1)
    miss = ~found
    probe_loss = miss & ~probed
    window_loss = miss & probed & ~reach
    quant_loss = miss & reach & (adc > kth)
    select_loss = miss & reach & (adc <= kth)

    total = float(gt.size)
    return {
        "found": float(found.sum()) / total,
        "probe": float(probe_loss.sum()) / total,
        "window": float(window_loss.sum()) / total,
        "quant": float(quant_loss.sum()) / total,
        "select": float(select_loss.sum()) / total,
    }
