"""Energy accounting for benchmark runs (the port of
``chamjax/utils/energy.py``).

- **Host CPU**: Linux powercap/RAPL sysfs counters sampled around a
  workload (``RaplMeter``, copied from the JAX package unchanged).
- **Card**: ``card_energy_estimate`` and ``card_efficiency`` apply the
  JAX package's methodology for its accelerator, constant board power ×
  a duty cycle, with the card's own power limit as ``nvidia-smi`` reads it
  (``utils/device.py::card_power_limit``), or the ``watts`` the caller
  gives.  No wattage is assumed: without ``watts`` a missing or failing
  ``nvidia-smi`` raises.

Usage:
    with RaplMeter() as m: run()
    joules = m.joules
    est = card_energy_estimate(seconds=run_s, duty=0.8)
"""

from __future__ import annotations

import glob
import os
import time
from typing import Dict, Optional, Tuple

from chamjax_torch.utils.device import card_power_limit


class RaplMeter:
    """Reads intel-rapl energy_uj counters around a with-block."""

    SYS = "/sys/class/powercap"

    def __init__(self) -> None:
        # top-level PACKAGE domains only (intel-rapl:<n>): subzones like
        # intel-rapl:0:0 (core) / :0:1 (uncore) are subsets of the package
        # counter — glob'ing them too would double-count energy
        self.domains = sorted(
            p for p in glob.glob(
                os.path.join(self.SYS, "intel-rapl:*", "energy_uj"))
            if ":" not in os.path.basename(os.path.dirname(p))
            .split("intel-rapl:", 1)[1])
        self.available = bool(self.domains) and all(
            os.access(p, os.R_OK) for p in self.domains)
        self.joules: Optional[float] = None
        self.seconds: Optional[float] = None

    def _read(self) -> Dict[str, int]:
        out = {}
        for p in self.domains:
            try:
                with open(p) as f:
                    out[p] = int(f.read().strip())
            except OSError:
                pass
        return out

    def __enter__(self) -> "RaplMeter":
        self._t0 = time.perf_counter()
        self._e0 = self._read() if self.available else {}
        return self

    def __exit__(self, *exc) -> bool:
        self.seconds = time.perf_counter() - self._t0
        if self.available:
            e1 = self._read()
            # counters wrap at max_energy_range_uj; ignore wrapped domains
            deltas = [e1[p] - self._e0[p] for p in self._e0
                      if p in e1 and e1[p] >= self._e0[p]]
            self.joules = sum(deltas) / 1e6 if deltas else None
        return False

    @property
    def watts(self) -> Optional[float]:
        if self.joules is None or not self.seconds:
            return None
        return self.joules / self.seconds


def _board(watts: Optional[float]) -> Tuple[Optional[str], float]:
    """``(card, watts)``: ``(None, watts)`` for the caller's ``watts``, else
    the first card's name and power limit from ``nvidia-smi``."""
    if watts is None:
        return card_power_limit()
    return None, float(watts)


def card_energy_estimate(seconds: float, duty: float = 1.0,
                         n_cards: int = 1, watts: Optional[float] = None
                         ) -> Dict:
    """Constant-power energy estimate: a card's board power × ``duty`` ×
    ``seconds`` × ``n_cards``.  ``watts`` is one card's power; without it
    the first card's power limit is read (and ``card`` is its name)."""
    card, w = _board(watts)
    return {
        "card": card, "n_cards": n_cards, "seconds": seconds,
        "assumed_watts": w, "duty": duty,
        "joules": w * duty * seconds * n_cards,
    }


def queries_per_joule(qps: float, watts: float) -> float:
    """The reference's headline efficiency metric (queries/J)."""
    return qps / watts if watts else float("nan")


def card_efficiency(qps: float, n_cards: int = 1, duty: float = 1.0,
                    watts: Optional[float] = None) -> Dict:
    """Card-side efficiency block for benchmark JSON lines: queries/J
    (== QPS/W) and mJ/query at one card's board power (``watts``, else its
    power limit from ``nvidia-smi``) × ``n_cards`` × the measured busy
    fraction ``duty`` — the JAX package's ``tpu_efficiency`` with the
    card's power in place of a published chip TDP."""
    card, w1 = _board(watts)
    w = w1 * n_cards * duty
    return {
        "card": card, "n_cards": n_cards, "assumed_watts": w,
        "qps_per_watt": round(qps / w, 3) if w else None,
        "mj_per_query": round(w / qps * 1e3, 4) if qps else None,
    }
