"""Finding a cell's parts by name.

``BENCHMARK.json`` at the checkout's root lists the cells.  Everything
that belongs to one configuration, traffic mix, per-layer metric or cell
sits in a file of its own under this folder and is found by its name:

- ``configs/<config>.json``: the model and index settings;
- ``traffic/<traffic>.json``: the traffic mix, read by the runner of its
  ``kind``, ``Run`` in ``<kind>.py``;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``;
- ``limits/<workload>.json``: the limits of the numbers ``check.py``
  compares.

Adding a configuration, a mix, a metric or a cell is adding files and
entries; no file here changes.  Nothing in this module imports torch.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Registry:
    """The benchmark file and the part files under ``base``."""

    def __init__(self, bench_file: Path = ROOT / "BENCHMARK.json",
                 base: Path = HERE):
        self.bench_file = Path(bench_file)
        self.base = Path(base)
        self.bench = json.loads(self.bench_file.read_text())

    def _json(self, folder: str, name: str) -> Dict[str, Any]:
        path = self.base / folder / f"{name}.json"
        if not path.is_file():
            raise FileNotFoundError(f"no {folder[:-1]} named {name!r} "
                                    f"({path})")
        return json.loads(path.read_text())

    def workload(self, name: str) -> Dict[str, Any]:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload named {name!r} in {self.bench_file}")

    def config(self, name: str) -> Dict[str, Any]:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict[str, Any]:
        return self._json("traffic", name)

    def limits(self, workload: str) -> Dict[str, float]:
        return self._json("limits", workload)

    def end_to_end(self, workload: str) -> List[Dict[str, Any]]:
        """The cell's end-to-end metrics: those with no ``workloads`` key
        and those that list it."""
        return [m for m in self.bench["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict[str, Any]]:
        return [m for m in self.bench["per_layer"]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str) -> Callable[[Any], Optional[float]]:
        """``metrics/<metric>.py``'s ``read``; the file name keeps the
        metric's dots, so it is loaded by path."""
        path = self.base / "metrics" / f"{metric}.py"
        if not path.is_file():
            raise FileNotFoundError(f"no reader for metric {metric!r} "
                                    f"({path})")
        mod_name = "portbench_metric_" + "".join(
            c if c.isalnum() else "_" for c in metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
