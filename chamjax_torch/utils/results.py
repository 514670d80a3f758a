"""Resumable nested benchmark-result store.

The reference persists every benchmark as a nested pickle dict keyed
``[dbname][index_key][arch][k][nprobe][batch] -> {metric: value}`` and makes
re-runs incremental via ``--load_dict 1 --overwrite 0``
(``Faiss_experiments/bench_cpu_performance_OSDI.py:19-38``,
``experiments/vector_search_FPGA.py:18-25``).  This is the same contract with
a safer on-disk format (JSON sidecar + pickle) and an explicit API.

The port's copy of ``chamjax/utils/results.py``, code unchanged: a store
saved by either package loads in the other.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple


class ResultStore:
    """Nested dict accumulator with load/overwrite semantics.

    Keys are an ordered tuple (e.g. ``(dbname, index_key, arch, k, nprobe,
    batch)``); the leaf is a flat ``{metric: value}`` dict.  ``has()`` lets a
    sweep skip already-measured points unless ``overwrite`` is set.
    """

    def __init__(self, path: Optional[str] = None, load: bool = True,
                 overwrite: bool = False):
        self.path = path
        self.overwrite = overwrite
        self.d: Dict[str, Any] = {}
        if path and load and os.path.exists(path):
            with open(path, "rb") as f:
                self.d = pickle.load(f)

    # -- core nested access ------------------------------------------------

    @staticmethod
    def _norm(key: Sequence[Any]) -> Tuple[str, ...]:
        return tuple(str(k) for k in key)

    def get(self, key: Sequence[Any]) -> Optional[Dict[str, Any]]:
        node = self.d
        for k in self._norm(key):
            if not isinstance(node, dict) or k not in node:
                return None
            node = node[k]
        return node

    def has(self, key: Sequence[Any]) -> bool:
        return self.get(key) is not None

    def should_run(self, key: Sequence[Any]) -> bool:
        return self.overwrite or not self.has(key)

    def put(self, key: Sequence[Any], value: Dict[str, Any]) -> None:
        ks = self._norm(key)
        node = self.d
        for k in ks[:-1]:
            node = node.setdefault(k, {})
        node[ks[-1]] = dict(value)

    def update(self, key: Sequence[Any], **metrics: Any) -> None:
        leaf = self.get(key)
        if leaf is None:
            self.put(key, metrics)
        else:
            leaf.update(metrics)

    # -- iteration / persistence --------------------------------------------

    def walk(self) -> Iterable[Tuple[Tuple[str, ...], Dict[str, Any]]]:
        """Yield (key_tuple, leaf_metrics). A leaf is a dict whose values are
        not all dicts."""
        def rec(node, prefix):
            if isinstance(node, dict) and node and all(
                    isinstance(v, dict) for v in node.values()):
                for k, v in node.items():
                    yield from rec(v, prefix + (k,))
            elif isinstance(node, dict):
                yield prefix, node
        yield from rec(self.d, ())

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        assert path, "no path given"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(self.d, f)
        # human-readable sidecar for quick inspection / diffing
        try:
            with open(path + ".json", "w") as f:
                json.dump(self.d, f, indent=1, default=str, sort_keys=True)
        except TypeError:
            pass
        return path
