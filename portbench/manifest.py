"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration (its ``file``), its traffic mix (``portbench/traffic/
<traffic>.json``), its correctness limits (``portbench/limits/
<workload>.json``) and each per-layer metric's reader (``portbench/metrics/
<name>.py``).  A new cell, mix or metric is a new file and a new entry."""
from __future__ import annotations

import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


class Manifest:
    def __init__(self, root: str, data: Dict[str, Any]):
        self.root = root
        self.data = data

    @classmethod
    def load(cls, root: str) -> "Manifest":
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            return cls(root, json.load(f))

    def _read(self, path: str) -> Dict[str, Any]:
        with open(os.path.join(self.root, path)) as f:
            return json.load(f)

    def cell(self, workload: str) -> Dict[str, Any]:
        for w in self.data["workloads"]:
            if w["name"] == workload:
                return w
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; it has "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> Dict[str, Any]:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return self._read(entry["file"])

    def traffic(self, name: str) -> Dict[str, Any]:
        return self._read(os.path.join("portbench", "traffic", f"{name}.json"))

    def limits(self, workload: str) -> Dict[str, Any]:
        return self._read(os.path.join("portbench", "limits", f"{workload}.json"))

    def metrics_for(self, workload: str, kind: str) -> List[Dict[str, Any]]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.data[kind]
                if "workloads" not in m or workload in m["workloads"]]


def reader(name: str, metrics_dir: str = os.path.join(HERE, "metrics")
           ) -> Callable[[Dict[str, Any]], Optional[float]]:
    """The ``read(record) -> value or None`` function of a per-layer metric."""
    path = os.path.join(metrics_dir, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
