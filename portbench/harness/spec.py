"""A cell, found by its name in ``BENCHMARK.json``: its configuration
file, its traffic file (``portbench/traffic/<traffic>.json``), its
metrics and the reader of each per-layer metric
(``portbench/metrics/<name>.py``, which declares its name, unit, layer,
the metric it moves and its source).  A later cell, mix or metric is a
new file and a new entry; nothing here names one."""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"


class Cell:
    def __init__(self, name, root=ROOT):
        spec = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.spec = spec
        self.entry = cells[name]
        self.name = name
        self.chips = self.entry["chips"]
        configs = {c["name"]: c for c in spec["configs"]}
        self.config = json.loads(
            (root / configs[self.entry["config"]]["file"]).read_text())
        self.traffic = json.loads(
            (root / "portbench" / "traffic"
             / f"{self.entry['traffic']}.json").read_text())
        self.end_to_end = [m for m in spec["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._has(m)]
        self.readers = {m["name"]: load_reader(m, root)
                        for m in self.per_layer}

    def _has(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]


def load_reader(metric, root=ROOT):
    path = root / "portbench" / "metrics" / f"{metric['name']}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric["name"].replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for key, attr in (("name", "NAME"), ("unit", "UNIT"), ("layer", "LAYER"),
                      ("moves", "MOVES"), ("source", "SOURCE")):
        if getattr(module, attr) != metric[key]:
            raise ValueError(f"{path.name}: {attr} {getattr(module, attr)!r}"
                             f" differs from BENCHMARK.json's {metric[key]!r}")
    return module
