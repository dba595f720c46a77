"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name:

- the configuration: the ``file`` of its ``configs`` entry;
- the traffic mix: ``xv2bench/traffic/<traffic>.json``;
- the limits of its correctness check: ``xv2bench/limits/<workload>.json``;
- its per-layer metrics: ``xv2bench/metrics/<metric>.py`` for each metric of
  ``per_layer`` that lists the cell (or lists no cells).

A later change adds a cell by adding these files and entries; it edits none
that is there.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Callable, Dict, List

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, dict]
    end_to_end: List[dict]
    per_layer: List[dict]
    root: str = ROOT

    @property
    def kind(self) -> str:
        return self.traffic["kind"]


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, root: str = ROOT) -> Cell:
    bench = _load_json(os.path.join(root, "BENCHMARK.json"))
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _load_json(os.path.join(root, conf["file"]))
    here = os.path.join(root, "xv2bench")
    traffic = _load_json(os.path.join(here, "traffic", f"{entry['traffic']}.json"))
    limits = _load_json(os.path.join(here, "limits", f"{workload}.json"))
    for key, want in traffic.get("requires", {}).items():
        if config["program"].get(key) != want:
            raise ValueError(f"traffic {entry['traffic']!r} needs {key}={want!r}, "
                             f"configuration {entry['config']!r} has "
                             f"{config['program'].get(key)!r}")
    return Cell(workload, entry["chips"], config, traffic, limits["limits"],
                [m for m in bench["end_to_end"] if _listed(m, workload)],
                [m for m in bench["per_layer"] if _listed(m, workload)], root)


def reader(metric: str, root: str = ROOT) -> Callable:
    """The ``read`` function of ``xv2bench/metrics/<metric>.py``."""
    path = os.path.join(root, "xv2bench", "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "xv2bench_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
