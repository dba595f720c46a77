"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name:

- the configuration: the ``file`` of its ``configs`` entry;
- its plain reference: ``xv2bench/reference/<name>.py`` for the
  configuration's ``"reference": "<name>"`` (``reference/model.py`` where it
  names none), and each term of its ``loss_str`` that ``losses.TERMS`` lacks:
  ``xv2bench/reference/terms/<term>.py``;
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
from typing import Callable, Dict, List, Tuple

from xv2bench import weights
from xv2bench.reference import losses

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@dataclasses.dataclass(frozen=True)
class Reference:
    """A configuration's plain reference.  Its file defines
    ``build(spec, p: Precision) -> nn.Module`` and may define ``RESIDUAL``
    (fragments of the leaf names that end a residual branch, which the
    draw's ``residual_scale`` scales; ``weights.RESIDUAL`` where it does
    not) and ``LEAF_KINDS`` (a leaf-name suffix -> the ``(a, b, c)`` of its
    draw ``a * U[0, 1) + b * N(0, 1) + c``, for leaves ``weights`` has no
    rule for)."""
    name: str
    build: Callable
    residual: Tuple[str, ...]
    kinds: Dict[str, Tuple[float, float, float]]
    terms: Dict[str, Callable]   # each term of the loss_str: term(logits, labels, w)

    @property
    def weight_rules(self) -> dict:
        return dict(residual=self.residual, kinds=self.kinds)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, dict]
    end_to_end: List[dict]
    per_layer: List[dict]
    reference: Reference = None
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
                [m for m in bench["per_layer"] if _listed(m, workload)],
                find_reference(config, root), root)


def _module(path: str, prefix: str, name: str, what: str):
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {what} {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(prefix + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_reference(config: dict, root: str = ROOT) -> Reference:
    """The plain reference of a configuration, found by its ``reference``
    name (``model`` where it names none), with the loss terms of its
    ``loss_str``."""
    name = config.get("reference", "model")
    if name == "model":
        from xv2bench.reference import model as module
    else:
        module = _module(os.path.join(root, "xv2bench", "reference", f"{name}.py"),
                         "xv2bench_reference_", name, "reference")
    terms = {}
    for term in config["program"]["loss_str"].split("+"):
        terms[term] = losses.TERMS.get(term) or _module(
            os.path.join(root, "xv2bench", "reference", "terms", f"{term}.py"),
            "xv2bench_term_", term, "loss term").term
    return Reference(name, module.build, tuple(getattr(module, "RESIDUAL", weights.RESIDUAL)),
                     dict(getattr(module, "LEAF_KINDS", {})), terms)


def reader(metric: str, root: str = ROOT) -> Callable:
    """The ``read`` function of ``xv2bench/metrics/<metric>.py``."""
    path = os.path.join(root, "xv2bench", "metrics", f"{metric}.py")
    return _module(path, "xv2bench_metric_", metric, "metric").read
