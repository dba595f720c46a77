"""The readers of the program's spans (``xv2bench/spans.py`` and the nine
metric files that call it) on a recorded summary: milliseconds a call of the
step span, None on the other kind of cell, where the step span's calls are
not the slice's steps, where a device time is missing, and on a program
without spans."""

import json
import os
import sys

import pytest

from xv2bench import cells, readers, trace
from xview2_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# metric -> (kind, span, clock)
METRICS = {"augment_ms.train": ("train", "train.augment", "device"),
           "forward_ms.train": ("train", "train.forward", "device"),
           "backward_ms.train": ("train", "train.backward", "device"),
           "update_ms.train": ("train", "train.update", "device"),
           "h2d_ms.train": ("train", "train.h2d", "host"),
           "host_sync_ms.train": ("train", "augment.sync", "host"),
           "h2d_ms.eval": ("eval", "eval.h2d", "host"),
           "forward_ms.eval": ("eval", "eval.forward", "device"),
           "score_ms.eval": ("eval", "eval.score", "device")}


def _stats(calls, host_s, device_s, parent=None):
    return spans.Stats(calls=calls, steps=calls, parent=parent, host_s=host_s,
                       self_host_s=host_s, device_s=device_s)


def _recorded(steps, device=True):
    """A summary of ``steps`` calls of each step span: span i of the table
    took (i + 1) host ms and (i + 1) * 10 device ms a call."""
    got = {"train.step": _stats(steps, 1.0, 2.0 if device else None),
           "eval.step": _stats(steps, 1.0, 2.0 if device else None)}
    for i, (kind, name, _) in enumerate(METRICS.values()):
        got[name] = _stats(steps, steps * (i + 1) * 1e-3,
                           steps * (i + 1) * 1e-2 if device else None, f"{kind}.step")
    return got


def _reading(kind, steps):
    sl = trace.Slice(steps, 1.0, 1.0, {}, {}, [], [])
    return readers.Reading(kind, 1.0, 10, 1.0, [0.1], sl, None, 1.0)


@pytest.mark.parametrize("metric", list(METRICS))
def test_each_reader_gives_ms_a_call_of_its_kind_only(metric, monkeypatch):
    kind, _, clock = METRICS[metric]
    i = list(METRICS).index(metric)
    read = cells.reader(metric)
    other = "eval" if kind == "train" else "train"
    monkeypatch.setattr(spans, "summary", lambda: _recorded(3))
    assert read(_reading(kind, 3)) == pytest.approx((i + 1) * (10.0 if clock == "device" else 1.0))
    assert read(_reading(other, 3)) is None
    assert read(_reading(kind, 2)) is None   # the registry holds other calls than the slice's
    monkeypatch.setattr(spans, "summary", lambda: _recorded(3, device=False))
    got = read(_reading(kind, 3))
    assert got is None if clock == "device" else got == pytest.approx(i + 1)
    monkeypatch.setattr(spans, "summary", lambda: {})
    assert read(_reading(kind, 3)) is None


def test_a_program_without_spans_gives_nothing(monkeypatch):
    monkeypatch.setitem(sys.modules, "xview2_tpu_torch.utils.spans", None)  # ImportError
    for metric, (kind, _, _) in METRICS.items():
        assert cells.reader(metric)(_reading(kind, 3)) is None, metric


def test_the_entries_name_their_cells_and_layers():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for metric, (kind, _, clock) in METRICS.items():
        m = entries[metric]
        assert (m["unit"], m["better"]) == ("ms", "lower")
        assert m["source"] == ("device_trace" if clock == "device" else "host_clock")
        assert m["moves"] == f"{kind}_tiles_per_s"
        want = [w["name"] for w in bench["workloads"] if w["traffic"].startswith(kind)]
        assert m["workloads"] == want
