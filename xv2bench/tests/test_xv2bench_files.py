"""A later change adds a configuration, a traffic mix, a cell and a
per-layer metric as files and entries of their own; the harness finds each
by its name in ``BENCHMARK.json`` and edits none that is there."""

import json
import os
import shutil

from xv2bench import cells, readers

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "xv2bench"), root / "xv2bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    config = json.load(open(root / "xv2bench" / "configs" / "loc-rs50-attn-ds.json"))
    config["program"]["encoder"] = "resnest101"
    (root / "xv2bench" / "configs" / "loc-rs101.json").write_text(json.dumps(config))
    mix = json.load(open(root / "xv2bench" / "traffic" / "eval-tta.json"))
    mix["tile"] = 512
    (root / "xv2bench" / "traffic" / "eval-512.json").write_text(json.dumps(mix))
    (root / "xv2bench" / "limits" / "loc-rs101.eval-512.json").write_text(
        json.dumps({"limits": {"logits_gap": {"limit": 0.5}}}))
    (root / "xv2bench" / "metrics" / "calls.eval.py").write_text(
        "def read(r):\n    return float(r.calls) if r.kind == 'eval' else None\n")
    bench["configs"].append({"name": "loc-rs101", "source": "https://arxiv.org/abs/2004.08955",
                             "file": "xv2bench/configs/loc-rs101.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "loc-rs101.eval-512", "config": "loc-rs101",
                               "traffic": "eval-512", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "calls.eval", "unit": "calls", "better": "higher",
                               "source": "host_clock", "layer": "trainer",
                               "moves": "eval_tiles_per_s",
                               "workloads": ["loc-rs101.eval-512"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = cells.load("loc-rs101.eval-512", root=str(root))
    assert cell.config["program"]["encoder"] == "resnest101"
    assert cell.traffic["tile"] == 512 and cell.kind == "eval"
    assert list(cell.limits) == ["logits_gap"]
    assert [m["name"] for m in cell.per_layer] == ["calls.eval"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "peak_mem_gib"}
    read = cells.reader("calls.eval", str(root))
    r = readers.Reading("eval", 1.0, 7, 1.0, [0.1], None, None, 1.0)
    assert read(r) == 7.0
    # the cells that were there are unchanged
    assert cells.load("loc-rs50-attn-ds.eval-tta", root=str(root)).limits == \
        cells.load("loc-rs50-attn-ds.eval-tta").limits


def test_every_per_layer_metric_has_its_reader():
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    for m in bench["per_layer"]:
        assert callable(cells.reader(m["name"])), m["name"]
    for w in bench["workloads"]:
        cell = cells.load(w["name"])
        assert cell.limits and cell.end_to_end and cell.per_layer
