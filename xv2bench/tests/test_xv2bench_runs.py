"""Whole runs of the harness on the CPU at a tiny size, with its look for a
chip skipped: the result line's shape, each fault a cell can have planted
under the timed path (the run must come out not correct), and the control
(the reference one precision below) held apart from the program."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from xv2bench import check, harness, measure
from xv2bench.tests import tiny

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CPU = torch.device("cpu")
D_TRAIN, D_EVAL = "loc-rs50-attn-ds.train-aa", "loc-rs50-attn-ds.eval-tta"
C_EVAL = "dmg-fused-rs200.eval-tta"


def _run(cell, seed=2 ** 31 + 5, traced=False):
    return measure.run_cell(cell, seed, 3.0, traced, CPU, time.perf_counter())


def test_result_line_has_the_contract_keys():
    out = _run(tiny.cell(D_EVAL))
    assert list(out)[-1] == "check"                       # the compared numbers last
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(out)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 2
    assert set(out["metrics"]) == {"setup_s", "eval_tiles_per_s", "peak_mem_gib"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] >= 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    for v in out["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(out)


@pytest.mark.parametrize("script,args", [
    ("run.py", ["--workload", D_TRAIN, "--seed", "1", "--seconds", "1", "--trace", "0"]),
    ("calibrate.py", ["--workload", D_TRAIN, "--seeds", "1"])])
def test_run_refuses_without_a_card(script, args):
    proc = subprocess.run([sys.executable, f"xv2bench/{script}"] + args, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def _plant(monkeypatch, fault: str):
    """Break the program under the timed path once ``prepare`` has built it."""
    orig = harness.prepare

    def prepare(*a, **k):
        ctx = orig(*a, **k)
        runner = ctx.runner
        if fault == "altered":        # one answer made confidently wrong where produced
            def negate_first(module, args, out):
                first = out[0] if isinstance(out, list) else out
                first = torch.cat([-10 * first[:1], first[1:]])
                return [first] + out[1:] if isinstance(out, list) else first
            runner.model.register_forward_hook(negate_first)
        elif ctx.kind == "train":
            step = runner.train_step
            if fault == "unchanged":  # a step that returns its state as it was
                def train_step(state, images, masks, rng):
                    keep = {k: v.clone() for k, v in runner.model.state_dict().items()}
                    state, loss = step(state, images, masks, rng)
                    runner.model.load_state_dict(keep)
                    return state, loss
            else:                     # half of the batch, the mean over the rest
                def train_step(state, images, masks, rng):
                    h = images.shape[0] // 2
                    return step(state, images[:h], masks[:h], rng)
            runner.train_step = train_step
        else:
            step = runner.eval_step
            if fault == "unchanged":  # the F1 counters returned as they came
                def eval_step(f1, images, masks, valid):
                    _, loss, logits = step(f1, images, masks, valid)
                    return f1, loss, logits
            else:                     # half of the batch, the mean over the rest
                def eval_step(f1, images, masks, valid):
                    valid = valid.copy()
                    valid[valid.shape[0] // 2:] = 0
                    return step(f1, images, masks, valid)
            runner.eval_step = eval_step
        return ctx

    monkeypatch.setattr(harness, "prepare", prepare)


@pytest.mark.parametrize("workload", [D_TRAIN, D_EVAL])
@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, workload, fault):
    _plant(monkeypatch, fault)
    out = _run(tiny.cell(workload))
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("workload", [D_TRAIN, C_EVAL])
def test_a_sound_run_is_correct(workload):
    over = {"encoder": "resnest50"} if workload == C_EVAL else {}
    out = _run(tiny.cell(workload, **over))
    assert out["correct"] is True, out["check"]


def test_the_control_is_held_apart_from_the_program():
    """At a test's size and the configuration's precision, the control's
    numbers lie beyond the program's: float8 logits farther from the
    reference than the program's bfloat16 ones, and a float8 first loss."""
    from xv2bench import calibrate

    ev = calibrate.readings(tiny.cell(D_EVAL, precision=16), 11, CPU, True, ["fp8"])
    assert ev["fp8"]["logits_gap"] > 3 * ev["program"]["logits_gap"]
    assert ev["fp8"]["loss_gap"] > 3 * ev["program"]["loss_gap"]
    tr = calibrate.readings(tiny.cell(D_TRAIN, precision=16), 11, CPU, True, ["fp8"])
    assert tr["fp8"]["loss1_gap"] > 3 * tr["program"]["loss1_gap"]
