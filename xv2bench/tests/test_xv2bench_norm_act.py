"""K9's plan (``work/norm_act.py``) and its roofline (``norm_act_roofline.eval``):
the launches planned from the reference are the program's BatchNorm
epilogues of an eval call (each ``layers.norm_act`` call, the one dispatch
that launches K9 on the card), with and without the fused tail taking
``dec_l2``; the metric reads the slice's K9 launches against the plan."""

import functools

import pytest
import torch

from xv2bench import cells, harness, readers, trace
from xv2bench.tests import tiny
from xv2bench.work import norm_act
from xview2_tpu_torch.models import layers

CPU = torch.device("cpu")
D_EVAL, C_EVAL = "loc-rs50-attn-ds.eval-tta", "dmg-fused-rs200.eval-tta"


@pytest.mark.parametrize("workload,tile,over", [
    (D_EVAL, 64, {}),                          # dec_l2 at 8^2: the fused tail does not take it
    (D_EVAL, 128, {}),                         # the fused tail takes dec_l2, dec_l3 and dec_l5
    (C_EVAL, 64, {"encoder": "resnest50"}),    # both branches, the cross-fusion, CORAL
    (C_EVAL, 128, {"encoder": "resnest50"})])
def test_the_plan_is_the_programs_epilogues(monkeypatch, workload, tile, over):
    cell = tiny.cell(workload, precision=16, **over)
    cell.traffic["tile"] = tile
    calls = []

    def record(x, mean, mul, bias, **kw):
        calls.append((x.numel(), mean.numel(), kw.get("residual") is not None))
        return orig(x, mean, mul, bias, **kw)

    orig = layers.norm_act
    monkeypatch.setattr(layers, "norm_act", record)
    ctx = harness.prepare(cell, 7, CPU)
    harness.eval_warmup(ctx)
    plan = norm_act.sites(cell.reference.build, ctx.spec, ctx.batch, ctx.tile)
    assert sorted(plan) == sorted(calls)
    assert any(r for *_, r in plan)


def test_the_plan_at_the_cells_size():
    """The eval cells' launches a call (PERF.md: D 89, C 572 at 256^2, the
    site count set by the depth alone) and their least time."""
    for workload, n in ((D_EVAL, 89), (C_EVAL, 572)):
        cell = cells.load(workload)
        spec = cell.config["program"]
        got = norm_act.sites(cell.reference.build, spec, 13, 1024)
        assert len(got) == n
        stem = (52 * 512 * 512 * 64, 64, False)   # the stem's last BatchNorm, relu
        assert stem in got
        bounds = norm_act.launch_bounds(cell.reference.build, spec, 13, 1024)
        assert bounds[got.index(stem)] == pytest.approx(1.0417e-3, rel=1e-4)   # kernel table
    d = cells.load(D_EVAL)
    assert norm_act.sites(d.reference.build, dict(d.config["program"], fused_tail=False),
                          13, 1024) is None


def _slice(names_durations, steps=2):
    events = [{"ph": "X", "cat": "kernel", "name": n, "ts": 10.0 * i, "dur": d, "tid": 1,
               "args": {}} for i, (n, d) in enumerate(names_durations)]
    return trace.summarize(events, steps=steps, window_s=1.0)


def test_the_roofline_reads_the_planned_launches():
    cell = cells.load(D_EVAL)
    read = cells.reader("norm_act_roofline.eval")
    bounds = norm_act.launch_bounds(cell.reference.build, cell.config["program"], 1, 64)
    k9 = ["void (anonymous namespace)::norm_act_elementwise_kernel<__nv_bfloat16, 1>(...)",
          "void (anonymous namespace)::norm_act_strided_elementwise_kernel<float>(...)"]
    events = [(k9[i % 2], 2.0) for i in range(2 * len(bounds))] + [("xmma_gemm", 50.0)]
    reading = functools.partial(readers.Reading, "eval", 1.0, 10, 1.0, [0.1],
                                kernel_bound_s=None, flops_per_tile=1.0, cell=cell, batch=1,
                                tile=64)
    sl = _slice(events)
    assert sl.launches_by_name[k9[0]] == len(bounds)
    assert len(sl.top_ops) == 3 and sum(sl.by_name.values()) == pytest.approx(
        (4 * len(bounds) + 50) * 1e-6)
    got = read(reading(sl))
    assert got == pytest.approx(100 * 2 * sum(bounds) / (2 * len(bounds) * 2e-6))
    assert read(reading(_slice(events + [(k9[0], 2.0)]))) is None    # a launch not planned
    assert read(reading(_slice(events[1:]))) is None                 # a launch missing
    assert read(readers.Reading("train", 1.0, 10, 1.0, [0.1], sl, None, 1.0, cell, 1, 64)) is None
    # K9's time stays in the elementwise category, outside K1-K6's roofline
    assert trace.category(k9[0]) == trace.category(k9[1]) == "elementwise"
    assert not set(trace.PORT_KERNELS) & {trace.category(k) for k in k9}
