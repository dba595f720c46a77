"""The benchmark's arithmetic on recorded inputs: the traffic as a pure
function of the seed, the kernels' least times against PERF.md's kernel
table, the model FLOPs, and the per-layer readers on a recorded trace."""

import json
import os

import numpy as np
import pytest

from xv2bench import readers, trace, traffic
from xv2bench.reference.model import build
from xv2bench.work import flops, kernels

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = dict(type="pre", encoder="resnest50", attention=True, deep_supervision=True,
         loss_str="focal+dice")


def _spec(name):
    with open(os.path.join(BENCH, "traffic", f"{name}.json")) as f:
        return dict(json.load(f), tile=128, pool_batches=3)


@pytest.mark.parametrize("channels,task", [(3, "pre"), (6, "post")])
def test_traffic_is_a_pure_function_of_the_seed(channels, task):
    seed = 2 ** 31 + 977   # seeds may pass 32 signed bits
    a = traffic.make_pool(_spec("train-aa"), seed, 2, channels, task)
    b = traffic.make_pool(_spec("train-aa"), seed, 2, channels, task)
    c = traffic.make_pool(_spec("train-aa"), seed + 1, 2, channels, task)
    for x, y in zip(a.images + a.masks, b.images + b.masks):
        assert x.dtype == np.uint8 and np.array_equal(x, y)
    assert np.array_equal(a.order, b.order)
    assert not np.array_equal(a.images[0], c.images[0])
    assert a.images[0].shape == (2, 128, 128, channels)
    assert list(a.order[:3]) == [0, 1, 2]   # the checked calls see distinct batches
    labels = set(np.unique(np.concatenate([m.ravel() for m in a.masks])))
    assert labels <= ({0, 1} if task == "pre" else {0, 1, 2, 3, 4, 255})


def test_kernel_bounds_match_the_kernel_table():
    """PERF.md's kernel table: K1 eval 0.020 ms, K2 eval 5.003 and train
    1.251 ms, K3 eval 0.3406 ms, K6 0.0242 and 0.3472 ms, D's K1 0.0463."""
    ev = kernels.launch_plan(D, "eval", 4, 1024)
    tr = kernels.launch_plan(D, "train", 16, 512)
    ms = lambda v: 1e3 * sum(v)  # noqa: E731
    assert ms(ev["K1 relayout"]) == pytest.approx(0.020, abs=5e-4)
    assert ms(ev["K2 conv_bn_fused"]) == pytest.approx(5.003, abs=5e-4)
    assert ms(tr["K2 conv_bn_fused"]) == pytest.approx(1.251, abs=5e-4)
    assert ms(ev["K3 head_conv_fused"]) == pytest.approx(0.3406, abs=5e-5)
    assert ms(tr["K1 relayout"]) == pytest.approx(0.0463, abs=5e-5)
    assert ms(kernels.k6_plan([("rotate", 2), ("shift", 2)], 512, 3)) == \
        pytest.approx(0.0242, abs=5e-5)
    assert ms(kernels.k6_plan([("rotate", 16)] * 2 + [("shift", 16)], 512, 3)) == \
        pytest.approx(0.3472, abs=5e-5)
    assert len(tr["K4 conv_bn_wgrad"]) == len(tr["K5 conv_bn_dgrad"]) == 6


def test_fused_damage_model_plan_has_the_cross_fusion():
    c = dict(type="post", dmg_model="fused", encoder="resnest200", loss_str="coral")
    plan = kernels.launch_plan(c, "train", 8, 512)
    assert len(plan["K2 conv_bn_fused"]) == 14 and len(plan["K1 relayout"]) == 3
    assert len(kernels.launch_plan(c, "eval", 13, 1024)["K1 relayout"]) == 1


def test_model_flops_count_forward_and_backward():
    train = flops.per_tile(build, D, "train", 1, 64)
    ev = flops.per_tile(build, D, "eval", 1, 64)
    fwd = ev / 4                                   # four flips at eval
    assert 2.5 * fwd < train < 3.5 * fwd          # a backward is about two forwards


def _event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1,
            "args": args}


def _recorded_trace():
    """Two steps: kernels with a gap between them that the op launching the
    second kernel ends."""
    return [
        _event("cpu_op", "aten::conv2d", 0.0, 50.0),
        _event("cuda_runtime", "cudaLaunchKernel", 10.0, 2.0, correlation=1),
        _event("kernel", "conv_wgmma_kernel<...>", 20.0, 30.0, correlation=1),
        _event("kernel", "elementwise_kernel<add>", 40.0, 20.0, correlation=2),
        _event("cpu_op", "aten::copy_", 60.0, 100.0),
        _event("cuda_runtime", "cudaLaunchKernel", 150.0, 2.0, correlation=3),
        _event("kernel", "xmma_gemm_bf16", 160.0, 40.0, correlation=3),
        _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 200.0, 10.0, correlation=4),
    ]


def test_trace_union_categories_and_gaps():
    sl = trace.summarize(_recorded_trace(), steps=2, window_s=250e-6)
    assert sl.busy_s == pytest.approx((60 - 20 + 50) * 1e-6)   # [20, 60] and [160, 210]
    assert sl.by_category["K2 conv_bn_fused"] == pytest.approx(30e-6)
    assert sl.by_category["elementwise"] == pytest.approx(20e-6)
    assert sl.by_category["library conv/GEMM"] == pytest.approx(40e-6)
    assert sl.by_category["cat/copy"] == pytest.approx(10e-6)
    assert sl.launches["K2 conv_bn_fused"] == 1
    assert sl.idle_gaps == [("aten::copy_", pytest.approx(100e-6))]
    assert sl.top_ops[0][0] == "xmma_gemm_bf16"


def _reading(**kw):
    sl = trace.Slice(steps=2, window_s=0.5, busy_s=0.3,
                     by_category={"elementwise": 0.2, "cat/copy": 0.04,
                                  "library conv/GEMM": 0.06, "K2 conv_bn_fused": 0.02,
                                  "K6 row_shift": 0.02},
                     launches={}, top_ops=[], idle_gaps=[])
    base = dict(kind="train", tiles_per_s=64.0, calls=40, wall_s=10.0,
                host_call_s=[0.2, 0.3, 0.25], slice=sl, kernel_bound_s=0.01,
                flops_per_tile=4.0e11)
    base.update(kw)
    return readers.Reading(**base)


def test_readers_on_a_recorded_reading():
    r = _reading()
    assert readers.host_call_ms(r, "train") == pytest.approx(250.0)
    assert readers.device_ms(r, "train", ("elementwise", "cat/copy")) == pytest.approx(120.0)
    assert readers.kernel_roofline(r, "train") == pytest.approx(25.0)  # 0.01 of 0.04 s
    assert readers.mfu(r, "train") == pytest.approx(100 * 4e11 * 64 / 989e12)
    # 0.15 s busy a call against 0.25 s of wall a call
    assert readers.idle_share(r, "train") == pytest.approx(40.0)
    for fn in (readers.mfu, readers.idle_share, readers.kernel_roofline):
        assert fn(r, "eval") is None                   # another cell's call
    assert readers.kernel_roofline(_reading(kernel_bound_s=None), "train") is None


def test_rates_are_taken_over_the_whole_window():
    """The window's rate counts every call over the time to the final
    synchronize, not a mean of per-call times."""
    from types import SimpleNamespace

    from xv2bench import harness

    pool = SimpleNamespace(batch=lambda i: (None, None))
    calls = []
    ctx = SimpleNamespace(kind="train", calls=0, device=SimpleNamespace(type="cpu"),
                          pool=pool)

    def slow(c):
        import time
        calls.append(c.calls)
        c.calls += 1
        time.sleep(0.02)

    orig = harness.call
    harness.call = slow
    try:
        win = harness.window(ctx, 0.2)
    finally:
        harness.call = orig
    assert win.calls == len(calls) and win.calls >= 5
    assert win.wall_s >= 0.2 and win.wall_s >= sum(win.host_call_s)


def test_calibrate_judges_each_row_against_the_committed_limits():
    """Rows read on the chip (D train, one seed): the program within every
    limit, the float8 control and each fault over at least one, and the
    summary naming the numbers over their limits."""
    from xv2bench import calibrate, cells

    limits = cells.load("loc-rs50-attn-ds.train-aa").limits
    row = {"seed": 92,
           "program": dict(loss1_gap=2.3e-05, grad_gap=0.00411, update_worst=0.0402,
                           stats_gap=0.000384),
           "fp8": dict(loss1_gap=0.00274, grad_gap=0.0273, update_worst=0.0836,
                       stats_gap=0.00256),
           "half": dict(loss1_gap=6e-05, grad_gap=0.0955, update_worst=0.0671,
                        stats_gap=0.00324),
           "altered": dict(loss1_gap=0.0554, grad_gap=0.447, update_worst=0.138,
                           stats_gap=0.000904)}
    kinds = ["program", "fp8", "half", "altered"]
    row["verdict"] = calibrate.judged(row, limits, kinds)
    assert row["verdict"]["program"] == {"correct": True, "fails": []}
    assert row["verdict"]["fp8"] == {"correct": False, "fails": ["loss1_gap", "stats_gap"]}
    assert row["verdict"]["half"] == {"correct": False, "fails": ["grad_gap", "stats_gap"]}
    assert row["verdict"]["altered"] == {"correct": False, "fails": ["loss1_gap", "grad_gap"]}
    summary = calibrate.summarize([row], kinds)
    assert summary["fp8"]["correct"] == [False]
    assert summary["altered"]["fails"] == {"92": ["loss1_gap", "grad_gap"]}
    assert summary["program"]["readings"]["grad_gap"] == 0.00411
