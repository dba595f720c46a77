"""One run of a cell: set-up, the window, the traced slice, the check, and
the result object of the benchmark's contract."""

from __future__ import annotations

import sys
import time

import torch

from xv2bench import cells, check, harness, readers
from xv2bench.work import flops

GIB = 2 ** 30


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, t_start: float) -> dict:
    cuda = device.type == "cuda"
    imports_s = time.perf_counter() - t_start
    ctx = harness.prepare(cell, seed, device)
    t = time.perf_counter()
    sample = []
    if ctx.kind == "train":
        got = harness.train_first_steps(ctx)
    else:
        harness.eval_warmup(ctx)
        sample = harness.eval_sample(ctx)
    harness.sync(device)
    setup_s = time.perf_counter() - t_start
    phases = dict(imports=imports_s, **ctx.phases, warmup=time.perf_counter() - t)
    first_call = ctx.calls
    win = harness.window(ctx, seconds, sample)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rate = win.calls * ctx.batch / win.wall_s
    sl = bound = None
    if traced:
        slice_call, slice_step = ctx.calls, ctx.runner.state.step
        sl = harness.profile_slice(ctx, cell.traffic["slice_calls"])
        bound = harness.slice_bound_s(ctx, sl, slice_call, slice_step)
    if ctx.kind == "eval":
        got = harness.program_eval_readings(win.captured)
    harness.free_program(ctx)

    if ctx.kind == "train":
        numbers = check.train_numbers(got, harness.reference_train(ctx, ctx.prec))
    else:
        calls = [first_call + i for i in sample]
        ref = harness.reference_logits(ctx, calls, ctx.prec)
        witness = harness.witness_logits(ctx, calls) if "logits_ratio" in cell.limits else None
        numbers = harness.eval_numbers(ctx, got, ref, witness)
    verdict = check.judge(numbers, cell.limits)

    values = {"setup_s": setup_s, f"{ctx.kind}_tiles_per_s": rate, "peak_mem_gib": peak / GIB}
    device_info = {"platform": "gpu", "count": 1,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "memory_peak_bytes": peak}
    result = {"correct": verdict["correct"], "attempted": win.calls,
              "failed": sum(1 for v in verdict["numbers"].values()
                            if not (v["value"] is not None and v["value"] <= v["limit"]))}
    if traced:
        reading = readers.Reading(
            kind=ctx.kind, tiles_per_s=rate, calls=win.calls, wall_s=win.wall_s,
            host_call_s=win.host_call_s, slice=sl, kernel_bound_s=bound,
            flops_per_tile=flops.per_tile(cell.reference.build, ctx.spec, ctx.kind, ctx.batch,
                                          ctx.tile),
            cell=cell, batch=ctx.batch, tile=ctx.tile)
        metrics = {}
        for m in cell.per_layer:
            v = cells.reader(m["name"], cell.root)(reading)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=sl.busy_s, window_s=sl.window_s)
        result["metrics"] = metrics
        result["device"] = device_info
        result["breakdown"] = {"device_ops": [[n[:160], s] for n, s in sl.top_ops],
                               "idle_gaps": [[n[:160], s] for n, s in sl.idle_gaps]}
    else:
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        result["device"] = device_info
    result["check"] = verdict["numbers"]
    print("set-up seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()),
          file=sys.stderr)
    check.report(verdict)
    return result

