"""Readings from which a cell's limits are set: on each seed, the program's
numbers against the reference (the lower readings), and the numbers of the
control (the reference one precision below: float8 for the bfloat16 model,
bfloat16 for the float32 losses) and, in a train cell, of the planted faults
(``half``: half of the batch; ``altered``: one sample's logits negated and
scaled by ten where they are produced), each against the same reference (the upper readings).
A state left unchanged reads 1 on ``update_worst`` by construction and
needs no run.

    python3 xv2bench/calibrate.py --workload <cell> --seeds 1,2,3 [--no-program]
        [--controls fp8,half,altered] [--out FILE]

One process runs every seed: the kernels build once.  Each row (the program,
the control, each fault) is also judged against the cell's committed limits
(``check.judge``), as a run would judge it.  Each seed prints one JSON line
(and appends it to ``--out``); the last line is the summary: per row kind,
the largest program reading and the smallest of each control's, the verdict
on each seed, and the numbers over their limits on each seed.  Like
``run.py``, it refuses to run without a card: limits come from readings at
the cell's own size on the chip.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse  # noqa: E402

import torch  # noqa: E402

from xv2bench import cells, check, harness  # noqa: E402


def readings(cell, seed: int, device, with_program: bool, controls):
    t0 = time.perf_counter()
    ctx = harness.prepare(cell, seed, device, with_program)
    row = {"seed": seed}
    if ctx.kind == "train":
        got = harness.train_first_steps(ctx) if with_program else None
        harness.free_program(ctx)
        want = harness.reference_train(ctx, ctx.prec)
        row["losses"] = want["losses"]
        if got is not None:
            row["program"] = check.train_numbers(got, want)
            row["program_losses"] = got["losses"]
        for name in controls:
            if name == "fp8":
                other = harness.reference_train(ctx, harness.control_precision(ctx))
            else:
                other = harness.reference_train(ctx, ctx.prec, name)
            row[name] = check.train_numbers(other, want)
            row[f"{name}_losses"] = other["losses"]
    else:
        sample = harness.eval_sample(ctx)
        calls = list(sample)
        got = None
        if with_program:
            harness.eval_warmup(ctx)
            calls = [ctx.calls + i for i in sample]
            win = harness.window(ctx, 1e9, sample, max_calls=max(sample) + 1)
            got = harness.program_eval_readings(win.captured)
        harness.free_program(ctx)
        ref = harness.reference_logits(ctx, calls, ctx.prec)
        witness = harness.witness_logits(ctx, calls)
        if got is not None:
            row["program"] = harness.eval_numbers(ctx, got, ref, witness)
        if "fp8" in controls:
            row["fp8"] = harness.eval_numbers(ctx, harness.control_eval_readings(ctx, calls),
                                              ref, witness)
    row["seconds"] = time.perf_counter() - t0
    return row


def judged(row: dict, limits: dict, kinds) -> dict:
    """Each row kind's verdict against the committed limits: ``correct`` and
    the names of the numbers over their limits."""
    out = {}
    for key in kinds:
        if key in row:
            verdict = check.judge(row[key], limits)
            out[key] = {"correct": verdict["correct"],
                        "fails": [n for n, v in verdict["numbers"].items()
                                  if not (v["value"] is not None and v["value"] <= v["limit"])]}
    return out


def summarize(rows, kinds) -> dict:
    """Per row kind: the largest program reading or the smallest control
    one of each number, and, seed by seed, the verdict and the numbers over
    their limits."""
    summary = {}
    for key in kinds:
        got = [r for r in rows if key in r]
        if got:
            pick = max if key == "program" else min
            summary[key] = {
                "readings": {n: pick(r[key][n] for r in got) for n in got[0][key]},
                "correct": [r["verdict"][key]["correct"] for r in got],
                "fails": {str(r["seed"]): r["verdict"][key]["fails"] for r in got}}
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--no-program", dest="program", action="store_false")
    p.add_argument("--controls", default="fp8,half,altered")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); limits are read on the "
              f"chip at the cell's own size", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    controls = [c for c in args.controls.split(",") if c]
    kinds = ["program"] + controls
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(cell, seed, device, args.program, controls)
        row["verdict"] = judged(row, cell.limits, kinds)
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    print(json.dumps({"summary": summarize(rows, kinds)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
