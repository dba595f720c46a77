"""Set-up, the timed window, the traced slice and the check of one cell.

Train cells drive ``Runner.train_step`` as ``fit`` does, eval cells
``Runner.eval_step`` as ``run_eval`` and ``test`` do, in a closed loop: the
next batch goes in as soon as the call returns, with no synchronisation
between calls, and the window ends with one ``torch.cuda.synchronize()``.

Set-up builds the ``Runner`` once, loads the seeded weights and warms the
cell's own shapes.  For a train cell the warm-up is the check's first steps:
the same object, driven through the window's own call on the pool's first
batches, whose readings the reference follows after the window.  For an
eval cell the warm-up is one call, and the check compares a seeded sample of
the window's own batches.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np
import torch

from xv2bench import check, program, trace, traffic, weights
from xv2bench.reference import lowp
from xv2bench.reference import steps as ref_steps
from xv2bench.reference.model import Precision
from xv2bench.work import kernels

SAMPLE_MIX = 0x5A3B1E
DTYPES = {16: torch.bfloat16, 32: torch.float32, 64: torch.float64}


@dataclasses.dataclass
class Ctx:
    cell: object
    seed: int
    device: torch.device
    spec: dict                 # the configuration's program fields
    kind: str                  # "train" or "eval"
    batch: int
    pool: traffic.Pool
    leaves: list
    runner: object = None
    calls: int = 0             # calls made so far (the pool's order)
    f1: object = None          # an eval cell's F1 state, threaded through its calls
    phases: dict = dataclasses.field(default_factory=dict)   # set-up seconds by part

    def state(self) -> Dict[str, torch.Tensor]:
        init = self.cell.config["init"]
        return weights.draw(self.leaves, self.seed, self.device, **init,
                            **self.cell.reference.weight_rules)

    @property
    def prec(self) -> Precision:
        return Precision(DTYPES[self.spec.get("precision", 16)])

    @property
    def tile(self) -> int:
        """The side of the step's input: the crop in training, the tile at eval."""
        return self.spec.get("train_crop", 512) if self.kind == "train" else \
            self.cell.traffic["tile"]


def prepare(cell, seed: int, device: torch.device, with_program: bool = True) -> Ctx:
    """The runner with the seeded weights, and the traffic pool (made on a
    second host thread while the runner builds: numpy releases the
    interpreter in its array loops)."""
    spec = cell.config["program"]
    kind = cell.kind
    cfg = program.make_config(spec, seed, eval_mode=kind == "eval")
    batch = cfg.batch_size if kind == "train" else cfg.val_batch_size
    with torch.device("meta"):
        leaves = weights.leaves_of(cell.reference.build(spec, Precision()))
    with ThreadPoolExecutor(1) as pool_maker:
        pending = pool_maker.submit(traffic.make_pool, cell.traffic, seed, batch,
                                    cfg.in_channels, cfg.type)
        runner = None
        if with_program:
            t = time.perf_counter()
            runner = program.make_runner(cfg, device)
            sync(device)
            runner_s = time.perf_counter() - t
        t = time.perf_counter()
        ctx = Ctx(cell, seed, device, spec, kind, batch, pending.result(), leaves, runner)
    ctx.phases["pool_wait"] = time.perf_counter() - t
    if not with_program:
        return ctx
    ctx.phases["runner"] = runner_s
    t = time.perf_counter()
    state = ctx.state()
    program.load_state(ctx.runner.model, state)
    del state
    sync(device)
    ctx.phases["weights"] = time.perf_counter() - t
    return ctx


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    keys = list(tensors)
    vals = torch._foreach_norm([tensors[k].float() for k in keys])
    return dict(zip(keys, torch.stack(vals).tolist()))


def call(ctx: Ctx):
    """One call of the timed path on the pool's next batch."""
    images, masks = ctx.pool.batch(ctx.calls)
    ctx.calls += 1
    if ctx.kind == "train":
        return program.train_call(ctx.runner, images, masks)
    ctx.f1, loss, logits = program.eval_call(ctx.runner, ctx.f1, images, masks, ctx.pool.valid)
    return loss, logits


def train_first_steps(ctx: Ctx) -> dict:
    """The check's steps through the window's own call: each loss, the
    first gradient as AdamW holds it (its first moment over 1 - b1), and each
    leaf's and running statistic's change after the last."""
    runner = ctx.runner
    named = dict(runner.model.named_parameters())
    out = {"losses": []}
    for step in range(ctx.cell.traffic["check_steps"]):
        out["losses"].append(call(ctx))
        if step == 0:
            b1 = runner.opt.param_groups[0]["b1"]
            out["grad"] = _norms({k: runner.opt.state[p]["exp_avg"] / (1 - b1)
                                  for k, p in named.items()})
    start = ctx.state()
    with torch.no_grad():
        out["change"] = _norms({k: p - start[k] for k, p in named.items()})
        out["stats"] = _norms({k: b - start[k] for k, b in runner.model.named_buffers()})
    del start
    out["losses"] = [float(v) for v in out["losses"]]
    return out


def eval_warmup(ctx: Ctx) -> None:
    """One eval call outside the window: the cell's only shape."""
    ctx.f1 = program.init_f1(ctx.runner)
    call(ctx)
    ctx.f1 = None


def eval_sample(ctx: Ctx) -> List[int]:
    t = ctx.cell.traffic
    rng = np.random.Generator(np.random.PCG64([ctx.seed & (2 ** 64 - 1), SAMPLE_MIX]))
    return sorted(int(i) for i in rng.choice(t["sample_among"], t["check_batches"],
                                             replace=False))


@dataclasses.dataclass
class Window:
    calls: int
    wall_s: float
    host_call_s: List[float]
    captured: dict


def window(ctx: Ctx, seconds: float, sample=(), max_calls: int = 2 ** 62) -> Window:
    """Calls in a closed loop until ``seconds`` have passed, then one
    synchronize.  For the eval calls of ``sample`` (indices into the
    window's calls) the logits go to pinned host buffers, asynchronously,
    and the loss and the F1 counters before and after are kept."""
    pinned, captured = {}, {}
    if ctx.kind == "eval":
        ctx.f1 = program.init_f1(ctx.runner)
        shape = ctx.pool.images[0].shape[:3] + (ctx.runner.cfg.n_class,)
        pin = ctx.device.type == "cuda"
        pinned = {i: torch.empty(shape, dtype=torch.float32, pin_memory=pin) for i in sample}
    host, n = [], 0
    sync(ctx.device)
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        if t - t0 >= seconds or n >= max_calls:
            break
        before = ctx.f1 if ctx.kind == "eval" else None
        out = call(ctx)
        if n in pinned:
            loss, logits = out
            pinned[n].copy_(logits, non_blocking=True)
            captured[n] = (ctx.calls - 1, pinned[n], loss, before, ctx.f1)
        host.append(time.perf_counter() - t)
        n += 1
    sync(ctx.device)
    return Window(n, time.perf_counter() - t0, host, captured)


def profile_slice(ctx: Ctx, n: int) -> trace.Slice:
    """``n`` calls under ``torch.profiler`` (CPU and CUDA), read from its
    chrome trace in a temporary directory."""
    from torch.profiler import ProfilerActivity, profile

    if ctx.kind == "eval":
        ctx.f1 = program.init_f1(ctx.runner)
    sync(ctx.device)
    with tempfile.TemporaryDirectory() as tmp:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                call(ctx)
            sync(ctx.device)
            wall = time.perf_counter() - t0
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        del prof
        return trace.read_chrome_trace(path, n, wall)


def slice_bound_s(ctx: Ctx, sl: trace.Slice, first_call: int, first_step: int) -> Optional[float]:
    """The least time of the port's kernel launches in the slice, from the
    cell's shapes (and, for K6, the slice's draws), or None where the
    launches seen are not the launches planned."""
    tile = ctx.tile
    plan = kernels.launch_plan(ctx.spec, ctx.kind, ctx.batch, tile)
    want = {k: v * sl.steps for k, v in plan.items()}
    if ctx.kind == "train" and ctx.spec.get("autoaugment"):
        want["K6 row_shift"] = []
        for i in range(sl.steps):
            masks = torch.from_numpy(ctx.pool.batch(first_call + i)[1]).to(ctx.device)
            want["K6 row_shift"] += kernels.k6_step(ctx.seed, first_step + i, masks, tile,
                                                    ctx.pool.images[0].shape[-1])
    seen = {k: sl.launches.get(k, 0) for k in trace.PORT_KERNELS}
    planned = {k: len(want.get(k, [])) for k in trace.PORT_KERNELS}
    if seen != planned:
        print(f"kernel launches in the slice {seen} are not the planned {planned}: "
              "no kernel roofline", file=sys.stderr)
        return None
    return sum(sum(v) for v in want.values())


def free_program(ctx: Ctx) -> None:
    ctx.runner = None
    ctx.f1 = None
    sync(ctx.device)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def reference_train(ctx: Ctx, prec: Precision, fault: Optional[str] = None) -> dict:
    n = ctx.cell.traffic["check_steps"]
    return ref_steps.train_readings(ctx.cell.reference, ctx.spec, ctx.state,
                                    [ctx.pool.batch(i) for i in range(n)], ctx.seed, ctx.device,
                                    prec, fault)


def reference_logits(ctx: Ctx, calls: List[int], prec: Precision) -> Dict[int, torch.Tensor]:
    """The reference's four-flip logits of the pool's batches at ``calls``."""
    model = ref_steps.eval_model(ctx.cell.reference, ctx.spec, ctx.state(), prec, ctx.device)
    out = {c: ref_steps.eval_logits(model, ctx.pool.batch(c)[0], ctx.device) for c in calls}
    del model
    return out


def witness_logits(ctx: Ctx, calls: List[int]) -> Dict[int, torch.Tensor]:
    """The reference in float32 (TF32 off): how far one rounding of the
    configuration's own precision moves this seed's logits."""
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return reference_logits(ctx, calls, Precision(torch.float32))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def control_precision(ctx: Ctx) -> Precision:
    """The reference one precision below the configuration's: float8 for the
    bfloat16 model (``lowp.py``), bfloat16 for the float32 losses."""
    if ctx.prec.dtype != torch.bfloat16:
        raise ValueError("the control is written for a bfloat16 configuration")
    return Precision(torch.bfloat16, lowp.fp8, loss_dtype=torch.bfloat16)


def control_eval_readings(ctx: Ctx, calls: List[int]) -> Dict[int, tuple]:
    """The control in the program's place: its logits, its loss of them and
    its F1 counters after each call, from zero."""
    prec = control_precision(ctx)
    out = {}
    for c, logits in reference_logits(ctx, calls, prec).items():
        _, masks = ctx.pool.batch(c)
        loss, counts = ref_steps.judge_eval(ctx.cell.reference, ctx.spec, logits, masks,
                                            ctx.pool.valid, prec.loss_dtype)
        zero = torch.zeros(counts.shape, dtype=torch.float32)
        out[c] = (logits, loss, zero, zero + counts.float())
    return out


def program_eval_readings(captured: dict) -> Dict[int, tuple]:
    """The captured calls' (logits, loss, F1 counters before, after), keyed
    by pool call."""
    out = {}
    for _, (c, logits, loss, before, after) in captured.items():
        out[c] = (logits, float(loss), program.f1_tensor(before).cpu(),
                  program.f1_tensor(after).cpu())
    return out


def eval_numbers(ctx: Ctx, got: Dict[int, tuple], ref: Dict[int, torch.Tensor],
                 witness: Optional[Dict[int, torch.Tensor]] = None) -> dict:
    """The worst over the sample of:

    - ``logits_gap``: the relative L2 distance of the logits from the
      reference's; ``logits_ratio`` that over the float32 witness's distance
      from the same reference (where a witness is given);
    - ``loss_gap``: the loss against the float32 loss the reference gives for
      the same logits;
    - ``f1_gap``: the F1 counters after the call against the counters before
      it plus the reference's counts of the same logits, added in float32 as
      the counters are (exact: the counts are integers), over those counts.

    A sampled call that never came counts as infinitely far."""
    rows = []
    for c in ref:
        if c not in got:
            return {"logits_gap": float("inf"), "logits_ratio": float("inf"),
                    "loss_gap": float("inf"), "f1_gap": float("inf")}
        logits, loss, before, after = got[c]
        _, masks = ctx.pool.batch(c)
        dev_logits = logits.to(ctx.device)
        want_loss, counts = ref_steps.judge_eval(ctx.cell.reference, ctx.spec, dev_logits, masks,
                                                 ctx.pool.valid)
        del dev_logits
        row = check.eval_batch_numbers(logits, loss, before, after, ref[c], want_loss, counts)
        if witness is not None:
            row["logits_ratio"] = row["logits_gap"] / max(check.rel_l2(witness[c], ref[c]), 1e-30)
        rows.append(row)
    return check.worst(rows)
