"""The numbers that decide ``correct``: each a gap between what the program
produced on the timed path and what the plain reference produces from the
same weights and batches, each held to the limit of the cell's limits file.

Train (the first steps the set-up drives through ``Runner.train_step``):

- ``loss_gap``: the largest relative gap of a step's loss; ``loss1_gap``
  the first step's alone (the later steps' losses carry AdamW's first
  updates, which move every weight by the learning rate whatever its
  gradient's size, so rounding in a gradient near zero moves them).
- ``grad_gap``: per leaf, the gap between the program's and the
  reference's norm of the first step's gradient (the program's taken from
  AdamW's first moment), over the larger of the reference leaf's norm and
  the median leaf's; the median over the leaves (the worst leaf's is the
  reading ``grad_worst``: in bfloat16 it is the noise of a few leaves,
  as large between the reference and itself in float32, see PERF.md).
- ``update_gap``: the same of each parameter's change after the steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone).
- ``stats_gap``: the same of each BatchNorm running statistic's change.

Eval (a seeded sample of the window's batches; ``harness.eval_numbers``):
the four-flip logits against the reference's (``logits_gap``, and over the
float32 witness's distance, ``logits_ratio``), the loss against the
reference's loss of the same logits (``loss_gap``), the F1 counters against
the counters before the call plus the reference's counts of the same logits
(``f1_gap``, exact).
"""

from __future__ import annotations

import statistics
import sys
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

SKIP_BELOW = 1e-3   # leaves whose reference gradient is under this share of the median's


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float],
               keep: Optional[Iterable[str]] = None) -> List[float]:
    """Each leaf's gap of norms over the larger of its reference norm and
    the median leaf's, in increasing order."""
    names = [k for k in want if keep is None or k in keep]
    if not names:
        return [0.0]
    median = statistics.median(want[k] for k in names)
    return sorted(abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in names)


def train_numbers(got: dict, want: dict) -> Dict[str, float]:
    """The compared numbers take the median leaf's gap; the worst leaf's are
    readings beside them (``*_worst``)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], want["losses"]))
    median_g = statistics.median(want["grad"].values())
    moving = {k for k, v in want["grad"].items() if v >= SKIP_BELOW * median_g}
    first = abs(got["losses"][0] - want["losses"][0]) / max(abs(want["losses"][0]), 1e-30)
    out = {"loss_gap": loss, "loss1_gap": first}
    for name, key, keep in (("grad", "grad", None), ("update", "change", moving),
                            ("stats", "stats", None)):
        gaps = _leaf_gaps(got[key], want[key], keep)
        out[f"{name}_gap"] = statistics.median(gaps)
        out[f"{name}_worst"] = gaps[-1]
    return out


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    num = den = 0.0
    for a, b in zip(got.split(1), want.split(1)):   # a sample at a time: no large temporaries
        b = b.double()
        num += float(torch.linalg.vector_norm(a.to(b.device).double() - b) ** 2)
        den += float(torch.linalg.vector_norm(b) ** 2)
    return (num / max(den, 1e-300)) ** 0.5


def eval_batch_numbers(logits, loss: float, before, after, ref_logits, ref_loss: float,
                       counts) -> Dict[str, float]:
    """One batch's numbers (see ``harness.eval_numbers``)."""
    expect = before.float() + counts.float()
    return {"logits_gap": rel_l2(logits, ref_logits),
            "loss_gap": abs(loss - ref_loss) / max(abs(ref_loss), 1e-30),
            "f1_gap": float((after.double() - expect.double()).abs().sum()
                            / max(float(counts.sum()), 1.0))}


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    return {k: max(r[k] for r in rows) for k in rows[0]}


def judge(numbers: Dict[str, float], limits: Dict[str, dict]) -> dict:
    """Each number beside its limit; ``correct`` when every number is within
    its limit and none is missing or not a number."""
    out, ok = {}, True
    for name, spec in limits.items():
        v = numbers.get(name)
        good = v is not None and np.isfinite(v) and v <= spec["limit"]
        ok = ok and bool(good)
        out[name] = {"value": v, "limit": spec["limit"]}
    return {"correct": ok, "numbers": out}


def report(verdict: dict) -> None:
    """The numbers beside their limits, as the last lines on stderr."""
    for name, v in verdict["numbers"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(f"check correct: {verdict['correct']}", file=sys.stderr, flush=True)
