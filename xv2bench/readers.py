"""What a per-layer metric reads: the untraced window's rate and host spans,
the traced slice, the planned kernels' least time, the model's FLOPs, and
the cell itself with the batch and tile of its timed call.  Each metric is a
file of its own under ``metrics/`` whose ``read(reading)`` returns a number,
or None where its cell gives it nothing to read."""

from __future__ import annotations

import dataclasses
import statistics
import sys
from typing import List, Optional, Sequence

from xv2bench import trace
from xv2bench.work import kernels


@dataclasses.dataclass
class Reading:
    kind: str                        # "train" or "eval": the cell's timed call
    tiles_per_s: float               # over the untraced window
    calls: int                       # in the untraced window
    wall_s: float                    # the untraced window
    host_call_s: List[float]         # the host's wall time of each call
    slice: trace.Slice
    kernel_bound_s: Optional[float]  # least time of the slice's port-kernel launches
    flops_per_tile: float
    cell: object = None              # cells.Cell: its config and traffic dicts, its reference
    batch: int = 0                   # the timed call's batch (tiles)
    tile: int = 0                    # the side of its input: the crop in training, the tile at eval


def host_call_ms(r: Reading, kind: str) -> Optional[float]:
    """Median host wall time of one call."""
    return statistics.median(r.host_call_s) * 1e3 if r.kind == kind else None


def device_ms(r: Reading, kind: str, categories: Sequence[str]) -> Optional[float]:
    """Device milliseconds a call in ``categories``."""
    if r.kind != kind:
        return None
    return sum(r.slice.by_category.get(c, 0.0) for c in categories) / r.slice.steps * 1e3


def kernel_roofline(r: Reading, kind: str) -> Optional[float]:
    """The slice's K1-K6 launches: their least time over their device time, %."""
    spent = sum(r.slice.by_category.get(c, 0.0) for c in trace.PORT_KERNELS)
    if r.kind != kind or r.kernel_bound_s is None or spent <= 0:
        return None
    return 100.0 * r.kernel_bound_s / spent


def named_roofline(r: Reading, names: Sequence[str],
                   bounds_s: Optional[Sequence[float]]) -> Optional[float]:
    """One kernel's launches in the slice (device ops whose names hold one of
    ``names``): the least time of the launches planned for a call
    (``bounds_s``) times the slice's calls, over their device time, in %;
    None where nothing is planned or the launches seen are not the launches
    planned."""
    if bounds_s is None or r.slice is None:
        return None
    picked = [n for n in r.slice.by_name if any(k in n for k in names)]
    seen = sum(r.slice.launches_by_name[n] for n in picked)
    spent = sum(r.slice.by_name[n] for n in picked)
    if seen != len(bounds_s) * r.slice.steps:
        print(f"{seen} launches of {names} in the slice, {len(bounds_s)} planned a call over "
              f"{r.slice.steps} calls: no roofline", file=sys.stderr)
        return None
    if spent <= 0:
        return None
    return 100.0 * sum(bounds_s) * r.slice.steps / spent


def mfu(r: Reading, kind: str) -> Optional[float]:
    """Model FLOPs a second of the untraced window over the bf16 peak, %."""
    if r.kind != kind:
        return None
    return 100.0 * r.flops_per_tile * r.tiles_per_s / kernels.PEAK_FLOPS_BF16


def idle_share(r: Reading, kind: str) -> Optional[float]:
    """1 - the device's busy time a call (the slice's union of intervals)
    over the wall time a call (the untraced window), %."""
    if r.kind != kind or r.calls == 0:
        return None
    return 100.0 * (1.0 - (r.slice.busy_s / r.slice.steps) / (r.wall_s / r.calls))
