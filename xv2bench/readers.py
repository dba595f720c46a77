"""What a per-layer metric reads: the untraced window's rate and host spans,
the traced slice, the planned kernels' least time and the model's FLOPs.
Each metric is a file of its own under ``metrics/`` whose ``read(reading)``
returns a number, or None where its cell gives it nothing to read."""

from __future__ import annotations

import dataclasses
import statistics
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
