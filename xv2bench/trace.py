"""Reading a ``torch.profiler`` chrome trace of a steady slice of steps: device
time and launches by category and by kernel name, the union of the
device's busy intervals, and its idle gaps labelled by the host op that
launched the work that ended each gap.

The categories are the port's smoke test's table of kernel-name fragments
(first match wins): the port's kernels K1-K8, the library convolutions and
matrix products, the elementwise and reduction passes, and copies.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from typing import Dict, List, Tuple

CATEGORIES = (("K6 row_shift", ("row_shift_kernel",)),
              ("K7 small_conv_fwd", ("small_fwd_mma_kernel", "small_fwd_f32_kernel")),
              ("K8 small_conv_wgrad", ("small_wgrad_mma_kernel", "small_wgrad_sum_kernel",
                                       "small_wgrad_f32_kernel")),
              ("K4 conv_bn_wgrad", ("wgrad_wgmma_kernel", "wgrad_bf16_kernel",
                                    "wgrad_f32_kernel")),
              ("K5 conv_bn_dgrad", ("dgrad_wgmma_kernel", "dgrad_bf16_kernel",
                                    "dgrad_f32_kernel")),
              ("K2 conv_bn_fused", ("conv_wgmma_kernel", "conv_bf16_kernel", "conv_f32_kernel")),
              ("K3 head_conv_fused", ("head_mma_kernel", "head_kernel")),
              ("K1 relayout", ("relayout_",)),
              ("library conv/GEMM", ("xmma", "cudnn", "cutlass", "gemm", "conv")),
              ("elementwise", ("elementwise", "reduce")),
              ("cat/copy", ("CatArray", "copy", "Memcpy", "Memset")))
PORT_KERNELS = ("K1 relayout", "K2 conv_bn_fused", "K3 head_conv_fused", "K4 conv_bn_wgrad",
                "K5 conv_bn_dgrad", "K6 row_shift")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def category(name: str) -> str:
    return next((c for c, keys in CATEGORIES if any(k in name for k in keys)), "other")


@dataclasses.dataclass
class Slice:
    steps: int
    window_s: float                     # the slice's wall time on the host's clock
    busy_s: float                       # union of the device's busy intervals
    by_category: Dict[str, float]       # device seconds
    launches: Dict[str, int]
    top_ops: List[Tuple[str, float]]    # the most device seconds by kernel name
    idle_gaps: List[Tuple[str, float]]  # idle seconds by the host op that ended the gap
    by_name: Dict[str, float] = dataclasses.field(default_factory=dict)  # every kernel name
    launches_by_name: Dict[str, int] = dataclasses.field(default_factory=dict)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _innermost_op(ops: List[dict], starts: List[float], tid, ts: float) -> str:
    """The shortest CPU op on thread ``tid`` that contains time ``ts``."""
    best, best_dur = None, float("inf")
    for j in range(bisect.bisect_right(starts, ts) - 1, -1, -1):
        e = ops[j]
        if e["tid"] == tid and e["ts"] <= ts <= e["ts"] + e["dur"] and e["dur"] < best_dur:
            best, best_dur = e["name"], e["dur"]
        if ts - e["ts"] > best_dur:   # an op that starts earlier is longer
            break
    return best or "host (no op)"


def summarize(events: List[dict], steps: int, window_s: float, top: int = 10) -> Slice:
    """``events``: the ``traceEvents`` of a chrome trace (times in us)."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    by_cat: Dict[str, float] = {}
    launches: Dict[str, int] = {}
    by_name: Dict[str, float] = {}
    by_name_n: Dict[str, int] = {}
    for e in dev:
        c = category(e["name"])
        by_cat[c] = by_cat.get(c, 0.0) + e["dur"] * 1e-6
        launches[c] = launches.get(c, 0) + 1
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
        by_name_n[e["name"]] = by_name_n.get(e["name"], 0) + 1
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    gaps = sorted(((b[0] - a[1], b[0]) for a, b in zip(busy, busy[1:])), reverse=True)
    # label a gap by the host op that launched the first device op after it
    ops = sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "cpu_op"),
                 key=lambda e: e["ts"])
    starts = [e["ts"] for e in ops]
    runtime = {e.get("args", {}).get("correlation"): e for e in events
               if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"}
    first_at = {}
    for e in dev:
        first_at.setdefault(e["ts"], e)
    labels: Dict[str, float] = {}
    for length, end in gaps[:200]:
        kernel = first_at.get(end)
        launch = runtime.get((kernel or {}).get("args", {}).get("correlation"))
        name = (_innermost_op(ops, starts, launch["tid"], launch["ts"]) if launch
                else "no launch found")
        labels[name] = labels.get(name, 0.0) + length * 1e-6
    return Slice(steps, window_s, sum(b - a for a, b in busy) * 1e-6, by_cat, launches,
                 sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
                 sorted(labels.items(), key=lambda kv: -kv[1])[:top], by_name, by_name_n)


def read_chrome_trace(path: str, steps: int, window_s: float) -> Slice:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"], steps, window_s)
