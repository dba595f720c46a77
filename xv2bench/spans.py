"""The program's own spans of the traced slice (``xview2_tpu_torch.utils.spans``),
in milliseconds a call of the cell's step.

The spans record only while a profiler collects, and the traced slice is the
only profiler session of a ``--trace 1`` run, so the registry holds the
slice's calls alone; the readers run after ``free_program``'s synchronize,
so every event pair has completed.  A program without the spans gives
nothing to read, and every reader then returns None."""

from __future__ import annotations

from typing import Optional


def _summary() -> dict:
    try:
        from xview2_tpu_torch.utils import spans
    except ImportError:
        return {}
    return spans.summary()


def span_ms(r, kind: str, name: str, clock: str) -> Optional[float]:
    """The span ``name``'s ``clock`` ("host" or "device") milliseconds over
    the calls of the ``kind`` step span; None on another kind of cell,
    where the span or its device time is missing, or where the step span's
    calls are not the slice's steps."""
    if r.kind != kind or r.slice is None:
        return None
    got = _summary()
    step, s = got.get(f"{kind}.step"), got.get(name)
    if step is None or s is None or step.calls != r.slice.steps:
        return None
    seconds = s.device_s if clock == "device" else s.host_s
    return None if seconds is None else seconds / step.calls * 1e3
