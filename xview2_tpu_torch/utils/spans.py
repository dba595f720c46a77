"""Named spans of the train and eval steps, recorded only while a torch
profiler collects.

``with span("train.forward"): ...`` marks one phase of a step.  While no
``torch.profiler`` or ``torch.autograd.profiler`` session collects (checked
once per entry) it returns a shared no-op context: whether anyone profiles
(``fit --profile``, a benchmark's traced slice, an operator's own profiler)
is the only switch.  While one collects, a span:

- enters ``torch.profiler.record_function(name)``, so that it lies in the
  profiler's chrome trace beside the kernels and on the profiler's clock: a
  host ``user_annotation`` and, where it launched device work, a
  ``gpu_user_annotation``;
- reads the host's ``perf_counter_ns`` at entry and exit;
- where its work runs on a CUDA device (the ``device`` it is given),
  records a pair of timing events on that device's current stream around
  its work.

While the current stream captures a CUDA graph, a span on a CUDA device is
the no-op too: the capture runs nothing.

Spans nest per thread: a span's parent is the span open around it on its
thread, and its step is the ordinal, since :func:`reset`, of the outermost
span open on its thread (the step span).  Only aggregates by name are kept,
and an event pair is resolved as soon as its end event has completed
(polled at each span's exit, all of them in :func:`summary`), so memory is
bounded by the spans still running on the device.

The program's spans (``parallel/steps.py``, ``ops/autoaugment.py``); the
children of a step span tile it, so nothing the step enqueues falls outside
a child:

- ``train.step``: the whole of ``make_train_step``'s step; under it, in
  order, ``train.h2d`` (the inputs' copies to the device), ``train.augment``
  (``augment_batch``; under ``--autoaugment`` it holds ``augment.sync``,
  ``slot_plan``'s read of the draws to the host), ``train.forward`` (the
  labels' loss views, the forward and the loss), ``train.backward`` (the
  backward and the gradients' average over the ranks) and ``train.update``
  (the learning rate, the optimizer's step, zeroing the gradients).  A CUDA
  graph of K train steps (``make_train_multistep``) records, at its first
  call, the K eager steps of its warm-up (its capture records nothing), and
  at each replay one ``train.step`` for its K steps, under it ``train.h2d``
  (the inputs' copies into the graph's buffers) and ``train.replay`` (the
  steps' draws, the optimizer's table of per-step scalars, the replay).
- ``eval.step``: the whole of ``make_eval_step``'s step; under it
  ``eval.h2d``, ``eval.forward`` (normalize, the TTA forward, the cast to
  float32) and ``eval.score`` (the relayout, the loss, the F1 counters).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, Optional

import torch

_collecting = torch._C._autograd._profiler_enabled


@dataclasses.dataclass(frozen=True)
class Stats:
    """What the spans of one name recorded since the last :func:`reset`."""

    calls: int                 # spans closed
    steps: int                 # distinct steps (outermost spans) they fell in
    parent: Optional[str]      # the span open around the first of them (None: outermost)
    host_s: float              # host seconds from entry to exit, summed
    self_host_s: float         # host_s less the host seconds of the spans directly inside
    device_s: Optional[float]  # the device timeline from the start event to the end event,
    #                            idle inside included, summed; None unless every call
    #                            recorded its events (None off CUDA)


class _Agg:
    __slots__ = ("parent", "calls", "steps", "last_step", "host_ns", "inner_ns", "device_ms",
                 "timed")

    def __init__(self, parent: Optional[str]):
        self.parent = parent
        self.calls = self.steps = self.timed = 0
        self.last_step = -1
        self.host_ns = self.inner_ns = 0
        self.device_ms = 0.0


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()
        self.aggs: Dict[str, _Agg] = {}
        self.pending: collections.deque = collections.deque()  # (agg, start, end)
        self.steps = 0

    def stack(self) -> list:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def resolve(self, wait: bool) -> None:
        """Add the device time of each pending pair whose end has completed,
        in the order they closed; with ``wait``, of every pending pair."""
        while True:
            with self.lock:
                if not self.pending:
                    return
                agg, start, end = self.pending[0]
                if not wait and not end.query():
                    return
                self.pending.popleft()
            if wait:
                end.synchronize()
            ms = start.elapsed_time(end)
            with self.lock:
                agg.device_ms += ms
                agg.timed += 1


_REGISTRY = _Registry()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "stream", "agg", "parent", "step", "record", "events", "t0",
                 "inner_ns")

    def __init__(self, name: str, stream: Optional[torch.cuda.Stream]):
        self.name, self.stream = name, stream

    def __enter__(self):
        reg = _REGISTRY
        stack = reg.stack()
        self.parent = stack[-1] if stack else None
        with reg.lock:
            if self.parent is None:
                reg.steps += 1
            self.step = self.parent.step if self.parent else reg.steps
            self.agg = reg.aggs.get(self.name)
            if self.agg is None:
                self.agg = reg.aggs[self.name] = _Agg(self.parent and self.parent.name)
        self.record = torch.profiler.record_function(self.name)
        self.record.__enter__()
        self.events = None
        if self.stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        self.inner_ns = 0
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        took = time.perf_counter_ns() - self.t0
        reg = _REGISTRY
        if self.events is not None:
            self.events[1].record(self.stream)
        self.record.__exit__(*exc)
        reg.stack().pop()
        if self.parent is not None:
            self.parent.inner_ns += took
        agg = self.agg
        with reg.lock:
            agg.calls += 1
            if agg.last_step != self.step:
                agg.steps += 1
                agg.last_step = self.step
            agg.host_ns += took
            agg.inner_ns += self.inner_ns
            if self.events is not None:
                reg.pending.append((agg, *self.events))
        reg.resolve(wait=False)
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A context that records the span ``name`` while a profiler collects,
    and does nothing otherwise.  ``device`` is where the span's work runs:
    its events are recorded only on a CUDA device (None: on the host)."""
    if not _collecting():
        return _OFF
    if device is None or torch.device(device).type != "cuda":
        return _Span(name, None)
    if torch.cuda.is_current_stream_capturing():
        return _OFF
    return _Span(name, torch.cuda.current_stream(device))


def summary() -> Dict[str, Stats]:
    """The spans recorded since the last :func:`reset`, by name, in the
    order each name was first entered.  Waits for the device to reach the
    end events still pending."""
    _REGISTRY.resolve(wait=True)
    with _REGISTRY.lock:
        return {name: Stats(calls=a.calls, steps=a.steps, parent=a.parent,
                            host_s=a.host_ns * 1e-9, self_host_s=(a.host_ns - a.inner_ns) * 1e-9,
                            device_s=a.device_ms * 1e-3 if a.calls and a.timed == a.calls
                            else None)
                for name, a in _REGISTRY.aggs.items()}


def reset() -> None:
    """Forget every span recorded so far (and the spans open now, when they
    close)."""
    with _REGISTRY.lock:
        _REGISTRY.aggs.clear()
        _REGISTRY.pending.clear()
        _REGISTRY.steps = 0
