"""The port's spans and counters, and its Chrome-trace exporter.

- ``span(name, device=None, **counters)``: a context manager around one
  unit of the program's work (a request, a stage, a leaf pass, a graph
  capture). It always measures its host duration on
  ``time.monotonic_ns()`` (``t0``, ``t1``, ``s``: the stages fill
  ``SynthesisResult.timings`` from it) and holds counters (``add``).
  While a ``torch.profiler`` session is active it also RECORDS:

  1. it goes to a bounded in-memory ring (``RING`` spans, read by
     ``records()``) with its id, its parent's id, its request id (the id
     of the outermost span open in its thread) and its counters;
  2. it opens a profiler CPU range ``tt.<name>`` that kineto does not
     mirror onto the device timeline (``_RecordFunctionFast``: not a
     user annotation, as ``record_function``'s ranges are), so the
     Chrome trace shows the program's ranges beside the kernels and the
     device's events hold only the device's work;
  3. on a CUDA device it records a timing event on the current stream at
     its start and at its end (none while that stream captures a graph),
     so it also has a device-clock interval, ``dev``: seconds from its
     request's start event, resolved by ``records()``.

  ``dev`` is an interval, not busy time: it holds whatever idle the card
  has between those two events (waits for the host inside the span).
  ``device`` is inherited from the enclosing span when not given. With
  recording off a span costs a flag check and two clock reads.
- ``count(name, n)``: add to the innermost open span of the thread,
  while recording.
- ``trace(log_dir)``: a ``torch.profiler`` session around a block (the
  CLI's synthesis, the server's serving), written as a Chrome trace
  (Perfetto, TensorBoard) when a directory is given or
  ``TORTOISE_TRACE_DIR`` is set; a no-op otherwise.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import List, Optional

import torch
from torch.autograd import profiler as _profiler

try:  # a profiler range kineto does not mirror onto the device
    from torch._C._profiler import _RecordFunctionFast as _Range
except ImportError:  # an older torch: the spans open no range
    _Range = None

PREFIX = "tt."
RING = 4096

_ring: "collections.deque" = collections.deque(maxlen=RING)
_ring_lock = threading.Lock()
_ids = itertools.count(1)
_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def _timing_event(device):
    """A timing event recorded now on ``device``'s current stream, or
    None when that stream is capturing a graph."""
    if torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


class span:
    """One unit of the program's work (module docstring)."""

    __slots__ = ("name", "device", "counters", "t0", "t1", "id", "parent",
                 "request", "dev", "_on", "_range", "_ev0", "_ev1", "_ref")

    def __init__(self, name: str, device=None, **counters):
        self.name = name
        self.device = None if device is None else torch.device(device)
        self.counters = counters
        self.t0 = self.t1 = 0
        self.id = self.parent = self.request = None
        self.dev = None
        self._on = False
        self._range = self._ev0 = self._ev1 = self._ref = None

    def __enter__(self) -> "span":
        if _profiler._is_profiler_enabled:
            self._open()
        self.t0 = time.monotonic_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.monotonic_ns()
        if self._on:
            self._close()
        return False

    @property
    def s(self) -> float:
        """Host seconds from entry to exit."""
        return (self.t1 - self.t0) / 1e9

    def add(self, name: str, n=1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def _open(self) -> None:
        stack = _stack()
        self.id = next(_ids)
        if stack:
            top = stack[-1]
            self.parent, self.request = top.id, top.request
            if self.device is None:
                self.device = top.device
            self._ref = top._ref
        else:
            self.request = self.id
        if _Range is not None:
            self._range = _Range(PREFIX + self.name)
            self._range.__enter__()
        if self.device is not None and self.device.type == "cuda":
            self._ev0 = _timing_event(self.device)
            if self._ref is None:
                self._ref = self._ev0
        stack.append(self)
        self._on = True

    def _close(self) -> None:
        if self._ev0 is not None:
            self._ev1 = _timing_event(self.device)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        with _ring_lock:
            _ring.append(self)

    def _resolve(self) -> None:
        """``dev`` from the timing events (waits for the end event)."""
        if self.dev is not None or self._ev1 is None or self._ref is None:
            return
        self._ev1.synchronize()
        self.dev = (self._ref.elapsed_time(self._ev0) / 1e3,
                    self._ref.elapsed_time(self._ev1) / 1e3)
        self._ev0 = self._ev1 = None

    def __repr__(self) -> str:
        return (f"span({self.name!r}, id={self.id}, parent={self.parent}, "
                f"request={self.request}, s={self.s:.6f}, dev={self.dev}, "
                f"counters={self.counters})")


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span of this
    thread, while recording."""
    if _profiler._is_profiler_enabled:
        stack = getattr(_tls, "stack", None)
        if stack:
            stack[-1].add(name, n)


def records() -> List[span]:
    """The recorded spans, in the order they closed (children before
    their parent), each with its device interval resolved."""
    with _ring_lock:
        spans = list(_ring)
    for s in spans:
        s._resolve()
    return spans


def clear() -> None:
    """Empty the ring."""
    with _ring_lock:
        _ring.clear()


def _all_threads():
    """A profiler config that takes every thread's ops and ranges (the
    server's worker and request threads), where this torch offers it;
    else None, and only the calling thread's are taken."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block with torch.profiler (CPU activity, and
    CUDA activity when a card is present) into
    ``<log_dir>/trace_<pid>_<n>.json`` when a directory is configured;
    no-op otherwise. Yields the profiler (None when off). The program's
    spans record while it runs, so the trace holds their ``tt.`` ranges
    beside the kernels, from every thread where this torch offers it."""
    log_dir = log_dir or os.environ.get("TORTOISE_TRACE_DIR")
    if not log_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_all_threads()) as prof:
        yield prof
    n = sum(f.startswith(f"trace_{os.getpid()}_") for f in os.listdir(log_dir))
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))
