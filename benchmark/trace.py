"""The traced run's reduction: one ``torch.profiler`` window over the
measured window, reduced to device busy time, kernel time by name and
the longest idle gaps, each labelled by the harness span the host was in.

Spans are the harness's own ``record_function`` ranges named
``bench.<what>`` around its calls into the entry; ``bench.window``
brackets the measured window. Device time is every event the profiler
puts on the card (kernels, copies, fills), clipped to the window; busy
time is their union, so overlapping kernels count once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

SPAN_PREFIX = "bench."
WINDOW = SPAN_PREFIX + "window"
TOP = 10
NAME_CHARS = 120


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]]   # name -> (device s, count)
    idle_gaps: List[list]                    # [label, s], longest first

    def kernel_s(self, symbol: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds
        ``symbol``."""
        s = n = 0
        for name, (t, c) in self.kernels.items():
            if symbol in name:
                s, n = s + t, n + c
        return s, n

    def device_ops(self) -> List[list]:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
        return [[name[:NAME_CHARS], t] for name, (t, _) in top]


def span(name: str):
    """A harness span around one call into the entry."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


def profiler():
    import torch
    from torch.profiler import ProfilerActivity

    return torch.profiler.profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


def reduce(prof) -> Trace:
    """The window's numbers from a finished profile (module docstring)."""
    from torch.autograd import DeviceType

    events = prof.profiler.kineto_results.events()
    w0 = w1 = None
    spans, device = [], []
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            if name.startswith(SPAN_PREFIX):
                continue  # a span's mirror on the device timeline
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                           name))
        elif name == WINDOW:
            w0, w1 = e.start_ns(), e.start_ns() + e.duration_ns()
        elif name.startswith(SPAN_PREFIX):
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                          name[len(SPAN_PREFIX):]))
    if w0 is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    kernels: Dict[str, list] = {}
    clipped = []
    for a, b, name in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        k = kernels.setdefault(name, [0.0, 0])
        k[0] += (b - a) / 1e9
        k[1] += 1
    busy = _merge(clipped)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:TOP]

    def label(t):
        inner = [s for s in spans if s[0] <= t <= s[1]]
        return min(inner, key=lambda s: s[1] - s[0])[2] if inner \
            else "harness"

    return Trace(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(b - a for a, b in busy) / 1e9,
        kernels={k: (v[0], v[1]) for k, v in kernels.items()},
        idle_gaps=[[f"{label(a + d / 2)} +{(a - w0) / 1e9:.1f}s", d / 1e9]
                   for d, a in gaps])
