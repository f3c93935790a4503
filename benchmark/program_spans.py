"""What the readers of the program's own spans share.

The port records spans (``tortoise_tpu_torch.utils.profiling``) while a
``torch.profiler`` session is active, so a traced run holds the spans of
its traced requests: each with its name, its parent, its host interval
(``time.monotonic_ns()``, the clock of ``harness.now()``), its counters
and, on the card, its interval on the device's clock. A program without
the recorder, or a run that recorded nothing, gives nothing to read, and
each reader then returns None.
"""

from __future__ import annotations

from typing import List, Tuple

# the request spans, and the leaf spans that hold every launch a request
# makes (host glue falls between them)
REQUESTS = ("synthesize", "synthesize_batch")
LEAVES = ("ar.cast", "ar.prefill", "ar.decode_loop", "ar.latent",
          "diffusion.cast", "diffusion.conditioner", "diffusion.denoise_loop",
          "vocoder.forward", "download")
LOOPS = ("ar.decode_loop", "diffusion.denoise_loop")
GRAPH_COUNTERS = ("graph_warmups", "graph_captures", "graph_replays")


def requests(run) -> List[Tuple[object, list]]:
    """(request span, the spans under it) for each complete request span
    whose host interval lies inside the window ``[run.opened,
    run.closed]``, oldest first."""
    try:
        from tortoise_tpu_torch.utils import profiling
    except ImportError:
        return []
    records = getattr(profiling, "records", None)
    if records is None:
        return []
    spans = records()
    lo, hi = run.opened * 1e9, run.closed * 1e9
    roots = {s.id: (s, []) for s in spans
             if s.name in REQUESTS and lo <= s.t0 and s.t1 <= hi}
    if not roots:
        return []
    by_id = {s.id: s for s in spans}
    for s in spans:
        p = s.parent
        while p is not None and p not in roots:
            up = by_id.get(p)
            p = None if up is None else up.parent
        if p is not None:
            roots[p][1].append(s)
    return sorted(roots.values(), key=lambda r: r[0].t0)


def device_s(s) -> float:
    """A span's seconds on the device's clock."""
    return s.dev[1] - s.dev[0]


def device_ms_per(run, name: str, counter: str):
    """Σ device seconds of the spans ``name`` over Σ their ``counter``,
    in ms a unit, over the window's requests."""
    t = n = 0.0
    for _, spans in requests(run):
        for s in spans:
            if s.name == name and s.dev is not None:
                t += device_s(s)
                n += s.counters.get(counter, 0)
    return 1e3 * t / n if n > 0 else None


def _merge(intervals) -> float:
    """The length of the union of ``intervals``."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def host_gap_pct(run):
    """The part of each request span's device interval that lies in no
    leaf span's device interval, over the request spans' device total,
    in %."""
    gap = total = 0.0
    for root, spans in requests(run):
        if root.dev is None:
            continue
        a, b = root.dev
        covered = _merge((max(a, s.dev[0]), min(b, s.dev[1]))
                         for s in spans
                         if s.name in LEAVES and s.dev is not None
                         and min(b, s.dev[1]) > max(a, s.dev[0]))
        gap += (b - a) - covered
        total += b - a
    return 100.0 * gap / total if total > 0 else None


def graph_replay_pct(run):
    """Σ ``graph_replays`` over Σ (warm-ups + captures + replays) on the
    loop spans of the window's requests, in %."""
    counts = dict.fromkeys(GRAPH_COUNTERS, 0)
    for _, spans in requests(run):
        for s in spans:
            if s.name in LOOPS:
                for k in GRAPH_COUNTERS:
                    counts[k] += s.counters.get(k, 0)
    steps = sum(counts.values())
    return 100.0 * counts["graph_replays"] / steps if steps else None
