"""What several metric readers share (each metric keeps its own file in
``benchmark/metrics/``, named as in ``BENCHMARK.json``)."""

from __future__ import annotations

from benchmark.counts import attention, model
from benchmark.families import tortoise
from benchmark.reference import ar as R_ar


def stage_ms_per_step(timings, wall_key: str, steps_key: str):
    """A stage's stage-synced wall over its steps, summed over
    ``timings`` (``SynthesisResult.timings`` dicts), in ms a step."""
    timings = list(timings)
    steps = sum(t.get(steps_key, 0) for t in timings)
    if not steps:
        return None
    return 1e3 * sum(t[wall_key] for t in timings) / steps


def idle_pct(run):
    """The share of the traced window in which nothing ran on the card,
    in %; nothing where nothing ran on one."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu_pct(run):
    """The model FLOPs of the window's finished requests
    (``benchmark.counts.model``), each product class at its own
    published peak (``benchmark.peaks``), as least time over the window's
    wall (less the profiler's own stop where it fell inside it), in %."""
    wall = run.closed - run.opened - run.extra.get("trace_stop_s", 0.0)
    if not run.done or wall <= 0:
        return None
    ar = run.config["ar"]
    least = 0.0
    for r in run.done:
        keep = R_ar.keep_length(r.result.sequences[0], ar)
        least += model.least_time_s(model.request_flops(
            run.config, len(r.request.tokens),
            int(r.result.timings["ar_decode_steps"]), keep,
            tortoise.mel_frames(keep)))
    return 100.0 * least / wall


def attention_roofline_pct(run, plane: str):
    """The denoiser attention kernel's least time over the traced
    utterances (``benchmark.counts.attention``, call by call) over its
    device time in the trace, in %."""
    if run.trace is None:
        return None
    dev_s, n = run.trace.kernel_s(attention.SYMBOLS[plane])
    if n == 0 or dev_s <= 0:
        return None
    c = run.config["diffusion"]
    h, d = c["n_head"], c["d_model"] // c["n_head"]
    bound = 0.0
    for r in run.traced_done:
        keep = len(r.result.latents[0])
        out_len = r.result.mel.shape[-1]
        for rows, t in attention.calls(c, keep, out_len):
            bound += attention.bound_s(rows, t, h, d, plane)
    return 100.0 * bound / dev_s
