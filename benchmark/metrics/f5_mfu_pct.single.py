"""``f5_mfu_pct.single``: the model FLOPs of the window's F5 requests
(``benchmark.counts.f5``: the DiT's and the text encoder's products at
the bf16 peak, Vocos's at the f32 peak), as least time over the window's
wall (less the profiler's own stop where it fell inside it), in %."""

from benchmark.counts import f5 as counts
from benchmark.families import f5


def read(run):
    wall = run.closed - run.opened - run.extra.get("trace_stop_s", 0.0)
    if not run.done or wall <= 0:
        return None
    c, vc = run.config["dit"], run.config["vocos"]
    least = 0.0
    for r in run.done:
        t, t_ref, _ = f5.shape(run, r.request)
        least += counts.least_time_s(counts.request_flops(c, vc, t, t_ref),
                                     run.config["products"])
    return 100.0 * least / wall
