"""``dia_mfu_pct.single``: the model FLOPs of the window's Dia requests
(``benchmark.counts.dia``: the encoder's, the prefill's and the decode
steps' products at the bf16 peak, the DAC's at the f32 peak), as least
time over the window's wall (less the profiler's own stop where it fell
inside it), in %."""

from benchmark.counts import dia as counts
from benchmark.families import dia


def read(run):
    wall = run.closed - run.opened - run.extra.get("trace_stop_s", 0.0)
    if not run.done or wall <= 0:
        return None
    c, dc = run.config["dia"], run.config["dac"]
    least = 0.0
    for r in run.done:
        prompt, text, frames, steps = dia.shape(run, r.request)
        least += counts.least_time_s(
            counts.request_flops(c, dc, prompt, text, frames, steps),
            run.config["products"])
    return 100.0 * least / wall
