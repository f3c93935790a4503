"""``dia_step_roofline_pct.single``: the Dia decode loops' least time at
the card's memory bandwidth (``benchmark.counts.dia.loop_bound_s``: each
step reads the bf16 weights it multiplies, the self K/V of its valid
positions and the text's cross K/V; read from the ``dia.decode_loop``
span's ``prompt``, ``text`` and ``steps``) over those spans' device
time, summed over the traced requests, in %."""

from benchmark import program_spans
from benchmark.counts import dia as counts


def read(run):
    bound = dev = 0.0
    for _, spans in program_spans.requests(run):
        for s in spans:
            if s.name == "dia.decode_loop" and s.dev is not None:
                k = s.counters
                if not {"prompt", "text", "steps"} <= set(k):
                    continue
                bound += counts.loop_bound_s(run.config["dia"], k["prompt"],
                                             k["text"], k["steps"])
                dev += program_spans.device_s(s)
    return 100.0 * bound / dev if bound > 0 and dev > 0 else None
