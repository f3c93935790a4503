"""``f5_attention_roofline_pct.single``: kernel B's least time in the F5
loops of the traced requests (``benchmark.counts.f5``: 22 calls an eval
over both rows at the loop's padded length, read from the
``f5.denoise_loop`` span's ``frames`` and ``steps``) over B's device
time in the trace, in %."""

from benchmark import program_spans
from benchmark.counts import attention
from benchmark.counts import f5 as counts


def read(run):
    if run.trace is None:
        return None
    dev_s, n = run.trace.kernel_s(attention.SYMBOLS["bf16"])
    if n == 0 or dev_s <= 0:
        return None
    bound = 0.0
    for _, spans in program_spans.requests(run):
        for s in spans:
            if s.name == "f5.denoise_loop":
                bound += counts.attention_bound_s(
                    run.config["dit"], s.counters.get("frames", 0),
                    s.counters.get("steps", 0))
    return 100.0 * bound / dev_s if bound > 0 else None
