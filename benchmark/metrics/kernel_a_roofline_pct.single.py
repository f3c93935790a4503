"""``kernel_a_roofline_pct.single``: kernel A's least time over the
traced utterances (``benchmark.counts.kernel_a``: the bytes each
decode step needs over HBM's rate) over its device time in the trace,
in %."""

from benchmark.counts import kernel_a


def read(run):
    if run.trace is None:
        return None
    dev_s, n = run.trace.kernel_s(kernel_a.SYMBOL)
    if n == 0 or dev_s <= 0:
        return None
    ar = run.config["ar"]
    calls = []
    for r in run.traced_done:
        calls += kernel_a.calls(ar, len(r.request.tokens),
                                int(r.result.timings["ar_decode_steps"]))
    return 100.0 * kernel_a.bound_s(ar, calls) / dev_s
