"""``kernel_b_roofline_pct.single``: kernel B's least time over the
window's utterances (the larger of its bf16 products at 989 TFLOP/s,
its exps and its bytes, call by call) over its device time in the
trace, in %."""

from benchmark import readers


def read(run):
    return readers.attention_roofline_pct(run, "bf16")
