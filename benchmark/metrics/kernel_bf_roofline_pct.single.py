"""``kernel_bf_roofline_pct.single``: kernel Bf's least time over the
window's utterances (the larger of its f32 products as three TF32 ones
at 495 TFLOP/s, its exps and its bytes, call by call) over its device
time in the trace, in %."""

from benchmark import readers


def read(run):
    return readers.attention_roofline_pct(run, "f32")
