"""``f5_device_ms_per_step.single``: the F5 flow-matching loop's span
(``f5.denoise_loop``, the text encoder left out) on the device's clock
over its steps (one CFG eval of both rows each), summed over the traced
requests, in ms a step. The interval between the span's two timing
events, the card's idle inside it included: not busy time."""

from benchmark import program_spans


def read(run):
    return program_spans.device_ms_per(run, "f5.denoise_loop", "steps")
