"""``dia_device_ms_per_step.single``: the Dia decode loop's span
(``dia.decode_loop``; the encoder and the prefill left out) on the
device's clock over its steps (one decoder position of both CFG rows and
the sampler each), summed over the traced requests, in ms a step. The
interval between the span's two timing events, the card's idle inside it
included: not busy time."""

from benchmark import program_spans


def read(run):
    return program_spans.device_ms_per(run, "dia.decode_loop", "steps")
