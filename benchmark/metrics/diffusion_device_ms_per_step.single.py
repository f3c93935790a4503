"""``diffusion_device_ms_per_step.single``: the denoising loop's span
(``diffusion.denoise_loop``, the conditioner left out) on the device's
clock over its steps, summed over the traced requests, in ms a step. As
for ``ar_device_ms_per_step.single``, the interval between the span's
two timing events, the card's idle inside it included: not busy time."""

from benchmark import program_spans


def read(run):
    return program_spans.device_ms_per(run, "diffusion.denoise_loop",
                                       "steps")
