"""``dac_device_ms_per_s.single``: the DAC decoder's span
(``dac.forward``) on the device's clock over the seconds of audio it
made (its ``audio_s``), summed over the traced requests, in ms a second
of audio. The interval between the span's two timing events, the card's
idle inside it included: not busy time."""

from benchmark import program_spans


def read(run):
    return program_spans.device_ms_per(run, "dac.forward", "audio_s")
