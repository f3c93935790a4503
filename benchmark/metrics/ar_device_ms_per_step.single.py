"""``ar_device_ms_per_step.single``: the AR sampling loop's span
(``ar.decode_loop``) on the device's clock over its steps, summed over
the traced requests, in ms a step. The span's device interval runs from
the stream reaching its start event to its end event, which the host
records after the loop's stop-flag reads and token download: it holds
the card's idle inside the loop as well as its busy time, so it is an
interval and not busy time (on a loop the host waits on, it reads as
the loop's synced wall)."""

from benchmark import program_spans


def read(run):
    return program_spans.device_ms_per(run, "ar.decode_loop", "steps")
