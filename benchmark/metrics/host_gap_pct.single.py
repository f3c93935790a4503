"""``host_gap_pct.single``: the share of the traced requests' time on
the device's clock that lies between the program's leaf spans (the card
waiting on host glue between stages), in %."""

from benchmark import program_spans


def read(run):
    return program_spans.host_gap_pct(run)
