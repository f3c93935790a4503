"""``idle_pct.single``: the share of the traced window in which nothing
ran on the card, in %."""

from benchmark import readers


def read(run):
    return readers.idle_pct(run)
