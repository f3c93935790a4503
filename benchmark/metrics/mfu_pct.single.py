"""``mfu_pct.single``: the model FLOPs of the window's utterances, each
product class at its own published peak, as least time over the
window's wall, in % (``benchmark.readers.mfu_pct``)."""

from benchmark import readers


def read(run):
    return readers.mfu_pct(run)
