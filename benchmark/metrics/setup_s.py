"""``setup_s``: process start to the window's first request: imports,
the weights drawn on the card, the port's casts and kernel builds, and
the entry's warm-up."""


def read(run):
    return run.setup_s
