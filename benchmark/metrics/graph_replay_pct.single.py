"""``graph_replay_pct.single``: the share of the traced requests' loop
steps that replayed a captured step graph (the rest warmed one up or
captured it), in %."""

from benchmark import program_spans


def read(run):
    return program_spans.graph_replay_pct(run)
