"""``dia_graph_replay_pct.single``: the share of the traced requests' Dia
decode steps (``dia.decode_loop``) that replayed a captured step graph
(the rest warmed one up or captured it), in %."""

from benchmark import program_spans


def read(run):
    counts = dict.fromkeys(program_spans.GRAPH_COUNTERS, 0)
    for _, spans in program_spans.requests(run):
        for s in spans:
            if s.name == "dia.decode_loop":
                for k in counts:
                    counts[k] += s.counters.get(k, 0)
    steps = sum(counts.values())
    return 100.0 * counts["graph_replays"] / steps if steps else None
