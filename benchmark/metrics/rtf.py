"""``rtf``: the window's wall over the audio seconds its utterances
produced, every request of the window counted (a failed one adds its
wall and no audio). Closed loop: the window runs from the first
request's send to the last one's result."""


def read(run):
    audio = sum(len(r.result.audio) / r.result.sample_rate
                for r in run.done)
    if not run.records or audio <= 0:
        return None
    return (run.closed - run.opened) / audio
