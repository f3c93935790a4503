"""The port's on-device sampling loop (``ar_stage._generate``) ends where
a loop that reads its all-stop flag every step ends: the lazy flag read
(every ``STOP_CHECK_STEPS`` steps) drops the steps it runs past the
all-stop step, and the kept tokens and per-row lengths are the same.

The sampled tokens are scripted: the decode step and the sampler are
replaced by stand-ins that return the next column of a token table."""

import dataclasses

import pytest
import torch

from tortoise_tpu_torch.config import tiny_ar_config
from tortoise_tpu_torch.pipeline import ar_stage as TS

STOP = tiny_ar_config().stop_mel_token


def reference_loop(script, max_steps):
    """The rule with a flag read every step: append until every row's
    latest token is stop; lengths count a row's tokens up to and
    including its first stop."""
    b = len(script)
    tokens = [[row[0]] for row in script]
    finished = [row[0] == STOP for row in script]
    lengths = [1] * b
    step = 1
    while step < max_steps and not all(t[-1] == STOP for t in tokens):
        for r in range(b):
            tok = script[r][step]
            if not finished[r]:
                lengths[r] += 1
            finished[r] = finished[r] or tok == STOP
            tokens[r].append(tok)
        step += 1
    return tokens, lengths


def run_generate(monkeypatch, script, max_steps):
    cfg = dataclasses.replace(tiny_ar_config(), max_decode_steps=max_steps)
    column = iter(range(len(script[0])))
    table = torch.tensor(script, dtype=torch.int64)

    def sample(u, probs, ids):
        return table[:, next(column)]

    monkeypatch.setattr(TS.S, "process_logits_topk",
                        lambda *a, **k: (None, None))
    monkeypatch.setattr(TS.S, "sample_from_topk_u", sample)
    monkeypatch.setattr(TS.ar, "can_fuse_sampling", lambda *a, **k: False)
    monkeypatch.setattr(TS.ar, "decode_step",
                        lambda params, cfg, cache, *a, **k: (None, cache))
    first = torch.zeros((len(script), 4))
    gen = torch.Generator().manual_seed(0)
    return TS._generate(None, cfg, first, None, "cache", gen, None,
                        TS.normalize_sampler(None))


@pytest.mark.parametrize("stops", [
    (0, 0),        # every row stops on its first token
    (3, 5),        # the rows stop on different steps
    (8, 8),        # together, on a flag-read boundary
    (9, 2),        # just past one
    (None, 4),     # one row never stops: the loop runs to the maximum
])
def test_lazy_stop_check_keeps_the_per_step_result(monkeypatch, stops):
    max_steps = 20
    script = []
    for r, at in enumerate(stops):
        row = [100 + r] * max_steps
        if at is not None:
            row[at:] = [STOP] * (max_steps - at)
        script.append(row)
    want_tokens, want_lengths = reference_loop(script, max_steps)
    tokens, lengths = run_generate(monkeypatch, script, max_steps)
    assert tokens.tolist() == want_tokens
    assert lengths.tolist() == want_lengths
