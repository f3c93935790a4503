"""The check decides: a whole run at tiny sizes on the CPU (the look for
a card skipped) reads ``correct`` true, and false once the timed path is
broken underneath in each way the cells can break: a denoising step that
returns its state unchanged, a token altered where it is sampled, audio
altered where the vocoder makes it. (The cells run one row at a time on
one card: no batch to leave half of out, no exchange between cards.)"""

import time

import pytest
import torch

import benchmark.run as R

SINGLE = ["int8-single", "f32-single"]


def _run(tiny_cell, cell):
    spec, c, config, mix = tiny_cell(cell)
    return R.run_cell(spec, c, 20240601, 2.0, False, torch.device("cpu"),
                      time.monotonic(), config=config, mix=mix)


@pytest.mark.parametrize("cell", SINGLE)
def test_a_sound_run_is_correct(tiny_cell, cell):
    out = _run(tiny_cell, cell)
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1


def _step_unchanged(monkeypatch):
    from tortoise_tpu_torch.pipeline import diffusion_stage

    monkeypatch.setattr(diffusion_stage, "posterior_step",
                        lambda sched, cfg, x, *a, **k: x)


def _token_altered(monkeypatch):
    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.ops import sampling

    def shift(tok, v=40):
        return ((tok.long() + v // 2) % v).to(tok.dtype)

    first = sampling.sample_from_topk_u
    step = ar.decode_sample_step
    monkeypatch.setattr(sampling, "sample_from_topk_u",
                        lambda *a, **k: shift(first(*a, **k)))
    monkeypatch.setattr(ar, "decode_sample_step", lambda *a, **k: (
        lambda out: (shift(out[0]), out[1]))(step(*a, **k)))


def _audio_altered(monkeypatch):
    from tortoise_tpu_torch.models import vocoder

    forward = vocoder.vocoder_forward

    def late_half_silent(*a, **k):
        x = forward(*a, **k)
        x[..., x.shape[-1] // 2:] = 0.0
        return x

    monkeypatch.setattr(vocoder, "vocoder_forward", late_half_silent)


FAULTS = ([(c, _step_unchanged) for c in SINGLE]
          + [(c, _token_altered) for c in SINGLE]
          + [(c, _audio_altered) for c in SINGLE])


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__[1:]}" for c, f in FAULTS])
def test_a_broken_path_is_not_correct(tiny_cell, cell, fault, monkeypatch):
    fault(monkeypatch)
    out = _run(tiny_cell, cell)
    assert not out["correct"], out["check"]
