"""The port's streaming path (``pipeline/streaming.py``) against the JAX
package's on tiny random weights, with the port's random streams
replaced by the JAX package's key chains (``replay_jax_streams``).

Tolerances: mel spans within 1e-4 of the reference's max magnitude at
f32 (the same loop on the same noise; only summation order differs);
audio chunks within 1e-4; the whole f32 stream within 1e-3 like the
one-shot slice (tests/test_torch_slice.py). Chunked vocoding equals the
port's own full pass bit for bit at the tiny widths; at the production
widths within 1e-3 of its max: the CPU convolutions sum in an order that
depends on the input's length, and this random vocoder moves its output
by ~3e-4 of its max for a 1e-7 relative change of its input.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tortoise_tpu.config import (
    VocoderConfig,
    mel_length_for_latents,
    tiny_diffusion_config,
    tiny_vocoder_config,
)
from tortoise_tpu.io.checkpoint import (
    random_diffusion_params,
    random_vocoder_params,
)
from tortoise_tpu.pipeline import streaming as JST
from tortoise_tpu.pipeline import synthesize as J
from tortoise_tpu_torch.pipeline import streaming as TST
from tortoise_tpu_torch.pipeline import synthesize as T
from tortoise_tpu_torch.pipeline.common import round_up
from tortoise_tpu_torch.pipeline.vocoder_stage import audio_length

from test_torch_batch import close, replay_jax_streams


@pytest.fixture(scope="module")
def dparams():
    return random_diffusion_params(tiny_diffusion_config(), seed=2)


def _latents(seed, n):
    return np.random.default_rng(seed).normal(0, 0.5, (1, n, 64)) \
        .astype(np.float32)


def _both_windows(dparams, keep, lat, **geom):
    cfg = dataclasses.replace(tiny_diffusion_config(), n_sample_timesteps=10)
    want = list(JST.stream_mel_windows(dparams, cfg, jnp.asarray(lat), keep,
                                       seed=9, **geom))
    got = list(TST.stream_mel_windows(dparams, cfg, torch.tensor(lat), keep,
                                      seed=9, device="cpu", **geom))
    return got, want


@pytest.mark.parametrize("geom", [
    dict(window_frames=24, overlap_frames=8),
    dict(window_frames=24, overlap_frames=8, first_window_frames=12),
    dict(window_frames=16, overlap_frames=0, first_window_frames=40),
    dict(window_frames=64, overlap_frames=8),      # one window
])
def test_mel_windows_match_jax(dparams, monkeypatch, geom):
    replay_jax_streams(monkeypatch)
    keep = 15
    got, want = _both_windows(dparams, keep, _latents(4, 16), **geom)
    assert [(s, e) for s, e, _ in got] == [(s, e) for s, e, _ in want]
    assert got[-1][1] == mel_length_for_latents(keep)
    for (_, _, g), (_, _, w) in zip(got, want):
        close(g, w, 1e-4)


def test_audio_chunks_match_jax(monkeypatch):
    replay_jax_streams(monkeypatch)
    cfg = tiny_vocoder_config()
    params = random_vocoder_params(cfg, seed=1)
    out_len = 70
    mel = np.random.default_rng(0).uniform(-1, 1, (cfg.n_mel, out_len)) \
        .astype(np.float32)
    spans = [(0, 10), (10, 31), (31, 52), (52, 70)]

    def chunks(mod, **kw):
        return list(mod.stream_audio_chunks(
            params, cfg, ((s, e, mel[:, s:e]) for s, e in spans), out_len,
            seed=7, margin=6, **kw))

    got, want = chunks(TST, device="cpu"), chunks(JST)
    assert [(c.start_sample, c.final) for c in got] == \
        [(c.start_sample, c.final) for c in want]
    for g, w in zip(got, want):
        close(g.audio, w.audio, 1e-4)


def _chunked_audio(params, cfg, mel, spans, margin):
    chunks = list(TST.stream_audio_chunks(
        params, cfg, ((s, e, mel[:, s:e]) for s, e in spans), mel.shape[1],
        seed=7, margin=margin, device="cpu"))
    assert chunks[-1].final and not any(c.final for c in chunks[:-1])
    return TST.collect_stream(chunks)


@pytest.mark.parametrize("cfg,out_len,span,margin,tol", [
    (tiny_vocoder_config(), 80, 24, 16, 0.0),
    # the production widths at a short length: the real receptive field
    # fits the default margin
    (VocoderConfig(), 96, 32, 32, 1e-3),
])
def test_chunked_vocoding_equals_full_pass(cfg, out_len, span, margin, tol):
    """Every emitted sample equals the one-chunk pass's, bit for bit: the
    stack is local and shift-equivariant at the upsample stride, every
    sample sees >= margin frames of true context, and the noise is one
    global draw."""
    params = random_vocoder_params(cfg, seed=1)
    mel = np.random.default_rng(0).uniform(-1, 1, (cfg.n_mel, out_len)) \
        .astype(np.float32)
    full = _chunked_audio(params, cfg, mel, [(0, out_len)], margin)
    spans = [(s, min(s + span, out_len)) for s in range(0, out_len, span)]
    chunked = _chunked_audio(params, cfg, mel, spans, margin)
    assert full.shape == chunked.shape == (audio_length(out_len, cfg),)
    assert np.abs(chunked - full).max() <= tol * np.abs(full).max()


def test_insufficient_margin_differs():
    """The exactness test has teeth: with no margin the chunk edges see
    false boundaries."""
    cfg = tiny_vocoder_config()
    params = random_vocoder_params(cfg, seed=1)
    mel = np.random.default_rng(0).uniform(-1, 1, (cfg.n_mel, 80)) \
        .astype(np.float32)
    full = _chunked_audio(params, cfg, mel, [(0, 80)], 16)
    rough = _chunked_audio(params, cfg, mel,
                           [(s, s + 20) for s in range(0, 80, 20)], 0)
    assert np.abs(rough - full).max() > 1e-3


def test_window_geometry_fuzz_matches_jax(dparams, monkeypatch):
    """Window arithmetic over many (window, overlap, first window,
    utterance length) cases, with the denoising loop stubbed to the
    identity in both packages: the spans tile [0, out_len) once, in
    order, and equal the JAX package's spans and crossfaded blocks (the
    same replayed noise)."""
    replay_jax_streams(monkeypatch)
    monkeypatch.setattr(JST, "_denoise_window", lambda *a: a[4])
    monkeypatch.setattr(TST, "_denoise_window", lambda *a: a[4])
    cases = [(keep, w, ov, fw) for keep in (2, 5, 15, 33)
             for w in (4, 8, 24, 64) for ov in (0, 2, w // 2 - 1)
             if 0 <= ov < w for fw in (None, ov + 1, w + 9)]
    assert len(cases) > 50
    for keep, w, ov, fw in cases:
        lat = _latents(keep, max(keep, 4))
        got, want = _both_windows(dparams, keep, lat, window_frames=w,
                                  overlap_frames=ov, first_window_frames=fw)
        pos = 0
        for s, e, block in got:
            assert s == pos and e > s, (keep, w, ov, fw)
            assert block.shape == (8, e - s)
            pos = e
        assert pos == mel_length_for_latents(keep)
        assert [(s, e) for s, e, _ in got] == [(s, e) for s, e, _ in want]
        for (_, _, g), (_, _, wb) in zip(got, want):
            close(g, wb, 1e-6)


def test_first_window_clamped_for_a_short_utterance(dparams):
    """A first window wider than the padded timeline clamps to one global
    window instead of failing against the overlap."""
    keep = 14
    out_len = mel_length_for_latents(keep)
    out_pad = round_up(out_len, 64)
    spans, _ = _both_windows(dparams, keep, _latents(7, 16),
                             window_frames=out_pad + 128,
                             overlap_frames=out_pad - 1,
                             first_window_frames=out_pad + 64)
    assert [(s, e) for s, e, _ in spans] == [(0, out_len)]
    assert np.isfinite(spans[0][2]).all()


def test_validation_is_eager(dparams):
    """Bad geometry fails when stream_synthesize is CALLED (before any
    device work); the window and chunk generators reject it at their
    first step."""
    models = T.TortoiseModels.random(0, tiny=True)
    voice = np.zeros((64,), np.float32)
    kw = dict(tokens=[1, 4, 0], device="cpu")
    with pytest.raises(ValueError, match="vocoder_margin"):
        TST.stream_synthesize(models, voice=voice, vocoder_margin=-4, **kw)
    with pytest.raises(ValueError, match="window_frames"):
        TST.stream_synthesize(models, voice=voice, window_frames=16,
                              overlap_frames=16, **kw)
    with pytest.raises(ValueError, match="first_window_frames"):
        TST.stream_synthesize(models, voice=voice, window_frames=24,
                              overlap_frames=8, first_window_frames=8, **kw)
    with pytest.raises(ValueError, match="voice"):
        TST.stream_synthesize(models, voice=None, **kw)
    cfg = tiny_diffusion_config()
    lat = torch.tensor(_latents(6, 16))
    for fw in (8, 0):  # 0 is rejected like any value <= the overlap
        with pytest.raises(ValueError, match="first_window_frames"):
            next(TST.stream_mel_windows(dparams, cfg, lat, 15, seed=9,
                                        window_frames=24, overlap_frames=8,
                                        first_window_frames=fw,
                                        device="cpu"))
    with pytest.raises(ValueError, match="margin"):
        next(TST.stream_audio_chunks(
            random_vocoder_params(tiny_vocoder_config(), 0),
            tiny_vocoder_config(), iter(()), 8, seed=0, margin=-1,
            device="cpu"))
    with pytest.raises(ValueError, match="starts at"):
        TST.collect_stream([TST.StreamChunk(np.zeros(4, np.float32), 2,
                                            True)])


def test_stream_synthesize_matches_jax(monkeypatch):
    """The whole stream on the f32 plane: AR, global conditioner, three
    windows and the chunked vocoder, against the JAX package's stream on
    the same key chains; the utterance has the one-shot length."""
    base = J.TortoiseModels.random(seed=0, tiny=True)
    kw = dict(ar_params=base.ar_params,
              diffusion_params=base.diffusion_params,
              vocoder_params=base.vocoder_params,
              ar_cfg=dataclasses.replace(base.ar_cfg, max_decode_steps=8),
              diffusion_cfg=dataclasses.replace(base.diffusion_cfg,
                                                n_sample_timesteps=6),
              vocoder_cfg=base.vocoder_cfg)
    voice = np.random.default_rng(5).normal(0, 0.5, (64,)) \
        .astype(np.float32)
    geom = dict(tokens=[1, 7, 3, 22, 9, 14, 0], voice=voice, seed=11,
                window_frames=24, overlap_frames=8, first_window_frames=16,
                vocoder_margin=8)
    want = list(JST.stream_synthesize(J.TortoiseModels(**kw), **geom))
    replay_jax_streams(monkeypatch)
    got = list(TST.stream_synthesize(T.TortoiseModels(**kw), device="cpu",
                                     **geom))
    assert len(got) > 1 and got[-1].final
    assert all(c.latency_s > 0 for c in got)
    assert [(c.start_sample, c.final, len(c.audio)) for c in got] == \
        [(c.start_sample, c.final, len(c.audio)) for c in want]
    audio = TST.collect_stream(got)
    close(audio, JST.collect_stream(want), 1e-3)
    assert (len(audio) + 6) % kw["vocoder_cfg"].total_upsample == 0
