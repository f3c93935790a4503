"""The AR stage's ``qkv_f16`` and the diffusion and vocoder stages'
``bucketed`` against the JAX package on the CPU, on the same numpy
weights and inputs, each called in the JAX package's argument order
(tests/test_torch_signatures.py holds the orders themselves).

``qkv_f16`` (the reference's f16 round trip of the qkv activations):
prefill, decode_step and latent_forward within 1e-3 of the reference's
max magnitude on the f32 plane and 3e-2 on the bf16 planes (as in
tests/test_torch_models.py); the logits move off the clean ones by 0 <
d < 5e-3 (tests/test_ar_model.py's bound); the reference-sampler AR
stage gives the JAX package's tokens; kernels A and C stay off.

``bucketed=False`` pads to the true lengths, none of which a bucket
divides here (latents of 9 and 14 frames, mels of 39 and 60 frames, 20,
33 and 7 vocoder frames). With the JAX key chains replayed through the
port's seams (tests/test_torch_batch.py), the f32 mel and audio are held
within 1e-3 of the reference's max magnitude, as the stage tests are;
the noise is drawn at the unbucketed shape, and an all-valid batch
drops its masks.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from test_torch_batch import close, replay_jax_streams
from tortoise_tpu.config import (
    tiny_ar_config,
    tiny_diffusion_config,
    tiny_vocoder_config,
)
from tortoise_tpu.io.checkpoint import (
    random_ar_params,
    random_diffusion_params,
    random_vocoder_params,
)
from tortoise_tpu.models import ar as JAR
from tortoise_tpu.pipeline import ar_stage as JAS
from tortoise_tpu.pipeline import diffusion_stage as JDS
from tortoise_tpu.pipeline import vocoder_stage as JVS
from tortoise_tpu.pipeline.ar_stage import cast_matmul_weights as jcast
from tortoise_tpu_torch.models import ar as TAR
from tortoise_tpu_torch.pipeline import ar_stage as TS
from tortoise_tpu_torch.pipeline import diffusion_stage as TDS
from tortoise_tpu_torch.pipeline import vocoder_stage as TVS

torch.set_num_threads(1)

TOKENS = [3, 9, 4, 12, 7, 1, 20, 5]


@pytest.fixture(scope="module")
def ar_inputs():
    cfg = tiny_ar_config()
    params = random_ar_params(cfg, seed=7)
    rng = np.random.default_rng(11)
    b, t = 2, 12
    text_ids = rng.integers(0, cfg.n_text_vocab, (b, t)).astype(np.int64)
    text_valid = np.arange(t)[None, :] < np.array([[12], [9]])
    voice = rng.normal(0, 0.5, (cfg.d_model,)).astype(np.float32)
    return cfg, params, text_ids, text_valid, voice


def _no_kernel(*a, **k):
    raise AssertionError("a kernel ran on the qkv_f16 plane")


@pytest.mark.parametrize("plane", ["f32", "bf16_int8", "bf16_flash"])
def test_qkv_f16_ar_model_matches_jax(ar_inputs, plane, monkeypatch):
    """prefill, decode_step and latent_forward with qkv_f16=True, passed
    positionally after compute_dtype as the JAX package takes it. On the
    bf16 planes kernel A's plane is on (fused_decode) and bf16_flash sets
    flash_prefill_min_score to 0: neither kernel may run."""
    cfg, params, text_ids, text_valid, voice = ar_inputs
    jcd, tcd, int8, tol = None, None, False, 1e-3
    if plane != "f32":
        jcd, tcd, tol = jnp.bfloat16, torch.bfloat16, 3e-2
        int8 = plane == "bf16_int8"
        cfg = dataclasses.replace(cfg, fused_decode=True)
    if plane == "bf16_flash":
        cfg = dataclasses.replace(cfg, flash_prefill_min_score=0)
    monkeypatch.setattr(TAR, "fused_decode_trunk", _no_kernel)
    monkeypatch.setattr(TAR, "flash_attention_causal_qkv", _no_kernel)
    assert not TAR.flash_prefill_on(cfg, tcd, True, (2, 14))
    jp = jcast(params, jcd, int8)
    tp = TS.cast_matmul_weights(params, tcd, int8)
    jargs = (jnp.asarray(text_ids), jnp.asarray(text_valid),
             jnp.asarray(voice))
    targs = tuple(torch.tensor(a) for a in (text_ids, text_valid, voice))
    jl, jc = JAR.prefill(jp, cfg, *jargs, jcd, True)
    tl, tc = TAR.prefill(tp, cfg, *targs, tcd, True)
    close(tl.float(), jl, tol)
    close(tc.k.float(), jc.k, tol)
    for i, toks in enumerate([(4, 9), (1, 2)]):
        jl, jc = JAR.decode_step(jp, cfg, jc, jnp.asarray(toks), i, jcd,
                                 True)
        tl, tc = TAR.decode_step(tp, cfg, tc, torch.tensor(toks), i, tcd,
                                 True)
        close(tl.float(), jl, tol)
    mel = np.array([TS.apply_padding([4, 9, 1], cfg)] * 2)
    close(TAR.latent_forward(tp, cfg, *targs[:2], torch.tensor(mel),
                             targs[2], tcd, True).float(),
          JAR.latent_forward(jp, cfg, *jargs[:2], jnp.asarray(mel),
                             jargs[2], jcd, True), tol)


def test_qkv_f16_moves_the_logits_slightly():
    """The port's twin of tests/test_ar_model.py's qkv_f16 check, on the
    same tiny model and inputs: the f16 round trip moves the prefill
    logits off the clean ones by 0 < d < 5e-3."""
    cfg = tiny_ar_config()
    params = TS.cast_matmul_weights(random_ar_params(cfg, seed=3), None)
    rng = np.random.default_rng(0)
    b, t = 2, 7
    ids = torch.tensor(rng.integers(0, cfg.n_text_vocab, (b, t)))
    voice = torch.tensor(rng.normal(0, 0.5, (cfg.d_model,)).astype(
        np.float32))
    valid = torch.ones((b, t), dtype=torch.bool)
    l0, _ = TAR.prefill(params, cfg, ids, valid, voice)
    l1, _ = TAR.prefill(params, cfg, ids, valid, voice, qkv_f16=True)
    d = (l1 - l0).abs().max().item()
    assert 0 < d < 5e-3


def test_qkv_f16_decode_sample_step_takes_the_plain_plane(ar_inputs,
                                                          monkeypatch):
    """decode_sample_step(qkv_f16=True) on kernel A's plane is
    decode_step(qkv_f16=True) and the plain sampler on the same
    uniforms; kernel A does not run."""
    cfg, params, text_ids, text_valid, voice = ar_inputs
    cfg = dataclasses.replace(cfg, fused_decode=True)
    tp = TS.cast_matmul_weights(params, torch.bfloat16, True)
    targs = [torch.tensor(a) for a in (text_ids, text_valid, voice)]
    monkeypatch.setattr(TAR, "fused_decode_trunk", _no_kernel)
    _, cache = TAR.prefill(tp, cfg, *targs, torch.bfloat16, True)
    snap = TAR.KVCache(cache.k.clone(), cache.v.clone(), cache.valid.clone(),
                       cache.length)
    toks, u = torch.tensor((4, 9)), torch.tensor([[0.31], [0.77]])
    got, _ = TAR.decode_sample_step(tp, cfg, cache, toks, 0, u,
                                    torch.bfloat16, qkv_f16=True)
    logits, _ = TAR.decode_step(tp, cfg, snap, toks, 0, torch.bfloat16, True)
    from tortoise_tpu_torch.ops import sampling as S

    probs, ids = S.process_logits_topk(logits, toks[:, None],
                                       *TAR.DEFAULT_SAMPLER)
    assert torch.equal(got, S.sample_from_topk_u(u, probs, ids))


def test_qkv_f16_reference_sampler_matches_jax_tokens():
    """autoregressive on the reference (mt19937) sampler plane with
    qkv_f16=True, positional in the JAX order: the JAX package's tokens,
    its latents within 1e-3."""
    cfg = tiny_ar_config()
    params = random_ar_params(cfg, 1)
    voice = np.random.default_rng(0).normal(0, 0.5, 64).astype(np.float32)
    jl, jseq = JAS.autoregressive(params, TOKENS, voice, 1, cfg,
                                  "reference", 5, None, None, True)
    tl, tseq = TS.autoregressive(params, TOKENS, voice, 1, cfg,
                                 "reference", 5, None, None, True,
                                 device="cpu")
    clean = TS.autoregressive(params, TOKENS, voice, 1, cfg, "reference", 5,
                              device="cpu")[0]
    assert tseq == jseq
    for a, b in zip(tl, jl):
        close(a, b, 1e-3)
    assert not all(np.array_equal(a, b) for a, b in zip(tl, clean))


def test_qkv_f16_batch_keeps_kernel_a_off_and_matches_jax(monkeypatch):
    """autoregressive_batch(..., compute_dtype, qkv_f16) positional, on
    kernel A's plane (bf16 + int8, B <= 16) with the JAX key chain
    replayed: every step takes decode_step, never decode_sample_step, and
    the f32 plane gives the JAX package's tokens."""
    cfg = dataclasses.replace(tiny_ar_config(), fused_decode=True,
                              max_decode_steps=6)
    params = random_ar_params(cfg, 5)
    rows = [[1, 5, 9, 4, 0], [1, 3, 9, 4, 12, 7, 0]]
    voices = np.random.default_rng(2).normal(0, 0.5, (2, 64)).astype(
        np.float32)
    seen = {"fused": 0, "plain": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            seen[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(TAR, "decode_sample_step",
                        spy("fused", TAR.decode_sample_step))
    monkeypatch.setattr(TAR, "decode_step", spy("plain", TAR.decode_step))
    TS.autoregressive_batch(params, rows, voices, cfg, 3, torch.bfloat16,
                            True, int8_weights=True, device="cpu")
    assert seen["fused"] == 0 and seen["plain"] > 0
    want_lat, want_seq = JAS.autoregressive_batch(params, rows, voices, cfg,
                                                  3, None, True)
    replay_jax_streams(monkeypatch)
    got_lat, got_seq = TS.autoregressive_batch(params, rows, voices, cfg, 3,
                                               None, True, device="cpu")
    assert got_seq == want_seq
    for a, b in zip(got_lat, want_lat):
        close(a, b, 1e-3)


@pytest.fixture(scope="module")
def stage_params():
    return dict(diffusion=random_diffusion_params(tiny_diffusion_config(), 2),
                vocoder=random_vocoder_params(tiny_vocoder_config(), 3))


def _lats(lens):
    return [np.random.default_rng(i).normal(0, 0.5, (n, 64))
            .astype(np.float32) for i, n in enumerate(lens)]


@pytest.mark.parametrize("use_flash", [False, True])
def test_unbucketed_diffusion_batch_matches_jax(stage_params, monkeypatch,
                                                use_flash):
    """diffusion_batch(..., compute_dtype, bucketed=False) positional at
    latent lengths 9 and 14 (mels of 39 and 60 frames): the noise is
    drawn at (2, n_mel, 60), not at the 64-frame bucket, and the f32 mels
    match the JAX package's. use_flash sends the tiny config's attention
    down the fallback route (kernel D1's plain version; the JAX generic
    flash_attention) at those ragged lengths."""
    cfg = dataclasses.replace(tiny_diffusion_config(),
                              n_sample_timesteps=6, use_flash=use_flash)
    lats = _lats((9, 14))
    want = JDS.diffusion_batch(stage_params["diffusion"], lats, cfg, 1, True,
                               None, False)
    replay_jax_streams(monkeypatch)
    shapes = []
    draw = TDS.draw_normal

    def recording(gen, shape, device):
        shapes.append(tuple(shape))
        return draw(gen, shape, device)

    monkeypatch.setattr(TDS, "draw_normal", recording)
    got = TDS.diffusion_batch(stage_params["diffusion"], lats, cfg, 1, True,
                              None, False, device="cpu")
    assert set(shapes) == {(2, cfg.n_mel, 60)}
    assert [g.shape for g in got] == [w.shape for w in want] == [
        (cfg.n_mel, 39), (cfg.n_mel, 60)]
    for g, w in zip(got, want):
        close(g, w, 1e-3)


def test_unbucketed_diffusion_matches_jax_and_drops_masks(stage_params,
                                                          monkeypatch):
    """diffusion(params, lat, cfg, seed, rng, variance_swap,
    compute_dtype, bucketed=False) at 9 latent frames: one row filling
    its unbucketed lengths needs no masks (the JAX package drops them
    too), and the mel matches."""
    cfg = dataclasses.replace(tiny_diffusion_config(), n_sample_timesteps=6)
    lat = _lats((9,))[0]
    want = JDS.diffusion(stage_params["diffusion"], lat, cfg, 1, None, True,
                         None, False)
    assert TDS._masks([9], [39], 9, 39, "cpu") == (None, None)
    lat_mask, out_mask = TDS._masks([9], [39], 32, 64, "cpu")
    assert lat_mask is not None and out_mask is not None
    seen = []
    masks = TDS._masks

    def recording(*a):
        seen.append(masks(*a))
        return seen[-1]

    monkeypatch.setattr(TDS, "_masks", recording)
    replay_jax_streams(monkeypatch)
    got = TDS.diffusion(stage_params["diffusion"], lat, cfg, 1, None, True,
                        None, False, device="cpu")
    assert seen == [(None, None)]
    assert got.shape == want.shape == (cfg.n_mel, 39)
    close(got, want, 1e-3)


def test_unbucketed_reference_rng_diffusion_matches_jax(stage_params):
    """The reference-rng plane (mt19937 noise) with bucketed=False."""
    from tortoise_tpu.rng import ReferenceRng as JRng
    from tortoise_tpu_torch.rng import ReferenceRng as TRng

    cfg = dataclasses.replace(tiny_diffusion_config(), n_sample_timesteps=4)
    lat = _lats((14,))[0]
    want = JDS.diffusion(stage_params["diffusion"], lat, cfg, 0, JRng(4),
                         True, None, False)
    got = TDS.diffusion(stage_params["diffusion"], lat, cfg, 0, TRng(4),
                        True, None, False, device="cpu")
    assert got.shape == want.shape == (cfg.n_mel, 60)
    close(got, want, 1e-3)


@pytest.mark.parametrize("fused_lvc", [False, True])
def test_unbucketed_vocoder_batch_matches_jax(stage_params, monkeypatch,
                                              fused_lvc):
    """vocoder_batch(..., compute_dtype, bucketed=False) positional at 20,
    33 and 7 frames: the noise at the longest row's frames plus the pad
    frames (no 32-frame bucket), every row's f32 audio within 1e-3; with
    use_pallas_lvc the fused LVC (kernel E's plain version; the JAX
    Pallas kernel in interpret mode) at that length."""
    cfg = dataclasses.replace(tiny_vocoder_config(),
                              use_pallas_lvc=fused_lvc)
    mels = [np.random.default_rng(i).uniform(-1, 1, (cfg.n_mel, n))
            .astype(np.float32) for i, n in enumerate((20, 33, 7))]
    want = JVS.vocoder_batch(stage_params["vocoder"], mels, cfg, 4, None,
                             False)
    replay_jax_streams(monkeypatch)
    shapes = []
    draw = TVS.draw_normal

    def recording(gen, shape, device):
        shapes.append(tuple(shape))
        return draw(gen, shape, device)

    monkeypatch.setattr(TVS, "draw_normal", recording)
    got = TVS.vocoder_batch(stage_params["vocoder"], mels, cfg, 4, None,
                            False, device="cpu")
    assert shapes == [(3, cfg.noise_ch, 33 + cfg.mel_pad_frames)]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        close(g, w, 1e-3)


def test_unbucketed_vocoder_matches_jax(stage_params, monkeypatch):
    """vocoder(params, mel, cfg, seed, rng, compute_dtype, bucketed=False)
    on one 33-frame mel, with jax.random noise and with the reference's
    mt19937 noise."""
    from tortoise_tpu.rng import ReferenceRng as JRng
    from tortoise_tpu_torch.rng import ReferenceRng as TRng

    cfg = tiny_vocoder_config()
    mel = np.random.default_rng(9).uniform(-1, 1, (cfg.n_mel, 33)).astype(
        np.float32)
    want_ref = JVS.vocoder(stage_params["vocoder"], mel, cfg, 0, JRng(2),
                           None, False)
    got_ref = TVS.vocoder(stage_params["vocoder"], mel, cfg, 0, TRng(2),
                          None, False, device="cpu")
    close(got_ref, want_ref, 1e-3)
    want = JVS.vocoder(stage_params["vocoder"], mel, cfg, 4, None, None,
                       False)
    replay_jax_streams(monkeypatch)
    got = TVS.vocoder(stage_params["vocoder"], mel, cfg, 4, None, None,
                      False, device="cpu")
    assert got.shape == want.shape
    close(got, want, 1e-3)
