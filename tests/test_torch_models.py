"""The port's models (AR decoder, denoiser, vocoder) against the JAX
package's functions on the same weights and inputs, and against the
committed fixtures in tests/data/pseudo_golden.npz.

Tolerances: max abs error <= tol * max |reference|; tol is the fixture
key's own (tests/pseudo_golden_lib.tolerance_for: 1e-3 f32, 5e-3 int8,
3e-2 bf16 + flash) and the same values for the live JAX comparisons,
except the bf16 + int8 denoiser (5e-2, see the test). Sampled tokens
must be equal.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tortoise_tpu.config import (
    DiffusionConfig,
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
from tortoise_tpu.models import diffusion as JDM
from tortoise_tpu.models import vocoder as JVM
from tortoise_tpu_torch.models import ar as TAR
from tortoise_tpu_torch.models import diffusion as TDM
from tortoise_tpu_torch.models import vocoder as TVM
from tortoise_tpu_torch.ops.relpos import relative_position_buckets
from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline import ar_stage as TS
from tortoise_tpu_torch.pipeline import diffusion_stage as TDS

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "pseudo_golden.npz")


def close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err,
                                                          np.abs(want).max())


@pytest.fixture(scope="module")
def golden():
    from pseudo_golden_lib import tolerance_for

    data = np.load(GOLDEN)
    return {k: data[k] for k in data.files}, tolerance_for


@pytest.fixture(scope="module")
def ar_inputs():
    """The fixture generator's AR inputs (tests/pseudo_golden_lib.py)."""
    cfg = tiny_ar_config()
    params = random_ar_params(cfg, seed=7)
    rng = np.random.default_rng(11)
    b, t = 2, 12
    text_ids = rng.integers(0, cfg.n_text_vocab, (b, t)).astype(np.int64)
    text_valid = np.arange(t)[None, :] < np.array([[12], [9]])
    voice = rng.normal(0, 0.5, (cfg.d_model,)).astype(np.float32)
    return cfg, params, text_ids, text_valid, voice


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def test_ar_f32_against_fixtures(golden, ar_inputs):
    g, tol = golden
    cfg, params, text_ids, text_valid, voice = ar_inputs
    p = TS.cast_matmul_weights(params, None)
    ids, valid, v = _t(text_ids, text_valid, voice)
    logits, cache = TAR.prefill(p, cfg, ids, valid, v)
    close(logits, g["ar_prefill_logits"], tol("ar_prefill_logits"))
    for i, toks in enumerate([(4, 9), (1, 2), (7, 3)]):
        logits, cache = TAR.decode_step(p, cfg, cache, torch.tensor(toks), i)
        close(logits, g[f"ar_decode_logits_{i}"], tol("ar_decode_logits_"))
    seqs = [[4, 9, 1, 7, cfg.calm_token, 2], [3, 3, 3]]
    mel_ids = torch.tensor([TS.apply_padding(s, cfg) for s in seqs])
    close(TAR.latent_forward(p, cfg, ids, valid, mel_ids, v),
          g["ar_latents"], tol("ar_latents"))


def test_ar_int8_and_fused_against_fixtures(golden, ar_inputs):
    g, tol = golden
    cfg, params, text_ids, text_valid, voice = ar_inputs
    ids, valid, v = _t(text_ids, text_valid, voice)
    p8 = TS.cast_matmul_weights(params, None, int8=True)
    _, cache = TAR.prefill(p8, cfg, ids, valid, v)
    for i, toks in enumerate([(4, 9), (1, 2), (7, 3)]):
        logits, cache = TAR.decode_step(p8, cfg, cache, torch.tensor(toks), i)
        close(logits, g[f"ar_decode_int8_logits_{i}"],
              tol("ar_decode_int8_"))
    # kernel A's plane: bf16 + int8, decode + in-kernel sampler
    fcfg = dataclasses.replace(cfg, fused_decode=True)
    p16 = TS.cast_matmul_weights(params, torch.bfloat16, int8=True)
    _, cache = TAR.prefill(p16, fcfg, ids, valid, v, torch.bfloat16)
    toks = torch.tensor((4, 9))
    for i, uu in enumerate((0.31, 0.77)):
        toks, cache = TAR.decode_sample_step(
            p16, fcfg, cache, toks, i, torch.full((2, 1), uu),
            torch.bfloat16)
        np.testing.assert_array_equal(toks.numpy(),
                                      g[f"fused_decode_tokens_{i}"])
    close(cache.k[:, :, cache.length - 1, :], g["fused_decode_krow"],
          tol("fused_decode_"))


@pytest.mark.parametrize("plane", ["f32", "bf16_int8", "bf16_flash"])
def test_ar_against_jax(ar_inputs, plane):
    """prefill / decode_step / latent_forward on each plane; bf16_flash
    forces kernel C's path (flash_prefill_min_score=0)."""
    cfg, params, text_ids, text_valid, voice = ar_inputs
    jcd, tcd, int8, tol = None, None, False, 1e-3
    if plane != "f32":
        jcd, tcd, tol = jnp.bfloat16, torch.bfloat16, 3e-2
        int8 = plane == "bf16_int8"
    if plane == "bf16_flash":
        cfg = dataclasses.replace(cfg, flash_prefill_min_score=0)
    from tortoise_tpu.pipeline.ar_stage import cast_matmul_weights as jcast

    jp = jcast(params, jcd, int8)
    tp = TS.cast_matmul_weights(params, tcd, int8)
    jargs = (jnp.asarray(text_ids), jnp.asarray(text_valid),
             jnp.asarray(voice))
    targs = _t(text_ids, text_valid, voice)
    jl, jc = JAR.prefill(jp, cfg, *jargs, compute_dtype=jcd)
    tl, tc = TAR.prefill(tp, cfg, *targs, compute_dtype=tcd)
    close(tl, jl, tol)
    close(tc.k, jc.k, tol)
    assert tc.length == int(jc.length)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    for i, toks in enumerate([(4, 9), (1, 2)]):
        jl, jc = JAR.decode_step(jp, cfg, jc, jnp.asarray(toks), i, jcd)
        tl, tc = TAR.decode_step(tp, cfg, tc, torch.tensor(toks), i, tcd)
        close(tl, jl, tol)
    mel = np.array([TS.apply_padding([4, 9, 1], cfg)] * 2)
    close(TAR.latent_forward(tp, cfg, *targs[:2], torch.tensor(mel),
                             targs[2], tcd),
          JAR.latent_forward(jp, cfg, *jargs[:2], jnp.asarray(mel),
                             jargs[2], jcd), tol)


@pytest.fixture(scope="module")
def denoise_inputs():
    """The fixture generator's denoiser inputs (same rng stream order)."""
    rng = np.random.default_rng(11)
    cfg = tiny_ar_config()
    rng.integers(0, cfg.n_text_vocab, (2, 12))
    rng.normal(0, 0.5, (cfg.d_model,))
    dcfg = tiny_diffusion_config()
    dt = 12
    x = rng.normal(0, 1, (2, dcfg.n_mel, dt)).astype(np.float32)
    code = rng.normal(0, 0.5, (2, dcfg.d_model, dt)).astype(np.float32)
    mask = np.arange(dt)[None, :] < np.array([[12], [10]])
    return dcfg, x, code, mask


def test_denoise_against_fixture(golden, denoise_inputs):
    g, tol = golden
    dcfg, x, code, mask = denoise_inputs
    p = tree_to_torch(random_diffusion_params(dcfg, seed=3))
    out = TDM.denoise(p, dcfg, *_t(x, code), 1234,
                      torch.tensor(relative_position_buckets(12)),
                      torch.tensor(mask))
    close(out, g["diff_denoise"], tol("diff_denoise"))


def test_denoise_bf16_packed_against_fixture(golden):
    """The production denoiser plane with kernel B's path (its plain
    version on the CPU), d_head=64."""
    g, tol = golden
    prng = np.random.default_rng(21)
    pcfg = dataclasses.replace(tiny_diffusion_config(), d_model=256,
                               n_head=4, n_groups=8, timestep_dim=256,
                               use_flash=True)
    p = tree_to_torch(random_diffusion_params(pcfg, seed=9))
    pt = 128
    px = prng.normal(0, 1, (2, pcfg.n_mel, pt)).astype(np.float32)
    pcode = prng.normal(0, 0.5, (2, pcfg.d_model, pt)).astype(np.float32)
    pmask = np.arange(pt)[None, :] < np.array([[128], [100]])
    out = TDM.denoise(p, pcfg, *_t(px, pcode), 777,
                      torch.tensor(relative_position_buckets(pt)),
                      torch.tensor(pmask), torch.bfloat16)
    close(out, g["diff_denoise_bf16_flash"],
          tol("diff_denoise_bf16_flash"))


@pytest.mark.parametrize("plane", ["f32", "bf16_int8"])
def test_code_embeddings_and_denoise_against_jax(denoise_inputs, plane):
    from tortoise_tpu.pipeline.diffusion_stage import (
        quantize_diffusion_weights as jq,
    )

    dcfg, x, code, mask = denoise_inputs
    params = random_diffusion_params(dcfg, seed=5)
    jcd, tcd, tol = None, None, 1e-3
    if plane != "f32":
        # 5e-2: XLA computes fused bf16 elementwise chains (group norm ->
        # SiLU -> activation quantization, the FiLM chain) with excess f32
        # precision; PyTorch rounds to bf16 after every op
        params = jq(params)
        jcd, tcd, tol = jnp.bfloat16, torch.bfloat16, 5e-2
    tp = tree_to_torch(params)
    lat = np.random.default_rng(6).normal(0, 1, (1, 32, dcfg.d_model)) \
        .astype(np.float32)
    lat_mask = np.arange(32)[None, :] < 20
    bk32 = relative_position_buckets(32)
    want = JDM.code_embeddings(params, dcfg, jnp.asarray(lat),
                               jnp.asarray(bk32), 64, 20, 43,
                               jnp.asarray(lat_mask), jcd)
    got = TDM.code_embeddings(tp, dcfg, torch.tensor(lat),
                              torch.tensor(bk32), 64, 20, 43,
                              torch.tensor(lat_mask), tcd)
    for a, b in zip(got, want):
        close(a, b, tol)
    bk = relative_position_buckets(12)
    close(TDM.denoise(tp, dcfg, *_t(x, code), 99, torch.tensor(bk),
                      torch.tensor(mask), tcd),
          JDM.denoise(params, dcfg, jnp.asarray(x), jnp.asarray(code), 99,
                      jnp.asarray(bk), jnp.asarray(mask), jcd), tol)


def test_posterior_step_against_fixture(golden):
    g, tol = golden
    rng = np.random.default_rng(11)
    # replay the fixture generator's draws up to the posterior inputs
    cfg, dcfg = tiny_ar_config(), tiny_diffusion_config()
    rng.integers(0, cfg.n_text_vocab, (2, 12))
    rng.normal(0, 0.5, (cfg.d_model,))
    rng.normal(0, 1, (2, dcfg.n_mel, 12))
    rng.normal(0, 0.5, (2, dcfg.d_model, 12))
    n_mel = DiffusionConfig().n_mel
    cm, um, cv, xs, noise = (rng.normal(0, s, (1, n_mel, 4))
                             .astype(np.float32)
                             for s in (0.3, 0.3, 0.3, 1.0, 1.0))
    sched = TDS.schedule_arrays(DiffusionConfig())
    got = TDS.posterior_step(sched, DiffusionConfig(), *_t(xs, cm, um, cv),
                             40, torch.tensor(noise))
    close(got, g["diff_posterior_step"], tol("diff_posterior_step"))


def test_vocoder_against_fixture_and_jax(golden):
    g, tol = golden
    rng = np.random.default_rng(11)
    cfg, dcfg = tiny_ar_config(), tiny_diffusion_config()
    rng.integers(0, cfg.n_text_vocab, (2, 12))
    rng.normal(0, 0.5, (cfg.d_model,))
    rng.normal(0, 1, (2, dcfg.n_mel, 12))
    rng.normal(0, 0.5, (2, dcfg.d_model, 12))
    for s in (0.3, 0.3, 0.3, 1.0, 1.0):
        rng.normal(0, s, (1, DiffusionConfig().n_mel, 4))
    vcfg = tiny_vocoder_config()
    vparams = random_vocoder_params(vcfg, seed=5)
    m = 8
    mel = rng.normal(-5.0, 2.0, (1, vcfg.n_mel, m)).astype(np.float32)
    noise = rng.normal(0, 1, (1, vcfg.noise_ch, m)).astype(np.float32)
    tp = tree_to_torch(vparams)
    close(TVM.vocoder_forward(tp, vcfg, *_t(mel, noise)), g["voc_audio"],
          tol("voc_audio"))
    # bucketed: zero padding past a true length, reflection at the edge
    pad = 16
    melp = np.pad(mel, ((0, 0), (0, 0), (0, pad - m)))
    noisep = np.pad(noise, ((0, 0), (0, 0), (0, pad - m)))
    want = JVM.vocoder_forward(vparams, vcfg, jnp.asarray(melp),
                               jnp.asarray(noisep), jnp.int32(m))
    got = TVM.vocoder_forward(tp, vcfg, *_t(melp, noisep), m)
    close(got, want, 1e-3)
    close(got[:, :g["voc_audio"].shape[1]], g["voc_audio"], 1e-3)
