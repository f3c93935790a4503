"""The denoiser's fallback attention route (kernel D1) and the slice that
runs it with the vocoder's fused LVC route (kernel E), against the JAX
package on the CPU.

``use_flash`` with a head layout the packed kernel cannot take (odd
heads, or 6*d_head % 128 != 0: the tiny config's 4 heads of 16, or 32
heads of 32 at full width) sends every attention through the JAX
package's generic ``flash_attention``; the port sends it through kernel
D1 (its plain version here) on strided views of the fused qkv.

Tolerances (max abs error relative to the reference's max magnitude):
the denoiser 1e-4 at f32 and 2e-2 at bf16; with int8 weights 5e-2 as in
tests/test_torch_models.py (XLA keeps excess f32 precision in fused
bf16 chains). The slice as in tests/test_torch_slice.py: identical
tokens; f32 mel and audio within 1e-3; bf16 + int8 mel within 0.1 and
audio within 5e-2.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

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
from tortoise_tpu.models import diffusion as JDM
from tortoise_tpu.pipeline import synthesize as J
from tortoise_tpu_torch.models import diffusion as TDM
from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline import diffusion_stage as TDS
from tortoise_tpu_torch.pipeline import synthesize as T

TOKENS = [3, 9, 4, 12, 7, 1, 20, 5]


def close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), (err,
                                                          np.abs(want).max())


def _denoise_both(dcfg, params, plane, t=40, n_valid=33, seed=0):
    from tortoise_tpu.ops.relpos import relative_position_buckets
    from tortoise_tpu.pipeline.diffusion_stage import (
        quantize_diffusion_weights as jq,
    )

    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, dcfg.n_mel, t)).astype(np.float32)
    code = rng.normal(0, 0.5, (2, dcfg.d_model, t)).astype(np.float32)
    mask = np.arange(t)[None, :] < np.array([[t], [n_valid]])
    jcd = tcd = None
    if plane != "f32":
        jcd, tcd = jnp.bfloat16, torch.bfloat16
    if plane == "bf16_int8":
        params = jq(params)
    bk = relative_position_buckets(t)
    want = JDM.denoise(params, dcfg, jnp.asarray(x), jnp.asarray(code), 321,
                       jnp.asarray(bk), jnp.asarray(mask), jcd)
    got = TDM.denoise(tree_to_torch(params), dcfg, torch.tensor(x),
                      torch.tensor(code), 321,
                      TDS._buckets(t, dcfg, "cpu"), torch.tensor(mask), tcd)
    return got, want


@pytest.mark.parametrize("plane,tol", [("f32", 1e-4), ("bf16", 2e-2),
                                       ("bf16_int8", 5e-2)])
def test_tiny_denoiser_fallback_route_matches_jax(plane, tol):
    dcfg = dataclasses.replace(tiny_diffusion_config(), use_flash=True)
    assert not TDM.use_packed(dcfg)        # 4 heads of 16: the fallback
    assert TDS._buckets(40, dcfg, "cpu") is None
    got, want = _denoise_both(dcfg, random_diffusion_params(dcfg, seed=4),
                              plane)
    close(got, want, tol)


def test_code_embeddings_fallback_route_matches_jax():
    """The latent conditioner's four attention blocks on the fallback
    route, masked latents."""
    dcfg = dataclasses.replace(tiny_diffusion_config(), use_flash=True)
    params = random_diffusion_params(dcfg, seed=6)
    lat = np.random.default_rng(7).normal(0, 1, (1, 32, dcfg.d_model)) \
        .astype(np.float32)
    lat_mask = np.arange(32)[None, :] < 21
    want = JDM.code_embeddings(params, dcfg, jnp.asarray(lat), None, 64, 21,
                               45, jnp.asarray(lat_mask))
    got = TDM.code_embeddings(tree_to_torch(params), dcfg, torch.tensor(lat),
                              None, 64, 21, 45, torch.tensor(lat_mask))
    for a, b in zip(got, want):
        close(a, b, 1e-4)


def test_denoiser_at_32_heads_loads_its_table():
    """The head split of the full-width fallback config (32 heads) at a
    small width: the (32 buckets, 32 heads) rel-pos tables load and the
    route matches the JAX package's."""
    dcfg = dataclasses.replace(tiny_diffusion_config(), d_model=512,
                               n_head=32, n_groups=8, timestep_dim=512,
                               use_flash=True)
    params = random_diffusion_params(dcfg, seed=2, fast=True)
    tp = tree_to_torch(params)
    assert tuple(tp["layers"]["attn_rel_w"].shape[1:]) == (32, 32)
    assert tuple(tp["latent_blocks"]["attn_rel_w"].shape[1:]) == (32, 32)
    assert not TDM.use_packed(dcfg)
    got, want = _denoise_both(dcfg, params, "f32", t=24, n_valid=19)
    close(got, want, 1e-4)


@pytest.fixture(scope="module")
def models_kw():
    dcfg = dataclasses.replace(tiny_diffusion_config(), use_flash=True)
    vcfg = dataclasses.replace(tiny_vocoder_config(), use_pallas_lvc=True)
    return dict(
        ar_params=random_ar_params(tiny_ar_config(), 1),
        diffusion_params=random_diffusion_params(dcfg, 2),
        vocoder_params=random_vocoder_params(vcfg, 3),
        ar_cfg=tiny_ar_config(), diffusion_cfg=dcfg, vocoder_cfg=vcfg)


@pytest.mark.parametrize("plane", ["f32", "bf16_int8"])
def test_synthesize_fallback_and_fused_lvc_matches_jax(models_kw, plane):
    voice = np.random.default_rng(0).normal(0, 0.5, 64).astype(np.float32)
    kw = {}
    jcd = tcd = None
    if plane == "bf16_int8":
        kw["int8_weights"] = True
        jcd, tcd = jnp.bfloat16, torch.bfloat16
    want = J.synthesize(J.TortoiseModels(**models_kw), tokens=TOKENS,
                        voice=voice, seed=5, sampler="reference",
                        compute_dtype=jcd, **kw)
    got = T.synthesize(T.TortoiseModels(**models_kw), tokens=TOKENS,
                       voice=voice, seed=5, sampler="reference",
                       compute_dtype=tcd, device="cpu", **kw)
    assert got.sequences == want.sequences
    assert got.mel.shape == want.mel.shape
    assert got.audio.shape == want.audio.shape
    if plane == "f32":
        for name in ("mel", "audio"):
            a, b = getattr(got, name), getattr(want, name)
            assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), name
    else:
        assert np.abs(got.mel - want.mel).max() <= 0.1
        assert np.abs(got.audio - want.audio).max() <= \
            5e-2 * np.abs(want.audio).max()


def test_random_models_take_config_fields():
    """TortoiseModels.random draws the weights for the replaced configs:
    the production fallback split (32 heads) and the fused LVC flag."""
    m = T.TortoiseModels.random(0, tiny=True,
                                diffusion={"n_head": 8, "use_flash": True},
                                vocoder={"use_pallas_lvc": True})
    assert m.diffusion_cfg.n_head == 8 and m.diffusion_cfg.use_flash
    assert m.vocoder_cfg.use_pallas_lvc
    assert m.diffusion_params["layers"]["attn_rel_w"].shape[-1] == 8
