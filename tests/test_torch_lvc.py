"""Kernel E (the port's ``lvc_gated_residual``) and the vocoder's fused
route against the JAX package, on the CPU.

On the CPU the wrapper runs its plain PyTorch version; here it is held
against the Pallas kernel in interpret mode on the same numpy inputs,
and the tiny vocoder with ``use_pallas_lvc`` against the JAX package's
on the same weights. The hand-written kernel is held against the plain
version on a card by tests/test_torch_cuda.py.

Tolerances (max abs error relative to the reference's max magnitude):
the kernel 1e-4 (f32 in and out, another summation order); the tiny
vocoder 1e-4 at f32 and 2e-2 on the bf16 plane (bf16 rounding of the
convolutions' operands; the fused LVC itself is f32 in both packages).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tortoise_tpu.config import tiny_vocoder_config
from tortoise_tpu.io.checkpoint import random_vocoder_params
from tortoise_tpu.models import vocoder as JVM
from tortoise_tpu_torch.models import vocoder as TVM
from tortoise_tpu_torch.ops.cuda import lvc as TL
from tortoise_tpu_torch.params import tree_to_torch

JL = importlib.import_module("tortoise_tpu.ops.pallas.lvc")


def assert_close(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


# (C_in, C, K, L, hop): the shapes of tests/test_vocoder_model.py's
# kernel oracle test
@pytest.mark.parametrize("c_in,c_res,k,l,hop", [
    (3, 4, 3, 4, 2), (8, 8, 3, 5, 16), (4, 4, 3, 2, 128)])
def test_lvc_gated_residual_matches_pallas(c_in, c_res, k, l, hop):
    rng = np.random.default_rng(hop)
    x = rng.normal(0, 1, (2, c_in, l * hop)).astype(np.float32)
    kernel = rng.normal(0, 1, (2, c_in, 2 * c_res, k, l)).astype(np.float32)
    bias = rng.normal(0, 1, (2, 2 * c_res, l)).astype(np.float32)
    res = rng.normal(0, 1, (2, c_res, l * hop)).astype(np.float32)
    want = JL.lvc_gated_residual(*(jnp.asarray(a) for a in
                                   (x, kernel, bias, res)), hop,
                                 interpret=True)
    got = TL.lvc_gated_residual(*(torch.tensor(a) for a in
                                  (x, kernel, bias, res)), hop)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(want), 1e-4)


def test_lvc_gated_residual_takes_a_block_slice():
    """The vocoder passes kernels[:, c] of the stacked per-block kernels:
    a view whose batch rows are contiguous gives the copy's result."""
    rng = np.random.default_rng(4)
    kern_all = torch.tensor(rng.normal(0, 1, (2, 4, 3, 8, 3, 5)).astype(
        np.float32))
    bias_all = torch.tensor(rng.normal(0, 1, (2, 4, 8, 5)).astype(
        np.float32))
    x = torch.tensor(rng.normal(0, 1, (2, 3, 20)).astype(np.float32))
    res = torch.tensor(rng.normal(0, 1, (2, 4, 20)).astype(np.float32))
    got = TL.lvc_gated_residual(x, kern_all[:, 2], bias_all[:, 2], res, 4)
    want = TL.lvc_gated_residual(x, kern_all[:, 2].contiguous(),
                                 bias_all[:, 2].contiguous(), res, 4)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("plane", ["f32", "bf16"])
@pytest.mark.parametrize("bucketed", [False, True])
def test_tiny_vocoder_fused_lvc_matches_jax(plane, bucketed):
    cfg = dataclasses.replace(tiny_vocoder_config(), use_pallas_lvc=True)
    params = random_vocoder_params(cfg, seed=8)
    rng = np.random.default_rng(9)
    m, pad = 9, 16
    mel = rng.normal(-5.0, 2.0, (1, cfg.n_mel, m)).astype(np.float32)
    noise = rng.normal(0, 1, (1, cfg.noise_ch, m)).astype(np.float32)
    jkw, tkw = {}, {}
    if bucketed:
        mel = np.pad(mel, ((0, 0), (0, 0), (0, pad - m)))
        noise = np.pad(noise, ((0, 0), (0, 0), (0, pad - m)))
        jkw["mel_len"], tkw["mel_len"] = jnp.int32(m), m
    jcd, tcd, tol = None, None, 1e-4
    if plane == "bf16":
        jcd, tcd, tol = jnp.bfloat16, torch.bfloat16, 2e-2
    want = JVM.vocoder_forward(params, cfg, jnp.asarray(mel),
                               jnp.asarray(noise), compute_dtype=jcd, **jkw)
    got = TVM.vocoder_forward(tree_to_torch(params), cfg,
                              torch.tensor(mel), torch.tensor(noise),
                              compute_dtype=tcd, **tkw)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(want, np.float32), tol)
