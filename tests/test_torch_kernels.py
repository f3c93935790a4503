"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper in ``tortoise_tpu_torch.ops.cuda`` runs its plain
PyTorch version; here that version is held against the Pallas kernel run
in interpret mode on the same numpy inputs. The hand-written kernels are
held against the plain versions on a card by tests/test_torch_cuda.py.

Tolerances (max abs error relative to the reference's max magnitude):
f32 inputs 1e-4 (same math, different summation order and exp vs exp2);
bf16 inputs 2e-2 (bf16 rounding of q*scale in the Pallas kernel, of the
softmax weights, and of the output); the int8 decode trunk 5e-3 as in
tests/pseudo_golden_lib.py. Sampled tokens must be equal.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tortoise_tpu.config import tiny_ar_config
from tortoise_tpu.io.checkpoint import random_ar_params
from tortoise_tpu.pipeline.ar_stage import cast_matmul_weights as j_cast
from tortoise_tpu_torch.ops.cuda import decode_trunk as TA
from tortoise_tpu_torch.ops.cuda import flash_attention as TF
from tortoise_tpu_torch.params import tree_to_torch

# the Pallas modules (the package re-exports functions of the same names)
JA = importlib.import_module("tortoise_tpu.ops.pallas.decode_trunk")
JF = importlib.import_module("tortoise_tpu.ops.pallas.flash_attention")

DTYPES = {"f32": (np.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def assert_close(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _qkv(b, t, h, d, seed):
    return np.random.default_rng(seed).normal(0, 1, (b, t, 3 * h * d)) \
        .astype(np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("t,n_valid", [(128, None), (150, 131), (256, 200)])
def test_packed_attention_matches_pallas(dtype, t, n_valid):
    jdt, tdt, rel = DTYPES[dtype]
    h, d = 4, 64
    qkv = _qkv(2, t, h, d, t)
    table = np.random.default_rng(1).normal(0, 0.3, (32, h)) \
        .astype(np.float32)
    valid = None
    if n_valid is not None:
        valid = np.arange(t)[None, :] < np.array([[t], [n_valid]])
    want = JF.flash_attention_packed(
        jnp.asarray(qkv, jdt), h,
        None if valid is None else jnp.asarray(valid),
        bias_table=jnp.asarray(table), interpret=True)
    got = TF.flash_attention_packed(
        torch.tensor(qkv).to(tdt), h,
        None if valid is None else torch.tensor(valid),
        bias_table=torch.tensor(table))
    assert got.dtype == tdt
    assert_close(got.float().numpy(), np.asarray(want, np.float32), rel)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("s,pad", [(64, None), (150, (5, 9))])
def test_causal_qkv_attention_matches_pallas(dtype, s, pad):
    jdt, tdt, rel = DTYPES[dtype]
    h, d = 4, 64
    qkv = _qkv(2, s, h, d, s + 7)
    valid = np.ones((2, s), bool)
    if pad is not None:
        valid[1, pad[0]:pad[1]] = False   # padded text slots mid-sequence
    want = JF.flash_attention_causal_qkv(
        jnp.asarray(qkv, jdt), h, jnp.asarray(valid), interpret=True)
    got = TF.flash_attention_causal_qkv(torch.tensor(qkv).to(tdt), h,
                                        torch.tensor(valid))
    assert_close(got.float().numpy(), np.asarray(want, np.float32), rel)


def test_relpos_bias_vector_is_the_bucket_bias():
    """The Toeplitz vector equals the full (H, T, T) bucket bias."""
    from tortoise_tpu.ops.relpos import relative_position_buckets, relpos_bias

    t, h = 150, 4
    table = np.random.default_rng(2).normal(0, 1, (32, h)).astype(np.float32)
    full = np.asarray(relpos_bias(jnp.asarray(table),
                                  relative_position_buckets(t)))
    vec = TF.relpos_bias_vector(torch.tensor(table), t).numpy()
    idx = np.arange(t)[None, :] - np.arange(t)[:, None] + t - 1
    np.testing.assert_array_equal(vec[:, idx], full)


@pytest.fixture(scope="module")
def decode_setup():
    cfg = tiny_ar_config()
    params = j_cast(random_ar_params(cfg, seed=3), jnp.bfloat16, int8=True)
    host = {"blocks": {k: tuple(np.asarray(a) for a in v)
                       if isinstance(v, tuple) else np.asarray(v)
                       for k, v in params["blocks"].items()},
            "head_pack": {k: np.asarray(v)
                          for k, v in params["head_pack"].items()}}
    return cfg, params, host


def _decode_inputs(cfg, b, seed):
    rng = np.random.default_rng(seed)
    c, hd = cfg.cache_len, cfg.d_model
    ck = rng.normal(0, 1, (cfg.n_layer, b, c, hd)).astype(np.float32)
    cv = rng.normal(0, 1, (cfg.n_layer, b, c, hd)).astype(np.float32)
    bias = np.where(np.arange(c)[None, :] < np.array([[20 + 3 * i]
                                                      for i in range(b)]),
                    0.0, -1e30).astype(np.float32)
    x = rng.normal(0, 1, (b, hd)).astype(np.float32)
    prev = rng.integers(0, cfg.n_mel_vocab, (b, 1)).astype(np.int32)
    u = rng.uniform(0, 1, (b, 1)).astype(np.float32)
    return ck, cv, bias, x, prev, u


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("mode", ["trunk", "head", "sampler"])
def test_decode_trunk_matches_pallas(decode_setup, b, mode):
    cfg, params, host = decode_setup
    ck, cv, bias, x, prev, u = _decode_inputs(cfg, b, 10 + b)
    sampler = (0.8, 5, 0.2, 2.0)
    jkw, tkw = {}, {}
    if mode != "trunk":
        jkw["head"] = params["head_pack"]
        tkw["head"] = tree_to_torch(host["head_pack"])
    if mode == "sampler":
        jkw.update(prev_u=(jnp.asarray(prev), jnp.asarray(u)),
                   sampler=sampler)
        tkw.update(prev_u=(torch.tensor(prev), torch.tensor(u)),
                   sampler=sampler)
    want = JA.fused_decode_trunk(
        params["blocks"], jnp.asarray(ck, jnp.bfloat16),
        jnp.asarray(cv, jnp.bfloat16), jnp.asarray(bias), jnp.asarray(x),
        n_head=cfg.n_head, interpret=True, **jkw)
    got = TA.fused_decode_trunk(
        tree_to_torch(host["blocks"]), torch.tensor(ck).bfloat16(),
        torch.tensor(cv).bfloat16(), torch.tensor(bias), torch.tensor(x),
        n_head=cfg.n_head, **tkw)
    assert len(got) == len(want)
    for g, w in zip(got[:4], want[:4]):
        assert_close(g.float().numpy(), np.asarray(w, np.float32), 5e-3)
    if mode == "sampler":
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


def test_sampler_ties_and_nucleus_rules():
    """First index wins a top-k tie, and the top candidate is never
    dropped even when it alone carries <= p_drop of the mass."""
    logits = torch.full((1, 256), -5.0)
    logits[0, [7, 9, 40]] = 3.0       # a three-way tie for the top
    logits[0, 100] = 2.0
    prev = torch.tensor([[200]], dtype=torch.int32)
    for uu, want in ((0.0, 7), (0.34, 9), (0.67, 40)):
        u = torch.tensor([[uu]])
        tok = TA.sample_plain(logits, prev, u, (1.0, 4, 0.0, 2.0))
        assert int(tok) == want
    flat = torch.zeros((1, 256))       # uniform: every top-k value ties
    flat[0, 3] = 1e-3
    tok = TA.sample_plain(flat, prev, torch.tensor([[0.0]]),
                          (1.0, 50, 0.99, 2.0))
    assert int(tok) == 3               # #0 kept although its mass <= 0.99
