"""Kernel D (the port's ``flash_attention``) against the JAX package's
``flash_attention``, on the CPU.

On the CPU the wrapper runs its plain PyTorch version; here that version
is held against the Pallas kernels run in interpret mode on the same
numpy inputs, in every bias mode the JAX function computes: both of its
bodies, D1 (the grouped band-bias body: ``bias_formula``, non-causal,
square) and D2 (the generic body). The hand-written kernel is held
against the plain version on a card by tests/test_torch_cuda.py.

Tolerances (max abs error relative to the reference's max magnitude):
f32 inputs 1e-4 (same math, another summation order, exp vs exp2);
bf16 inputs 2e-2 (the Pallas D1 body rounds q*scale*log2(e) to bf16
before the product; both round the softmax weights, and D1 the output,
to bf16).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tortoise_tpu_torch.ops.cuda import flash_attention as TF

JF = importlib.import_module("tortoise_tpu.ops.pallas.flash_attention")

DTYPES = {"f32": (np.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
MODES = ["none", "materialized", "buckets", "formula", "formula_masked",
         "causal_masked"]


def assert_close(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _inputs(mode, b, h, t, d, seed):
    from tortoise_tpu_torch.ops.relpos import relative_position_buckets

    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(0, 1, (b, h, t, d)).astype(np.float32)
               for _ in range(3))
    table = rng.normal(0, 0.3, (32, h)).astype(np.float32)
    kw = {}
    if mode == "materialized":
        kw["bias"] = rng.normal(0, 1, (h, t, t)).astype(np.float32)
    elif mode == "buckets":
        kw.update(bias_buckets=relative_position_buckets(t),
                  bias_table=table)
    elif mode.startswith("formula"):
        kw.update(bias_table=table, bias_formula=True)
    valid = None
    if mode.endswith("masked") or mode == "buckets":
        valid = np.ones((b, t), bool)
        valid[-1, t - 17:] = False      # a ragged row: padded keys
        valid[0, 5:9] = False           # and a hole mid-sequence
    return q, k, v, valid, kw


@pytest.mark.parametrize("d", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_flash_attention_matches_pallas(mode, dtype, d):
    jdt, tdt, rel = DTYPES[dtype]
    b, h, t = 2, 2, 100
    q, k, v, valid, kw = _inputs(mode, b, h, t, d, seed=d)
    causal = mode == "causal_masked"
    jkw = {n: jnp.asarray(a) for n, a in kw.items()
           if n not in ("bias_formula",)}
    tkw = {n: torch.tensor(a) for n, a in kw.items()
           if n not in ("bias_formula",)}
    if "bias_formula" in kw:
        jkw["bias_formula"] = tkw["bias_formula"] = True
    want = JF.flash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)),
        kv_valid=None if valid is None else jnp.asarray(valid),
        causal=causal, interpret=True, **jkw)
    got = TF.flash_attention(
        *(torch.tensor(a).to(tdt) for a in (q, k, v)),
        kv_valid=None if valid is None else torch.tensor(valid),
        causal=causal, **tkw)
    grouped = mode.startswith("formula")
    assert got.dtype == (tdt if grouped else torch.float32)
    assert np.dtype(want.dtype) == np.dtype(jdt if grouped else np.float32)
    assert_close(got.float().numpy(), np.asarray(want, np.float32), rel)


@pytest.mark.parametrize("d", [16, 32, 64])
def test_flash_attention_on_fused_qkv_views(d):
    """The diffusion fallback's call: strided (B, H, T, D) views of one
    per-head-interleaved qkv give the result of contiguous copies."""
    b, h, t = 2, 3, 70
    rng = np.random.default_rng(d)
    qkv = torch.tensor(rng.normal(0, 1, (b, t, 3 * h * d)).astype(
        np.float32))
    table = torch.tensor(rng.normal(0, 0.3, (32, h)).astype(np.float32))
    q, k, v = (qkv.reshape(b, t, h, 3, d)[:, :, :, p].transpose(1, 2)
               for p in range(3))
    got = TF.flash_attention(q, k, v, bias_table=table, bias_formula=True)
    want = TF.flash_attention(q.contiguous(), k.contiguous(),
                              v.contiguous(), bias_table=table,
                              bias_formula=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_toeplitz_vector_is_the_formula_bias_of_any_shape():
    """The (H, Tq+Tkv-1) vector equals the T5 bucket bias of j - i for a
    non-square block too (D2's formula mode when causal or ragged)."""
    from tortoise_tpu.ops.relpos import bucket_of_delta

    tq, tkv, h = 40, 90, 3
    table = np.random.default_rng(3).normal(0, 1, (32, h)).astype(
        np.float32)
    vec = TF.relpos_bias_vector(torch.tensor(table), tq, t_kv=tkv).numpy()
    delta = np.arange(tkv)[None, :] - np.arange(tq)[:, None]
    ids = np.asarray(bucket_of_delta(jnp.asarray(delta)))
    want = 8.0 * table[ids].transpose(2, 0, 1)
    np.testing.assert_array_equal(vec[:, delta + tq - 1], want)


UNEQUAL = [(200, 256), (256, 200), (100, 300)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mode", ["none", "materialized"])
@pytest.mark.parametrize("tq,tkv", UNEQUAL)
def test_flash_attention_at_unequal_lengths_matches_xla(tq, tkv, mode,
                                                        masked):
    """Kernel D's generic mode with Tq != Tkv (f32, 1e-4) against the JAX
    package's readable ``xla_attention``. Not against the Pallas kernel:
    its wrapper builds the all-valid key mask at the query length
    (``jnp.ones((b, t))`` with t = Tq) and pads that to the key blocks,
    so with Tq != Tkv it masks real keys or keeps padded ones. The port's
    key mask is of length Tkv."""
    b, h, d = 2, 2, 32
    rng = np.random.default_rng(tq + 7 * tkv)
    q = rng.normal(0, 1, (b, h, tq, d)).astype(np.float32)
    k, v = (rng.normal(0, 1, (b, h, tkv, d)).astype(np.float32)
            for _ in range(2))
    bias = None
    if mode == "materialized":
        bias = rng.normal(0, 1, (h, tq, tkv)).astype(np.float32)
    valid = None
    if masked:
        valid = np.ones((b, tkv), bool)
        valid[1, tkv - 23:] = False
        valid[0, 3:6] = False
    want = JF.xla_attention(
        *(jnp.asarray(a) for a in (q, k, v)),
        bias=None if bias is None else jnp.asarray(bias),
        kv_valid=None if valid is None else jnp.asarray(valid))
    got = TF.flash_attention(
        *(torch.tensor(a) for a in (q, k, v)),
        bias=None if bias is None else torch.tensor(bias),
        kv_valid=None if valid is None else torch.tensor(valid))
    assert got.dtype == torch.float32
    assert_close(got.numpy(), np.asarray(want), 1e-4)


def _numpy_attention(q, k, v, add):
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1]) + add
    p = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), v)


@pytest.mark.parametrize("formula", [False, True])
@pytest.mark.parametrize("tq,tkv", UNEQUAL)
def test_causal_at_unequal_lengths_is_top_left(tq, tkv, formula):
    """Causal with Tq != Tkv keeps the JAX kernel's top-left rule on
    absolute indices (row i sees key j when j <= i; rows past Tkv see
    every key), with a key mask and optionally the formula bias (then D2
    in the JAX package's routing), against numpy (f32, 1e-4).
    ``xla_attention`` builds its causal mask at Tq x Tq, so it cannot
    serve here."""
    from tortoise_tpu.ops.relpos import bucket_of_delta

    b, h, d = 2, 2, 16
    rng = np.random.default_rng(tq * tkv)
    q = rng.normal(0, 1, (b, h, tq, d)).astype(np.float32)
    k, v = (rng.normal(0, 1, (b, h, tkv, d)).astype(np.float32)
            for _ in range(2))
    table = rng.normal(0, 0.3, (32, h)).astype(np.float32)
    valid = np.ones((b, tkv), bool)
    valid[1, 40:45] = False
    i, j = np.arange(tq)[:, None], np.arange(tkv)[None, :]
    add = np.where(j <= i, 0.0, -1e30)[None, None] + \
        np.where(valid, 0.0, -1e30)[:, None, None, :]
    kw = {}
    if formula:
        ids = np.asarray(bucket_of_delta(jnp.asarray(j - i)))
        add = add + 8.0 * table[ids].transpose(2, 0, 1)[None]
        kw = dict(bias_table=torch.tensor(table), bias_formula=True)
    got = TF.flash_attention(*(torch.tensor(a) for a in (q, k, v)),
                             kv_valid=torch.tensor(valid), causal=True, **kw)
    assert got.dtype == torch.float32
    assert_close(got.numpy(), _numpy_attention(q, k, v, add), 1e-4)
