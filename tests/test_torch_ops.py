"""The port's ops (tortoise_tpu_torch.ops, pipeline.schedule) against
their JAX twins on the same numpy inputs.

Tolerance: max abs error <= tol * max |reference|, with tol from
tests/pseudo_golden_lib.py — 1e-3 on f32, 5e-3 with int8 weights, 3e-2
on bf16 (the two frameworks round bf16 at different places). Integer
outputs (bucket ids, sampled tokens, schedules' maps) must be equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tortoise_tpu.ops import basic as JB
from tortoise_tpu.ops import conv as JC
from tortoise_tpu.ops import relpos as JR
from tortoise_tpu.ops import sampling as JS
from tortoise_tpu.pipeline import schedule as JSch
from tortoise_tpu_torch.ops import basic as TB
from tortoise_tpu_torch.ops import conv as TC
from tortoise_tpu_torch.ops import relpos as TR
from tortoise_tpu_torch.ops import sampling as TS
from tortoise_tpu_torch.pipeline import schedule as TSch

F32, INT8, BF16 = 1e-3, 5e-3, 3e-2
JDT = {None: None, "bf16": jnp.bfloat16}
TDT = {None: None, "bf16": torch.bfloat16}


def rnd(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


def close(got, want, tol):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), err


def t(a):
    return torch.tensor(a)


@pytest.mark.parametrize("cd", [None, "bf16"])
@pytest.mark.parametrize("int8", [False, True])
def test_pdot(cd, int8):
    x, w = rnd(5, 32), rnd(32, 24, seed=1)
    jw, tw = jnp.asarray(w), t(w)
    if int8:
        wq, sc = JB.quantize_cols_host(w)
        jw, tw = (jnp.asarray(wq), jnp.asarray(sc)), (t(wq), t(sc))
    want = JB.pdot(jnp.asarray(x), jw, JDT[cd])
    got = TB.pdot(t(x), tw, TDT[cd])
    close(got, want, 1e-5)
    if cd is not None:  # out_dtype emits the compute dtype
        got = TB.pdot(t(x), tw, TDT[cd], out_dtype=torch.bfloat16)
        assert got.dtype == torch.bfloat16
        close(got, JB.pdot(jnp.asarray(x), jw, JDT[cd], jnp.bfloat16), BF16)


def test_pdot_int8act():
    x, w = rnd(6, 48, seed=2), rnd(48, 20, seed=3)
    wq, sc = JB.quantize_cols_host(w)
    want = JB.pdot_int8act(jnp.asarray(x), (jnp.asarray(wq),
                                            jnp.asarray(sc)))
    close(TB.pdot_int8act(t(x), (t(wq), t(sc))), want, 1e-6)


def test_quantize_cols_is_the_jax_packages():
    w = rnd(3, 40, 17, seed=4)
    for a, b in zip(TB.quantize_cols(t(w)), JB.quantize_cols_host(w)):
        assert a.numpy().dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("cd", [None, "bf16"])
def test_layer_norm(affine, cd):
    x = rnd(4, 7, 64, seed=5, scale=3.0) + 1.0
    w, b = (rnd(64, seed=6), rnd(64, seed=7)) if affine else (None, None)
    jx, tx = jnp.asarray(x), t(x)
    if cd:
        jx, tx = jx.astype(jnp.bfloat16), tx.bfloat16()
    want = JB.layer_norm(jx, None if w is None else jnp.asarray(w),
                         None if b is None else jnp.asarray(b))
    got = TB.layer_norm(tx, None if w is None else t(w),
                        None if b is None else t(b))
    assert got.dtype == tx.dtype
    close(got, want, BF16 if cd else F32)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_group_norm_tc(fast, masked):
    x = rnd(2, 10, 16, seed=8, scale=2.0) + 0.5
    w, b = rnd(16, seed=9), rnd(16, seed=10)
    mask = np.arange(10)[None, :] < np.array([[10], [6]]) if masked else None
    want = JB.group_norm_tc(jnp.asarray(x), 4, jnp.asarray(w),
                            jnp.asarray(b), mask=None if mask is None
                            else jnp.asarray(mask), fast=fast)
    got = TB.group_norm_tc(t(x), 4, t(w), t(b), mask=None if mask is None
                           else t(mask), fast=fast)
    close(got, want, F32)


@pytest.mark.parametrize("name", ["gelu", "silu", "leaky_relu"])
def test_activations(name):
    x = rnd(3, 50, seed=11, scale=3.0)
    close(getattr(TB, name)(t(x)), getattr(JB, name)(jnp.asarray(x)), F32)


@pytest.mark.parametrize("stride,padding,dilation,groups",
                         [(1, 2, 1, 1), (1, 3, 3, 1), (2, 1, 1, 1),
                          (1, 1, 1, 2)])
def test_conv1d(stride, padding, dilation, groups):
    x, w, b = rnd(2, 8, 30, seed=12), rnd(6, 8 // groups, 5, seed=13), \
        rnd(6, seed=14)
    kw = dict(stride=stride, padding=padding, dilation=dilation,
              groups=groups)
    close(TC.conv1d(t(x), t(w), t(b), **kw),
          JC.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw),
          F32)


@pytest.mark.parametrize("k,padding,cd", [(3, 1, None), (1, 0, None),
                                          (3, 1, "bf16"), (5, 2, None)])
def test_conv1d_nwc(k, padding, cd):
    x, w, b = rnd(2, 12, 8, seed=15), rnd(10, 8, k, seed=16), rnd(10, seed=17)
    want = JC.conv1d_nwc(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                         padding=padding, compute_dtype=JDT[cd],
                         out_dtype=JDT[cd])
    got = TC.conv1d_nwc(t(x), t(w), t(b), padding=padding,
                        compute_dtype=TDT[cd], out_dtype=TDT[cd])
    close(got, want, BF16 if cd else F32)


@pytest.mark.parametrize("k", [1, 3])
def test_conv1d_nwc_int8(k):
    x, b = rnd(2, 12, 8, seed=18), rnd(10, seed=19)
    w = rnd(10, 8, k, seed=20)
    wm = np.swapaxes(w, -1, -3).reshape(k * 8, 10)
    wq, sc = JB.quantize_cols_host(wm)
    pad = (k - 1) // 2
    want = JC.conv1d_nwc(jnp.asarray(x), (jnp.asarray(wq), jnp.asarray(sc)),
                         jnp.asarray(b), padding=pad)
    close(TC.conv1d_nwc(t(x), (t(wq), t(sc)), t(b), padding=pad), want, 1e-6)


def test_conv_transpose_pad_upscale():
    x, w, b = rnd(2, 4, 9, seed=21), rnd(4, 3, 8, seed=22), rnd(3, seed=23)
    close(TC.conv_transpose1d(t(x), t(w), t(b), stride=4),
          JC.conv_transpose1d(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(b), stride=4), F32)
    close(TC.reflect_pad1d(t(x), 3), JC.reflect_pad1d(jnp.asarray(x), 3), 0)
    close(TC.nearest_upscale_time(t(x), 23),
          JC.nearest_upscale_time(jnp.asarray(x), 23), 0)


@pytest.mark.parametrize("length", [7, 64, 300])
def test_relpos_buckets(length):
    np.testing.assert_array_equal(TR.relative_position_buckets(length),
                                  JR.relative_position_buckets(length))
    delta = np.arange(-2 * length, 2 * length)
    np.testing.assert_array_equal(TR.bucket_of_delta(delta),
                                  np.asarray(JR.bucket_of_delta(
                                      jnp.asarray(delta))))
    table = rnd(32, 4, seed=24)
    bk = TR.relative_position_buckets(length)
    close(TR.relpos_bias(t(table), t(bk)),
          JR.relpos_bias(jnp.asarray(table), jnp.asarray(bk)), 0)


def _logits(b=3, v=300, seed=25):
    return rnd(b, v, seed=seed, scale=2.0)


def test_penalty_topk_topp_filters():
    x = _logits()
    prev = np.array([[1, 5, 5], [0, 299, 7], [3, 3, 3]], np.int32)
    close(TS.apply_repetition_penalty(t(x), t(prev)),
          JS.apply_repetition_penalty(jnp.asarray(x), jnp.asarray(prev)), 0)
    close(TS.top_k_filter(t(x), 50), JS.top_k_filter(jnp.asarray(x), 50), 0)
    close(TS.top_p_filter(t(x)), JS.top_p_filter(jnp.asarray(x)), 0)
    close(TS.process_logits(t(x), t(prev)),
          JS.process_logits(jnp.asarray(x), jnp.asarray(prev)), F32)


@pytest.mark.parametrize("top_k", [5, 50])
def test_process_logits_topk_and_draw(top_k):
    x = _logits(seed=26)
    prev = np.array([[4], [8], [15]], np.int32)
    probs, ids = TS.process_logits_topk(t(x), t(prev), top_k=top_k)
    jp, ji = JS.process_logits_topk(jnp.asarray(x), jnp.asarray(prev),
                                    top_k=top_k)
    close(probs, jp, F32)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ji))
    for uu in (0.05, 0.5, 0.93):
        u = np.full((3, 1), uu, np.float32)
        np.testing.assert_array_equal(
            TS.sample_from_topk_u(t(u), probs, ids).numpy(),
            np.asarray(JS.sample_from_topk_u(jnp.asarray(u), jp, ji)))


def test_host_sampler_reference_plane():
    from tortoise_tpu.rng import ReferenceRng

    x = _logits(b=2, v=500, seed=27)
    prev = [[1, 1, 1, 498], [7]]
    for seed in (0, 3):
        got = TS.host_process_logits_and_sample(x, prev, ReferenceRng(seed))
        want = JS.host_process_logits_and_sample(x, prev, ReferenceRng(seed))
        np.testing.assert_array_equal(got, want)


def test_schedule_arrays():
    for n in (80, 30):
        a = TSch.make_schedule(n_steps=n)
        b = JSch.make_schedule(n_steps=n)
        for field in ("timestep_map", "betas", "alphas_cumprod",
                      "posterior_log_variance_clipped",
                      "posterior_mean_coef1", "posterior_mean_coef2"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))


def test_timestep_embedding_and_posterior_math():
    ts = np.array([0, 17, 1234, 3999])
    close(TSch.timestep_embedding(t(ts), 64),
          JSch.timestep_embedding(jnp.asarray(ts), 64), 1e-5)
    for step in (0, 40, 79):
        assert TSch.cond_free_k(step, 80) == pytest.approx(
            float(JSch.cond_free_k(step, 80)), abs=0)
    x, eps = rnd(2, 8, seed=28), rnd(2, 8, seed=29)
    close(TSch.predict_xstart_from_eps(t(x), t(eps), 1.7, 0.9),
          JSch.predict_xstart_from_eps(jnp.asarray(x), jnp.asarray(eps),
                                       1.7, 0.9), F32)
