"""The error budget of the split-TF32 attention body, on the CPU.

``csrc/flash_attention_bhtd.cu`` runs every f32 attention call (kernels
B, C, D1 and D2 on f32 inputs) on the tensor cores: each f32 operand x of
Q K^T and P V is split into hi = tf32(x) and lo = tf32(x - hi), rounded
to 10 mantissa bits to nearest with ties away from zero (what
``cvt.rna.tf32.f32`` does), and each product is hi*hi + hi*lo + lo*hi
with f32 sums. The card cannot be asked here, so this file emulates that
arithmetic in torch and holds it, for every route and head width, against
the JAX package's f32 attention (``xla_attention`` on the route's
operands) and against the port's plain version, at 1e-5 of max |out|:
the tolerance the card holds the kernel to (tests/test_torch_cuda.py).
A single TF32 product misses it.
"""

import importlib
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tortoise_tpu_torch.ops.cuda import flash_attention as TF

JF = importlib.import_module("tortoise_tpu.ops.pallas.flash_attention")

TOL = 1e-5  # max |error| / max |out|
LOG2E = 1.4426950408889634


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero: half an ulp of TF32 (bit 12) added to the magnitude bits, then
    the 13 low bits cleared."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def mm_tf32(a: torch.Tensor, b: torch.Tensor, products: int = 3):
    """a @ b as the kernel forms it: three TF32 products (small terms
    first) or, with products=1, hi*hi alone. A TF32 x TF32 product is
    exact in f32 (11 + 11 significant bits), so an f32 matmul of the
    parts sums them as the tensor cores do, in f32."""
    ah, al = split(a)
    bh, bl = split(b)
    if products == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def attention_tf32(q, k, v, add, scale, products=3):
    """The kernel's function in its arithmetic: scores in split TF32,
    (s * scale + add) * log2 e and a base-2 softmax, P V in split TF32;
    f32 (B, H, Tq, D)."""
    s = mm_tf32(q, k.transpose(-1, -2), products)
    x = (s * scale + add) * LOG2E
    p = torch.exp2(x - x.amax(dim=-1, keepdim=True))
    return mm_tf32(p, v, products) / p.sum(dim=-1, keepdim=True)


def _route(route, d, seed):
    """One route's f32 call at a small size: (q, k, v as the kernel
    reads them, the (B or 1, H, Tq, Tkv) additive bias + mask + causal
    mask, the materialized bias for xla_attention or None, kv_valid,
    causal, the port's output in (B, H, Tq, D))."""
    b, h, t = 2, 2, 72
    rng = np.random.default_rng(seed)
    table = torch.tensor(rng.normal(0, 0.3, (32, h)).astype(np.float32))
    valid = np.ones((b, t), bool)
    valid[1, t - 13:] = False
    valid[0, 3:6] = False
    kv = torch.tensor(valid)
    mask = TF._additive_mask(kv)[:, None, None, :]
    if route in ("B", "C"):
        qkv = torch.tensor(rng.normal(0, 1, (b, t, 3 * h * d)).astype(
            np.float32))
        if route == "B":
            q, k, v = TF._split_packed(qkv, h)
            vec = TF.relpos_bias_vector(table, t)
            bias = TF._toeplitz_full(vec, t, t)
            out = TF.flash_attention_packed(qkv, h, kv, bias_vec=vec)
            causal = False
        else:
            q, k, v = TF._split_part_major(qkv, h)
            bias = None
            out = TF.flash_attention_causal_qkv(qkv, h, kv)
            causal = True
        out = out.view(b, t, h, d).transpose(1, 2)
    else:
        q, k, v = (torch.tensor(rng.normal(0, 1, (b, h, t, d)).astype(
            np.float32)) for _ in range(3))
        if route == "D1":  # the grouped band-bias body
            kw = dict(bias_table=table, bias_formula=True)
            bias = TF._toeplitz_full(TF.relpos_bias_vector(table, t), t, t)
            causal = False
        else:  # the generic body: a materialized bias, causal
            bias = torch.tensor(rng.normal(0, 1, (h, t, t)).astype(
                np.float32))
            kw = dict(bias=bias)
            causal = True
        out = TF.flash_attention(q, k, v, kv_valid=kv, causal=causal, **kw)
    add = mask + (0.0 if bias is None else bias[None])
    if causal:
        add = add + TF._causal_add(t, t, q.device)
    return q, k, v, add, bias, valid, causal, out


ROUTES = ["B", "C", "D1", "D2"]
WIDTHS = [16, 32, 64, 128]


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("value,want", [
    (1.0, 1.0),
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),     # a tie rounds away from 0
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),     # just below a tie: down
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2 * 2.0 ** -10),  # tie at an odd ulp
    (2.0 - 2.0 ** -23, 2.0),                  # carries into the exponent
    (3.0e-39, 3.0e-39 - math.fmod(3.0e-39, 2.0 ** -136)),  # subnormal
])
def test_tf32_rounding_is_nearest_ties_away(value, want):
    got = tf32_rna(torch.tensor([value], dtype=torch.float32))
    assert got.item() == np.float32(want)
    assert got.view(torch.int32).item() & 0x1FFF == 0


def test_split_keeps_f32_accuracy():
    """hi + lo stands for x to ~2^-22 of |x| (lo rounded too); hi alone
    to 2^-11."""
    x = torch.tensor(np.random.default_rng(0).normal(0, 3, 100_000)
                     .astype(np.float32))
    hi, lo = split(x)
    err2 = ((hi.double() + lo.double()) - x.double()).abs() / x.abs().double()
    err1 = (hi.double() - x.double()).abs() / x.abs().double()
    assert float(err2.max()) <= 2.0 ** -22
    assert float(err1.max()) <= 2.0 ** -11
    assert float(err1.max()) > 2.0 ** -13


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("route", ROUTES)
def test_split_tf32_attention_matches_jax_and_plain(route, d):
    """The kernel's arithmetic on each route's operands (views of the
    packed or part-major qkv for B and C; the band bias for D1; a
    materialized bias, a key mask and the causal flag for D2) within 1e-5
    of max |out| of the JAX package's f32 attention and of the port's
    plain version."""
    q, k, v, add, bias, valid, causal, plain = _route(route, d, seed=d)
    got = attention_tf32(q, k, v, add, d ** -0.5)
    want = JF.xla_attention(
        *(jnp.asarray(x.numpy()) for x in (q, k, v)),
        bias=None if bias is None else jnp.asarray(bias.numpy()),
        kv_valid=jnp.asarray(valid), causal=causal)
    assert _rel(got, want) <= TOL
    assert _rel(got, plain) <= TOL
    assert _rel(plain, want) <= TOL


@pytest.mark.parametrize("route,d", [("B", 64), ("D1", 32), ("C", 16),
                                     ("D2", 128)])
def test_one_tf32_product_misses_the_tolerance(route, d):
    """hi*hi alone (plain TF32, ~3 decimal digits a product) is off by
    far more than 1e-5 of max |out| on the same inputs, so the split is
    what holds the kernel to f32 accuracy."""
    q, k, v, add, _, _, _, plain = _route(route, d, seed=d)
    one = _rel(attention_tf32(q, k, v, add, d ** -0.5, products=1), plain)
    three = _rel(attention_tf32(q, k, v, add, d ** -0.5), plain)
    assert one > 10 * TOL
    assert three <= TOL
