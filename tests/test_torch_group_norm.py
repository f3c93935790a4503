"""Kernel G's op (``ops.cuda.group_norm.group_norm_act``) on the CPU: its
plain twin against the JAX package's ``group_norm_tc`` followed by the
same chain in float32, its launch plan, the arguments it refuses, and
how often the denoiser calls it. The kernel itself runs only on a card
(tests/test_torch_cuda.py).

Tolerance: f32 maps within 1e-5 of max |out| (the exact centered
statistics, another summation order); bf16 maps within one bf16
rounding of the JAX chain's f32 result (half a bf16 ulp, plus 1e-5 of
max |out| for the f32 sums' order).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tortoise_tpu.ops import basic as JB
from tortoise_tpu_torch.ops.cuda import group_norm as G

torch.set_num_threads(1)  # the tier-1 run's workers share the cores


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    a = np.maximum(np.abs(v), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(a)) - 7)


def _inputs(b, t, c, dtype, masked, film, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(0.3, 1.7, (b, t, c)).astype(np.float32))
    x = x.to(dtype)
    w = torch.tensor(rng.normal(1.0, 0.2, c).astype(np.float32))
    bias = torch.tensor(rng.normal(0.0, 0.2, c).astype(np.float32))
    mask = None
    if masked:
        lens = torch.tensor([t - 5 * i for i in range(b)])
        mask = torch.arange(t)[None, :] < lens[:, None]
    pair = None
    if film == "rows":
        pair = tuple(torch.tensor(rng.normal(0, 0.5, (b, c)).astype(
            np.float32)).to(dtype) for _ in range(2))
    elif film == "shared":
        pair = tuple(torch.tensor(rng.normal(0, 0.5, c).astype(
            np.float32)).to(dtype) for _ in range(2))
    return x, w, bias, mask, pair


JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jax_chain(x, groups, w, bias, mask, film, silu):
    """The JAX package's group_norm_tc on the f32 map (the one-pass form
    for a bf16 map), then FiLM (its factor 1 + scale in the FiLM's dtype,
    as the JAX denoiser forms it), SiLU and the mask in f32."""
    m = None if mask is None else jnp.asarray(mask.numpy())
    y = JB.group_norm_tc(jnp.asarray(x.float().numpy()), groups,
                         jnp.asarray(w.numpy()), jnp.asarray(bias.numpy()),
                         mask=m, fast=x.dtype == torch.bfloat16)
    if film is not None:
        s, sh = (jnp.asarray(f.float().numpy()).reshape(-1, 1, x.shape[-1])
                 .astype(JDT[f.dtype]) for f in film)
        y = y * (1.0 + s).astype(jnp.float32) + sh.astype(jnp.float32)
    if silu:
        y = JB.silu(y)
        if m is not None:
            y = jnp.where(m[..., None], y, 0.0)
    return np.asarray(y, np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("film,silu", [(None, False), (None, True),
                                       ("rows", True), ("shared", False)])
@pytest.mark.parametrize("b,t,c,groups", [(2, 37, 64, 4), (3, 20, 32, 2)])
def test_plain_twin_matches_the_jax_chain(dtype, masked, film, silu, b, t, c,
                                          groups):
    x, w, bias, mask, pair = _inputs(b, t, c, dtype, masked, film, b + t)
    got = G.group_norm_act(x, groups, w, bias, 1e-5, mask, film=pair,
                           silu=silu)
    assert got.dtype == dtype and got.shape == x.shape
    want = _jax_chain(x, groups, w, bias, mask, pair, silu)
    err = np.abs(got.float().numpy() - want)
    top = np.abs(want).max()
    if dtype == torch.float32:
        assert err.max() <= 1e-5 * top, err.max()
    else:
        assert (err <= 0.5 * _bf16_ulp(want) + 1e-5 * top).all(), err.max()
    if mask is not None:  # padded frames: 0, or the FiLM shift alone
        pad = got.float()[~mask]
        if silu or pair is None:
            assert not pad.any()
        else:
            shift = pair[1].float().reshape(-1, 1, c).expand(b, t, c)
            assert torch.equal(pad, shift[~mask])


@pytest.mark.parametrize("b", [1, 2, 3, 32])
@pytest.mark.parametrize("t", [1, 3, 39, 96, 2176, 2304])
def test_gn_plan_covers_the_rows_in_whole_row_sums(b, t):
    """Every row in exactly one chunk and no empty chunk (the C entry's
    checks), chunks a whole number of the kernel's interleaved row sums,
    and about two blocks an SM where the rows allow it."""
    p = G.gn_plan(b, t)
    chunk, n = p["chunk"], p["n_chunks"]
    assert chunk % G.GN_ACC == 0 and chunk * n >= t > chunk * (n - 1)
    if t >= 2 * G.SM_COUNT * G.GN_ACC:
        assert G.SM_COUNT <= n * b <= 3 * G.SM_COUNT


def test_gn_plan_at_the_denoisers_map():
    assert G.gn_plan(2, 2176) == dict(chunk=20, n_chunks=109)


def _refused(x, groups=4, w=None, b=None, mask=None, film=None):
    c = x.shape[-1]
    w = torch.ones(c) if w is None else w
    b = torch.zeros(c) if b is None else b
    with pytest.raises(ValueError):
        G.group_norm_act(x, groups, w, b, 1e-5, mask, film=film)


def test_group_norm_act_refuses_what_the_kernel_does_not_take():
    """On the CPU as on the card: the same checks run before either."""
    x = torch.randn(2, 10, 64)
    _refused(x.transpose(0, 1).contiguous().transpose(0, 1))  # strided
    _refused(x.half())
    _refused(torch.randn(2, 10, 60).bfloat16())  # C not a multiple of 8
    _refused(torch.randn(2, 10, 34), groups=2)   # ... nor of 4 in f32
    _refused(x, groups=5)                    # groups must divide C
    _refused(torch.randn(2, 10, 2048))       # past 256 f32 vectors
    _refused(torch.randn(10, 64))            # not (B, T, C)
    _refused(x, w=torch.ones(64).double())
    _refused(x, b=torch.zeros(32))
    _refused(x, mask=torch.ones(2, 9, dtype=torch.bool))
    _refused(x, mask=torch.ones(2, 10))
    _refused(x, film=(torch.randn(2, 64).bfloat16(), torch.randn(2, 64)))
    _refused(x, film=(torch.randn(2, 64), torch.randn(2, 128)[:, ::2]))


def test_group_norm_act_counts_only_card_launches():
    from tortoise_tpu_torch.ops.cuda import launch_counts

    before = launch_counts()["group_norm_act"]
    x, w, bias, _, _ = _inputs(2, 9, 64, torch.float32, False, None, 0)
    G.group_norm_act(x, 4, w, bias)
    assert launch_counts()["group_norm_act"] == before


@pytest.fixture
def counted(monkeypatch):
    """The denoiser's calls of group_norm_act, with what each asked for."""
    from tortoise_tpu_torch.models import diffusion as TDM

    calls = []
    real = TDM.group_norm_act

    def spy(x, n_groups, *args, **kw):
        calls.append((tuple(x.shape), x.dtype, kw.get("film") is not None,
                      kw.get("silu", False)))
        return real(x, n_groups, *args, **kw)

    monkeypatch.setattr(TDM, "group_norm_act", spy)
    return calls


@pytest.mark.parametrize("compute_dtype", [None, torch.bfloat16])
def test_denoiser_calls_the_op_at_every_group_norm(counted, compute_dtype):
    """One eval at the published depths (3 integrator layers, 10 main, 3
    tail resblocks) calls the op 46 times, on time-major maps of the
    compute dtype; a conditioner pass 5 times (4 blocks, code_norm)."""
    from tortoise_tpu_torch.config import DiffusionConfig
    from tortoise_tpu_torch.io.checkpoint import random_diffusion_params
    from tortoise_tpu_torch.models import diffusion as TDM
    from tortoise_tpu_torch.params import tree_to_torch

    cfg = dataclasses.replace(DiffusionConfig(), d_model=32, n_head=2,
                              n_groups=4, timestep_dim=32, n_mel=8)
    params = tree_to_torch(random_diffusion_params(cfg, seed=1))
    rng = np.random.default_rng(0)
    t = 24
    x = torch.tensor(rng.normal(0, 1, (2, cfg.n_mel, t)).astype(np.float32))
    code = torch.tensor(rng.normal(0, .5, (2, 32, t)).astype(np.float32))
    mask = (torch.arange(t)[None, :] < torch.tensor([[t], [t - 5]]))
    buckets = torch.zeros((t, t), dtype=torch.long)
    TDM.denoise(params, cfg, x, code, 7, buckets, mask, compute_dtype)
    assert len(counted) == 46
    assert {c[:2] for c in counted} == {((2, t, 32),
                                          compute_dtype or torch.float32)}
    film = [c for c in counted if c[2]]
    assert len(film) == 16 and all(c[3] for c in film)  # res_out_norm
    assert sum(1 for c in counted if c[3]) == 16 + 16 + 1
    del counted[:]
    lat = torch.tensor(rng.normal(0, 1, (2, 10, 32)).astype(np.float32))
    lat_mask = torch.arange(10)[None, :] < torch.tensor([[10], [6]])
    out = TDM.latent_conditioner(params, cfg, lat,
                                 torch.zeros((10, 10), dtype=torch.long),
                                 lat_mask, compute_dtype)
    assert len(counted) == 5 and counted[-1][2] and not counted[-1][3]
    # the conditioner's map stays f32 on either plane
    assert {c[1] for c in counted} == {torch.float32} == {out.dtype}
