"""The hand-written CUDA kernels against their plain PyTorch versions,
on a card. These skip without one (the kernels have no CPU mode). The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerance: 2e-2 of the reference's max magnitude (bf16 outputs, another
summation order); the in-kernel sampler must pick the plain sampler's
token on the kernel's own logits.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tortoise_tpu.config import tiny_ar_config
from tortoise_tpu.io.checkpoint import random_ar_params
from tortoise_tpu_torch.ops.basic import pdot_int8act
from tortoise_tpu_torch.ops.cuda import decode_trunk as TA
from tortoise_tpu_torch.ops.cuda import flash_attention as TF
from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline.ar_stage import quantize_ar


def assert_close(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


def _qkv(b, t, h, d, seed):
    return np.random.default_rng(seed).normal(0, 1, (b, t, 3 * h * d)) \
        .astype(np.float32)


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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("t,n_valid", [(128, None), (300, 211)])
def test_packed_kernel_matches_plain_on_card(cuda_device, t, n_valid):
    h = 4
    qkv = torch.tensor(_qkv(2, t, h, 64, 3)).bfloat16().to(cuda_device)
    table = torch.randn(32, h, device=cuda_device) * 0.3
    valid = None
    if n_valid is not None:
        valid = torch.arange(t, device=cuda_device)[None, :] < torch.tensor(
            [[t], [n_valid]], device=cuda_device)
    bias_vec = TF.relpos_bias_vector(table, t)
    got = TF.flash_attention_packed(qkv, h, valid, bias_vec=bias_vec)
    want = TF.flash_attention_packed_plain(qkv, h, valid, bias_vec)
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)


@pytest.mark.cuda
def test_causal_kernel_matches_plain_on_card(cuda_device):
    h, s = 4, 200
    qkv = torch.tensor(_qkv(3, s, h, 64, 4)).bfloat16().to(cuda_device)
    valid = torch.ones((3, s), dtype=torch.bool, device=cuda_device)
    valid[:, 10:14] = False
    got = TF.flash_attention_causal_qkv(qkv, h, valid)
    want = TF.flash_attention_causal_qkv_plain(qkv, h, valid)
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 3])
def test_decode_kernel_matches_plain_on_card(cuda_device, b):
    cfg = dataclasses.replace(tiny_ar_config(), d_model=128, n_head=2,
                              d_mlp=256, n_mel_vocab=300)
    params = quantize_ar(tree_to_torch(random_ar_params(cfg, seed=4),
                                       cuda_device))
    ck, cv, bias, x, prev, u = (torch.tensor(a).to(cuda_device)
                                for a in _decode_inputs(cfg, b, 20 + b))
    ck, cv = ck.bfloat16(), cv.bfloat16()
    kw = dict(head=params["head_pack"], prev_u=(prev, u),
              sampler=(0.8, 50, 0.2, 2.0), n_head=cfg.n_head)
    got = TA.fused_decode_trunk(params["blocks"], ck, cv, bias, x, **kw)
    want = TA.fused_decode_trunk_plain(params["blocks"], ck, cv, bias, x,
                                       **kw)
    for g, w in zip(got[:4], want[:4]):
        assert_close(g.float().cpu().numpy(), w.float().cpu().numpy(), 2e-2)
    assert got[4].cpu().tolist() == TA.sample_plain(
        got[3], prev, u, kw["sampler"]).cpu().tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [8, 40])
def test_int8_products_on_card_equal_cpu(cuda_device, rows):
    """The int8 x int8 product sums exactly on the card (int32 tensor-core
    sums above 16 rows, f32 below) and on the CPU (f32 sums of small
    integers), so both give the same float32 result."""
    rng = np.random.default_rng(rows)
    x = torch.tensor(rng.normal(0, 1, (2, rows, 64)).astype(np.float32))
    wq = torch.tensor(rng.integers(-127, 128, (64, 48)).astype(np.int8))
    sc = torch.tensor(rng.uniform(0.01, 0.02, (1, 48)).astype(np.float32))
    want = pdot_int8act(x, (wq, sc))
    got = pdot_int8act(x.to(cuda_device), (wq.to(cuda_device),
                                           sc.to(cuda_device)))
    assert_close(got.cpu().numpy(), want.numpy(), 1e-6)


@pytest.mark.cuda
def test_int8_cast_on_card_equals_cpu(cuda_device):
    """Quantizing on the card gives the CPU's (and so the JAX package's)
    int8 pairs and head pack, bit for bit."""
    cfg = dataclasses.replace(tiny_ar_config(), n_layer=2)
    params = random_ar_params(cfg, seed=6)
    want = quantize_ar(tree_to_torch(params))
    got = quantize_ar(tree_to_torch(params, cuda_device))

    def flat(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in flat(tree[k])]
        if isinstance(tree, (list, tuple)):
            return [x for v in tree for x in flat(v)]
        return [tree]

    for g, w in zip(flat(got), flat(want), strict=True):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w)
