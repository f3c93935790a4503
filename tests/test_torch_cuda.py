"""The hand-written CUDA kernels against their plain PyTorch versions,
on a card. These skip without one (the kernels have no CPU mode). The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerance: 2e-2 of the reference's max magnitude (bf16 outputs, another
summation order); 1e-4 for f32 inputs (kernel D's f32 body, kernel E);
the in-kernel sampler must pick the plain sampler's token on the
kernel's own logits.
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
from tortoise_tpu_torch.ops.cuda import lvc as TL
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
@pytest.mark.parametrize("t,lens", [(96, None), (384, None),
                                    (200, (200, 131, 77, 200))])
def test_packed_kernel_at_serving_shapes_on_card(cuda_device, t, lens):
    """Kernel B at the stream's window lengths (96 is not a multiple of
    its 64-key tile) and on a batch's 2B CFG rows with ragged per-row
    key masks (each length twice: the conditioned and unconditioned
    halves)."""
    h = 16
    valid = None
    b = 2 if lens is None else 2 * len(lens)
    qkv = torch.tensor(_qkv(b, t, h, 64, t)).bfloat16().to(cuda_device)
    if lens is not None:
        n = torch.tensor(list(lens) * 2, device=cuda_device)[:, None]
        valid = torch.arange(t, device=cuda_device)[None, :] < n
    bias_vec = TF.relpos_bias_vector(
        torch.randn(32, h, device=cuda_device) * 0.3, t)
    before = TF.flash_attention_packed.launches
    got = TF.flash_attention_packed(qkv, h, valid, bias_vec=bias_vec)
    assert TF.flash_attention_packed.launches == before + 1
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
@pytest.mark.parametrize("b", [1, 3, 16])
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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("n_valid", [None, 151])
def test_grouped_kernel_d1_matches_plain_on_card(cuda_device, d, n_valid):
    """Kernel D1 on strided views of a per-head-interleaved qkv, the
    diffusion fallback's call."""
    b, h, t = 2, 3, 190
    qkv = torch.tensor(_qkv(b, t, h, d, d)).bfloat16().to(cuda_device)
    q, k, v = (qkv.reshape(b, t, h, 3, d)[:, :, :, p].transpose(1, 2)
               for p in range(3))
    table = torch.randn(32, h, device=cuda_device) * 0.3
    valid = None
    if n_valid is not None:
        valid = torch.arange(t, device=cuda_device)[None, :] < torch.tensor(
            [[t], [n_valid]], device=cuda_device)
    kw = dict(bias_table=table, bias_formula=True)
    before = TF._grouped_flash.launches
    got = TF.flash_attention(q, k, v, None, valid, **kw)
    assert TF._grouped_flash.launches == before + 1
    want = TF.flash_attention_plain(q, k, v, None, valid, **kw)
    assert got.dtype == torch.bfloat16
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("mode", ["none", "materialized", "buckets",
                                  "causal_masked", "formula_f32"])
def test_generic_kernel_d2_matches_plain_on_card(cuda_device, dtype, tol,
                                                 mode):
    from tortoise_tpu_torch.ops.relpos import relative_position_buckets

    b, h, t, d = 2, 2, 150, 32
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn((b, h, t, d), generator=g, device=cuda_device)
               .to(dtype) for _ in range(3))
    table = torch.randn(32, h, device=cuda_device) * 0.3
    valid = torch.ones((b, t), dtype=torch.bool, device=cuda_device)
    valid[1, 131:] = False
    valid[0, 5:9] = False
    kw = {}
    if mode == "materialized":
        kw["bias"] = torch.randn((h, t, t), generator=g, device=cuda_device)
    elif mode == "buckets":
        kw.update(bias_buckets=torch.tensor(relative_position_buckets(t),
                                            device=cuda_device),
                  bias_table=table)
    elif mode == "formula_f32":
        # D1's rule with f32 inputs (the f32 parity plane's denoiser)
        kw.update(bias_table=table, bias_formula=True)
    causal = mode == "causal_masked"
    got = TF.flash_attention(q, k, v, kv_valid=valid, causal=causal, **kw)
    want = TF.flash_attention_plain(q, k, v, kv_valid=valid, causal=causal,
                                    **kw)
    assert got.dtype == want.dtype
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), tol)


@pytest.mark.cuda
def test_kernel_d_rejects_other_head_widths(cuda_device):
    q = torch.zeros((1, 2, 16, 48), dtype=torch.bfloat16,
                    device=cuda_device)
    with pytest.raises(ValueError, match="head width"):
        TF.flash_attention(q, q, q)


@pytest.mark.cuda
def test_packed_and_causal_kernels_take_head_width_128(cuda_device):
    """Kernels B and C at the other head width the JAX package routes to
    them: the wrappers run kernel D on strided views of the same qkv."""
    h, t = 2, 230
    qkv = torch.tensor(_qkv(2, t, h, 128, 7)).bfloat16().to(cuda_device)
    valid = torch.arange(t, device=cuda_device)[None, :] < torch.tensor(
        [[t], [201]], device=cuda_device)
    bias_vec = TF.relpos_bias_vector(
        torch.randn(32, h, device=cuda_device) * 0.3, t)
    got = TF.flash_attention_packed(qkv, h, valid, bias_vec=bias_vec)
    want = TF.flash_attention_packed_plain(qkv, h, valid, bias_vec)
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)
    got = TF.flash_attention_causal_qkv(qkv, h, valid)
    want = TF.flash_attention_causal_qkv_plain(qkv, h, valid)
    assert got.dtype == torch.bfloat16
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)


@pytest.mark.cuda
def test_packed_kernel_b_equals_d1_on_one_qkv(cuda_device):
    """Kernels B and D1 compute the same function from two layouts."""
    b, h, t, d = 2, 4, 300, 64
    qkv = torch.tensor(_qkv(b, t, h, d, 8)).bfloat16().to(cuda_device)
    table = torch.randn(32, h, device=cuda_device) * 0.3
    via_b = TF.flash_attention_packed(qkv, h, bias_table=table)
    q, k, v = (qkv.reshape(b, t, h, 3, d)[:, :, :, p].transpose(1, 2)
               for p in range(3))
    via_d = TF.flash_attention(q, k, v, bias_table=table, bias_formula=True)
    assert_close(via_d.transpose(1, 2).reshape(b, t, h * d).float().cpu()
                 .numpy(), via_b.float().cpu().numpy(), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,c_res,l,hop", [(32, 32, 23, 8),
                                              (32, 32, 9, 64),
                                              (32, 32, 5, 256),
                                              (4, 4, 11, 2), (8, 8, 6, 16),
                                              # a stream chunk: one 32-frame
                                              # bucket at each stage's hop
                                              (32, 32, 32, 8),
                                              (32, 32, 32, 64),
                                              (32, 32, 32, 256)])
def test_lvc_kernel_matches_plain_on_card(cuda_device, c_in, c_res, l, hop):
    g = torch.Generator(device=cuda_device).manual_seed(hop)
    x = torch.randn((2, c_in, l * hop), generator=g, device=cuda_device)
    kern_all = torch.randn((2, 4, c_in, 2 * c_res, 3, l), generator=g,
                           device=cuda_device) * 0.1
    bias = torch.randn((2, 2 * c_res, l), generator=g, device=cuda_device)
    res = torch.randn((2, c_res, l * hop), generator=g, device=cuda_device)
    before = TL.lvc_gated_residual.launches
    got = TL.lvc_gated_residual(x, kern_all[:, 1], bias, res, hop)
    assert TL.lvc_gated_residual.launches == before + 1
    want = TL.lvc_gated_residual_plain(x, kern_all[:, 1], bias, res, hop)
    assert_close(got.cpu().numpy(), want.cpu().numpy(), 1e-4)


@pytest.mark.cuda
def test_server_batch_on_card_launches_kernels_a_and_b(cuda_device):
    """A SynthesisServer batch on the card (bf16 + int8, a narrow AR and
    denoiser of 64-wide heads so kernels A and B take them): three ragged
    requests land in one batch padded to 4 and launch both kernels."""
    from tortoise_tpu.config import tiny_diffusion_config, tiny_vocoder_config
    from tortoise_tpu.io.checkpoint import (
        random_diffusion_params,
        random_vocoder_params,
    )
    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels
    from tortoise_tpu_torch.serve import SynthesisServer

    acfg = dataclasses.replace(tiny_ar_config(), d_model=128, n_head=2,
                               d_mlp=256, max_decode_steps=8)
    dcfg = dataclasses.replace(tiny_diffusion_config(), d_model=128,
                               n_head=2, timestep_dim=128,
                               n_sample_timesteps=4, use_flash=True)
    vcfg = tiny_vocoder_config()
    models = TortoiseModels(random_ar_params(acfg, 0),
                            random_diffusion_params(dcfg, 1),
                            random_vocoder_params(vcfg, 2), acfg, dcfg, vcfg)
    rng = np.random.default_rng(0)
    voice = rng.normal(0, 0.5, (128,)).astype(np.float32)
    server = SynthesisServer(models, compute_dtype=torch.bfloat16,
                             int8_weights=True, max_batch=4,
                             max_wait_ms=2000, default_voice=voice,
                             device=cuda_device)
    reset_launch_counts()
    with server:
        futs = [server.submit(tokens=[1] + rng.integers(3, 30, size=n)
                              .tolist() + [0], seed=1) for n in (3, 6, 9)]
        results = [f.result(timeout=60) for f in futs]
    counts = launch_counts()
    assert counts["decode_trunk"] > 0, counts
    assert counts["flash_attention_packed"] > 0, counts
    st = server.stats()
    assert (st["batches"], st["rows"], st["padded_rows"]) == (1, 3, 1)
    for r in results:
        assert len(r.audio) > 0 and np.isfinite(r.audio).all()
