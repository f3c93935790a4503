"""The hand-written CUDA kernels against their plain PyTorch versions,
on a card. These skip without one (the kernels have no CPU mode). The
file imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerance: 2e-2 of the reference's max magnitude (bf16 outputs, another
summation order); 1e-4 for f32 inputs (kernel E, and the older f32
checks of B, C and D), 1e-5 for the split-TF32 body on every f32 route
(``F32_TOL``: three TF32 products a product keep ~1e-6 of max |out|);
1e-2 for kernel F (round(127 p) on either side of a tie);
the in-kernel sampler must pick the plain sampler's token on the
kernel's own logits. Kernel G (the group norm and its chain) against
its plain twin's f32 result: 1e-5 of max |out| on f32 maps, within one
bf16 rounding (half an ulp, plus 1e-5 of max |out| for the f32 sums'
order) on bf16 maps.
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
from tortoise_tpu_torch.ops.cuda import flash_attention_int8 as TI
from tortoise_tpu_torch.ops.cuda import group_norm as TG
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
@pytest.mark.parametrize("sample", [True, False])
@pytest.mark.parametrize("b", [1, 3, 16])
def test_decode_kernel_matches_plain_on_card(cuda_device, b, sample):
    """Kernel A against its plain twin, with the head and with or without
    the in-kernel sampler."""
    cfg = dataclasses.replace(tiny_ar_config(), d_model=128, n_head=2,
                              d_mlp=256, n_mel_vocab=300)
    params = quantize_ar(tree_to_torch(random_ar_params(cfg, seed=4),
                                       cuda_device))
    ck, cv, bias, x, prev, u = (torch.tensor(a).to(cuda_device)
                                for a in _decode_inputs(cfg, b, 20 + b))
    ck, cv = ck.bfloat16(), cv.bfloat16()
    kw = dict(head=params["head_pack"], n_head=cfg.n_head)
    if sample:
        kw.update(prev_u=(prev, u), sampler=(0.8, 50, 0.2, 2.0))
    got = TA.fused_decode_trunk(params["blocks"], ck, cv, bias, x, **kw)
    want = TA.fused_decode_trunk_plain(params["blocks"], ck, cv, bias, x,
                                       **kw)
    assert len(got) == len(want) == (5 if sample else 4)
    for g, w in zip(got[:4], want[:4]):
        assert_close(g.float().cpu().numpy(), w.float().cpu().numpy(), 2e-2)
    if sample:
        assert got[4].cpu().tolist() == TA.sample_plain(
            got[3], prev, u, kw["sampler"]).cpu().tolist()


@pytest.mark.cuda
def test_decode_kernel_rows_split_as_their_batch_on_card(cuda_device):
    """A dp rank's rows through kernel A with ``split_rows`` naming the
    whole batch get the bits they get in the whole batch's launch (the
    cache attention is split over the blocks by B * H, so a smaller B
    alone would split it another way)."""
    cfg = dataclasses.replace(tiny_ar_config(), d_model=128, n_head=2,
                              d_mlp=256, n_mel_vocab=300, cache_len=640)
    params = quantize_ar(tree_to_torch(random_ar_params(cfg, seed=4),
                                       cuda_device))
    ck, cv, _, x, prev, u = (torch.tensor(a).to(cuda_device)
                             for a in _decode_inputs(cfg, 8, 28))
    ck, cv = ck.bfloat16(), cv.bfloat16()
    bias = torch.zeros((8, cfg.cache_len), device=cuda_device)
    kw = dict(head=params["head_pack"], n_head=cfg.n_head,
              sampler=(0.8, 50, 0.2, 2.0))
    whole = TA.fused_decode_trunk(params["blocks"], ck, cv, bias, x,
                                  prev_u=(prev, u), **kw)
    part = TA.fused_decode_trunk(
        params["blocks"], ck[:, :4].contiguous(), cv[:, :4].contiguous(),
        bias[:4], x[:4], prev_u=(prev[:4], u[:4]), split_rows=8, **kw)
    for w, p, rows_dim in zip(whole, part, (0, 1, 1, 0, 0)):
        assert torch.equal(w.narrow(rows_dim, 0, 4), p)


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
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("b,t,lens", [(2, 333, None), (16, 200, "ragged"),
                                      (2, 260, (260, 177))])
def test_d1_on_the_tma_body_matches_plain_on_card(cuda_device, d, b, t,
                                                  lens):
    """Kernel D1's bf16 work on the wgmma + TMA body: a ragged T (not a
    multiple of the 64-key tile or the 128-row block), 16 batch rows with
    ragged key masks (a server batch's CFG rows), and a masked row."""
    h = 3
    qkv = torch.tensor(_qkv(b, t, h, d, d + t)).bfloat16().to(cuda_device)
    q, k, v = (qkv.reshape(b, t, h, 3, d)[:, :, :, p].transpose(1, 2)
               for p in range(3))
    valid = None
    if lens == "ragged":
        n = torch.tensor([t - 11 * (i // 2) for i in range(b)],
                         device=cuda_device)
        valid = torch.arange(t, device=cuda_device)[None, :] < n[:, None]
    elif lens is not None:
        valid = torch.arange(t, device=cuda_device)[None, :] < torch.tensor(
            lens, device=cuda_device)[:, None]
    kw = dict(bias_table=torch.randn(32, h, device=cuda_device) * 0.3,
              bias_formula=True)
    assert TF.attention_body(q.dtype, d, "D1") == "tma"
    before = TF._grouped_flash.launches
    got = TF.flash_attention(q, k, v, None, valid, **kw)
    assert TF._grouped_flash.launches == before + 1
    want = TF.flash_attention_plain(q, k, v, None, valid, **kw)
    assert got.dtype == torch.bfloat16
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,h", [("B", 8), ("B", 4), ("C", 8),
                                      ("C", 4), ("D1", 16)])
def test_kernels_take_a_tp_ranks_local_heads_on_card(cuda_device, kernel,
                                                     h):
    """Under tensor parallelism a rank holds n_head / tp heads: B and C at
    8 and 4 of the production 16 heads of 64 (tp = 2, 4), D1 at 16 of
    the fallback's 32 heads of 32 (tp = 2), each against its plain
    version and counted as a launch."""
    d, t = (32, 600) if kernel == "D1" else (64, 535)
    qkv = torch.tensor(_qkv(2, t, h, d, h + t)).bfloat16().to(cuda_device)
    valid = torch.arange(t, device=cuda_device)[None, :] < torch.tensor(
        [[t], [t - 77]], device=cuda_device)
    if kernel == "D1":
        q, k, v = (qkv.reshape(2, t, h, 3, d)[:, :, :, p].transpose(1, 2)
                   for p in range(3))
        kw = dict(bias_table=torch.randn(32, h, device=cuda_device) * 0.3,
                  bias_formula=True)
        fn, before = TF._grouped_flash, TF._grouped_flash.launches
        got = TF.flash_attention(q, k, v, None, valid, **kw)
        want = TF.flash_attention_plain(q, k, v, None, valid, **kw)
    elif kernel == "B":
        bias_vec = TF.relpos_bias_vector(
            torch.randn(32, h, device=cuda_device) * 0.3, t)
        fn = TF.flash_attention_packed
        before = fn.launches
        got = fn(qkv, h, valid, bias_vec=bias_vec)
        want = TF.flash_attention_packed_plain(qkv, h, valid, bias_vec)
    else:
        fn = TF.flash_attention_causal_qkv
        before = fn.launches
        got = fn(qkv, h, valid)
        want = TF.flash_attention_causal_qkv_plain(qkv, h, valid)
    assert fn.launches == before + 1
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)


@pytest.mark.cuda
def test_tma_body_copies_a_view_that_breaks_the_16_byte_rule(cuda_device):
    """A q view 2 bytes off a 16-byte boundary, with rows 66 bytes apart,
    cannot be read through a tensor map: the wrapper copies it, as its
    docstring says, and the result still matches plain."""
    b, h, t, d = 2, 2, 150, 32
    g = torch.Generator(device=cuda_device).manual_seed(9)
    wide = torch.randn((b, h, t, d + 1), generator=g,
                       device=cuda_device).bfloat16()
    q = wide[..., 1:]
    k, v = (torch.randn((b, h, t, d), generator=g, device=cuda_device)
            .bfloat16() for _ in range(2))
    with pytest.raises(ValueError):
        TF.tma_layout(q)
    kw = dict(bias_table=torch.randn(32, h, device=cuda_device) * 0.3,
              bias_formula=True)
    got = TF.flash_attention(q, k, v, **kw)
    want = TF.flash_attention_plain(q, k, v, **kw)
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
@pytest.mark.parametrize("mode", ["none", "materialized", "buckets",
                                  "causal_masked", "formula_f32",
                                  "unequal_formula_masked", "causal_formula",
                                  "materialized_unequal"])
def test_generic_kernel_d2_matches_plain_on_card(cuda_device, dtype, tol,
                                                 mode, d):
    """Kernel D2 in each of its modes at every head width: bf16 on the
    wgmma + TMA body, f32 on the split-TF32 body, each one launch of D2 with an
    f32 output. Tq != Tkv: 150 query rows over 203 keys with the formula
    bias and a ragged key mask (203 % 4 != 0, so a materialized bias is
    read from a padded copy); causal with the formula bias is D2 too
    (the JAX package's D1 is non-causal). "formula_f32" is D1's rule
    (bf16 output for bf16 inputs)."""
    from tortoise_tpu_torch.ops.relpos import relative_position_buckets

    b, h, t = 2, 2, 150
    tkv = 203 if "unequal" in mode else t
    g = torch.Generator(device=cuda_device).manual_seed(5 + d)
    q = torch.randn((b, h, t, d), generator=g, device=cuda_device).to(dtype)
    k, v = (torch.randn((b, h, tkv, d), generator=g, device=cuda_device)
            .to(dtype) for _ in range(2))
    table = torch.randn(32, h, device=cuda_device) * 0.3
    valid = torch.ones((b, tkv), dtype=torch.bool, device=cuda_device)
    valid[1, tkv - 19:] = False
    valid[0, 5:9] = False
    kw = {}
    if mode.startswith("materialized"):
        kw["bias"] = torch.randn((h, t, tkv), generator=g,
                                 device=cuda_device)
    elif mode == "buckets":
        kw.update(bias_buckets=torch.tensor(relative_position_buckets(t),
                                            device=cuda_device),
                  bias_table=table)
    elif "formula" in mode:
        # D1's rule with f32 inputs (the f32 parity plane's denoiser)
        kw.update(bias_table=table, bias_formula=True)
    causal = mode.startswith("causal")
    fn = TF._grouped_flash if mode == "formula_f32" else TF._generic_flash
    before = fn.launches
    got = TF.flash_attention(q, k, v, kv_valid=valid, causal=causal, **kw)
    assert fn.launches == before + 1
    want = TF.flash_attention_plain(q, k, v, kv_valid=valid, causal=causal,
                                    **kw)
    assert got.dtype == want.dtype
    if fn is TF._generic_flash:
        assert got.dtype == torch.float32
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
    them: the wrappers run the wgmma + TMA body on strided views of the
    same qkv (two 64-column boxes a tile) and count as B and C."""
    h, t = 2, 230
    qkv = torch.tensor(_qkv(2, t, h, 128, 7)).bfloat16().to(cuda_device)
    valid = torch.arange(t, device=cuda_device)[None, :] < torch.tensor(
        [[t], [201]], device=cuda_device)
    bias_vec = TF.relpos_bias_vector(
        torch.randn(32, h, device=cuda_device) * 0.3, t)
    before = (TF.flash_attention_packed.launches,
              TF.flash_attention_causal_qkv.launches)
    got = TF.flash_attention_packed(qkv, h, valid, bias_vec=bias_vec)
    want = TF.flash_attention_packed_plain(qkv, h, valid, bias_vec)
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)
    got = TF.flash_attention_causal_qkv(qkv, h, valid)
    assert (TF.flash_attention_packed.launches,
            TF.flash_attention_causal_qkv.launches) == (before[0] + 1,
                                                        before[1] + 1)
    want = TF.flash_attention_causal_qkv_plain(qkv, h, valid)
    assert got.dtype == torch.bfloat16
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [64, 230])
def test_packed_and_causal_kernels_take_head_width_16(cuda_device, t):
    """Kernels B and C at the tiny configs' head width (4 heads of 16):
    the wrappers run the wgmma + TMA body on strided views of the qkv
    (one 16-column box a tile, the 32-byte swizzle) with a bf16 output
    and count as B and C."""
    h = 4
    qkv = torch.tensor(_qkv(2, t, h, 16, 17)).bfloat16().to(cuda_device)
    valid = torch.arange(t, device=cuda_device)[None, :] < torch.tensor(
        [[t], [t - 29]], device=cuda_device)
    bias_vec = TF.relpos_bias_vector(
        torch.randn(32, h, device=cuda_device) * 0.3, t)
    counted = (TF.flash_attention_packed, TF.flash_attention_causal_qkv,
               TF._grouped_flash, TF._generic_flash)
    before = [fn.launches for fn in counted]
    got = TF.flash_attention_packed(qkv, h, valid, bias_vec=bias_vec)
    want = TF.flash_attention_packed_plain(qkv, h, valid, bias_vec)
    assert got.dtype == torch.bfloat16
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)
    got = TF.flash_attention_causal_qkv(qkv, h, valid)
    want = TF.flash_attention_causal_qkv_plain(qkv, h, valid)
    assert [fn.launches for fn in counted] == [before[0] + 1, before[1] + 1,
                                               before[2], before[3]]
    assert got.dtype == torch.bfloat16
    assert_close(got.float().cpu().numpy(), want.float().cpu().numpy(), 2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,b,t", [("B", 2, 2176), ("C", 8, 535)])
def test_packed_and_causal_kernels_take_f32_on_card(cuda_device, kernel, b,
                                                    t):
    """Kernels B and C on an f32 qkv, as the Pallas kernels take it (the
    JAX denoiser's f32 plane with use_flash): the split-TF32 body on strided
    views of the qkv, an f32 output, counted as B or C and not as D; at
    the denoiser's (2, 2176) and the latent pass's (8, 535) x 16 x 64."""
    h = 16
    qkv = torch.tensor(_qkv(b, t, h, 64, 19)).to(cuda_device)
    valid = torch.ones((b, t), dtype=torch.bool, device=cuda_device)
    valid[-1, t - 37:] = False
    counted = (TF.flash_attention_packed, TF.flash_attention_causal_qkv,
               TF._grouped_flash, TF._generic_flash)
    before = [fn.launches for fn in counted]
    if kernel == "B":
        bias_vec = TF.relpos_bias_vector(
            torch.randn(32, h, device=cuda_device) * 0.3, t)
        got = TF.flash_attention_packed(qkv, h, valid, bias_vec=bias_vec)
        want = TF.flash_attention_packed_plain(qkv, h, valid, bias_vec)
        after = [before[0] + 1, *before[1:]]
    else:
        got = TF.flash_attention_causal_qkv(qkv, h, valid)
        want = TF.flash_attention_causal_qkv_plain(qkv, h, valid)
        after = [before[0], before[1] + 1, *before[2:]]
    assert [fn.launches for fn in counted] == after
    assert got.dtype == torch.float32
    assert_close(got.cpu().numpy(), want.cpu().numpy(), 1e-4)


F32_TOL = 1e-5  # the split-TF32 body against its plain version
# f32 route cases: (route, mode); a mode names its bias ("bias" for B's
# Toeplitz vector, "formula", "buckets", "materialized" or none), a key
# mask ("masked"), "causal", and Tq != Tkv ("wide": 150 queries over 203
# keys; "tall": 203 over 150)
F32_CASES = [("B", "bias"), ("B", "bias_masked"), ("C", "plain"),
             ("C", "masked"), ("D1", "formula"), ("D1", "formula_masked"),
             ("D2", "none"), ("D2", "causal_masked"),
             ("D2", "materialized_masked"), ("D2", "materialized_causal"),
             ("D2", "buckets_masked"), ("D2", "buckets_causal"),
             ("D2", "formula_causal_masked"), ("D2", "wide_formula_masked"),
             ("D2", "wide_materialized_causal"), ("D2", "tall_masked"),
             ("D2", "tall_causal_masked")]


def _f32_route(route, mode, d, device, seed):
    """One f32 call of ``route``: (the wrapper's output, the plain
    version's, the wrapper function whose launch counter counts it)."""
    from tortoise_tpu_torch.ops.relpos import relative_position_buckets

    b, h, t = 2, 2, 150
    rng = np.random.default_rng(seed)
    valid = None
    if "masked" in mode:
        valid = np.ones((b, 203), bool)
        valid[1, 150 - 19:] = False
        valid[0, 5:9] = False
    table = torch.tensor(rng.normal(0, 0.3, (32, h)).astype(np.float32)
                         ).to(device)
    if route in ("B", "C"):
        qkv = torch.tensor(_qkv(b, t, h, d, seed)).to(device)
        kv = None if valid is None else torch.tensor(valid[:, :t]).to(device)
        if route == "B":
            vec = TF.relpos_bias_vector(table, t)
            return (TF.flash_attention_packed(qkv, h, kv, bias_vec=vec),
                    TF.flash_attention_packed_plain(qkv, h, kv, vec),
                    TF.flash_attention_packed)
        return (TF.flash_attention_causal_qkv(qkv, h, kv),
                TF.flash_attention_causal_qkv_plain(qkv, h, kv),
                TF.flash_attention_causal_qkv)
    tq, tkv = (150, 203) if "wide" in mode else \
        (203, 150) if "tall" in mode else (t, t)
    if route == "D1":  # views of a packed qkv, as the denoiser's fallback
        x = torch.tensor(_qkv(b, t, h, d, seed)).to(device)
        q, k, v = (x.view(b, t, h, 3, d)[:, :, :, p].transpose(1, 2)
                   for p in range(3))
    else:
        q = torch.tensor(rng.normal(0, 1, (b, h, tq, d)).astype(
            np.float32)).to(device)
        k, v = (torch.tensor(rng.normal(0, 1, (b, h, tkv, d)).astype(
            np.float32)).to(device) for _ in range(2))
    kw = dict(causal="causal" in mode,
              kv_valid=None if valid is None else torch.tensor(
                  valid[:, :tkv]).to(device))
    if "materialized" in mode:
        kw["bias"] = torch.tensor(rng.normal(0, 1, (h, tq, tkv)).astype(
            np.float32)).to(device)
    elif "buckets" in mode:
        kw.update(bias_buckets=torch.tensor(relative_position_buckets(tq),
                                            device=device), bias_table=table)
    elif "formula" in mode:
        kw.update(bias_table=table, bias_formula=True)
    fn = TF._grouped_flash if route == "D1" else TF._generic_flash
    return (TF.flash_attention(q, k, v, **kw),
            TF.flash_attention_plain(q, k, v, **kw), fn)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("route,mode", F32_CASES)
def test_f32_body_matches_plain_on_card(cuda_device, route, mode, d):
    """Every f32 route (B, C, D1, D2) at every head width, in each bias
    mode, causal or not, with Tq != Tkv both ways: one launch of the
    route's kernel, counted by the route and by the split-TF32 body
    (``_launch_d``), an f32 output within 1e-5 of
    max |out| of the plain version (true f32 matmuls)."""
    counted = (TF.flash_attention_packed, TF.flash_attention_causal_qkv,
               TF._grouped_flash, TF._generic_flash, TF._launch_d)
    before = [fn.launches for fn in counted]
    torch.backends.cuda.matmul.allow_tf32 = False
    seed = 100 + d + 7 * F32_CASES.index((route, mode))
    with torch.no_grad():
        got, want, fn = _f32_route(route, mode, d, cuda_device, seed)
    assert [c.launches for c in counted] == [
        n + (c in (fn, TF._launch_d)) for c, n in zip(counted, before)]
    assert got.dtype == torch.float32
    assert_close(got.cpu().numpy(), want.cpu().numpy(), F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128])
def test_f32_body_gives_the_mean_of_v_on_a_row_with_no_valid_key(
        cuda_device, d):
    """Batch row 1 has every key masked: every key scores -1e30 alike
    (the mask absorbs the bias), so each query row there is the mean of
    V: on D2 with a materialized bias, on kernel B, and, when causal, the
    mean of the keys up to the row (row i still sees key 0)."""
    b, h, t = 2, 2, 100
    rng = np.random.default_rng(d)
    q, k, v = (torch.tensor(rng.normal(0, 1, (b, h, t, d)).astype(
        np.float32)).to(cuda_device) for _ in range(3))
    valid = torch.ones((b, t), dtype=torch.bool, device=cuda_device)
    valid[1] = False
    table = torch.randn(32, h, device=cuda_device) * 0.3
    got = TF.flash_attention(q, k, v, kv_valid=valid,
                             bias=torch.randn(h, t, t, device=cuda_device))
    mean = v[1].mean(dim=1, keepdim=True).expand(h, t, d)
    assert_close(got[1].cpu().numpy(), mean.cpu().numpy(), F32_TOL)
    got = TF.flash_attention(q, k, v, kv_valid=valid, causal=True)
    prefix = v[1].cumsum(dim=1) / torch.arange(
        1, t + 1, device=cuda_device)[:, None]
    assert_close(got[1].cpu().numpy(), prefix.cpu().numpy(), F32_TOL)
    qkv = torch.tensor(_qkv(b, t, h, d, d)).to(cuda_device)
    got = TF.flash_attention_packed(qkv, h, valid, bias_table=table)
    vb = qkv.view(b, t, h, 3, d)[1, :, :, 2]  # (t, h, d)
    assert_close(got[1].cpu().numpy(),
                 vb.mean(dim=0).reshape(1, h * d).expand(t, h * d)
                 .cpu().numpy(), F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("d,tkv", [(64, 8192), (128, 9000), (16, 8192)])
def test_f32_body_takes_a_long_key_sequence(cuda_device, d, tkv):
    """Tkv long enough that a whole-window design would not fit in
    shared memory (the Toeplitz window and the mask over every key):
    the keys stream through in tiles, so the call runs and agrees with
    the plain version, with the formula bias and a ragged key mask."""
    b, h, tq = 2, 2, 256
    rng = np.random.default_rng(tkv + d)
    q = torch.tensor(rng.normal(0, 1, (b, h, tq, d)).astype(np.float32)
                     ).to(cuda_device)
    k, v = (torch.tensor(rng.normal(0, 1, (b, h, tkv, d)).astype(
        np.float32)).to(cuda_device) for _ in range(2))
    valid = torch.arange(tkv, device=cuda_device)[None, :] < torch.tensor(
        [[tkv], [tkv - 333]], device=cuda_device)
    kw = dict(kv_valid=valid, bias_table=torch.randn(
        32, h, device=cuda_device) * 0.3, bias_formula=True)
    before = TF._generic_flash.launches
    got = TF.flash_attention(q, k, v, **kw)
    assert TF._generic_flash.launches == before + 1
    want = TF.flash_attention_plain(q, k, v, **kw)
    assert_close(got.cpu().numpy(), want.cpu().numpy(), F32_TOL)


@pytest.mark.cuda
def test_f32_body_takes_views_that_break_the_16_byte_rule(cuda_device):
    """A q, k, v whose base or strides are not multiples of 16 bytes
    (here a packed qkv offset by one float) runs with 4-byte copies."""
    b, h, t, d = 2, 2, 130, 32
    raw = torch.tensor(_qkv(b, t * 3 * h * d + 1, 1, 1, 3).reshape(-1)
                       ).to(cuda_device)
    qkv = raw[1:1 + b * t * 3 * h * d].view(b, t, 3 * h * d)
    assert qkv.data_ptr() % 16
    q, k, v = (qkv.view(b, t, h, 3, d)[:, :, :, p].transpose(1, 2)
               for p in range(3))
    kw = dict(bias_table=torch.randn(32, h, device=cuda_device) * 0.3,
              bias_formula=True, causal=True)
    got = TF.flash_attention(q, k, v, **kw)
    want = TF.flash_attention_plain(q, k, v, **kw)
    assert_close(got.cpu().numpy(), want.cpu().numpy(), F32_TOL)


def _i8_inputs(b, t, h, d, n_valid, seed, device):
    rng = np.random.default_rng(seed)
    qkv = torch.tensor(rng.normal(0, 1, (b, t, 3 * h * d)).astype(
        np.float32)).to(device)
    table = torch.tensor(rng.normal(0, 0.1, (32, h)).astype(
        np.float32)).to(device)
    valid = torch.ones((b, t), dtype=torch.bool, device=device)
    if n_valid is not None:
        valid[1, n_valid:] = False
    return qkv, table, valid


def _assert_i8_close(got, qkv, h, valid, table):
    """Kernel F's output against its plain version. Both quantize the
    same f32 values of qkv and part only in the order of l's sum: an f32
    output within 1e-5 of max |out|, a bf16 one within one bf16 rounding
    of the plain version's f32 result, element by element."""
    want = TI.flash_packed_i8_plain(qkv.float(), h, valid, table)
    assert got.shape == want.shape
    if got.dtype == torch.float32:
        assert_close(got.cpu().numpy(), want.cpu().numpy(), 1e-5)
        return
    err = (got.float() - want).abs()
    bound = 2.0 ** -8 * want.abs() + 1e-5 * want.abs().max()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("n_valid", [None, 1813, 0])
def test_int8_kernel_f_matches_plain_on_card(cuda_device, n_valid):
    """Kernel F at the A/B's (2, 2176) x 16 x 64 in bf16, all keys valid,
    row 1 valid to 1813, and row 1 with no valid key: one launch of the
    quantize pass and one of the attention kernel, within one bf16
    rounding of its plain version."""
    qkv, table, valid = _i8_inputs(2, 2176, 16, 64, n_valid, 23, cuda_device)
    qkv = qkv.bfloat16()
    before = (TI.flash_packed_i8.launches, TI.quantize_kv.launches)
    got = TI.flash_packed_i8(qkv, 16, valid, table)
    assert (TI.flash_packed_i8.launches,
            TI.quantize_kv.launches) == (before[0] + 1, before[1] + 1)
    assert got.dtype == torch.bfloat16
    _assert_i8_close(got, qkv, 16, valid, table)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,t", [(32, 200), (64, 300), (128, 130)])
def test_int8_kernel_f_takes_its_widths_and_dtypes_on_card(cuda_device,
                                                           dtype, d, t):
    """Kernel F at head widths 32, 64 and 128 on bf16 and f32 qkv, at
    lengths that pad to 128 rows, with a ragged row."""
    qkv, table, valid = _i8_inputs(2, t, 4, d, t - 41, d + t, cuda_device)
    qkv = qkv.to(dtype)
    got = TI.flash_packed_i8(qkv, 4, valid, table)
    assert got.dtype == dtype
    _assert_i8_close(got, qkv, 4, valid, table)


def _old_i8_limit(d):
    """The longest padded length the first design of kernel F took at
    head width d: it staged the whole bias window and key mask a block
    (128 q8 rows and a 64-key K tile of d + 16 bytes, a V tile of d rows
    of 80 bytes, then 4 (2 Tp + 160) bytes) in the card's 232448."""
    fixed = 192 * (d + 16) + 80 * d + 640
    return (232448 - fixed) // 8 // 128 * 128


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_int8_kernel_f_past_the_old_bias_window_on_card(cuda_device, dtype,
                                                        d):
    """One head at 27,500 keys (27,520 padded), past every width's limit
    of the first design; the bias window and mask now stream with each
    key tile. A ragged row end."""
    t = 27500
    assert TI.padded_length(t) > _old_i8_limit(d)
    qkv, table, valid = _i8_inputs(1, t, 1, d, None, d, cuda_device)
    valid[0, t - 77:] = False
    got = TI.flash_packed_i8(qkv.to(dtype), 1, valid, table)
    assert got.dtype == dtype
    _assert_i8_close(got, qkv.to(dtype), 1, valid, table)


@pytest.mark.cuda
def test_int8_kernel_f_scales_q_per_128_row_block_on_card(cuda_device):
    """Q scaled 50x in one 128-row block of one head: its scale is that
    block's alone, and the blocks beside it and the other heads keep
    their own. Q's scale taken per head instead moves this output by
    8.4e-2 of max |out| (the plain version so changed, on the CPU),
    against the f32 tolerance of 1e-5."""
    b, t, h, d = 2, 384, 4, 64
    qkv, table, valid = _i8_inputs(b, t, h, d, 300, 31, cuda_device)
    q0 = qkv.view(b, t, h, 3, d)[:, :, 0, 0]  # head 0's q
    q0[:, 128:256] *= 50.0
    got = TI.flash_packed_i8(qkv, h, valid, table)
    _assert_i8_close(got, qkv, h, valid, table)


@pytest.mark.cuda
def test_int8_quantize_pass_matches_plain_on_card(cuda_device):
    """Kernel F's quantize pass: ki and the scales equal the plain
    quantizer's bit for bit, and vit is vi transposed with the keys of
    each 32-key chunk in the order the P@V fragments read them."""
    b, t, h, d = 2, 300, 4, 64
    qkv, _, _ = _i8_inputs(b, t, h, d, None, 29, cuda_device)
    ki, vit, scales = TI.quantize_kv(qkv.bfloat16(), h)
    tp = TI.padded_length(t)
    x = torch.nn.functional.pad(qkv.bfloat16().float(), (0, 0, 0, tp - t))
    _, k, v = TF._split_packed(x, h)
    want_k, want_v, sk, sv = TI.quantize_kv_plain(k, v)
    assert torch.equal(ki, want_k)
    assert torch.equal(scales, torch.stack([sk, sv], dim=-1))
    j = torch.arange(32)
    nt, w = j >> 3, j & 7
    slot = 16 * (nt >> 1) + 4 * (w >> 1) + ((nt & 1) << 1) + (w & 1)
    key = torch.empty_like(slot)
    key[slot] = j  # the key each slot of a 32-key chunk holds
    order = (torch.arange(0, tp, 32)[:, None] + key[None]).flatten()
    assert torch.equal(vit, want_v[:, :, order.to(cuda_device)]
                       .transpose(-1, -2))


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
@pytest.mark.parametrize("hop", [8, 64, 256])
@pytest.mark.parametrize("l", [32, 2186, 2208])
def test_lvc_kernel_at_vocoder_lengths_on_card(cuda_device, l, hop):
    """Kernel E at the vocoder's lengths (a 32-frame stream chunk, the
    ragged 2186 frames of 500 latents, their 2208 bucket) at each stage's
    hop, on two batch rows taken as a block slice of the stacked
    kernels (the vocoder's batch stride)."""
    g = torch.Generator(device=cuda_device).manual_seed(l + hop)
    x = torch.randn((2, 32, l * hop), generator=g, device=cuda_device)
    kern_all = torch.randn((2, 4, 32, 64, 3, l), generator=g,
                           device=cuda_device) * 0.1
    bias = torch.randn((2, 64, l), generator=g, device=cuda_device)
    res = torch.randn((2, 32, l * hop), generator=g, device=cuda_device)
    got = TL.lvc_gated_residual(x, kern_all[:, 2], bias, res, hop)
    want = TL.lvc_gated_residual_plain(x, kern_all[:, 2], bias, res, hop)
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


def _graph_vs_eager(fn, seed_runs=(0, 1)):
    """fn(eager) -> (outputs tuple, launch counts), run eager, graph,
    graph, eager (the second graph run replays the cached entry)."""
    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    runs = []
    for eager in (True, False, False, True):
        reset_launch_counts()
        out = fn(eager)
        torch.cuda.synchronize()
        runs.append((out, launch_counts()))
    return runs


@pytest.mark.cuda
@pytest.mark.parametrize("plane", ["bf16_weights", "bf16_int8"])
@pytest.mark.parametrize("b", [1, 4])
def test_generate_graph_replays_the_eager_loop_on_card(cuda_device, plane,
                                                       b):
    """The AR sampling loop as one captured step (the plain step on the
    bf16-weights plane, kernel A's step on the int8 plane) against the
    eager loop: the same tokens and lengths, the same launch counts."""
    from tortoise_tpu_torch.config import tiny_ar_config as port_ar_config
    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.pipeline import ar_stage, common, graphs

    cfg = dataclasses.replace(port_ar_config(), d_model=128, n_head=2,
                              d_mlp=256, n_mel_vocab=300, fused_decode=True,
                              max_decode_steps=40, cache_len=128)
    host = random_ar_params(cfg, seed=4)
    params = ar_stage.cast_matmul_weights(host, torch.bfloat16,
                                          plane == "bf16_int8", cuda_device)
    rng = np.random.default_rng(b)
    ids = torch.tensor(rng.integers(0, cfg.n_text_vocab, (b, 12)),
                       device=cuda_device)
    valid = torch.ones((b, 12), dtype=torch.bool, device=cuda_device)
    voice = torch.tensor(rng.normal(0, .5, 128).astype(np.float32),
                         device=cuda_device)
    logits, cache = ar.prefill(params, cfg, ids, valid, voice,
                               torch.bfloat16)
    first = torch.ones((b, 14), dtype=torch.long, device=cuda_device)
    graphs.clear()

    def run(eager):
        c = ar.KVCache(cache.k.clone(), cache.v.clone(), cache.valid.clone(),
                       cache.length)
        return ar_stage._generate(params, cfg, logits, first, c,
                                  common.make_generator(5, cuda_device),
                                  torch.bfloat16, ar.DEFAULT_SAMPLER,
                                  eager=eager)

    runs = _graph_vs_eager(run)
    (want_t, want_l), want_c = runs[0]
    assert want_t.shape[1] > 8
    for (t, l), c in runs[1:]:
        assert torch.equal(t, want_t) and torch.equal(l, want_l)
        assert c == want_c
    assert (want_c["decode_trunk"] > 0) == (plane == "bf16_int8")
    assert len(graphs.entries()) == 1
    graphs.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4])
def test_denoise_graph_replays_the_eager_loop_on_card(cuda_device, b):
    """The denoising loop as one captured step on kernel B's route (2
    heads of 64, bf16 + int8, ragged rows) against the eager loop: the
    same mel bit for bit, the same launch counts."""
    from tortoise_tpu_torch.config import tiny_diffusion_config
    from tortoise_tpu_torch.io.checkpoint import random_diffusion_params
    from tortoise_tpu_torch.pipeline import common, graphs
    from tortoise_tpu_torch.pipeline import diffusion_stage as DS

    cfg = dataclasses.replace(tiny_diffusion_config(), d_model=128,
                              n_head=2, timestep_dim=128, use_flash=True,
                              n_sample_timesteps=8)
    params = DS._prepare_params(random_diffusion_params(cfg, 2), True,
                                cuda_device)
    rng = np.random.default_rng(b)
    t = 96
    code = torch.tensor(rng.normal(0, .5, (2 * b, 128, t)).astype(np.float32),
                        device=cuda_device)
    x0 = torch.tensor(rng.normal(0, 1, (b, cfg.n_mel, t)).astype(np.float32),
                      device=cuda_device)
    lens = torch.tensor([t - 7 * i for i in range(b)], device=cuda_device)
    mask = torch.arange(t, device=cuda_device)[None, :] < lens[:, None]
    sched = DS.schedule_arrays(cfg, cuda_device)
    graphs.clear()

    def run(eager):
        gen = common.make_generator(3, cuda_device)
        return DS._denoise_loop(
            params, cfg, sched, code, x0, None, mask,
            lambda: DS.draw_normal(gen, tuple(x0.shape), cuda_device),
            torch.bfloat16, True, eager=eager)

    runs = _graph_vs_eager(run)
    want, want_c = runs[0]
    assert want_c["flash_attention_packed"] == 8 * 3  # 3 attention layers
    for got, c in runs[1:]:
        assert torch.equal(got, want)
        assert c == want_c
    assert len(graphs.entries()) == 1
    graphs.clear()


def _gn_inputs(b, t, c, dtype, masked, film, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn((b, t, c), generator=g, device=device) * 1.7
         + 0.3).to(dtype)
    w = 1 + 0.2 * torch.randn(c, generator=g, device=device)
    bias = 0.2 * torch.randn(c, generator=g, device=device)
    mask = None
    if masked:  # ragged rows, the last one cut to a few frames
        lens = torch.tensor([t - (t * i) // max(b, 2) for i in range(b)],
                            device=device).clamp_min(3)
        mask = torch.arange(t, device=device)[None, :] < lens[:, None]
    pair = None
    if film is not None:
        shape = (b, c) if film == "rows" else (c,)
        pair = tuple((0.5 * torch.randn(shape, generator=g, device=device))
                     .to(dtype) for _ in range(2))
    return x, w, bias, mask, pair


def _bf16_ulp(v):
    """One bf16 ulp at |v| (8 significant bits)."""
    a = v.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _assert_gn_close(got, want):
    """got (bf16 or f32) against the plain twin's f32 result."""
    err = (got.float() - want).abs()
    top = want.abs().max()
    if got.dtype == torch.float32:
        assert err.max() <= 1e-5 * top, (err.max(), top)
    else:
        assert (err <= 0.5 * _bf16_ulp(want) + 1e-5 * top).all(), \
            (err.max(), top)


# (b, t, c, groups): the denoiser's map; T not a whole number of chunks; a
# tp rank's half and a tiny config's local channels; 16 CFG rows x 2
GN_SHAPES = [(2, 2176, 1024, 32), (2, 333, 1024, 32), (2, 300, 512, 16),
             (2, 97, 64, 2), (32, 200, 1024, 32)]
# (mask, FiLM, SiLU): attn_norm; res_in_norm and out_norm; res_out_norm
# (with and without a mask); code_norm
GN_CHAINS = [(False, None, False), (True, None, True), (True, "rows", True),
             (False, "rows", True), (True, "shared", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,c,groups", GN_SHAPES)
@pytest.mark.parametrize("masked,film,silu", GN_CHAINS)
def test_group_norm_kernel_matches_plain_on_card(cuda_device, dtype, b, t, c,
                                                 groups, masked, film, silu):
    """Kernel G against its plain twin's f32 result, two calls bit-equal,
    one count a call."""
    x, w, bias, mask, pair = _gn_inputs(b, t, c, dtype, masked, film,
                                        cuda_device, b * t + c)
    before = TG.group_norm_act.launches
    got = TG.group_norm_act(x, groups, w, bias, 1e-5, mask, film=pair,
                            silu=silu)
    again = TG.group_norm_act(x, groups, w, bias, 1e-5, mask, film=pair,
                              silu=silu)
    torch.cuda.synchronize()
    assert TG.group_norm_act.launches == before + 2
    assert got.dtype == dtype and torch.equal(got, again)
    want = TG.group_norm_act_plain(x, groups, w, bias, 1e-5, mask, film=pair,
                                   silu=silu)
    _assert_gn_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("tp", [2, 4])
def test_group_norm_kernel_gives_a_tp_ranks_bits_on_card(cuda_device, dtype,
                                                         tp):
    """A tp rank's res_out_norm (its C / tp channels in its groups / tp
    groups, its slice of the FiLM) gives the bits of the same channels of
    the single rank's call: kernel G's sums meet in an order that reads
    neither C nor the groups."""
    b, t, c, groups = 4, 2176, 1024, 32
    x, w, bias, mask, pair = _gn_inputs(b, t, c, dtype, True, "rows",
                                        cuda_device, 9)
    whole = TG.group_norm_act(x, groups, w, bias, 1e-5, mask, film=pair,
                              silu=True)
    step = c // tp
    for lo in range(0, c, step):
        sl = slice(lo, lo + step)
        local = TG.group_norm_act(x[..., sl].contiguous(), groups // tp,
                                  w[sl], bias[sl], 1e-5, mask,
                                  film=tuple(f[:, sl] for f in pair),
                                  silu=True)
        assert torch.equal(local, whole[..., sl]), (lo, tp)


@pytest.mark.cuda
def test_denoise_runs_kernel_g_at_every_group_norm_on_card(cuda_device):
    """At the published depths (3 integrator layers, 10 main, 3 tail
    resblocks; narrow widths), a conditioner pass launches kernel G 5
    times and a denoising step 46 times, eagerly and in the step graph,
    whose ``launches`` hold 46 and whose replays add them."""
    from tortoise_tpu_torch.config import DiffusionConfig
    from tortoise_tpu_torch.io.checkpoint import random_diffusion_params
    from tortoise_tpu_torch.models import diffusion as TDM
    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tortoise_tpu_torch.pipeline import common, graphs
    from tortoise_tpu_torch.pipeline import diffusion_stage as DS

    cfg = dataclasses.replace(DiffusionConfig(), d_model=128, n_head=2,
                              timestep_dim=128, use_flash=True,
                              n_sample_timesteps=4)
    params = DS._prepare_params(random_diffusion_params(cfg, 2), True,
                                cuda_device)
    rng = np.random.default_rng(0)
    lat = torch.tensor(rng.normal(0, 1, (1, 32, 128)).astype(np.float32),
                       device=cuda_device)
    lat_mask = torch.arange(32, device=cuda_device)[None, :] < 27
    reset_launch_counts()
    cond, uncond = TDM.code_embeddings(params, cfg, lat, None, 128, 27, 120,
                                       lat_mask, torch.bfloat16)
    assert launch_counts()["group_norm_act"] == 5
    code = torch.cat([cond, uncond], dim=0)
    x0 = torch.tensor(rng.normal(0, 1, (1, cfg.n_mel, 128)).astype(
        np.float32), device=cuda_device)
    mask = torch.arange(128, device=cuda_device)[None, :] < 120
    sched = DS.schedule_arrays(cfg, cuda_device)
    graphs.clear()
    for eager in (True, False):
        reset_launch_counts()
        gen = common.make_generator(3, cuda_device)
        DS._denoise_loop(params, cfg, sched, code, x0, None, mask,
                         lambda: DS.draw_normal(gen, tuple(x0.shape),
                                                cuda_device),
                         torch.bfloat16, True, eager=eager)
        torch.cuda.synchronize()
        assert launch_counts()["group_norm_act"] == 46 * 4, eager
    (_, graph), = graphs.entries()
    assert graph.launches["group_norm_act"] == 46
    assert (graph.warmups, graph.captures, graph.replays) == (1, 1, 2)
    graphs.clear()


# kernels Q8 and E8 at the int8 cell's shapes: M = 2 x 2176 rows, the
# last 40 frames of the second row zeroed; (K, N, padding): qkv, proj or
# res_in_conv, the integrating product, res_out_conv
I8_SHAPES = [(1024, 3072, 0), (1024, 1024, 0), (2048, 1024, 0),
             (1024, 1024, 1)]


def _i8_eager(monkeypatch, x, pair, bias, out_dtype, padding):
    """The product by the eager chain on the card (the route turned off):
    ``conv1d_nwc``'s int8 branch or ``_linear``."""
    from tortoise_tpu_torch.models import diffusion as TDM
    from tortoise_tpu_torch.ops import conv
    from tortoise_tpu_torch.ops.cuda import int8_product as TQ

    with monkeypatch.context() as m:
        m.setattr(TQ, "takes_kernels", lambda *a, **k: False)
        if padding:
            return conv.conv1d_nwc(x, pair, bias, padding=1,
                                   compute_dtype=out_dtype,
                                   out_dtype=out_dtype)
        return TDM._linear(x, pair, bias, out_dtype, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k_in,n,padding", I8_SHAPES)
def test_int8_product_kernels_equal_the_eager_chain_on_card(
        cuda_device, monkeypatch, dtype, k_in, n, padding):
    """Q8's codes and scales equal the eager quantize, E8 its epilogue on
    the same sums, and the route the eager product (bf16, f32 and f32
    without a cast, with and without the bias), bit for bit; each route
    call launches Q8 and E8 once."""
    from tortoise_tpu_torch.ops.basic import mm_bf16, quantize_cols
    from tortoise_tpu_torch.ops.cuda import int8_product as TQ

    g = torch.Generator(device=cuda_device).manual_seed(k_in + n + padding)
    x = torch.randn((2, 2176, k_in), generator=g, device=cuda_device) * 1.7
    x[1, -40:] = 0.0
    x = x.to(dtype)
    taps = 2 * padding + 1
    pair = quantize_cols(0.05 * torch.randn(
        (taps * k_in, n), generator=g, device=cuda_device))
    bias = torch.randn(n, generator=g, device=cuda_device)
    x3 = x if padding else x.reshape(1, -1, k_in)
    codes, s_row = TQ.quantize_rows(x3, padding)
    want_codes, want_s = TQ.quantize_rows_plain(x3, padding)
    assert torch.equal(codes, want_codes) and torch.equal(s_row, want_s)
    flat = codes.reshape(-1, k_in)
    sums = [mm_bf16(flat, wj) for wj in pair[0].reshape(taps, k_in, n)]
    for out_dtype, b in ((torch.bfloat16, bias),
                         (torch.bfloat16, bias.bfloat16()),
                         (torch.float32, bias), (None, None)):
        got = TQ.epilogue(sums, s_row, pair[1], b, out_dtype)
        want = TQ.epilogue_plain(sums, s_row, pair[1], b, out_dtype)
        assert got.dtype == want.dtype and torch.equal(got, want), out_dtype
    for out_dtype in (torch.bfloat16, torch.float32, None):
        q8, e8 = TQ.quantize_rows.launches, TQ.epilogue.launches
        got = TQ.int8_product(x, pair, bias, out_dtype, padding)
        assert (TQ.quantize_rows.launches, TQ.epilogue.launches) == (
            q8 + 1, e8 + 1)
        want = _i8_eager(monkeypatch, x, pair, bias, out_dtype, padding)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and torch.equal(got, want), out_dtype


@pytest.mark.cuda
def test_int8_product_refuses_on_card_what_it_refuses_on_cpu(cuda_device):
    from test_torch_int8_product import refusals

    from tortoise_tpu_torch.ops.cuda import int8_product as TQ

    for name, args in refusals(cuda_device).items():
        with pytest.raises(ValueError, match="int8_product"):
            TQ.int8_product(*args)
            pytest.fail(name)


@pytest.mark.cuda
def test_int8_denoiser_eval_runs_q8_and_e8_at_every_product_on_card(
        cuda_device, monkeypatch):
    """At the published widths and depths, one int8 CFG eval at the cell's
    T (2176, 40 padded frames) launches Q8 and E8 59 times each and gives
    the eager route's bits (the parent's eval); the step graph of the
    denoising loop holds the 59 launches and its replays add them."""
    from tortoise_tpu_torch.config import DiffusionConfig
    from tortoise_tpu_torch.io.checkpoint import random_diffusion_params
    from tortoise_tpu_torch.models import diffusion as TDM
    from tortoise_tpu_torch.ops.cuda import int8_product as TQ
    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tortoise_tpu_torch.pipeline import common, graphs
    from tortoise_tpu_torch.pipeline import diffusion_stage as DS

    cfg = dataclasses.replace(DiffusionConfig(), use_flash=True,
                              n_sample_timesteps=4)
    params = DS._prepare_params(random_diffusion_params(cfg, 3, fast=True),
                                True, cuda_device)
    t = 2176
    g = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((2, cfg.n_mel, t), generator=g, device=cuda_device)
    code = torch.randn((2, cfg.d_model, t), generator=g, device=cuda_device)
    mask = torch.arange(t, device=cuda_device)[None, :] < t - 40
    reset_launch_counts()
    got = TDM.denoise(params, cfg, x, code, 400, None, mask, torch.bfloat16)
    counts = launch_counts()
    assert (counts["int8_quantize_rows"], counts["int8_epilogue"]) == (59, 59)
    with monkeypatch.context() as m:
        m.setattr(TQ, "takes_kernels", lambda *a, **k: False)
        want = TDM.denoise(params, cfg, x, code, 400, None, mask,
                           torch.bfloat16)
    assert launch_counts()["int8_quantize_rows"] == 59
    assert torch.equal(got, want)
    sched = DS.schedule_arrays(cfg, cuda_device)
    graphs.clear()
    for eager in (True, False):
        reset_launch_counts()
        gen = common.make_generator(3, cuda_device)
        DS._denoise_loop(params, cfg, sched, code, x[:1], None, mask,
                         lambda: DS.draw_normal(gen, (1,) + x.shape[1:],
                                                cuda_device),
                         torch.bfloat16, True, eager=eager)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert (counts["int8_quantize_rows"], counts["int8_epilogue"]) == (
            59 * 4, 59 * 4), eager
    (_, graph), = graphs.entries()
    assert graph.launches["int8_quantize_rows"] == 59
    assert graph.launches["int8_epilogue"] == 59
    assert (graph.warmups, graph.captures, graph.replays) == (1, 1, 2)
    graphs.clear()
