"""The int8 product's kernel route (``ops.cuda.int8_product``: Q8, the
bf16 GEMM per tap, E8) on the CPU, where Q8 and E8 run their plain
models: the route against the eager chain it replaces on the card
(``pdot_int8act``, ``conv1d_nwc``'s int8 branch, ``_linear``'s cast and
bias), bit for bit; the padded-buffer tap indexing against the eager
per-tap slices; a whole denoiser eval on the route; which calls take it;
and the arguments it refuses. The kernels themselves run only on a card
(tests/test_torch_cuda.py). No tolerance: every comparison is exact.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tortoise_tpu_torch.config import DiffusionConfig
from tortoise_tpu_torch.io.checkpoint import random_diffusion_params
from tortoise_tpu_torch.models import diffusion as TDM
from tortoise_tpu_torch.ops import basic, conv
from tortoise_tpu_torch.ops.cuda import int8_product as I8
from tortoise_tpu_torch.pipeline import diffusion_stage as DS

torch.set_num_threads(1)  # the tier-1 run's workers share the cores


def _inputs(b, t, k_in, n, taps, dtype, padded, seed):
    """x (b, t, k_in) with the last frames of every row but the first
    zeroed when ``padded`` (as the group norm before each product leaves
    them), an int8 pair of ``taps`` taps and an f32 bias."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, k_in), generator=g) * 1.7 + 0.2
    if padded:
        x[1:, t - 5:] = 0.0
    w = torch.randn((taps * k_in, n), generator=g) * 0.05
    bias = torch.randn(n, generator=g)
    return x.to(dtype), basic.quantize_cols(w), bias


@pytest.mark.parametrize("b", [1, 2, 16])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32, None])
@pytest.mark.parametrize("padding", [0, 1])
def test_route_equals_the_eager_chain(b, padded, out_dtype, padding):
    """k1 as ``_linear`` calls it (the qkv's N = 3 K), k3 as the
    resblock's ``conv1d_nwc`` calls it, on the bf16 plane's input."""
    n = 96 if padding else 192
    x, pair, bias = _inputs(b, 24, 64, n, 2 * padding + 1, torch.bfloat16,
                            padded and b > 1, b + padding)
    got = I8.int8_product(x, pair, bias, out_dtype, padding)
    if padding:
        want = conv.conv1d_nwc(x, pair, bias, padding=1,
                               compute_dtype=out_dtype, out_dtype=out_dtype)
    else:
        want = TDM._linear(x, pair, bias, out_dtype, out_dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(6, 48), (2, 5, 64)])
def test_route_equals_pdot_int8act(dtype, shape):
    """The bare product, f32 out and no bias, on any leading dims and on
    an f32 input."""
    g = torch.Generator().manual_seed(len(shape))
    x = (torch.randn(shape, generator=g) * 3).to(dtype)
    pair = basic.quantize_cols(torch.randn((shape[-1], 20), generator=g))
    got = I8.int8_product(x, pair)
    assert got.dtype == torch.float32
    assert torch.equal(got, basic.pdot_int8act(x, pair))


def test_padded_buffer_taps_equal_the_per_tap_slices():
    """The k3 GEMM over the flattened (B (T + 2), K) code buffer, tap j
    read j rows down, gives the eager chain's per-tap slices of the
    padded f32 codes bit for bit, up to the largest sums the int8 codes
    make at K = 1024 (every code +-127: 1024 * 127^2 < 2^24)."""
    b, t, k_in, n = 3, 7, 1024, 8
    x = torch.full((b, t, k_in), 1.0)
    x[:, :, 1::2] = -1.0
    x[1] *= -1.0
    x[2, 3:] = 0.0
    wq = torch.full((3 * k_in, n), 127, dtype=torch.int8)
    wq[1::2] = -127  # every product of a row of x is +-127^2, one sign
    wq[k_in:2 * k_in] *= -1
    wq[:, 1::2] *= -1
    scale = torch.full((1, n), 0.01)
    codes, s_row = I8.quantize_rows(x, 1)
    flat = codes.reshape(-1, k_in)
    wq3 = wq.reshape(3, k_in, n)
    xq, s_eager = basic.quantize_rows(x)
    xqp = F.pad(xq, (0, 0, 1, 1))
    for j in range(3):
        acc = basic.mm_bf16(flat, wq3[j]).reshape(b, t + 2, n)[:, j:j + t]
        want = basic.mm_bf16(xqp[:, j:j + t], wq3[j])
        assert torch.equal(acc, want), j
    assert float(want.abs().max()) == k_in * 127 * 127
    assert torch.equal(s_row[:, 1:-1, None], s_eager)
    assert not s_row[:, [0, -1]].any() and not codes[:, [0, -1]].any()
    taps = [basic.mm_bf16(flat, wq3[j]) for j in range(3)]
    got = I8.epilogue(taps, s_row, scale, None, torch.bfloat16)
    want = conv.conv1d_nwc(x, (wq, scale), padding=1,
                           compute_dtype=torch.bfloat16,
                           out_dtype=torch.bfloat16)
    assert torch.equal(got, want)


def test_tensor_parallel_calls_keep_the_eager_route(monkeypatch):
    """A card tensor takes the kernels unless ``row_max`` or ``reduce`` is
    given; with the route opened on the CPU, the tp calls of
    ``pdot_int8act`` and ``conv1d_nwc`` still run the eager chain."""
    card = types.SimpleNamespace(is_cuda=True)

    def hook(v):
        return v

    assert I8.takes_kernels(card)
    assert not I8.takes_kernels(card, row_max=hook)
    assert not I8.takes_kernels(card, reduce=hook)
    assert not I8.takes_kernels(types.SimpleNamespace(is_cuda=False))
    calls = []
    monkeypatch.setattr(I8, "takes_kernels",
                        lambda x, row_max=None, reduce=None:
                        row_max is None and reduce is None)
    monkeypatch.setattr(I8, "int8_product",
                        lambda *a, **k: calls.append(a) or None)
    x, pair, _ = _inputs(2, 8, 64, 32, 1, torch.bfloat16, False, 5)
    assert basic.pdot_int8act(x, pair, hook, hook) is not None
    _, pair3, _ = _inputs(2, 8, 64, 32, 3, torch.bfloat16, False, 6)
    assert conv.conv1d_nwc(x, pair3, padding=1, row_max=hook,
                           reduce=hook) is not None
    assert calls == []
    assert basic.pdot_int8act(x, pair) is None
    assert conv.conv1d_nwc(x, pair3, padding=1) is None
    assert len(calls) == 2


def test_denoiser_eval_on_the_route_gives_the_eager_bits(monkeypatch):
    """At the published depths (3 integrator layers, 10 main, 3 tail
    resblocks; narrow widths), a CFG eval on the int8 plane sends all 59
    int8 products down the route (each layer's qkv, proj and two resblock
    convs, the tail's convs, the integrating product) and gives the eager
    eval's bits."""
    cfg = dataclasses.replace(DiffusionConfig(), d_model=128, n_head=2,
                              timestep_dim=128, use_flash=True)
    params = DS._prepare_params(random_diffusion_params(cfg, 4, fast=True),
                                True, "cpu")
    rng = np.random.default_rng(1)
    t = 40
    x = torch.tensor(rng.normal(0, 1, (2, cfg.n_mel, t)).astype(np.float32))
    code = torch.tensor(rng.normal(0, 1, (2, cfg.d_model, t)).astype(
        np.float32))
    mask = torch.arange(t)[None, :] < t - 7
    want = TDM.denoise(params, cfg, x, code, 400, None, mask, torch.bfloat16)
    calls = []
    route = I8.int8_product

    def counted(*args, **kwargs):
        calls.append(args[3:] + tuple(kwargs.values()))
        return route(*args, **kwargs)

    monkeypatch.setattr(I8, "takes_kernels",
                        lambda x, row_max=None, reduce=None:
                        row_max is None and reduce is None)
    monkeypatch.setattr(I8, "int8_product", counted)
    got = TDM.denoise(params, cfg, x, code, 400, None, mask, torch.bfloat16)
    assert torch.equal(got, want)
    assert len(calls) == 59
    assert calls.count((torch.bfloat16, 1)) == 13 + 3  # the k3 convs


def refusals(device):
    """{name: (x, pair, bias, out_dtype, padding)}: calls the kernels do
    not take, which ``int8_product`` refuses on either device."""
    def pair(rows, n, wdt=torch.int8, sdt=torch.float32, sn=None):
        return (torch.zeros((rows, n), dtype=wdt, device=device),
                torch.ones((1, sn or n), dtype=sdt, device=device))

    def zeros(*shape, dtype=torch.bfloat16):
        return torch.zeros(shape, dtype=dtype, device=device)

    x = zeros(2, 8, 64)
    odd = zeros(2 * 8 * 64 + 1)[1:].view(2, 8, 64)  # 2 bytes off 16
    return {
        "f16 x": (x.half(), pair(64, 48), None, None, 0),
        "int x": (x.int(), pair(64, 48), None, None, 0),
        "strided x": (x.transpose(0, 1), pair(64, 48), None, None, 0),
        "misaligned x": (odd, pair(64, 48), None, None, 0),
        "empty x": (zeros(2, 0, 64), pair(64, 48), None, None, 0),
        "K not whole vectors": (zeros(2, 8, 60), pair(60, 48), None, None, 0),
        "f32 K not whole vectors": (zeros(2, 8, 6, dtype=torch.float32),
                                    pair(6, 48), None, None, 0),
        "row past the registers": (zeros(1, 2, 4104), pair(4104, 8), None,
                                   None, 0),
        "conv of a 2-D x": (zeros(8, 64), pair(192, 48), None, None, 1),
        "conv past exact sums": (zeros(1, 4, 1048), pair(3 * 1048, 8), None,
                                 None, 1),
        "padding 2": (x, pair(5 * 64, 48), None, None, 2),
        "weight rows": (x, pair(128, 48), None, None, 0),
        "N not a multiple of 4": (x, pair(64, 50), None, None, 0),
        "bf16 weight": (x, pair(64, 48, wdt=torch.bfloat16), None, None, 0),
        "bf16 scale": (x, pair(64, 48, sdt=torch.bfloat16), None, None, 0),
        "short scale": (x, pair(64, 48, sn=24), None, None, 0),
        "f16 out": (x, pair(64, 48), None, torch.float16, 0),
        "short bias": (x, pair(64, 48), zeros(24), torch.bfloat16, 0),
        "int bias": (x, pair(64, 48), zeros(48, dtype=torch.int32),
                     torch.bfloat16, 0),
    }


REFUSALS = sorted(refusals("cpu"))


@pytest.mark.parametrize("name", REFUSALS)
def test_route_refuses_what_the_kernels_do_not_take(name):
    with pytest.raises(ValueError, match="int8_product"):
        I8.int8_product(*refusals("cpu")[name])
