"""The int8 product (``ops.cuda.int8_product.int8_product``) on the CPU:
its plain steps against the eager chain the port ran before it
(``eager_product``, a copy kept here as the reference), bit for bit,
with the arguments the kernels would get held to the kernels' checks;
the padded-buffer tap indexing against the eager per-tap slices; a whole
denoiser eval; which calls take the kernels and where the
tensor-parallel hooks act; and the arguments the kernels refuse. Here a
"card" is a CPU tensor that says it is on one and a launch is faked; the
kernels themselves run only on a card (tests/test_torch_cuda.py). No
tolerance: every comparison is exact.
"""

import dataclasses

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


def eager_product(x, w, b=None, out_dtype=None, padding=0, row_max=None,
                  reduce=None):
    """The eager chain the port ran before ``int8_product``: the bare
    product of ``pdot_int8act`` (padding 0: f32 codes, one matmul, the
    hook on the sums, the row scales, the column scales), the tap loop of
    ``conv1d_nwc``'s int8 branch (padding 1: the f32 codes and scales
    padded, one matmul per tap slice, the hook on the stacked sums, the
    taps summed in order), then the cast and the bias as ``_linear`` and
    ``conv1d_nwc`` added them."""
    wq, scale = w
    xq, s_row = basic.quantize_rows(x, row_max)
    if padding == 0:
        acc = basic.mm_bf16(xq, wq)
        out = (acc if reduce is None else reduce(acc)) * s_row * scale
    else:
        t, k = x.shape[1], 2 * padding + 1
        xqp = F.pad(xq, (0, 0, padding, padding))
        srp = F.pad(s_row, (0, 0, padding, padding))
        wq3 = wq.reshape(k, wq.shape[0] // k, wq.shape[-1])
        taps = [basic.mm_bf16(xqp[:, j:j + t], wq3[j]) for j in range(k)]
        if reduce is not None:
            taps = reduce(torch.stack(taps)).unbind(0)
        out = None
        for j in range(k):
            part = taps[j] * srp[:, j:j + t]
            out = part if out is None else out + part
        out = out * scale
    if out_dtype is not None:
        out = out.to(out_dtype)
    if b is not None:
        out = out + (b.to(out_dtype) if out_dtype else b)
    return out


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


class _OnACard(torch.Tensor):
    """A CPU tensor that says it is on a card: the wrappers' choice reads
    nothing else."""

    @property
    def is_cuda(self):
        return True


def _card(t):
    return t.as_subclass(_OnACard)


@pytest.fixture
def launches(monkeypatch):
    """Fakes the kernel library: a launch that passed its wrapper's checks
    is recorded here (Q8 or E8) and writes nothing. The counters are put
    back afterwards."""
    seen = []

    class Library:
        def tt_int8_quantize_rows(self, *args):
            seen.append("Q8")
            return 0

        def tt_int8_epilogue(self, *args):
            seen.append("E8")
            return 0

    monkeypatch.setattr(I8.build, "library", Library)
    monkeypatch.setattr(I8.build, "stream_ptr", lambda: 0)
    monkeypatch.setattr(I8.quantize_rows, "launches", 0)
    monkeypatch.setattr(I8.epilogue, "launches", 0)
    return seen


def kernel_checks(x, pair, bias=None, out_dtype=None, padding=0):
    """``int8_product``'s steps as a card runs them without hooks, up to
    each kernel's launch (faked; the ``launches`` fixture): the pair's
    check, then Q8's wrapper on x said to be on a card, then E8's wrapper
    on the plain steps' sums said to be on a card. Raises what the first
    refusing wrapper raises."""
    wq, scale = pair
    taps, _ = I8._check_pair(x, wq, padding)
    I8.quantize_rows(_card(x), padding)
    codes, s_row = I8.quantize_rows_plain(x, padding)
    I8.epilogue([_card(a) for a in I8._tap_sums(codes, wq, taps)],
                _card(s_row), scale, bias, out_dtype)


@pytest.mark.parametrize("b", [1, 2, 16])
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32, None])
@pytest.mark.parametrize("padding", [0, 1])
def test_route_equals_the_eager_chain(launches, b, padded, out_dtype,
                                     padding):
    """k1 as ``_linear`` calls it (the qkv's N = 3 K), k3 as the
    resblock's ``conv1d_nwc`` calls it, on the bf16 plane's input: the
    product and the callers give the eager bits, and a card's kernels
    take the call."""
    n = 96 if padding else 192
    x, pair, bias = _inputs(b, 24, 64, n, 2 * padding + 1, torch.bfloat16,
                            padded and b > 1, b + padding)
    want = eager_product(x, pair, bias, out_dtype, padding)
    if padding:
        caller = conv.conv1d_nwc(x, pair, bias, padding=1,
                                 compute_dtype=out_dtype, out_dtype=out_dtype)
    else:
        caller = TDM._linear(x, pair, bias, out_dtype, out_dtype)
    for got in (I8.int8_product(x, pair, bias, out_dtype, padding), caller):
        assert got.dtype == want.dtype and torch.equal(got, want)
    kernel_checks(x, pair, bias, out_dtype, padding)
    assert launches == ["Q8", "E8"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(6, 48), (2, 5, 64)])
def test_route_equals_pdot_int8act(launches, dtype, shape):
    """The bare product, f32 out and no bias, on any leading dims and on
    an f32 input: ``pdot_int8act`` and the product give the eager bits,
    and a card's kernels take the call."""
    g = torch.Generator().manual_seed(len(shape))
    x = (torch.randn(shape, generator=g) * 3).to(dtype)
    pair = basic.quantize_cols(torch.randn((shape[-1], 20), generator=g))
    want = eager_product(x, pair)
    for got in (basic.pdot_int8act(x, pair), I8.int8_product(x, pair)):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    kernel_checks(x, pair)
    assert launches == ["Q8", "E8"]


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
    assert torch.equal(got, eager_product(x, (wq, scale), None,
                                          torch.bfloat16, 1))


def test_tensor_parallel_calls_keep_the_eager_route(launches, monkeypatch):
    """The kernels run only on a card without hooks: Q8 on a card's x
    without ``row_max``, E8 on a card's sums without ``reduce``. The CPU,
    and hooks on either device, run the plain steps with ``row_max`` on
    the rows' absmax before the codes and ``reduce`` on the stacked tap
    sums before the scales, and give the eager chain's bits with the
    same hooks."""
    seen = []
    plain = I8.quantize_rows_plain

    def row_max(a):
        seen.append(("row_max", tuple(a.shape)))
        return a * 2

    def reduce(sums):
        seen.append(("reduce", tuple(sums.shape)))
        return sums + 1

    x, pair, _ = _inputs(2, 8, 64, 32, 1, torch.bfloat16, False, 5)
    x3, pair3, _ = _inputs(2, 8, 64, 32, 3, torch.bfloat16, False, 6)
    for xi, padding in ((x, 0), (x3, 1)):
        codes, s_row = I8.quantize_rows(_card(xi), padding)
        assert launches == ["Q8"] and I8.quantize_rows.launches == 1
        assert codes.shape == plain(xi, padding)[0].shape
        assert s_row.shape == plain(xi, padding)[1].shape
        for q in (I8.quantize_rows(_card(xi), padding, row_max),
                  I8.quantize_rows(xi, padding)):
            assert launches == ["Q8"]
        assert seen == [("row_max", (2, 8, 1))]
        codes, s_row = plain(xi, padding)
        sums = I8._tap_sums(codes, pair3[0] if padding else pair[0],
                            2 * padding + 1)
        scale = pair3[1] if padding else pair[1]
        I8.epilogue([_card(a) for a in sums], _card(s_row), scale)
        assert launches == ["Q8", "E8"] and I8.epilogue.launches == 1
        want = I8.epilogue_plain([a + 1 for a in sums], s_row, scale)
        got = I8.epilogue([_card(a) for a in sums], _card(s_row), scale,
                          reduce=reduce)
        assert torch.equal(got.as_subclass(torch.Tensor), want)
        assert launches == ["Q8", "E8"]
        launches.clear()
        seen.clear()
        I8.quantize_rows.launches = I8.epilogue.launches = 0

    def first_plain_step(x, padding, row_max):  # the codes on the CPU
        seen.append(("plain", type(x).__name__))
        return plain(x.as_subclass(torch.Tensor), padding, row_max)

    monkeypatch.setattr(I8, "quantize_rows_plain", first_plain_step)
    for xi, p, padding in ((_card(x), pair, 0), (x, pair, 0),
                           (_card(x3), pair3, 1), (x3, pair3, 1)):
        seen.clear()
        got = I8.int8_product(xi, p, None, None, padding, row_max, reduce)
        taps, rows = 2 * padding + 1, 2 * (8 + 2 * padding)
        assert seen == [("plain", type(xi).__name__), ("row_max", (2, 8, 1)),
                        ("reduce", (taps, 2, rows // 2, 32))]
        want = eager_product(xi.as_subclass(torch.Tensor), p, None, None,
                             padding, row_max, reduce)
        assert torch.equal(got.as_subclass(torch.Tensor), want)
    assert launches == []
    seen.clear()
    I8.int8_product(_card(x), pair)
    assert launches == ["Q8"] and seen == []


def test_denoiser_eval_on_the_route_gives_the_eager_bits(monkeypatch,
                                                         launches):
    """At the published depths (3 integrator layers, 10 main, 3 tail
    resblocks; narrow widths), a CFG eval on the int8 plane gives the
    eager eval's bits, and a card's kernels take all 59 int8 products (each layer's qkv, proj and two resblock
    convs, the tail's convs, the integrating product)."""
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
    with monkeypatch.context() as m:
        m.setattr(I8, "int8_product", eager_product)
        want = TDM.denoise(params, cfg, x, code, 400, None, mask,
                           torch.bfloat16)
    assert torch.equal(TDM.denoise(params, cfg, x, code, 400, None, mask,
                                   torch.bfloat16), want)
    calls = []

    def counted(x, w, b=None, out_dtype=None, padding=0, row_max=None,
                reduce=None):
        assert row_max is None and reduce is None
        calls.append((out_dtype, padding))
        kernel_checks(x, w, b, out_dtype, padding)
        return product(x, w, b, out_dtype, padding)

    product = I8.int8_product
    monkeypatch.setattr(I8, "int8_product", counted)
    got = TDM.denoise(params, cfg, x, code, 400, None, mask, torch.bfloat16)
    assert torch.equal(got, want)
    assert len(calls) == 59
    assert calls.count((torch.bfloat16, 1)) == 13 + 3  # the k3 convs


def refusals(device):
    """{name: (x, pair, bias, out_dtype, padding)}: calls the kernels do
    not take, which ``int8_product`` refuses on a card (the pair's check,
    then Q8's, then E8's)."""
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
def test_route_refuses_what_the_kernels_do_not_take(launches, name):
    with pytest.raises(ValueError, match="int8_product"):
        kernel_checks(*refusals("cpu")[name])
