"""Host-side arithmetic of the hand-written kernels, on the CPU: which
attention body takes a call, the tensor maps through which the wgmma +
TMA attention body reads its operands, and kernel E's launch plan. The
kernels themselves run only on a card (tests/test_torch_cuda.py)."""

import pytest
import torch

from tortoise_tpu_torch.ops.cuda import flash_attention as TF
from tortoise_tpu_torch.ops.cuda import lvc as TL

BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dtype,d,route,want", [
    (BF16, 32, "D1", "tma"), (BF16, 64, "D1", "tma"), (BF16, 128, "D1", "tma"),
    (BF16, 16, "D1", "mma"), (BF16, 32, "B", "tma"), (BF16, 64, "B", "qkv"),
    (BF16, 128, "B", "tma"), (BF16, 16, "B", "mma"), (BF16, 64, "C", "qkv"),
    (BF16, 128, "C", "tma"), (BF16, 16, "C", "mma"), (BF16, 32, "D2", "mma"),
    (BF16, 64, "D2", "mma"), (F32, 32, "D1", "fma"), (F32, 64, "D2", "fma"),
])
def test_attention_body_picks_the_body(dtype, d, route, want):
    assert TF.attention_body(dtype, d, route) == want


@pytest.mark.parametrize("dtype,d,route", [
    (F32, 64, "B"), (F32, 64, "C"), (torch.float16, 64, "D1"),
    (BF16, 48, "D1"), (BF16, 64, "E"),
])
def test_attention_body_refuses_what_no_body_takes(dtype, d, route):
    with pytest.raises(ValueError):
        TF.attention_body(dtype, d, route)


def _qkv(b, t, h, d):
    return torch.zeros((b, t, 3 * h * d), dtype=BF16)


def test_tma_layout_of_packed_views():
    """The denoiser's per-head-interleaved qkv: h (3D apart) nests inside
    t (3HD apart), so the map's dims run d, h, t, b with the box's 64
    rows on t."""
    b, t, h, d = 2, 100, 4, 32
    _, k, _ = TF._split_packed(_qkv(b, t, h, d), h)
    lay = TF.tma_layout(k)
    assert lay["dims"] == (d, h, t, b)
    assert lay["strides"] == (3 * d * 2, 3 * h * d * 2, t * 3 * h * d * 2)
    assert lay["box"] == (32, 1, 64, 1)
    assert lay["perm"] == 2 | 1 << 2 | 3 << 4  # t in slot 2, h 1, b 3


def test_tma_layout_of_part_major_views():
    b, t, h, d = 3, 70, 2, 64
    q, k, v = TF._split_part_major(_qkv(b, t, h, d), h)
    for x in (q, k, v):
        lay = TF.tma_layout(x)
        assert lay["dims"] == (d, h, t, b)
        assert lay["strides"] == (d * 2, 3 * h * d * 2, t * 3 * h * d * 2)
        assert lay["box"] == (64, 1, 64, 1)


def test_tma_layout_of_a_contiguous_bhtd_tensor_and_width_128():
    x = torch.zeros((2, 3, 50, 128), dtype=BF16)
    lay = TF.tma_layout(x)
    assert lay["dims"] == (128, 50, 3, 2)
    assert lay["strides"] == (256, 50 * 256, 3 * 50 * 256)
    assert lay["box"] == (64, 64, 1, 1)  # two 64-column boxes a tile
    assert lay["perm"] == 1 | 2 << 2 | 3 << 4


def test_tma_layout_puts_unit_dims_last():
    """A batch of one and a single head: their strides are free, so they
    go after the others with a stride past everything."""
    x = torch.zeros((1, 1, 40, 32), dtype=BF16)
    lay = TF.tma_layout(x)
    assert lay["dims"] == (32, 40, 1, 1)
    assert lay["strides"] == (64, 40 * 64, 40 * 64)
    assert lay["box"] == (32, 64, 1, 1)
    assert lay["perm"] == 1 | 2 << 2 | 3 << 4


def _refused():
    base = torch.zeros((2, 2, 30, 33), dtype=BF16)
    wide = torch.zeros((2, 2, 30, 64), dtype=BF16)
    flat = torch.zeros(2 * 2 * 30 * 32 + 8, dtype=BF16)
    return {
        "misaligned base": flat[1:1 + 2 * 2 * 30 * 32].view(2, 2, 30, 32),
        "stride not a multiple of 16 bytes": base[..., 1:],
        "d not contiguous": wide.view(2, 2, 30, 32, 2)[..., 0],
        "overlapping dims": torch.zeros((2, 1, 30, 32), dtype=BF16)
        .expand(2, 3, 30, 32),
        "head width 16": torch.zeros((2, 2, 30, 16), dtype=BF16),
        "f32": torch.zeros((2, 2, 30, 32)),
    }


@pytest.mark.parametrize("case", list(_refused()))
def test_tma_layout_refuses_what_tma_cannot_read(case):
    with pytest.raises(ValueError):
        TF.tma_layout(_refused()[case])


@pytest.mark.parametrize("case", ["misaligned base",
                                  "stride not a multiple of 16 bytes",
                                  "d not contiguous", "overlapping dims"])
def test_tma_operand_copies_a_view_tma_cannot_read(case):
    x = _refused()[case]
    if case != "overlapping dims":
        x.copy_(torch.randn(x.shape))
    y, lay = TF._tma_operand(x)
    assert y.data_ptr() != x.data_ptr() and torch.equal(y, x)
    assert lay == TF.tma_layout(y)


def test_tma_operand_keeps_a_readable_view():
    _, k, _ = TF._split_packed(_qkv(2, 64, 4, 32), 4)
    y, _ = TF._tma_operand(k)
    assert y.data_ptr() == k.data_ptr()


@pytest.mark.parametrize("b,c,l,hop,samples,chunks,pairs,grid", [
    (1, 32, 2208, 8, 1, 32, 2, (16, 69, 1)),
    (1, 32, 2208, 64, 2, 8, 8, (4, 276, 1)),
    (1, 32, 2208, 256, 8, 8, 4, (8, 276, 1)),
    (2, 32, 2186, 256, 8, 8, 4, (8, 274, 2)),
    (1, 32, 32, 8, 1, 8, 1, (32, 4, 1)),
    (1, 32, 32, 64, 2, 8, 1, (32, 4, 1)),
    (1, 32, 32, 256, 8, 8, 1, (32, 4, 1)),
    (2, 4, 11, 2, 1, 8, 1, (4, 2, 2)),
])
def test_lvc_plan(b, c, l, hop, samples, chunks, pairs, grid):
    """The vocoder's widths (32 channels in and gated) at the three hops,
    as the sweep on the card picked them for 500 latents: 32 chunks
    (128-byte row segments) and 2 gated channels a block at hop 8, one
    pass of 2 samples a thread over 8 chunks and 8 gated channels at hop
    64, the wide path (8 samples a thread) at hop 256. A stream chunk of
    32 frames splits down to one gated channel a block so the grid covers
    the card."""
    assert TL.lvc_plan(b, c, c, l, hop) == dict(
        samples=samples, chunks=chunks, pairs=pairs, grid=grid)


@pytest.mark.parametrize("hop", [2, 8, 16, 24, 64, 100, 256, 512])
@pytest.mark.parametrize("c", [4, 8, 12, 32])
@pytest.mark.parametrize("l", [1, 9, 32, 500, 2208])
def test_lvc_plan_covers_every_sample_and_output(hop, c, l):
    """A thread's samples lie in one chunk (S divides hop; 256 does on the
    wide path), an item's gated channels divide C, its staged slices fit a
    buffer, and the items cover every chunk and channel."""
    p = TL.lvc_plan(1, 32, c, l, hop)
    assert hop % p["samples"] == 0 and c % p["pairs"] == 0
    assert p["samples"] != 8 or hop % 256 == 0
    assert (p["samples"], p["pairs"], p["chunks"]) in TL.LVC_SHAPES
    taps = 4 if p["samples"] == 8 else 3
    assert 32 * 2 * p["pairs"] * taps * p["chunks"] * 4 <= TL.LVC_SMEM
    assert p["grid"][0] * p["pairs"] == c
    assert (p["grid"][1] - 1) * p["chunks"] < l <= \
        p["grid"][1] * p["chunks"]


def test_lvc_shapes_are_the_ones_the_kernel_builds():
    """csrc/lvc.cu instantiates exactly LVC_SHAPES (its kShapes table),
    and lvc_plan reaches every one of them."""
    import pathlib
    import re

    src = (pathlib.Path(TL.__file__).resolve().parents[2] / "csrc"
           / "lvc.cu").read_text()
    table = src[src.index("kShapes[] = {"):]
    table = table[:table.index("};")]
    built = {tuple(map(int, m)) for m in
             re.findall(r"\{(\d+), (\d+), (\d+), launch<", table)}
    assert built == TL.LVC_SHAPES
    picked = {(p["samples"], p["pairs"], p["chunks"])
              for p in (TL.lvc_plan(b, 32, c, l, hop)
                        for b in (1, 2) for c in (1, 2, 4, 32)
                        for l in (1, 32, 2208)
                        for hop in (1, 8, 16, 32, 64, 256))}
    assert picked == TL.LVC_SHAPES


@pytest.mark.parametrize("hop", [8, 64, 256])
def test_lvc_plan_fills_the_card_at_a_stream_chunk(hop):
    """A stream's 32-frame chunk splits its outputs over blocks so the
    launch covers the card's SMs (it was 8 blocks)."""
    grid = TL.lvc_plan(1, 32, 32, 32, hop)["grid"]
    assert grid[0] * grid[1] * grid[2] >= 0.95 * TL.SM_COUNT
