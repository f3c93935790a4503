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
    (BF16, 16, "D1", "tma"), (BF16, 32, "B", "tma"), (BF16, 64, "B", "qkv"),
    (BF16, 128, "B", "tma"), (BF16, 16, "B", "tma"), (BF16, 64, "C", "qkv"),
    (BF16, 128, "C", "tma"), (BF16, 16, "C", "tma"), (BF16, 32, "D2", "tma"),
    (BF16, 64, "D2", "tma"), (BF16, 16, "D2", "tma"), (BF16, 128, "D2", "tma"),
    (F32, 32, "D1", "tf32x3"), (F32, 64, "D2", "tf32x3"),
    (F32, 16, "D2", "tf32x3"), (F32, 64, "B", "tf32x3"),
    (F32, 64, "C", "tf32x3"),
])
def test_attention_body_picks_the_body(dtype, d, route, want):
    assert TF.attention_body(dtype, d, route) == want


def test_attention_body_has_one_bf16_design():
    """Every bf16 call runs on csrc/flash_attention.cu (the generic body,
    or the fused-qkv body for B and C at width 64), every f32 call of B,
    C, D1 and D2 on the split-TF32 body: no other body is named for any (dtype,
    head width, route) the wrappers accept."""
    taken = {}
    for dtype in (BF16, F32, torch.float16):
        for d in (8, 16, 32, 48, 64, 128, 256):
            for route in ("B", "C", "D1", "D2"):
                try:
                    taken[dtype, d, route] = TF.attention_body(dtype, d,
                                                               route)
                except ValueError:
                    pass
    assert set(taken.values()) == {"tma", "qkv", "tf32x3"}
    assert {k for k, v in taken.items() if v == "tf32x3"} == {
        (F32, d, r) for d in TF.HEAD_WIDTHS for r in ("B", "C", "D1", "D2")}
    assert {k for k, v in taken.items() if v == "qkv"} == {
        (BF16, 64, "B"), (BF16, 64, "C")}
    assert len(taken) == 16 + 16


@pytest.mark.parametrize("dtype,d,route", [
    (torch.float16, 64, "D1"), (BF16, 48, "D1"), (BF16, 64, "E"),
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


def test_tma_layout_of_width_16_packed_views():
    """The tiny configs' 4 heads of 16: 32-byte rows (the 32-byte swizzle
    on the card), one 16-column box of 64 rows of t."""
    b, t, h, d = 2, 100, 4, 16
    _, k, _ = TF._split_packed(_qkv(b, t, h, d), h)
    lay = TF.tma_layout(k)
    assert lay["dims"] == (d, h, t, b)
    assert lay["strides"] == (3 * d * 2, 3 * h * d * 2, t * 3 * h * d * 2)
    assert lay["box"] == (16, 1, 64, 1)
    assert lay["perm"] == 2 | 1 << 2 | 3 << 4


def _bhtd(b, h, t, d, dtype=BF16):
    return torch.zeros((b, t, h, d), dtype=dtype).transpose(1, 2)


def test_tma_args_map_q_over_tq_and_k_v_over_tkv():
    """D2 with Tq != Tkv: q's map runs over its 256 rows, k's and v's
    over their 1000, each with its own strides; the mask is (B, Tkv)."""
    b, h, tq, tkv, d = 2, 3, 256, 1000, 64
    q, k, v = _bhtd(b, h, tq, d), _bhtd(b, h, tkv, d), _bhtd(b, h, tkv, d)
    out = _bhtd(b, h, tq, d, torch.float32)
    mask = torch.zeros((1, tkv))
    ops, geom, vec, full, ld, m = TF._tma_args(
        q, k, v, out, torch.zeros((h, tq + tkv - 1)), None, mask, True)
    assert [x.data_ptr() for x in ops] == [x.data_ptr() for x in (q, k, v)]
    row = d * 2 * h
    assert geom[:8] == [d, h, tq, b, d * 2, row, row * tq, 2 | 1 << 2 | 3 << 4]
    for x in (1, 2):
        assert geom[8 * x:8 * x + 8] == [d, h, tkv, b, d * 2, row,
                                         row * tkv, 2 | 1 << 2 | 3 << 4]
    assert tuple(vec.shape) == (h, tq + tkv - 1) and full is None
    assert ld == 0 and tuple(m.shape) == (b, tkv)
    assert TF.tma_layout(q)["box"] == TF.tma_layout(k)["box"] == (64, 1, 64, 1)


@pytest.mark.parametrize("tkv", [1, 997, 998, 999, 1000])
def test_bias_operand_pads_rows_to_a_multiple_of_4(tkv):
    """A materialized (H, Tq, Tkv) bias is read as (H, Tq, ld) rows of a
    multiple of 4 floats (16-byte rows for the body's 8-byte pair loads);
    Tkv % 4 != 0 gets a zero-padded copy, the rest is kept as it is."""
    h, tq = 3, 5
    bias = torch.randn((h, tq, tkv))
    got, ld = TF._bias_operand(bias, h, tq, tkv, torch.device("cpu"))
    assert ld % 4 == 0 and tkv <= ld < tkv + 4
    assert tuple(got.shape) == (h, tq, ld) and got.is_contiguous()
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got[..., :tkv], bias)
    assert not got[..., tkv:].any()
    if ld == tkv:
        assert got.data_ptr() == bias.data_ptr()
    with pytest.raises(ValueError):
        TF._bias_operand(bias, h, tq + 1, tkv, torch.device("cpu"))


def test_tma_smem_bytes_is_the_kernels_layout():
    """csrc/flash_attention.cu's smem_bytes: D1 at (2176, width 32) with
    its bias window, C at (535, 64) with the mask alone, and a
    materialized bias (no window) at width 128."""
    assert TF.tma_smem_bytes(32, 2176, True) == \
        1024 + 8 * 64 * 32 * 2 + 128 + 4 * (2176 + 2 * (2176 + 130))
    assert TF.tma_smem_bytes(64, 535, False) == \
        1024 + 8 * 64 * 64 * 2 + 128 + 4 * 576
    assert TF.tma_smem_bytes(128, 1000, False) == \
        1024 + 8 * 64 * 128 * 2 + 128 + 4 * 1024
    for d in TF.TMA_WIDTHS:  # D1 at the denoiser's 2176 keeps its window
        assert TF.tma_smem_bytes(d, 2176, True) <= TF.TMA_SMEM_LIMIT


@pytest.mark.parametrize("window,fits,over", [(True, 8256, 8257),
                                              (False, 25024, 25025)])
def test_tma_args_name_the_shared_memory_limit(window, fits, over):
    """At head width 128 the bias window fits 8256 keys (the mask alone
    25024); one more raises a ValueError naming the card's limit."""
    h, tq, d = 1, 64, 128
    q = _bhtd(1, h, tq, d)
    out = _bhtd(1, h, tq, d, torch.float32)
    for tkv, ok in ((fits, True), (over, False)):
        assert (TF.tma_smem_bytes(d, tkv, window) <= TF.TMA_SMEM_LIMIT) == ok
        k = _bhtd(1, h, tkv, d)
        vec = torch.zeros((h, tq + tkv - 1)) if window else None
        if ok:
            TF._tma_args(q, k, k, out, vec, None, None, True)
        else:
            with pytest.raises(ValueError, match="232448"):
                TF._tma_args(q, k, k, out, vec, None, None, True)


@pytest.mark.parametrize("case", ["bf16 output, materialized bias",
                                  "bf16 output, causal with a bias",
                                  "two biases", "f16 output", "f32 inputs",
                                  "k and v differ", "Toeplitz length"])
def test_tma_args_refuse_what_the_body_does_not_take(case):
    h, tq, tkv, d = 2, 40, 70, 32
    q, k, v = _bhtd(1, h, tq, d), _bhtd(1, h, tkv, d), _bhtd(1, h, tkv, d)
    out = _bhtd(1, h, tq, d, torch.float32)
    vec, full, causal = None, None, False
    if case == "bf16 output, materialized bias":
        out, full = _bhtd(1, h, tq, d), torch.zeros((h, tq, tkv))
    elif case == "bf16 output, causal with a bias":
        out, vec, causal = _bhtd(1, h, tq, d), torch.zeros(
            (h, tq + tkv - 1)), True
    elif case == "two biases":
        vec, full = torch.zeros((h, tq + tkv - 1)), torch.zeros((h, tq, tkv))
    elif case == "f16 output":
        out = _bhtd(1, h, tq, d, torch.float16)
    elif case == "f32 inputs":
        q = _bhtd(1, h, tq, d, torch.float32)
    elif case == "k and v differ":
        v = _bhtd(1, h, tkv + 1, d)
    else:
        vec = torch.zeros((h, 2 * tq - 1))
    with pytest.raises(ValueError):
        TF._tma_args(q, k, v, out, vec, full, None, causal)


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
        "head width 48": torch.zeros((2, 2, 30, 48), dtype=BF16),
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


def test_f32_body_variants_match_the_source():
    """scripts/torch_f32_body_variants.py builds each variant of the f32
    body by a text substitution: every one must match
    csrc/flash_attention_bhtd.cu exactly once, or the script raises on
    the card."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "torch_f32_body_variants",
        root / "scripts" / "torch_f32_body_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = (root / "tortoise_tpu_torch" / "csrc" /
           "flash_attention_bhtd.cu").read_text()
    assert mod.VARIANTS["as built"] == []
    for name, subs in mod.VARIANTS.items():
        text = src
        for old, new in subs:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        assert (text != src) == bool(subs), name
