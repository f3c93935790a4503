"""F5's conv position embedding (``ops.cuda.conv_pos``): the plain twin
against the eager chain ``models.f5.velocity`` ran before it, the tap
tiles kernel CP reads, the wrapper's refusals; on a card, CP's two
bodies against the chain and its place in one F5 eval and in a whole
request. The file imports no JAX, so its card tests also run on a
machine without it:

    python -m pytest --noconftest tests/test_torch_conv_pos.py -m cuda

The twin is the chain moved as it was, so the CPU tests hold it (and
``velocity`` through it) bit for bit. On the card CP's bf16 bodies are
held to ``chain64``, the chain at its own rounding points with every
conv summed in f64 (so its roundings are the exact sums'): CP sums each
conv's K = 31 x 64 = 1,984 products (31 x 16 = 496 at groups of 16) in
f32 in another order (~1e-6 apart), and a sum that close to a bf16
rounding boundary rounds the other way. So at least ``SHARE_EXACT`` of
the outputs equal chain64's bits, and none is farther from it than
``MAX_OFF`` of the map's largest value (one bf16 ulp there, 2^-8 ..
2^-7 of it: a y2 flip of one ulp moves the residual sum by at most
that). The twin on the card (cuDNN) lands farther from chain64 (on an
H100: 76% bit-equal, RMS 2.7e-3 against CP's 99.5% and 3.2e-4), so the
wgmma body is held to be no farther from chain64 in RMS than the twin,
and within ``MAX_OFF`` of it twice over. The f32 body is held to the
chain summed in f64 and never rounded below f32, within ``F32_OFF`` of
the map's largest value: the two f32 sums of 1,984 products in another
order, each ~1e-7 relative, and Mish between them. Masked frames are h
itself, bit for bit.
"""

import dataclasses

import pytest
import torch

from tortoise_tpu_torch.models import f5 as FM
from tortoise_tpu_torch.ops.basic import conv1d_tm, zero_frames
from tortoise_tpu_torch.ops.cuda import conv_pos as CP

SHARE_EXACT = 0.99
MAX_OFF = 2.0 ** -7
F32_OFF = 2.0 ** -16


def eager_chain(h, w1, b1, w2, b2, groups, frame_mask, cd):
    """The lines ``models.f5.velocity`` ran before kernel CP."""
    y = FM.F.mish(conv1d_tm(zero_frames(h, frame_mask), w1, b1, cd, groups))
    y = FM.F.mish(conv1d_tm(zero_frames(y, frame_mask), w2, b2, cd, groups))
    return h + zero_frames(y, frame_mask)


def embedding_inputs(b, t, c, groups, dtype, n_valid=None, seed=0,
                     device="cpu"):
    """h (b, t, c) ~ N(0, 1.5) with its rows unlike (the conditioned and
    unconditioned CFG rows), the two convs' weights at F5's draw (std
    0.02) and biases, and a (1, t, 1) frame mask keeping ``n_valid``
    frames (None: no mask)."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((b, t, c), generator=g) * 1.5
    h[1:] = h[1:] * 0.5 + 0.3
    k = CP.TAPS

    def w():
        return torch.randn((c, c // groups, k), generator=g) * 0.02

    def bias():
        return torch.randn((c,), generator=g) * 0.02

    ws = [w(), bias(), w(), bias()]
    mask = None if n_valid is None else \
        (torch.arange(t) < n_valid)[None, :, None]
    to = dict(device=device)
    return (h.to(dtype).to(**to), [x.to(dtype).to(**to) for x in ws],
            None if mask is None else mask.to(**to))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n_valid", [None, 41])
def test_plain_twin_is_the_eager_chain(dtype, n_valid):
    """At ``tiny_f5_config``'s width (4 groups of 16), with and without a
    ragged tail masked: the twin gives the chain's bits."""
    cfg = FM.tiny_f5_config()
    cd = dtype if dtype == torch.bfloat16 else None
    h, ws, fm = embedding_inputs(2, 57, cfg.dim, cfg.conv_pos_groups, dtype,
                                 n_valid)
    want = eager_chain(h, *ws, cfg.conv_pos_groups, fm, cd)
    got = CP.conv_pos_embed(h, *ws, cfg.conv_pos_groups, fm, cd)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_velocity_is_unchanged(dtype, monkeypatch):
    """One tiny CFG eval on a padded bucket gives the bits it gave with
    the chain inline, in bf16 and in f32."""
    cfg = FM.tiny_f5_config()
    from tortoise_tpu_torch.pipeline import f5_stage as S

    params, _ = S.random_params(cfg, S.vmodel.tiny_vocos_config(), S.WEIGHTS,
                                2, "cpu")
    cd = dtype if dtype == torch.bfloat16 else None
    prep = FM.prepare(params, cfg, cd)
    tiles = prep["input"]["pos_tiles"]  # groups of 16: the SIMT body's
    assert tiles[0].shape == (4, CP.TAPS, 16, 16) and tiles[0].dtype == dtype
    g = torch.Generator().manual_seed(4)
    t, n = 64, 50
    x = torch.randn((1, t, cfg.mel_dim), generator=g)
    ct = torch.randn((2, t, cfg.mel_dim + cfg.text_dim), generator=g)
    valid = torch.arange(t) < n
    args = (prep, cfg, x, ct, torch.tensor([0.4]), valid[None, :, None],
            valid.expand(2, t), None, cd)
    got = FM.velocity(*args)
    monkeypatch.setattr(CP, "conv_pos_embed", lambda h, w1, b1, w2, b2,
                        groups, fm, cd, tiles: eager_chain(
                            h, w1, b1, w2, b2, groups, fm, cd))
    assert torch.equal(got, FM.velocity(*args))


def unswizzle(tiles):
    """weight_tiles' inverse: (groups, 31, 64, 64) -> (C, 64, 31)."""
    groups, k, cg, _ = tiles.shape
    t = tiles.reshape(groups, k, cg, 8, 8)
    row = torch.arange(cg)[:, None]
    t = t[:, :, row, torch.arange(8)[None, :] ^ (row % 8)]
    return t.reshape(groups, k, cg, cg).permute(0, 3, 2, 1).reshape(
        groups * cg, cg, k)


def test_weight_tiles_hold_every_tap_swizzled():
    """Tile (g, j) row i (input channel i) holds tap j's outputs of
    group g, its 16-byte chunk p at p ^ (i % 8); the layout round-trips,
    and prepare() lays both convs out where CP takes them (bf16, groups
    of 64)."""
    w = torch.randn((3 * 64, 64, CP.TAPS)).bfloat16()
    tiles = CP.weight_tiles(w, 3)
    assert tiles.shape == (3, CP.TAPS, 64, 64) and tiles.is_contiguous()
    assert torch.equal(unswizzle(tiles), w)
    g, j, i, n = 2, 17, 13, 42
    p = (n // 8) ^ (i % 8)
    assert tiles[g, j, i, 8 * p + n % 8] == w[64 * g + n, i, j]
    assert CP.takes_weights(w, 3) and CP.takes_weights(w.float(), 3)
    assert not CP.takes_weights(w.half(), 3)
    assert not CP.takes_weights(w[:, :, :7], 3)
    assert not CP.takes_weights(w[:96, :32], 3)  # groups of 32
    cfg = dataclasses.replace(FM.tiny_f5_config(), dim=128, heads=2,
                              conv_pos_groups=2)
    shapes = FM.param_shapes(cfg)

    def draw(tree):
        return {k: draw(v) if isinstance(v, dict) else torch.randn(v) * 0.02
                for k, v in tree.items()}

    params = draw(shapes)
    prep = FM.prepare(params, cfg, torch.bfloat16)
    for tile, k in zip(prep["input"]["pos_tiles"], ("pos1_w", "pos2_w")):
        assert torch.equal(unswizzle(tile), params["input"][k].bfloat16())
    f32 = FM.prepare(params, cfg)["input"]  # the f32 plane: plain tiles
    for tile, k in zip(f32["pos_tiles"], ("pos1_w", "pos2_w")):
        assert torch.equal(tile, plain_tiles(params["input"][k], 2))


def plain_tiles(w, groups):
    """Tile (g, j) as tap j's (in, out) block of group g, built a tap and
    a group at a time."""
    cg = w.shape[1]
    return torch.stack([torch.stack([w[g * cg:(g + 1) * cg, :, j].T
                                     for j in range(w.shape[2])])
                        for g in range(groups)])


@pytest.mark.parametrize("dtype,width", [(torch.bfloat16, 16),
                                         (torch.float32, 16),
                                         (torch.float32, 64)])
def test_weight_tiles_of_the_simt_body_are_plain(dtype, width):
    """What the SIMT body reads (f32, and bf16 groups of 16): tile (g, j)
    is tap j of group g as (in, out), unpermuted."""
    w = torch.randn((3 * width, width, CP.TAPS)).to(dtype)
    assert CP.takes_weights(w, 3) and not CP.swizzled(dtype, width)
    tiles = CP.weight_tiles(w, 3)
    assert tiles.dtype == dtype and tiles.is_contiguous()
    assert torch.equal(tiles, plain_tiles(w, 3))


def test_the_checks_refuse_what_cp_does_not_take():
    """The wrapper's checks (CP's launch conditions) on CPU tensors: it
    takes bf16 and f32 maps in groups of 16 or 64; it refuses another
    dtype, a compute dtype other than the map's, weights or tiles of
    another dtype, groups of other widths, missing tiles, a mask of other
    rows."""
    h, ws, fm = embedding_inputs(2, 40, 128, 2, torch.bfloat16, 30)
    tiles = tuple(CP.weight_tiles(w, 2) for w in (ws[0], ws[2]))
    assert CP._check(h, *ws, 2, fm, torch.bfloat16, tiles) == 1
    assert CP._check(h, *ws, 2, None, torch.bfloat16, tiles) == 0
    assert CP._check(h, *ws, 2, fm.expand(2, -1, -1).contiguous(),
                     torch.bfloat16, tiles) == 2
    h16, ws16, fm16 = embedding_inputs(2, 40, 64, 4, torch.bfloat16, 30)
    tiles16 = tuple(CP.weight_tiles(w, 4) for w in (ws16[0], ws16[2]))
    assert CP._check(h16, *ws16, 4, fm16, torch.bfloat16, tiles16) == 1
    h32, ws32, _ = embedding_inputs(2, 40, 128, 2, torch.float32)
    tiles32 = tuple(CP.weight_tiles(w, 2) for w in (ws32[0], ws32[2]))
    assert CP._check(h32, *ws32, 2, None, None, tiles32) == 0
    assert CP._check(h32, *ws32, 2, fm, torch.float32, tiles32) == 1
    bad = [((h, *ws, 2, fm, None, tiles), "bf16"),
           ((h32, *ws32, 2, fm, torch.bfloat16, tiles32), "compute dtype"),
           ((h.half(), *ws, 2, fm, torch.float16, tiles), "f32 map"),
           ((h32, ws[0], *ws32[1:], 2, fm, None, tiles32), "weights"),
           ((h32, *ws32, 2, fm, None, tiles), "tap tiles"),
           ((h, *ws, 4, fm, torch.bfloat16, tiles), "groups"),
           ((h, *ws, 2, fm, torch.bfloat16, None), "tap tiles"),
           ((h, ws[0], ws[1].float(), *ws[2:], 2, fm, torch.bfloat16, tiles),
            "biases"),
           ((h, *ws, 2, torch.ones((3, 40, 1), dtype=torch.bool),
             torch.bfloat16, tiles), "frame mask"),
           ((h.transpose(0, 1), *ws, 2, fm, torch.bfloat16, tiles),
            "contiguous")]
    for args, match in bad:
        with pytest.raises(ValueError, match=match):
            CP._check(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel CP has no CPU mode)")
    return torch.device("cuda")


def chain64(h, w1, b1, w2, b2, groups, frame_mask):
    """The chain with each conv summed in f64, its bias added there and
    the sum rounded once to bf16; Mish, the masks and the add as the
    chain has them."""
    def conv(x, w, b):
        y = FM.F.conv1d(x.double().transpose(1, 2), w.double(), b.double(),
                        padding=w.shape[-1] // 2, groups=groups)
        return y.transpose(1, 2).to(torch.bfloat16)

    y = FM.F.mish(conv(zero_frames(h, frame_mask), w1, b1))
    y = FM.F.mish(conv(zero_frames(y, frame_mask), w2, b2))
    return h + zero_frames(y, frame_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("t,n_valid,rows", [
    (768, None, 1), (1280, 1213, 1), (2048, 1957, 1), (100, 83, 1),
    (300, (300, 211), 2)])
def test_cp_matches_its_plain_twin_on_card(cuda_device, t, n_valid, rows):
    """CP on both CFG rows (unlike rows) at the loop's padded lengths,
    the mask shared by the rows as the loop builds it, cutting a ragged
    tail; a T shorter than one block's tile; a mask a row (``rows``).
    Against chain64 and the twin (cuDNN) as the module says; masked
    frames bit-equal to h."""
    n = n_valid if rows == 1 else None
    h, ws, fm = embedding_inputs(2, t, 1024, 16, torch.bfloat16, n,
                                 seed=t, device=cuda_device)
    if rows == 2:
        fm = (torch.arange(t, device=cuda_device)[None, :] < torch.tensor(
            n_valid, device=cuda_device)[:, None])[..., None].contiguous()
    tiles = tuple(CP.weight_tiles(w, 16) for w in (ws[0], ws[2]))
    got = CP.conv_pos_embed(h, *ws, 16, fm, torch.bfloat16, tiles)
    twin = CP.conv_pos_embed_plain(h, *ws, 16, fm, torch.bfloat16)
    exact = chain64(h, *ws, 16, fm)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == h.shape
    got, twin, exact = got.float(), twin.float(), exact.float()
    top = float(exact.abs().max())
    assert float((got == exact).float().mean()) >= SHARE_EXACT
    assert float((got - exact).abs().max()) <= MAX_OFF * top
    assert float((got - exact).pow(2).mean()) <= \
        float((twin - exact).pow(2).mean())
    assert float((got - twin).abs().max()) <= 2 * MAX_OFF * top
    if fm is not None:
        masked = ~fm.expand(2, t, 1024)
        assert torch.equal(got[masked], h.float()[masked])


def chain_f64(h, w1, b1, w2, b2, groups, frame_mask):
    """The chain in f64 throughout (the f32 plane's exact answer)."""
    return conv_pos_embed_f64(h.double(), w1.double(), b1.double(),
                              w2.double(), b2.double(), groups, frame_mask)


def conv_pos_embed_f64(h, w1, b1, w2, b2, groups, frame_mask):
    y = FM.F.mish(conv1d_tm(zero_frames(h, frame_mask), w1, b1,
                            torch.float64, groups))
    y = FM.F.mish(conv1d_tm(zero_frames(y, frame_mask), w2, b2,
                            torch.float64, groups))
    return h + zero_frames(y, frame_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,c,groups,t,n_valid,rows", [
    (torch.float32, 1024, 16, 1280, 1213, 1),
    (torch.float32, 1024, 16, 300, (300, 211), 2),
    (torch.float32, 64, 4, 100, 83, 1),
    (torch.bfloat16, 64, 4, 300, (300, 211), 2),
    (torch.bfloat16, 64, 4, 1280, None, 1)])
def test_cp_simt_body_matches_the_chain_on_card(cuda_device, dtype, c,
                                                groups, t, n_valid, rows):
    """The SIMT body: the f32 plane at full width (16 groups of 64) and
    the tiny configs' groups of 16 in f32 and bf16, on both CFG rows,
    with a ragged tail masked (shared, or a mask a row), a T shorter
    than a block's tile; f32 against the chain in f64, bf16 against
    chain64, as the module says; masked frames bit-equal to h."""
    n = n_valid if rows == 1 else None
    h, ws, fm = embedding_inputs(2, t, c, groups, dtype, n, seed=t + c,
                                 device=cuda_device)
    if rows == 2:
        fm = (torch.arange(t, device=cuda_device)[None, :] < torch.tensor(
            n_valid, device=cuda_device)[:, None])[..., None].contiguous()
    tiles = tuple(CP.weight_tiles(w, groups) for w in (ws[0], ws[2]))
    cd = torch.bfloat16 if dtype == torch.bfloat16 else None
    CP.conv_pos_embed.launches = 0
    got = CP.conv_pos_embed(h, *ws, groups, fm, cd, tiles)
    torch.cuda.synchronize()
    assert CP.conv_pos_embed.launches == 1
    assert got.dtype == dtype and got.shape == h.shape
    if dtype == torch.float32:
        exact = chain_f64(h, *ws, groups, fm)
        top = float(exact.abs().max())
        assert float((got.double() - exact).abs().max()) <= F32_OFF * top
    else:
        exact = chain64(h, *ws, groups, fm).float()
        top = float(exact.abs().max())
        assert float((got.float() == exact).float().mean()) >= SHARE_EXACT
        assert float((got.float() - exact).abs().max()) <= MAX_OFF * top
    if fm is not None:
        masked = ~fm.expand(2, t, c)
        assert torch.equal(got[masked], h[masked])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tiny_f5_requests_launch_cp_each_step_on_card(cuda_device, dtype,
                                                      monkeypatch):
    """A whole tiny F5 request (``tiny_f5_config``: 4 groups of 16, heads
    of 16) through ``synthesize()`` on the card, in bf16 and on the f32
    plane: CP (its SIMT body) launches once a step, nfe in all, and the
    mel agrees with the CPU's eager run at the bf16 plane's 2e-2 relative
    L2 (the card's kernels sum in other orders). y0 is drawn on the CPU
    for both."""
    from tortoise_tpu_torch.ops import cuda as kernels
    from tortoise_tpu_torch.pipeline import f5_stage as S
    from tortoise_tpu_torch.pipeline import graphs
    from tortoise_tpu_torch.pipeline.synthesize import synthesize

    monkeypatch.setattr(S, "draw_normal", lambda gen, shape, device: (
        torch.randn(shape, generator=torch.Generator().manual_seed(9))
        .to(device)))
    cfg, vcfg = FM.tiny_f5_config(), S.vmodel.tiny_vocos_config()
    p, v = S.random_params(cfg, vcfg, S.WEIGHTS, 5, "cpu")
    g = torch.Generator().manual_seed(1)
    voice = S.F5Voice((torch.randn((120, 100), generator=g) * 2 - 4).numpy(),
                      torch.randint(0, 40, (20,), generator=g).tolist())
    gen = torch.randint(0, 40, (30,), generator=g).tolist()
    cd = torch.bfloat16 if dtype == torch.bfloat16 else None
    mels = {}
    for dev in ("cpu", cuda_device):
        graphs.clear()
        kernels.reset_launch_counts()
        res = synthesize(S.F5Models(p, v, cfg, vcfg), tokens=gen, voice=voice,
                         seed=9, compute_dtype=cd, device=dev)
        mels[str(dev)] = torch.as_tensor(res.mel).double()
        if dev != "cpu":
            assert kernels.launch_counts()["conv_pos"] == cfg.nfe
    cpu, card = mels["cpu"], mels[str(cuda_device)]
    assert bool(torch.isfinite(card).all())
    assert float((card - cpu).norm() / cpu.norm()) < 2e-2


@pytest.mark.cuda
def test_one_f5_eval_launches_cp_once(cuda_device, monkeypatch):
    """One bf16 CFG eval at full width (1 block, T = 1,280, a ragged
    tail): one launch of CP and no cuDNN kernel; the launches it saves
    are every one of the eager chain's (its convs, transposes, Mish,
    masks and add) but CP's one."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tortoise_tpu_torch.ops import cuda as kernels
    from tortoise_tpu_torch.pipeline import f5_stage as S

    cfg = dataclasses.replace(FM.F5Config(), depth=1)
    params, _ = S.random_params(cfg, S.vmodel.tiny_vocos_config(), S.WEIGHTS,
                                1, cuda_device)
    cd = torch.bfloat16
    prep = FM.prepare(params, cfg, cd)
    g = torch.Generator(device=cuda_device).manual_seed(5)
    t, n = 1280, 1213
    x = torch.randn((1, t, cfg.mel_dim), generator=g, device=cuda_device)
    ct = torch.randn((2, t, cfg.mel_dim + cfg.text_dim), generator=g,
                     device=cuda_device).to(cd)
    h = torch.randn((2, t, cfg.dim), generator=g, device=cuda_device).to(cd)
    valid = torch.arange(t, device=cuda_device) < n
    fm = valid[None, :, None]
    mask_add = torch.where(valid, 0.0, FM.NEG_INF).expand(2, t).contiguous()
    args = (prep, cfg, x, ct, torch.tensor([0.4], device=cuda_device), fm,
            valid.expand(2, t), mask_add, cd)
    pi = prep["input"]
    weights = (pi["pos1_w"], pi["pos1_b"], pi["pos2_w"], pi["pos2_b"],
               cfg.conv_pos_groups)

    def kernels_of(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return {e.key: e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA}

    kernels.reset_launch_counts()
    FM.velocity(*args)
    assert kernels.launch_counts()["conv_pos"] == 1
    with_cp = kernels_of(lambda: FM.velocity(*args))
    chain = kernels_of(lambda: CP.conv_pos_embed_plain(h, *weights, fm, cd))
    cudnn = ("fprop", "xmma", "cudnn", "convolve", "nchw", "nhwc")
    assert not [k for k in with_cp if any(s in k.lower() for s in cudnn)]
    assert sum(c for k, c in with_cp.items() if "conv_pos" in k) == 1
    monkeypatch.setattr(CP, "conv_pos_embed", lambda h, w1, b1, w2, b2,
                        groups, fm, cd, tiles: CP.conv_pos_embed_plain(
                            h, w1, b1, w2, b2, groups, fm, cd))
    without = kernels_of(lambda: FM.velocity(*args))
    assert sum(without.values()) - sum(with_cp.values()) == \
        sum(chain.values()) - 1, (chain, with_cp, without)
