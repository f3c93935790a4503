"""F5-TTS's conv position embedding: kernel CP.

``conv_pos_embed`` is ConvPositionEmbedding (SWivid/F5-TTS
``model/modules.py``) on a time-major (B, T, C) map ``h``:

    h + zero(mish(conv2(zero(mish(conv1(zero(h)))))))

with conv1 and conv2 grouped Conv1d of k 31 and "same" zero padding, and
``zero`` the frame mask (padded frames to 0). Only ``models.f5.velocity``
calls it. It ports no Pallas kernel (the JAX package has no F5): the
eager chain, cuDNN's per-group kernels and the transposes and elementwise
passes around them, took 0.47 ms at T = 1,280 on an H100, ~4% of its
bound (``csrc/conv_pos.cu`` has the design).

An ``h`` on a card launches CP (one launch a call) or raises for what CP
does not take. CP takes a bf16 or an f32 map in groups of 16 or 64
channels (``GROUP_WIDTHS``), k 31, weights and biases in h's dtype, and
the weights' tap tiles from ``weight_tiles`` (laid out once, in
``models.f5.prepare``). Its wgmma body runs bf16 groups of 64 (F5 at
full width); its SIMT body runs the f32 plane and the tiny configs'
groups of 16. A CPU map takes the plain twin ``conv_pos_embed_plain``,
the eager chain. CP keeps the chain's rounding points (each conv's f32
sum plus bias rounded to h's dtype, Mish in f32 rounded to it, the
residual add rounded to it); its sums run in another order than cuDNN's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops.basic import conv1d_tm, zero_frames
from tortoise_tpu_torch.ops.cuda import build

GROUP_WIDTHS = (16, 64)  # csrc/conv_pos.cu: the SIMT body's, the wgmma's
TAPS = 31  # csrc/conv_pos.cu kK
DTYPES = (torch.bfloat16, torch.float32)


def conv_pos_embed_plain(h, w1, b1, w2, b2, groups: int, frame_mask=None,
                         compute_dtype=None):
    """The eager chain: each conv on the channel-major transpose in
    ``compute_dtype`` (f32 without it), ``F.mish`` after it, the mask
    before each conv and on the sum's second term. Returns (B, T, C)."""
    cd = compute_dtype
    y = F.mish(conv1d_tm(zero_frames(h, frame_mask), w1, b1, cd, groups))
    y = F.mish(conv1d_tm(zero_frames(y, frame_mask), w2, b2, cd, groups))
    return h + zero_frames(y, frame_mask)


def takes_weights(w: torch.Tensor, groups: int) -> bool:
    """Whether CP takes a conv of weight ``w`` (C, C / groups, k): bf16
    or f32, groups of 16 or 64 channels, 31 taps."""
    return w.dtype in DTYPES and w.dim() == 3 and \
        w.shape[1] in GROUP_WIDTHS and \
        tuple(w.shape) == (groups * w.shape[1], w.shape[1], TAPS)


def swizzled(dtype, group_width: int) -> bool:
    """Whether CP's wgmma body reads these tiles (bf16 groups of 64), so
    that ``weight_tiles`` lays them out in its swizzle."""
    return dtype == torch.bfloat16 and group_width == 64


def weight_tiles(w: torch.Tensor, groups: int) -> torch.Tensor:
    """A grouped conv weight (C, cg, 31) as CP's tap tiles (groups, 31,
    cg, cg) in w's dtype: tile (g, j) holds tap j of group g as (in,
    out). For the wgmma body (``swizzled``) each 128-byte row's eight
    16-byte chunks sit permuted, chunk p at p ^ (row % 8): the 128-byte
    swizzle, which wgmma reads an MN-major B operand in."""
    c, cg, k = w.shape
    tiles = w.reshape(groups, c // groups, cg, k).permute(0, 3, 2, 1)
    if swizzled(w.dtype, cg):
        tiles = tiles.reshape(groups, k, cg, -1, 8)
        row = torch.arange(cg, device=w.device)[:, None]
        chunk = torch.arange(tiles.shape[3], device=w.device)[None, :] \
            ^ (row % 8)
        tiles = tiles[:, :, row, chunk].reshape(groups, k, cg, -1)
    return tiles.contiguous()


def _check(h, w1, b1, w2, b2, groups, frame_mask, compute_dtype, tiles):
    """Raise for what CP does not take; returns the mask's rows (0: no
    mask)."""
    if h.dim() != 3 or not h.is_contiguous() or h.data_ptr() % 16 \
            or h.numel() == 0:
        raise ValueError(f"conv_pos_embed: h must be a contiguous (B, T, C) "
                         f"map, got {tuple(h.shape)} (strides {h.stride()})")
    bsz, t, c = h.shape
    dt = h.dtype
    if dt not in DTYPES or (compute_dtype or torch.float32) != dt \
            or c % groups or c // groups not in GROUP_WIDTHS:
        raise ValueError(f"conv_pos_embed on a card takes a bf16 or f32 map "
                         f"in its compute dtype, in groups of "
                         f"{GROUP_WIDTHS} channels; got a {dt} map, compute "
                         f"dtype {compute_dtype}, C = {c} in {groups} groups")
    cg = c // groups
    for w in (w1, w2):
        if w.dtype != dt or not takes_weights(w, groups):
            raise ValueError(f"conv_pos_embed: {dt} weights ({c}, {cg}, "
                             f"{TAPS}), got {w.dtype} {tuple(w.shape)}")
    want = (groups, TAPS, cg, cg)
    if tiles is None or len(tiles) != 2 or any(
            x.dtype != dt or tuple(x.shape) != want
            or not x.is_contiguous() or x.device != h.device
            or x.data_ptr() % 16 for x in tiles):
        raise ValueError(f"conv_pos_embed: both convs' tap tiles "
                         f"(weight_tiles) {want} {dt} on h's device")
    for b in (b1, b2):
        if b.dtype != dt or tuple(b.shape) != (c,) \
                or not b.is_contiguous() or b.device != h.device:
            raise ValueError(f"conv_pos_embed: contiguous {dt} ({c},) "
                             f"biases on h's device, got {b.dtype} "
                             f"{tuple(b.shape)}")
    if frame_mask is None:
        return 0
    if frame_mask.dtype != torch.bool or frame_mask.dim() != 3 \
            or frame_mask.shape[0] not in (1, bsz) \
            or tuple(frame_mask.shape[1:]) != (t, 1) \
            or not frame_mask.is_contiguous() \
            or frame_mask.device != h.device:
        raise ValueError(f"conv_pos_embed: a contiguous bool (1 or {bsz}, "
                         f"{t}, 1) frame mask, got {frame_mask.dtype} "
                         f"{tuple(frame_mask.shape)}")
    return frame_mask.shape[0]


def conv_pos_embed(h, w1, b1, w2, b2, groups: int, frame_mask=None,
                   compute_dtype=None, tiles=None):
    """``h + zero(mish(conv2(zero(mish(conv1(zero(h)))))))`` over h (B, T,
    C): w1, w2 (C, C / groups, 31) and b1, b2 (C,) in torch's Conv1d
    layout; ``frame_mask`` (1 or B, T, 1) bool or None; ``tiles`` the two
    convs' ``weight_tiles`` (CP's operands). Kernel CP on a CUDA h, else
    ``conv_pos_embed_plain``. Returns (B, T, C) in h's dtype."""
    if not h.is_cuda:
        return conv_pos_embed_plain(h, w1, b1, w2, b2, groups, frame_mask,
                                    compute_dtype)
    mask_rows = _check(h, w1, b1, w2, b2, groups, frame_mask, compute_dtype,
                       tiles)
    bsz, t, c = h.shape
    out = torch.empty_like(h)
    build.check(build.library().tt_conv_pos(
        h.data_ptr(), None if frame_mask is None else frame_mask.data_ptr(),
        mask_rows, tiles[0].data_ptr(), b1.data_ptr(), tiles[1].data_ptr(),
        b2.data_ptr(), out.data_ptr(), bsz, t, groups, c // groups,
        int(h.dtype == torch.float32), build.stream_ptr()), "tt_conv_pos")
    conv_pos_embed.launches += 1
    return out


conv_pos_embed.launches = 0

__all__ = ["conv_pos_embed", "conv_pos_embed_plain", "swizzled",
           "takes_weights", "weight_tiles"]
