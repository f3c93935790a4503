"""The denoiser's group norms: kernel G.

``group_norm_act`` is a group norm over a time-major (B, T, C) map and
the elementwise chain that follows it in the denoiser, up to the next
product: the affine, then optionally the FiLM ``y * (1 + scale) +
shift`` per (row, channel) (the factor ``1 + scale`` formed in the
FiLM's dtype, as in the JAX package), the SiLU, and the zeroing of padded
frames.
It replaces the JAX package's ``group_norm_tc`` with the ops after it in
``tortoise_tpu/models/diffusion.py``, which XLA fuses; it ports no
Pallas kernel.

Its definition, on either device: the statistics of each (row, group)
over the valid frames (``mask`` true) and the group's channels, in
float32; on a bf16 map the one-pass E[x^2] - mean^2 form (the JAX
package's ``fast``), on an f32 map the exact centered form. The chain
stays in float32 and rounds once, to x's dtype. The
norm gives 0 on padded frames, from which FiLM and SiLU go on as on any
frame; with SiLU, padded frames are zeroed after it too (else the FiLM
shift would leak into the next k3 conv). Without SiLU they keep the
FiLM shift, as the JAX package's conditioner gives.

A CPU tensor takes the plain twin (``group_norm_act_plain``: the port's
``group_norm_tc`` on the f32 map, then ``activate``). A CUDA tensor
launches ``csrc/group_norm.cu`` (two launches, one count a call) or
raises; it takes bf16 or f32 maps whose C is a multiple of the 16-byte
vector and at most 256 of them (2048 bf16 or 1024 f32 channels). Both
paths check the arguments alike, so the CPU tests refuse what the card
would.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops.basic import group_norm_tc
from tortoise_tpu_torch.ops.cuda import build

SM_COUNT = 132  # an H100 SXM's SMs: gn_plan aims at two blocks on each
GN_THREADS = 256  # csrc/group_norm.cu kThreads
GN_ACC = 4  # csrc/group_norm.cu kAcc: interleaved row sums a chunk
_DTYPES = (torch.bfloat16, torch.float32)


def gn_plan(b: int, t: int, sms: int = SM_COUNT) -> dict:
    """Kernel G's grid (n_chunks, b) for b rows of t frames: ``chunk``
    rows a block, a whole number of GN_ACC, about 2 * sms blocks in all
    whatever b and t. It reads neither the channels nor the groups, so a
    tp rank's local groups meet their sums in the single rank's order and
    give its bits."""
    n_chunks = max(1, min(-(-2 * sms // b), -(-t // GN_ACC)))
    chunk = -(-t // n_chunks)
    chunk = -(-chunk // GN_ACC) * GN_ACC
    return dict(chunk=chunk, n_chunks=-(-t // chunk))


def activate(y: torch.Tensor, mask=None, film=None,
             silu: bool = False) -> torch.Tensor:
    """The chain after the norm on its float32 (B, T, C) output ``y``
    (padded frames already 0): FiLM, SiLU, and padded frames zeroed after
    the SiLU. The FiLM factor ``1 + scale`` is formed in the FiLM's dtype,
    as the JAX package forms it from its bf16 split of the time
    embedding."""
    if film is not None:
        scale, shift = (f.reshape(-1, 1, y.shape[-1]) for f in film)
        y = y * (1.0 + scale).float() + shift.float()
    if silu:
        y = F.silu(y)
        if mask is not None:
            y = torch.where(mask[..., None], y, 0.0)
    return y


def group_norm_act_plain(x, n_groups, w, b, eps=1e-5, mask=None, *,
                         film=None, silu=False):
    """Plain PyTorch twin of kernel G (see the module's docstring): its
    float32 result, which the op rounds once to x's dtype."""
    y = group_norm_tc(x.float(), n_groups, w, b, eps, mask,
                      fast=x.dtype == torch.bfloat16)
    return activate(y, mask, film, silu)


def _rows(t: torch.Tensor, n: int, width: int, name: str) -> int:
    """The batch stride of a (n or 1, width) tensor (a (width,) one is
    one row for all), contiguous along its last axis; 0 for one row."""
    if t.dim() not in (1, 2) or t.shape[-1] != width \
            or (t.dim() == 2 and t.shape[0] not in (1, n)) \
            or t.stride(-1) != 1:
        raise ValueError(f"group_norm_act: {name} {tuple(t.shape)} (strides "
                         f"{t.stride()}) is not ({n} or 1, {width}) with "
                         f"contiguous rows")
    return t.stride(0) if t.dim() == 2 and t.shape[0] > 1 else 0


def _check(x, n_groups, w, b, mask, film):
    """Raise for what the kernel does not take; returns the mask's and
    the FiLM's batch strides."""
    if x.dim() != 3 or not x.is_contiguous() or x.dtype not in _DTYPES:
        raise ValueError(f"group_norm_act wants a contiguous bf16 or f32 "
                         f"(B, T, C) map, got {x.dtype} {tuple(x.shape)} "
                         f"(strides {x.stride()})")
    bsz, t, c = x.shape
    v = 16 // x.element_size()
    if c % v or c // v > GN_THREADS or n_groups < 1 or c % n_groups \
            or bsz < 1 or t < 1:
        raise ValueError(f"group_norm_act takes C a multiple of {v} up to "
                         f"{GN_THREADS * v} in groups that divide it, got "
                         f"{tuple(x.shape)} in {n_groups} groups")
    for name, p in (("w", w), ("b", b)):
        if p.dtype != torch.float32 or tuple(p.shape) != (c,) \
                or not p.is_contiguous() or p.device != x.device:
            raise ValueError(f"group_norm_act: {name} must be a contiguous "
                             f"f32 ({c},) on {x.device}, got {p.dtype} "
                             f"{tuple(p.shape)} on {p.device}")
    mask_sb = 0
    if mask is not None:
        if mask.dtype != torch.bool or mask.device != x.device:
            raise ValueError("group_norm_act: mask must be bool on x's "
                             "device")
        mask_sb = _rows(mask, bsz, t, "mask")
    film_sb = 0
    if film is not None:
        scale, shift = film
        strides = {_rows(f, bsz, c, name)
                   for name, f in (("scale", scale), ("shift", shift))}
        if len(strides) != 1 or scale.shape != shift.shape \
                or any(f.dtype != x.dtype or f.device != x.device
                       for f in film):
            raise ValueError(f"group_norm_act: the FiLM scale and shift "
                             f"must share shape and strides and have x's "
                             f"dtype {x.dtype} and device")
        film_sb = strides.pop()
    return mask_sb, film_sb


def group_norm_act(x: torch.Tensor, n_groups: int, w: torch.Tensor,
                   b: torch.Tensor, eps: float = 1e-5, mask=None, *,
                   film=None, silu: bool = False) -> torch.Tensor:
    """Kernel G: x (B, T, C) bf16 or f32, contiguous; ``n_groups`` groups
    of C / n_groups channels; w, b (C,) f32; ``mask`` (B or 1, T) bool or
    None; ``film`` a (scale, shift) pair of (B or 1, C) or (C,) tensors of
    x's dtype, or None; ``silu``. Returns (B, T, C) in x's dtype."""
    mask_sb, film_sb = _check(x, n_groups, w, b, mask, film)
    if not x.is_cuda:
        return group_norm_act_plain(x, n_groups, w, b, eps, mask, film=film,
                                    silu=silu).to(x.dtype)
    bsz, t, c = x.shape
    out = torch.empty_like(x)
    plan = gn_plan(bsz, t, torch.cuda.get_device_properties(x.device)
                   .multi_processor_count)
    n4 = -(-plan["n_chunks"] // 4) * 4
    part = torch.empty((bsz, 2 * n_groups + 1, n4), dtype=torch.float32,
                       device=x.device)
    scale, shift = film if film is not None else (None, None)
    lib = build.library()
    build.check(lib.tt_group_norm_act(
        x.data_ptr(), int(x.dtype == torch.float32),
        None if mask is None else mask.data_ptr(), mask_sb, w.data_ptr(),
        b.data_ptr(), None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(), film_sb,
        part.data_ptr(), out.data_ptr(), bsz, t, c, n_groups, plan["chunk"],
        plan["n_chunks"], float(eps), int(silu), build.stream_ptr()),
        "tt_group_norm_act")
    group_norm_act.launches += 1
    return out


group_norm_act.launches = 0

__all__ = ["activate", "gn_plan", "group_norm_act", "group_norm_act_plain"]
