"""The vocoder's fused conv-block tail: kernel E.

``lvc_gated_residual`` replaces
``tortoise_tpu/ops/pallas/lvc.py::lvc_gated_residual``: the
location-variable convolution of x with the kernel predicted for each
hop chunk, plus its bias, then the gate sigmoid(y[:C]) * tanh(y[C:]) and
the residual add, all in f32.

The CUDA kernel (``csrc/lvc.cu``) is bound by reading the predicted
kernel and, at hop 256, by its f32 FMAs. A persistent grid walks work
items of 8 to 32 chunks and a group of output channels; a block stages
the next item's kernel rows as whole 32-byte sectors (or longer
segments) with cp.async while it computes this one. Each thread computes
S samples of one chunk for the item's outputs, so one shared weight load
feeds S FMAs (24 on the hop-256 path, which loads a row's 3 taps at
once). ``lvc_plan`` picks S, the chunks and the output group from the
hop and the grid size, so a short input (a stream chunk) still covers
the card. It takes K = 3 taps and any C.

The wrapper dispatches on the device of ``x``: a CPU tensor takes the
plain version (``location_variable_conv`` in f32, then the gate and the
residual), a CUDA tensor launches the kernel (one count per call) or
raises.
"""

from __future__ import annotations

import torch

from tortoise_tpu_torch.ops.conv import location_variable_conv
from tortoise_tpu_torch.ops.cuda import build

SM_COUNT = 132  # an H100 SXM's SMs: the grid lvc_plan aims to cover twice
LVC_THREADS = 256  # csrc/lvc.cu kThreads
LVC_SMEM = 48 * 1024  # one buffer of staged kernel slices (a block has 2)
LVC_PAIRS = {1: 2, 2: 8, 8: 4}  # gated channels a block, by samples a thread
# the (samples, pairs, chunks) shapes csrc/lvc.cu builds (its kShapes):
# every shape lvc_plan can pick, and no other
LVC_SHAPES = frozenset(
    [(1, g, nl) for g in (1, 2) for nl in (8, 16, 32)]
    + [(2, g, 8) for g in (1, 2, 4, 8)] + [(8, g, 8) for g in (1, 2, 4)])


def lvc_plan(b: int, c_in: int, c: int, l: int, hop: int,
             sms: int = SM_COUNT) -> dict:
    """Kernel E's launch shape for batch b, c_in input and c gated
    channels, l chunks of ``hop`` samples: ``samples`` a thread, ``chunks``
    (8, 16 or 32) and ``pairs`` (gated channels) of a work item, and
    ``grid`` (output groups, chunk groups, b): the work items, which a
    persistent grid of blocks walks.

    A thread takes 8 samples where 256 divides the hop (the wide path: a
    warp's 256 samples lie in one chunk), else 2 from hop 64 on, else 1.
    An item takes the chunks that give a block's 256 threads one pass (the
    longest row segments of the predicted kernel at small hops) and the
    gated channels of LVC_PAIRS, as few as c, a staged buffer of
    LVC_SMEM and 2 * sms items need (chosen from a sweep of every block
    shape on the card at the vocoder's widths, PERF.md). The result is
    one of LVC_SHAPES."""
    s = 8 if hop % 256 == 0 else 2 if hop % 2 == 0 and hop >= 64 else 1
    nl = 32 if LVC_THREADS * s >= 32 * hop else \
        16 if LVC_THREADS * s >= 16 * hop else 8
    g = LVC_PAIRS[s]
    taps = 4 if s == 8 else 3  # the wide path pads a row's taps to 4
    while g > 1 and (c % g or c_in * 2 * g * taps * nl * 4 > LVC_SMEM):
        g //= 2
    while (c // g) * -(-l // nl) * b < 2 * sms and (g > 1 or nl > 8):
        if g > 1:
            g //= 2
        else:
            nl //= 2
    return dict(samples=s, chunks=nl, pairs=g, grid=(c // g, -(-l // nl), b))


def lvc_gated_residual_plain(x, kernel, bias, residual, hop: int
                             ) -> torch.Tensor:
    """Plain PyTorch twin of kernel E."""
    c = residual.shape[1]
    y = location_variable_conv(x.float(), kernel.float(), bias.float(), hop)
    return residual.float() + torch.sigmoid(y[:, :c]) * torch.tanh(y[:, c:])


def _batch_rows(t: torch.Tensor) -> torch.Tensor:
    """t with each batch row contiguous (a [:, c] slice of the stacked
    per-block kernels already is), else a contiguous copy."""
    row = t[0]
    return t if row.is_contiguous() and t.stride(-1) == 1 else t.contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous with a 16-byte aligned base (the kernel's float4
    accesses), copied if it is not."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def lvc_gated_residual(x: torch.Tensor, kernel: torch.Tensor,
                       bias: torch.Tensor, residual: torch.Tensor,
                       hop: int) -> torch.Tensor:
    """Kernel E. x (B, C_in, T); kernel (B, C_in, 2C, K, L); bias
    (B, 2C, L); residual (B, C, T); T = L*hop. Returns residual + gated
    LVC, f32 (B, C, T)."""
    if not x.is_cuda:
        return lvc_gated_residual_plain(x, kernel, bias, residual, hop)
    b, c_in, t = x.shape
    _, _, c2, k, l = kernel.shape
    c = residual.shape[1]
    if (kernel.shape[:2] != (b, c_in) or tuple(bias.shape) != (b, c2, l)
            or tuple(residual.shape) != (b, c, t) or c2 != 2 * c
            or t != l * hop):
        raise ValueError(
            f"lvc shapes do not fit: x {tuple(x.shape)}, kernel "
            f"{tuple(kernel.shape)}, bias {tuple(bias.shape)}, residual "
            f"{tuple(residual.shape)}, hop {hop}")
    if k != 3:
        raise ValueError(f"kernel E takes K = 3 taps, got K = {k}")
    tensors = (x, kernel, bias, residual)
    if any(a.dtype != torch.float32 for a in tensors):
        raise ValueError("kernel E wants float32 x, kernel, bias and "
                         "residual")
    x, residual = _aligned(x), _aligned(residual)
    kernel, bias = _batch_rows(kernel), _batch_rows(bias)
    out = torch.empty_like(residual)
    plan = lvc_plan(b, c_in, c, l, hop,
                    torch.cuda.get_device_properties(x.device)
                    .multi_processor_count)
    lib = build.library()
    build.check(lib.tt_lvc_gated_residual(
        x.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
        residual.data_ptr(), out.data_ptr(), b, c_in, c, k, l, hop,
        plan["samples"], plan["pairs"], plan["chunks"], kernel.stride(0),
        bias.stride(0), build.stream_ptr()), "tt_lvc_gated_residual")
    lvc_gated_residual.launches += 1
    return out


lvc_gated_residual.launches = 0

__all__ = ["lvc_gated_residual", "lvc_gated_residual_plain", "lvc_plan"]
