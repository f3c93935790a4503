"""The vocoder's fused conv-block tail: kernel E.

``lvc_gated_residual`` replaces
``tortoise_tpu/ops/pallas/lvc.py::lvc_gated_residual``: the
location-variable convolution of x with the kernel predicted for each
hop chunk, plus its bias, then the gate sigmoid(y[:C]) * tanh(y[C:]) and
the residual add, all in f32.

The CUDA kernel (``csrc/lvc.cu``) is bound by reading the predicted
kernel (and, at hop 256, x, the residual and the output); one block
stages four chunks' kernel slices in shared memory, one 16-byte load per
row of the native (B, C_in, 2C, K, L) layout, and each thread computes
all 2C outputs of one sample, reading x with its halo straight from
device memory, so no shifted copy of x or transposed copy of the kernel
is made. It takes K = 3 taps and C in {4, 8, 16, 32}.

The wrapper dispatches on the device of ``x``: a CPU tensor takes the
plain version (``location_variable_conv`` in f32, then the gate and the
residual), a CUDA tensor launches the kernel (one count per call) or
raises.
"""

from __future__ import annotations

import torch

from tortoise_tpu_torch.ops.conv import location_variable_conv
from tortoise_tpu_torch.ops.cuda import build


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
    if k != 3 or c not in (4, 8, 16, 32):
        raise ValueError(f"kernel E takes K = 3 taps and 4, 8, 16 or 32 "
                         f"gated channels, got K = {k}, C = {c}")
    tensors = (x, kernel, bias, residual)
    if any(a.dtype != torch.float32 for a in tensors):
        raise ValueError("kernel E wants float32 x, kernel, bias and "
                         "residual")
    x, residual = x.contiguous(), residual.contiguous()
    kernel, bias = _batch_rows(kernel), _batch_rows(bias)
    out = torch.empty_like(residual)
    lib = build.library()
    build.check(lib.tt_lvc_gated_residual(
        x.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
        residual.data_ptr(), out.data_ptr(), b, c_in, c, k, l, hop,
        kernel.stride(0), bias.stride(0), build.stream_ptr()),
        "tt_lvc_gated_residual")
    lvc_gated_residual.launches += 1
    return out


lvc_gated_residual.launches = 0

__all__ = ["lvc_gated_residual", "lvc_gated_residual_plain"]
