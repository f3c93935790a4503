"""1-D convolutions (counterpart of ``tortoise_tpu/ops/conv.py``).

Weights keep the torch Conv1d orientation (out_ch, in_ch, kernel) that the
GGML reader delivers; transposed-conv weights are (in_ch, out_ch, kernel).
Same dtype contract as ops.basic: operands rounded to ``compute_dtype``,
float32 arithmetic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops.basic import _mm, mm_bf16, quantize_rows
from tortoise_tpu_torch.ops.cuda import int8_product as i8


def _rounded(x, w, compute_dtype):
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    return x.float(), w.float()


def conv1d(x, w, b=None, stride: int = 1, padding: int = 0,
           dilation: int = 1, groups: int = 1, compute_dtype=None):
    """x (N, C_in, T); w (C_out, C_in/groups, K) -> (N, C_out, T') f32."""
    xr, wr = _rounded(x, w, compute_dtype)
    out = F.conv1d(xr, wr, None, stride, padding, dilation, groups)
    if b is not None:
        out = out + b[..., :, None]
    return out


def conv1d_nwc(x, w, b=None, stride: int = 1, padding: int = 0,
               dilation: int = 1, groups: int = 1, compute_dtype=None,
               out_dtype=None, row_max=None, reduce=None):
    """Time-major conv: x (N, T, C_in) -> (N, T', C_out). ``w`` may be an
    int8 pair (wmat (K*C_in, C_out) int8, scale) — then the product runs
    with per-row activation quantization, one shifted matmul per tap
    (k = 2*padding + 1); ``row_max`` and ``reduce`` (given the stacked
    taps' integer sums) as in ``ops.basic.pdot_int8act``; on a card
    without them kernels Q8 and E8 run it, the cast and the bias
    (``ops.cuda.int8_product``), the same bits."""
    if compute_dtype is None:
        out_dtype = None
    if isinstance(w, tuple):
        wq, scale = w
        k = 2 * padding + 1
        if stride != 1 or dilation != 1 or groups != 1:
            raise ValueError("int8 conv supports stride=dilation=groups=1")
        if i8.takes_kernels(x, row_max, reduce):
            return i8.int8_product(x, w, b, out_dtype, padding)
        if k == 1:
            xq, s_row = quantize_rows(x, row_max)
            acc = mm_bf16(xq, wq)
            out = (acc if reduce is None else reduce(acc)) * s_row * scale
        else:
            t = x.shape[1]
            xq, s_row = quantize_rows(x, row_max)
            xqp = F.pad(xq, (0, 0, padding, padding))
            srp = F.pad(s_row, (0, 0, padding, padding))
            cin = wq.shape[0] // k
            wq3 = wq.reshape(k, cin, wq.shape[-1])
            taps = [mm_bf16(xqp[:, j:j + t], wq3[j]) for j in range(k)]
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
    k = w.shape[-1]
    if (k <= 3 and stride == 1 and dilation == 1 and groups == 1
            and padding == (k - 1) // 2 and k % 2 == 1):
        if k == 1:
            xk = x
        else:
            t = x.shape[1]
            xp = F.pad(x, (0, 0, padding, padding))
            xk = torch.cat([xp[:, j:j + t] for j in range(k)], dim=-1)
        wmat = w.permute(2, 1, 0).reshape(k * w.shape[1], w.shape[0])
        out = _mm(xk, wmat, compute_dtype)
    else:
        xr, wr = _rounded(x, w, compute_dtype)
        out = F.conv1d(xr.transpose(1, 2), wr, None, stride, padding,
                       dilation, groups).transpose(1, 2)
    if out_dtype is not None:
        out = out.to(out_dtype)
    if b is not None:
        out = out + (b.to(out_dtype) if out_dtype else b)
    return out


def conv_transpose1d(x, w, b=None, stride: int = 1, compute_dtype=None):
    """torch ConvTranspose1d semantics: w (C_in, C_out, K),
    out_len = (T-1)*stride + K."""
    xr, wr = _rounded(x, w, compute_dtype)
    out = F.conv_transpose1d(xr, wr, None, stride)
    if b is not None:
        out = out + b[..., :, None]
    return out


def reflect_pad1d(x, pad: int):
    """Reflection padding on the last axis."""
    return F.pad(x, (pad, pad), mode="reflect")


def nearest_upscale_time(x, out_len: int):
    """Nearest upscale on the last axis with floor(i*in/out) indices."""
    in_len = x.shape[-1]
    idx = torch.arange(out_len, device=x.device) * in_len // out_len
    return x[..., idx]


def location_variable_conv(x, kernel, bias, hop: int, compute_dtype=None):
    """x (B, C_in, T); kernel (B, C_in, C_out, K, L); bias (B, C_out, L);
    T = L*hop. One batched matmul per hop chunk."""
    b, c_in, t = x.shape
    _, _, c_out, k, l = kernel.shape
    pad = (k - 1) // 2
    xp = F.pad(x, (pad, pad))
    # windows[b, l, s, k*C_in + i] = xp[b, i, l*hop + s + k] (tap-major)
    shifted = torch.cat([xp[:, :, j:j + t] for j in range(k)], dim=1)
    win = shifted.transpose(1, 2).reshape(b, l, hop, c_in * k)
    kern = kernel.permute(0, 4, 3, 1, 2).reshape(b, l, c_in * k, c_out)
    if compute_dtype is not None:
        win, kern = win.to(compute_dtype), kern.to(compute_dtype)
    out = torch.matmul(win.float(), kern.float())  # (B, L, hop, C_out)
    out = out + bias.transpose(1, 2)[:, :, None, :]
    return out.permute(0, 3, 1, 2).reshape(b, c_out, l * hop)
