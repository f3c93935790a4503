"""The int8 denoiser's activation product: kernels Q8 and E8 around the
bf16 GEMM on a card, their plain steps elsewhere.

``int8_product(x, (w_int8, scale), b, out_dtype, padding, row_max,
reduce)`` is every int8 activation product of the port: the bare one of
``ops.basic.pdot_int8act`` (``padding`` 0), ``ops.conv.conv1d_nwc``'s
int8 branch (k = 2 * padding + 1 taps over x's frames) and
``models.diffusion._linear`` / ``_row_linear``, with the cast to
``out_dtype`` and the bias they add after it. One body, three steps:

1. ``quantize_rows``: each row's scale ``s = max(absmax, 1e-12) / 127``
   in f32 (``row_max`` maps the absmax first: under tp the MAX over the
   ranks, so every rank quantizes on the grid of the whole row) and its
   codes ``clamp(round(x / s), -127, 127)`` as bf16 (integers up to 127
   are exact there), into a zero-padded (B, T + 2 padding, K) buffer
   whose pad rows have scale 0;
2. the GEMM of ``ops.basic.mm_bf16``, one call per tap with the tap's
   (K, N) slice of the weight; ``reduce`` maps the stacked tap sums (under
   tp their all-reduce);
3. ``epilogue``: ``((acc_0 s + acc_1 s') + acc_2 s'') * scale`` (tap j
   read j rows further down the padded buffer), cast to ``out_dtype``
   (None keeps f32), plus the bias in that dtype.

The wrappers of steps 1 and 3 make the one choice: on a CUDA tensor with
no hook they launch kernel Q8 and kernel E8, and raise for what those
do not take; otherwise they run their plain twins,
``quantize_rows_plain`` and ``epilogue_plain``, which check only what
their arithmetic needs. The kernels give their plain twins' bits, and a
tap's sums are exact integers in any order up to K = 1040 (K * 127^2 <
2^24, which bounds the K of a conv), so the card, the CPU and tp ranks
give the same product. The JAX package leaves this glue to XLA, which
fuses it; it ports no Pallas kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops import basic
from tortoise_tpu_torch.ops.cuda import build

MAX_ROW_BYTES = 32 * 16 * 16  # Q8: a warp's 32 lanes hold 16 vectors each
EXACT_TAP_K = 1040  # the largest K whose int8 x int8 sums stay below 2^24
_DTYPES = (torch.bfloat16, torch.float32)


def _check_rows(x, padding):
    """Raise for an x that Q8 does not take: (B, T, K) contiguous bf16 or
    f32, K whole 16-byte vectors of at most MAX_ROW_BYTES, 16-byte
    aligned; padding 0 or 1."""
    if padding not in (0, 1):
        raise ValueError(f"int8_product: padding 0 or 1 (k1 or k3), not "
                         f"{padding}")
    if x.dim() != 3 or x.dtype not in _DTYPES or not x.is_contiguous() \
            or x.numel() == 0:
        raise ValueError(f"int8_product: x must be a contiguous bf16 or f32 "
                         f"(B, T, C) map, got {x.dtype} {tuple(x.shape)} "
                         f"(strides {x.stride()})")
    k_in, v = x.shape[-1], 16 // x.element_size()
    if k_in % v or k_in * x.element_size() > MAX_ROW_BYTES \
            or x.data_ptr() % 16:
        raise ValueError(f"int8_product: rows of a multiple of {v} {x.dtype} "
                         f"values up to {MAX_ROW_BYTES} bytes, 16-byte "
                         f"aligned, not K = {k_in}")


def _check_sums(taps, s_row, scale, b, out_dtype):
    """Raise for what E8 does not take: 1 or 3 contiguous f32 sums of B (T
    + 2 padding) rows of N, N a multiple of 4, s_row (B, T + 2 padding) f32,
    a contiguous f32 scale of N values, a contiguous bf16 or f32 (N,)
    bias or None, out_dtype bf16, f32 or None."""
    bsz, tp = s_row.shape
    n = taps[0].shape[-1]
    if len(taps) not in (1, 3) or n % 4 or any(
            a.dtype != torch.float32 or not a.is_contiguous()
            or a.shape[-1] != n or a.numel() != bsz * tp * n
            or a.device != s_row.device
            for a in taps) or s_row.dtype != torch.float32 \
            or not s_row.is_contiguous():
        raise ValueError(f"int8_product: 1 or 3 contiguous f32 ({bsz * tp}, "
                         f"N) sums, N a multiple of 4, and f32 row scales, "
                         f"got {[tuple(a.shape) for a in taps]}")
    if scale.dtype != torch.float32 or scale.numel() != n \
            or not scale.is_contiguous() or scale.device != s_row.device:
        raise ValueError(f"int8_product: a contiguous f32 scale of {n} "
                         f"values, got {scale.dtype} {tuple(scale.shape)}")
    if out_dtype not in (None,) + _DTYPES:
        raise ValueError(f"int8_product: writes bf16 or f32, not {out_dtype}")
    if b is not None and (b.dtype not in _DTYPES or tuple(b.shape) != (n,)
                          or not b.is_contiguous()
                          or b.device != s_row.device):
        raise ValueError(f"int8_product: a contiguous bf16 or f32 ({n},) "
                         f"bias, got {b.dtype} {tuple(b.shape)}")


def quantize_rows_plain(x, padding=0, row_max=None):
    """Q8's result by eager ops (``ops.basic.quantize_rows``, ``row_max``
    as there): codes (..., T + 2 padding, K) bf16 and row scales (...,
    T + 2 padding) f32, the pad rows zero."""
    xq, s_row = basic.quantize_rows(x, row_max)
    if padding:
        pad = (0, 0, padding, padding)
        xq, s_row = F.pad(xq, pad), F.pad(s_row, pad)
    return xq.to(torch.bfloat16), s_row[..., 0]


def quantize_rows(x, padding=0, row_max=None):
    """Step 1 on x (..., K) (a conv's x (B, T, K)): kernel Q8 on a CUDA x
    without ``row_max`` (``_check_rows``' rules), else
    ``quantize_rows_plain``. Returns codes (..., T + 2 padding, K) bf16
    and row scales (..., T + 2 padding) f32."""
    if not x.is_cuda or row_max is not None:
        return quantize_rows_plain(x, padding, row_max)
    rows = x if padding or not x.is_contiguous() \
        else x.reshape(1, -1, x.shape[-1])
    _check_rows(rows, padding)
    bsz, t, k_in = rows.shape
    codes = torch.empty((bsz, t + 2 * padding, k_in), dtype=torch.bfloat16,
                        device=x.device)
    s_row = torch.empty((bsz, t + 2 * padding), dtype=torch.float32,
                        device=x.device)
    build.check(build.library().tt_int8_quantize_rows(
        rows.data_ptr(), int(x.dtype == torch.float32), codes.data_ptr(),
        s_row.data_ptr(), bsz, t, k_in, padding, build.stream_ptr()),
        "tt_int8_quantize_rows")
    quantize_rows.launches += 1
    if padding:
        return codes, s_row
    return codes.view(x.shape), s_row.view(x.shape[:-1])


quantize_rows.launches = 0


def epilogue_plain(taps, s_row, scale, b=None, out_dtype=None):
    """E8's result by eager ops in its order: ``taps`` the k GEMM outputs
    over the (..., T + 2 padding) rows of ``s_row`` (flattened or not),
    ``s_row`` the row scales from Q8; returns (..., T, N)."""
    t = s_row.shape[-1] - len(taps) + 1
    out = None
    for j, acc in enumerate(taps):
        part = acc.reshape(*s_row.shape, -1)[..., j:j + t, :] \
            * s_row[..., j:j + t, None]
        out = part if out is None else out + part
    out = out * scale
    if out_dtype is not None:
        out = out.to(out_dtype)
    if b is not None:
        out = out + (b.to(out_dtype) if out_dtype else b)
    return out


def epilogue(taps, s_row, scale, b=None, out_dtype=None, reduce=None):
    """Step 3 on the sums of 1 or 3 taps over the (..., T + 2 padding)
    rows of ``s_row``, after ``reduce`` maps the stacked sums: kernel E8
    on CUDA sums without ``reduce`` (``_check_sums``' rules), else
    ``epilogue_plain``. Returns (..., T, N)."""
    if reduce is not None:
        taps = reduce(torch.stack(taps)).unbind(0)
    if not s_row.is_cuda or reduce is not None:
        return epilogue_plain(taps, s_row, scale, b, out_dtype)
    rows = s_row.reshape(1, -1) if len(taps) == 1 else s_row
    _check_sums(taps, rows, scale, b, out_dtype)
    bsz, tp = rows.shape
    t, n = tp - len(taps) + 1, taps[0].shape[-1]
    out = torch.empty((*s_row.shape, n) if len(taps) == 1 else (bsz, t, n),
                      dtype=out_dtype or torch.float32, device=s_row.device)
    ptrs = [acc.data_ptr() for acc in taps] + [None] * (3 - len(taps))
    bias_kind = 0 if b is None else 1 if b.dtype == torch.float32 else 2
    build.check(build.library().tt_int8_epilogue(
        *ptrs, rows.data_ptr(), scale.data_ptr(),
        None if b is None else b.data_ptr(), bias_kind, out.data_ptr(),
        int(out.dtype == torch.bfloat16), bsz, t, n, len(taps) // 2,
        build.stream_ptr()), "tt_int8_epilogue")
    epilogue.launches += 1
    return out


epilogue.launches = 0


def _check_pair(x, wq, padding):
    """Raise for a weight that is not int8 (..., taps K, N) on x's device,
    or a conv the product cannot run exactly; returns (taps, K)."""
    taps, k_in = 2 * padding + 1, x.shape[-1] if x.dim() else 0
    if padding and (x.dim() != 3 or k_in > EXACT_TAP_K):
        raise ValueError(f"int8_product: a conv takes x (B, T, K) with K up "
                         f"to {EXACT_TAP_K} (exact tap sums), got "
                         f"{tuple(x.shape)}")
    if wq.dtype != torch.int8 or wq.dim() < 2 \
            or wq.shape[-2] != taps * k_in or wq.device != x.device:
        raise ValueError(f"int8_product: an int8 ({taps} * {k_in}, N) weight "
                         f"on x's device, got {wq.dtype} {tuple(wq.shape)}")
    return taps, k_in


def _tap_sums(codes, wq, taps):
    """The GEMM of each tap's (K, N) slice of the weight over every row of
    the (zero-padded) codes: f32 exact integer sums."""
    if taps == 1:
        return [basic.mm_bf16(codes, wq)]
    return [basic.mm_bf16(codes, wj)
            for wj in wq.reshape(taps, -1, wq.shape[-1])]


def int8_product(x, w, b=None, out_dtype=None, padding=0, row_max=None,
                 reduce=None):
    """x (..., K) @ an int8 pair ``w`` = (w_int8 (k K, N), scale (N)) with
    per-row activation quantization, k = 2 padding + 1 taps over x's
    frames (a conv needs x (B, T, K)), then cast to ``out_dtype`` (None:
    f32) and ``b`` added. ``row_max`` maps the rows' absmax before the
    codes are taken and ``reduce`` the stacked tap sums before the
    scales apply (the module's docstring). Returns (..., N)."""
    wq, scale = w
    taps, _ = _check_pair(x, wq, padding)
    codes, s_row = quantize_rows(x, padding, row_max)
    return epilogue(_tap_sums(codes, wq, taps), s_row, scale, b, out_dtype,
                    reduce)


__all__ = ["epilogue", "epilogue_plain", "int8_product", "quantize_rows",
           "quantize_rows_plain"]
