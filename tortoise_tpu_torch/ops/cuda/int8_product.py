"""The int8 denoiser's product glue: kernels Q8 and E8 around the bf16
GEMM.

``int8_product(x, (w_int8, scale), b, out_dtype, padding)`` is the int8
activation product of ``ops.basic.pdot_int8act`` (``padding`` 0) and of
``ops.conv.conv1d_nwc``'s int8 branch (k = 2 * padding + 1 taps), with
the cast to ``out_dtype`` and the bias that ``models.diffusion._linear``
and ``conv1d_nwc`` add after it. It runs in three steps:

1. Q8 (``quantize_rows``): one pass over x (B, T, K), bf16 or f32,
   writes each row's scale ``s = max(absmax, 1e-12) / 127`` in f32 and
   its codes ``clamp(round(x / s), -127, 127)`` as bf16 (integers up to
   127 are exact there), into a zero-padded (B, T + 2 padding, K) buffer
   whose pad rows have scale 0: the eager chain's ``F.pad`` of both.
2. The GEMM of ``ops.basic.mm_bf16``, unchanged: one call per tap, over
   the flattened buffer with the tap's (K, N) slice of the weight.
3. E8 (``epilogue``): one pass over the taps' f32 sums writes
   ``((acc_0 s + acc_1 s') + acc_2 s'') * scale`` (tap j read j rows
   further down the padded buffer), cast to ``out_dtype`` (None keeps
   f32), plus the bias in that dtype.

Every step is the eager chain's arithmetic in its order and rounding, so
the product has its bits: the GEMM of a k1 product is the eager call
itself (the codes' shape, layout and dtype), and a tap's sums are exact
integers in any order up to K = 1040 (K * 127^2 < 2^24), which bounds
the K of a conv. The JAX package leaves this glue to XLA, which fuses
it; it ports no Pallas kernel.

The route (``takes_kernels``): a CUDA tensor with no tensor-parallel
hooks (``row_max``, ``reduce``) takes the kernels; the CPU, and a rank
whose cross-rank max and all-reduce sit between the passes, keep the
eager chain. On the CPU ``quantize_rows`` and ``epilogue`` run their
plain models (``quantize_rows_plain``, ``epilogue_plain``), so
``int8_product`` there is the kernels' route step for step; the tests
hold it to the eager chain bit for bit. Both devices check the
arguments alike and raise for what the kernels do not take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops import basic
from tortoise_tpu_torch.ops.cuda import build

MAX_ROW_BYTES = 32 * 16 * 16  # Q8: a warp's 32 lanes hold 16 vectors each
EXACT_TAP_K = 1040  # the largest K whose int8 x int8 sums stay below 2^24
_DTYPES = (torch.bfloat16, torch.float32)


def takes_kernels(x, row_max=None, reduce=None) -> bool:
    """True when an int8 product of x runs kernels Q8 and E8: x on a
    card and no tensor-parallel hooks between the passes."""
    return x.is_cuda and row_max is None and reduce is None


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
    """Raise for what E8 does not take: 1 or 3 contiguous f32 (B (T + 2
    padding), N) sums, N a multiple of 4, s_row (B, T + 2 padding) f32,
    a contiguous f32 scale of N values, a contiguous bf16 or f32 (N,)
    bias or None, out_dtype bf16, f32 or None."""
    bsz, tp = s_row.shape
    n = taps[0].shape[-1]
    if len(taps) not in (1, 3) or n % 4 or any(
            a.dtype != torch.float32 or not a.is_contiguous()
            or tuple(a.shape) != (bsz * tp, n) or a.device != s_row.device
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


def quantize_rows_plain(x, padding=0):
    """Q8's result by the eager chain (``ops.basic.quantize_rows``): codes
    (B, T + 2 padding, K) bf16 and row scales (B, T + 2 padding) f32, the
    pad rows zero."""
    xq, s_row = basic.quantize_rows(x)
    if padding:
        pad = (0, 0, padding, padding)
        xq, s_row = F.pad(xq, pad), F.pad(s_row, pad)
    return xq.to(torch.bfloat16), s_row[..., 0]


def quantize_rows(x, padding=0):
    """Kernel Q8 on x (B, T, K) (``_check_rows``' rules);
    ``quantize_rows_plain`` on the CPU."""
    _check_rows(x, padding)
    if not x.is_cuda:
        return quantize_rows_plain(x, padding)
    bsz, t, k_in = x.shape
    codes = torch.empty((bsz, t + 2 * padding, k_in), dtype=torch.bfloat16,
                        device=x.device)
    s_row = torch.empty((bsz, t + 2 * padding), dtype=torch.float32,
                        device=x.device)
    build.check(build.library().tt_int8_quantize_rows(
        x.data_ptr(), int(x.dtype == torch.float32), codes.data_ptr(),
        s_row.data_ptr(), bsz, t, k_in, padding, build.stream_ptr()),
        "tt_int8_quantize_rows")
    quantize_rows.launches += 1
    return codes, s_row


quantize_rows.launches = 0


def epilogue_plain(taps, s_row, scale, b=None, out_dtype=None):
    """E8's result by eager ops in the eager chain's order: ``taps`` the
    k GEMM outputs over the flattened (B, T + 2 padding) rows, ``s_row``
    (B, T + 2 padding) from Q8; returns (B, T, N)."""
    bsz, tp = s_row.shape
    t = tp - len(taps) + 1
    out = None
    for j, acc in enumerate(taps):
        part = acc.reshape(bsz, tp, -1)[:, j:j + t] * s_row[:, j:j + t, None]
        out = part if out is None else out + part
    out = out * scale.reshape(-1)
    if out_dtype is not None:
        out = out.to(out_dtype)
    if b is not None:
        out = out + (b.to(out_dtype) if out_dtype else b)
    return out


def epilogue(taps, s_row, scale, b=None, out_dtype=None):
    """Kernel E8 (``epilogue_plain`` on the CPU) on the sums of 1 or 3
    taps over Q8's (B, T + 2 padding) rows (``_check_sums``' rules)."""
    _check_sums(taps, s_row, scale, b, out_dtype)
    if not s_row.is_cuda:
        return epilogue_plain(taps, s_row, scale, b, out_dtype)
    bsz, tp = s_row.shape
    t, n = tp - len(taps) + 1, taps[0].shape[-1]
    out = torch.empty((bsz, t, n), dtype=out_dtype or torch.float32,
                      device=s_row.device)
    ptrs = [acc.data_ptr() for acc in taps] + [None] * (3 - len(taps))
    bias_kind = 0 if b is None else 1 if b.dtype == torch.float32 else 2
    build.check(build.library().tt_int8_epilogue(
        *ptrs, s_row.data_ptr(), scale.data_ptr(),
        None if b is None else b.data_ptr(), bias_kind, out.data_ptr(),
        int(out.dtype == torch.bfloat16), bsz, t, n, len(taps) // 2,
        build.stream_ptr()), "tt_int8_epilogue")
    epilogue.launches += 1
    return out


epilogue.launches = 0


def int8_product(x, w, b=None, out_dtype=None, padding=0):
    """x (..., K) @ an int8 pair ``w`` = (w_int8 (k K, N), scale (N)) with
    per-row activation quantization, k = 2 padding + 1 taps over x's
    frames (a conv needs x (B, T, K)), then cast to ``out_dtype`` (None:
    f32) and ``b`` added: Q8, the bf16 GEMM per tap, E8 (their plain
    models on the CPU). Returns (..., N)."""
    wq, scale = w
    taps, k_in = 2 * padding + 1, x.shape[-1] if x.dim() else 0
    if not x.is_contiguous() or x.dim() < 1:
        raise ValueError(f"int8_product: a contiguous x, got {tuple(x.shape)}"
                         f" (strides {x.stride()})")
    if padding == 1 and k_in > EXACT_TAP_K:
        raise ValueError(f"int8_product: a conv's tap sums are exact only up "
                         f"to K = {EXACT_TAP_K}, not {k_in}")
    if wq.dtype != torch.int8 or wq.dim() != 2 \
            or wq.shape[0] != taps * k_in or wq.device != x.device:
        raise ValueError(f"int8_product: an int8 ({taps} * {k_in}, N) weight "
                         f"on x's device, got {wq.dtype} {tuple(wq.shape)}")
    n = wq.shape[1]
    x3 = x if padding else x.reshape(1, -1, k_in)
    codes, s_row = quantize_rows(x3, padding)
    flat = codes.reshape(-1, k_in)
    sums = [basic.mm_bf16(flat, wj) for wj in wq.reshape(taps, k_in, n)]
    out = epilogue(sums, s_row, scale, b, out_dtype)
    return out.reshape(*x.shape[:-1], n)


__all__ = ["epilogue", "epilogue_plain", "int8_product", "quantize_rows",
           "quantize_rows_plain", "takes_kernels"]
