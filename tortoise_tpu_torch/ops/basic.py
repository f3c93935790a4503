"""Matmul, normalization and activation primitives (counterpart of
``tortoise_tpu/ops/basic.py``).

Dtype contract, as in the JAX package: with ``compute_dtype`` (e.g.
``torch.bfloat16``) the operands are rounded to that dtype and the
product accumulates in float32; with ``compute_dtype=None`` everything is
float32 (on a GPU the caller turns TF32 off for this to be true f32).
Every product of two bf16 (or int8) values is exact in float32, so a
bf16 product is the same function whether it runs as a bf16 matmul with
f32 sums and output (on a card, on the tensor cores) or as a float32
matmul of the rounded operands (on the CPU). Norms compute in float32
and cast back to the input dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mm_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., K) @ w for operands exact in bf16 (bf16 values, int8
    weights, integer-valued int8 activations): f32 sums and output. A
    2-D weight on a card runs as a bf16 tensor-core matmul with f32
    output; otherwise as a float32 matmul of the same values. For int8 x
    int8 operands the f32 sums stay exact below 2^24, which K*127*127
    guarantees up to K = 1040: the JAX package's int32 sums."""
    if x.is_cuda and w.dim() == 2:
        k, n = w.shape
        out = torch.mm(x.reshape(-1, k).to(torch.bfloat16),
                       w.to(torch.bfloat16), out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], n)
    return torch.matmul(x.float(), w.float())


def _mm(x: torch.Tensor, w: torch.Tensor, cd) -> torch.Tensor:
    if cd == torch.bfloat16:
        return mm_bf16(x.to(cd), w.to(cd))
    if cd is not None:
        x, w = x.to(cd), w.to(cd)
    return torch.matmul(x.float(), w.float())


def pdot(x: torch.Tensor, w, compute_dtype=None, out_dtype=None):
    """``x @ w`` with the JAX package's dtype control. ``w`` may be an
    int8 weight-only pair ``(w_int8, scale)`` from ``quantize_cols``
    ((..., in, out) orientation, per-output-column scale applied to the
    f32 accumulator)."""
    if isinstance(w, tuple):
        wq, scale = w
        out = _mm(x, wq, compute_dtype) * scale
        if compute_dtype is None:
            return out
        return out.to(out_dtype) if out_dtype is not None else out
    out = _mm(x, w, compute_dtype)
    if compute_dtype is None or out_dtype is None:
        return out
    return out.to(out_dtype)


def quantize_rows(x: torch.Tensor, row_max=None):
    """Symmetric per-row int8 quantization of activations: returns
    (xq as float32 integers in [-127, 127], row scale (..., 1)).
    ``row_max`` maps the rows' absmax to the one to quantize by: under
    tensor parallelism x holds a slice of each row's channels and
    ``row_max`` takes the MAX over the ranks, so every rank quantizes on
    the grid of the whole row."""
    absmax = x.abs().amax(dim=-1, keepdim=True)
    if row_max is not None:
        absmax = row_max(absmax)
    s_row = absmax.float().clamp_min(1e-12)
    s_row = s_row / torch.full_like(s_row, 127.0)  # see quantize_cols
    xq = torch.clamp(torch.round(x.float() / s_row), -127, 127)
    return xq, s_row


def pdot_int8act(x: torch.Tensor, w, row_max=None,
                 reduce=None) -> torch.Tensor:
    """int8 x int8 product with dynamic per-row activation quantization
    (``w`` a ``(w_int8, scale)`` pair; ``row_max`` as in
    ``quantize_rows``). ``reduce`` maps the exact integer sums before
    the scales apply: under tensor parallelism the all-reduce of the
    ranks' partial sums, which keeps the product the single rank's bit
    for bit. Returns float32: ``ops.cuda.int8_product``, kernels Q8 and
    E8 on a card without the hooks."""
    from tortoise_tpu_torch.ops.cuda.int8_product import int8_product

    return int8_product(x, w, row_max=row_max, reduce=reduce)


def quantize_cols(w: torch.Tensor):
    """Symmetric per-output-column int8 quantization of a weight in the
    ``x @ w`` orientation ((..., in, out)), on the weight's device;
    returns (w_int8, scale (..., 1, out) f32), both contiguous. The same
    f32 math and round-half-even as the JAX package's quantize_cols_host,
    so both give identical pairs."""
    wf = w.float()
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    # a tensor divisor: on a card, a Python-scalar divisor becomes a
    # multiply by its reciprocal, which rounds differently
    scale = absmax.clamp_min(1e-12) / torch.full_like(absmax, 127.0)
    wq = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return wq.contiguous(), scale.contiguous()


def quantize_cols_host(w):
    """``quantize_cols`` for a host (numpy) weight, on the CPU: numpy
    pairs, identical to the JAX package's quantize_cols_host (the same
    f32 math and round-half-even)."""
    wq, scale = quantize_cols(torch.from_numpy(w))
    return wq.numpy(), scale.numpy()


def layer_norm(x: torch.Tensor, w=None, b=None, eps: float = 1e-5):
    """Population-variance LN over the last axis; w=b=None is the
    reference's bare second norm."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out.to(x.dtype)


def group_norm_tc(x: torch.Tensor, n_groups: int, w=None, b=None,
                  eps: float = 1e-5, mask=None, fast: bool = False):
    """GroupNorm over time-major (..., T, C) maps, statistics per group of
    C/n_groups channels over (T, group channels). ``mask`` (..., T) bool
    restricts the statistics to valid frames and zeroes the rest.
    ``fast``: one-pass E[x^2] - mean^2 statistics (the bf16 plane's
    form); otherwise the exact centered two-pass form."""
    *lead, t, c = x.shape
    cg = c // n_groups
    xf = x.float()
    if fast:
        if mask is not None:
            m = mask.expand(*lead, t)
            xf = torch.where(m[..., None], xf, 0.0)
            n = m.sum(dim=-1).clamp_min(1).float()[..., None] * cg
        else:
            n = float(t * cg)
        s1 = xf.sum(dim=-2)
        s2 = xf.square().sum(dim=-2)
        g1 = s1.reshape(*lead, n_groups, cg).sum(dim=-1)
        g2 = s2.reshape(*lead, n_groups, cg).sum(dim=-1)
        mean = g1 / n
        var = (g2 / n - mean.square()).clamp_min(0.0)
        inv = torch.rsqrt(var + eps)
        inv_c = inv.repeat_interleave(cg, dim=-1)
        mean_c = mean.repeat_interleave(cg, dim=-1)
        scale = inv_c if w is None else inv_c * w
        shift = -mean_c * scale
        if b is not None:
            shift = shift + b
        out = xf * scale[..., None, :] + shift[..., None, :]
    else:
        xg = xf.reshape(*lead, t, n_groups, cg)
        if mask is None:
            mean = xg.mean(dim=(-3, -1), keepdim=True)
            var = (xg - mean).square().mean(dim=(-3, -1), keepdim=True)
            out = (xg - mean) * torch.rsqrt(var + eps)
        else:
            m = mask.expand(*lead, t).reshape(*lead, t, 1, 1)
            xg = torch.where(m, xg, 0.0)
            n = m.sum(dim=(-3, -1), keepdim=True).clamp_min(1).float() * cg
            mean = xg.sum(dim=(-3, -1), keepdim=True) / n
            d = torch.where(m, xg - mean, 0.0)
            var = (d * d).sum(dim=(-3, -1), keepdim=True) / n
            out = d * torch.rsqrt(var + eps)
        out = out.reshape(*lead, t, c)
        if w is not None:
            out = out * w
        if b is not None:
            out = out + b
    if mask is not None:
        out = torch.where(mask.expand(*lead, t)[..., None], out, 0.0)
    return out.to(x.dtype)


def group_norm(x: torch.Tensor, n_groups: int, w=None, b=None,
               eps: float = 1e-5, mask=None):
    """GroupNorm over channel-major (..., C, T) maps: the JAX package's
    ``group_norm``, as ``group_norm_tc`` on the transposed map. ``mask``
    (broadcastable to (..., 1, T), bool) restricts the statistics to
    valid frames and zeroes the rest; ``w`` and ``b`` are (..., C)."""
    *lead, c, t = x.shape
    if mask is not None:
        mask = torch.as_tensor(mask, device=x.device).expand(
            *lead, 1, t)[..., 0, :]
    out = group_norm_tc(x.transpose(-1, -2), n_groups,
                        None if w is None else w.unsqueeze(-2),
                        None if b is None else b.unsqueeze(-2), eps, mask)
    return out.transpose(-1, -2)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


def leaky_relu(x, negative_slope: float = 0.2):
    return F.leaky_relu(x, negative_slope)


def conv1d_tm(x, w, b, compute_dtype=None, groups: int = 1):
    """Conv1d over a time-major (B, T, C) map, "same" zero padding, in
    ``compute_dtype`` (f32 without it): torch's layout (C_out, C_in /
    groups, k) for ``w``; returns (B, T, C_out)."""
    dt = compute_dtype or torch.float32
    y = F.conv1d(x.to(dt).transpose(1, 2), w.to(dt), b.to(dt),
                 padding=w.shape[-1] // 2, groups=groups)
    return y.transpose(1, 2)


def zero_frames(x, mask):
    """x with the frames outside a (B or 1, T, 1) bool ``mask`` set to 0
    (x itself without a mask)."""
    return x if mask is None else torch.where(mask, x, 0.0)
