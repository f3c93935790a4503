"""Kernel F: packed-qkv attention with int8 scores and int8 P@V.

``flash_packed_i8`` replaces ``scripts/ubench_attn_int8_ab.py::
flash_packed_i8``, the int8-score variant of kernel B that the JAX
package's A/B holds against ``flash_attention_packed`` at the denoiser's
shape. Over the per-head-interleaved qkv (c = h*3D + part*D + d), with T
padded to a multiple of 128 rows (padded keys masked):

- K and V scales, one per (batch row, head) over all padded rows:
  ``sk = max(max|k| / 127, 1e-20)``, ``sv`` the same; ``ki = round(k /
  sk)`` and ``vi = round(v / sv)`` as int8, half to even.
- The Q scale, one per (batch row, head, 128-row query block): the block
  height is part of the function.
- ``s = (q8 . ki as int32) * sq * sk * D^-1/2 + bias[h, j - i] + mask``,
  the bias the T5 bucket bias of kernel B (x8);
- ``p = exp(s - max s)``, ``l = sum p`` in f32 from the unquantized p;
- ``out = (round(127 p) . vi as int32) * sv / 127 / l``, in qkv's dtype.

The natural-exp domain: the Pallas kernel's log2(e) folding is a TPU
workaround. On a card the wrapper launches two kernels of
``csrc/flash_attention_int8.cu`` (head widths 32, 64 and 128, bf16 or
f32 qkv): ``quantize_kv``, the K/V quantize pass (one 8-block cluster a
(batch row, head, part); its own launch counter), then the attention
kernel (``flash_packed_i8.launches``; wgmma + TMA, the keys walked twice).
Nothing is staged per length, so Tp is bounded only by exact int32 sums
(``MAX_TP``). A CPU tensor takes ``flash_packed_i8_plain``, the kernel's
reference; a CUDA tensor launches both kernels or raises.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops.cuda import build
from tortoise_tpu_torch.ops.cuda.flash_attention import (
    NEG_INF,
    _merge,
    _split_packed,
    _toeplitz_full,
    relpos_bias_vector,
)

BQ = 128  # query rows a Q scale covers; T pads to a multiple of it
I8_WIDTHS = (32, 64, 128)  # head widths the kernels take
BIAS_SCALE = 8.0  # the T5 table's scale, as in the JAX A/B


def padded_length(t: int) -> int:
    return -(-t // BQ) * BQ


# the longest Tp whose context sums round(127 p) . vi stay exact in int32:
# Tp * 127^2 < 2^31 (``kMaxTp`` in the .cu)
MAX_TP = BQ * ((2 ** 31 - 1) // (127 * 127) // BQ)


INV127 = 1.0 / 127  # XLA compiles the Pallas kernel's "/ 127.0" as a
# multiply by f32(1 / 127); so do the plain version and the kernel


def _scale(x: torch.Tensor, dims) -> torch.Tensor:
    """max(max|x| over dims / 127, 1e-20)."""
    return torch.clamp_min(x.abs().amax(dim=dims) * INV127, 1e-20)


def _quant(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """round(x / s) half to even, saturated to int8."""
    return torch.round(x / s).clamp(-128, 127).to(torch.int8)


def quantize_kv_plain(k: torch.Tensor, v: torch.Tensor):
    """K and V of (B, H, Tp, D) f32 -> (ki, vi) int8 (B, H, Tp, D) and
    their scales (sk, sv), (B, H), one per (batch row, head)."""
    sk, sv = _scale(k, (2, 3)), _scale(v, (2, 3))
    return (_quant(k, sk[..., None, None]), _quant(v, sv[..., None, None]),
            sk, sv)


def quantize_q_plain(q: torch.Tensor):
    """Q of (B, H, Tp, D) f32, Tp a multiple of 128 -> q8 int8 (B, H, Tp,
    D) and its scales (B, H, Tp / 128), one per 128-row query block."""
    b, h, tp, d = q.shape
    blocks = q.reshape(b, h, tp // BQ, BQ, d)
    sq = _scale(blocks, (3, 4))
    return _quant(blocks, sq[..., None, None]).reshape(b, h, tp, d), sq


def _exact_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of int8 tensors as int32 sums, exactly: f64 holds every
    partial sum (under 2^31) without rounding, on either device."""
    return torch.matmul(a.double(), b.double())


def flash_packed_i8_plain(qkv: torch.Tensor, n_head: int,
                          kv_valid: torch.Tensor, bias_table: torch.Tensor,
                          bias_max_distance: int = 64) -> torch.Tensor:
    """Plain PyTorch twin of kernel F (same arguments and output)."""
    t, c3 = qkv.shape[1:]
    d = c3 // (3 * n_head)
    tp = padded_length(t)
    mask, bias = i8_side_inputs(qkv, n_head, kv_valid, bias_table,
                                bias_max_distance)
    q, k, v = _split_packed(F.pad(qkv.float(), (0, 0, 0, tp - t)), n_head)
    ki, vi, sk, sv = quantize_kv_plain(k, v)
    q8, sq = quantize_q_plain(q)
    sc = sq.repeat_interleave(BQ, dim=2) * sk[..., None] * (float(d) ** -0.5)
    s = (_exact_product(q8, ki.transpose(-1, -2)).float() * sc[..., None]
         + _toeplitz_full(bias[:, 1:], tp, tp)[None]
         + mask[:, None, None, :])
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    ctx = _exact_product(torch.round(p * 127.0), vi).float()
    ctx = ctx * (sv * INV127)[..., None, None] / l.clamp_min(1e-30)
    return _merge(ctx[:, :, :t]).to(qkv.dtype)


def _check(qkv: torch.Tensor, n_head: int, kv_valid) -> None:
    if kv_valid is None:
        raise ValueError("kernel F takes a key mask (kv_valid (B, T) bool), "
                         "as the JAX wrapper does")
    if qkv.dim() != 3 or qkv.shape[-1] % (3 * n_head):
        raise ValueError(f"qkv {tuple(qkv.shape)} does not split into 3 x "
                         f"{n_head} heads")
    if tuple(kv_valid.shape) != tuple(qkv.shape[:2]):
        raise ValueError(f"kv_valid {tuple(kv_valid.shape)} is not (B, T) = "
                         f"{tuple(qkv.shape[:2])}")
    d = qkv.shape[-1] // (3 * n_head)
    if d not in I8_WIDTHS:
        raise ValueError(f"kernel F takes head width {I8_WIDTHS}, got {d}")


def i8_side_inputs(qkv: torch.Tensor, n_head: int, kv_valid: torch.Tensor,
                   bias_table: torch.Tensor, bias_max_distance: int = 64):
    """(mask, bias) as the card kernels read them: the (B, Tp) f32 additive
    key mask (padded keys -1e30) and the (H, 2 Tp) f32 Toeplitz bias,
    bias[h, (j - i) + Tp] (column 0 a zero pad, so the 192-delta window
    of every (128-row block, 64-key tile) starts 16-byte aligned for the
    kernel's bulk copies). Neither depends on qkv's values, so a caller
    that runs many calls on one mask and table builds them once
    (``launch_i8``)."""
    t = qkv.shape[1]
    tp = padded_length(t)
    valid = F.pad(kv_valid.to(device=qkv.device, dtype=torch.bool),
                  (0, tp - t))
    mask = torch.where(valid, 0.0, NEG_INF).to(torch.float32).contiguous()
    bias = F.pad(relpos_bias_vector(bias_table.to(qkv.device), tp,
                                    BIAS_SCALE, bias_max_distance), (1, 0))
    if tuple(bias.shape) != (n_head, 2 * tp):
        raise ValueError(f"bias_table has {bias.shape[0]} heads, want "
                         f"{n_head}")
    return mask, bias


def quantize_kv(qkv: torch.Tensor, n_head: int):
    """Kernel F's quantize pass on the card: (ki (B, H, Tp, D), vi
    transposed (B, H, D, Tp) with keys permuted in 32-key chunks, int8;
    scales (B, H, 2) f32). One launch (an 8-block cluster a (b, h, part)),
    counted apart from the attention kernel."""
    b, t, c3 = qkv.shape
    d = c3 // (3 * n_head)
    tp = padded_length(t)
    dev = qkv.device
    ki = torch.empty((b, n_head, tp, d), dtype=torch.int8, device=dev)
    vit = torch.empty((b, n_head, d, tp), dtype=torch.int8, device=dev)
    scales = torch.empty((b, n_head, 2), dtype=torch.float32, device=dev)
    build.check(build.library().tt_int8_quantize_kv(
        qkv.data_ptr(), int(qkv.dtype == torch.float32), b, t, tp, n_head, d,
        ki.data_ptr(), vit.data_ptr(), scales.data_ptr(),
        build.stream_ptr()), "tt_int8_quantize_kv")
    quantize_kv.launches += 1
    return ki, vit, scales


quantize_kv.launches = 0


def _card_qkv(qkv: torch.Tensor) -> torch.Tensor:
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"kernel F takes a bfloat16 or float32 qkv, got "
                         f"{qkv.dtype}")
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:  # the kernels read 16-byte chunks of a row
        qkv = qkv.clone()
    return qkv


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous and 16-byte aligned (the kernel bulk-copies it)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def launch_i8(qkv: torch.Tensor, n_head: int, mask: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """Kernel F on the card with the side inputs of ``i8_side_inputs``:
    the quantize pass, then the attention kernel. Returns (B, T, H*D) in
    qkv's dtype."""
    b, t, c3 = qkv.shape
    tp = padded_length(t)
    if tp > MAX_TP:
        raise ValueError(f"kernel F sums {tp} padded keys of round(127 p) "
                         f". vi in int32, exact only up to {MAX_TP} keys")
    d = c3 // (3 * n_head)
    if d not in I8_WIDTHS:
        raise ValueError(f"kernel F takes head width {I8_WIDTHS}, got {d}")
    if tuple(mask.shape) != (b, tp) or mask.dtype != torch.float32 or \
            tuple(bias.shape) != (n_head, 2 * tp) or \
            bias.dtype != torch.float32:
        raise ValueError("mask and bias must be i8_side_inputs' f32 (B, Tp) "
                         "and (H, 2 Tp)")
    qkv = _card_qkv(qkv)
    mask, bias = _aligned(mask), _aligned(bias)
    return attend_i8(qkv, n_head, quantize_kv(qkv, n_head), mask, bias)


def attend_i8(qkv: torch.Tensor, n_head: int, kv, mask: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """Kernel F's attention kernel alone, on the quantize pass's ``kv`` =
    (ki, vit, scales) and ``launch_i8``'s checked, aligned qkv and side
    inputs (``chip_smoke.py`` times it apart from the quantize pass).
    Counted in ``flash_packed_i8.launches``."""
    b, t, c3 = qkv.shape
    d = c3 // (3 * n_head)
    ki, vit, scales = kv
    out = torch.empty((b, t, n_head * d), dtype=qkv.dtype, device=qkv.device)
    build.check(build.library().tt_flash_packed_i8(
        qkv.data_ptr(), int(qkv.dtype == torch.float32), ki.data_ptr(),
        vit.data_ptr(), scales.data_ptr(), bias.data_ptr(), mask.data_ptr(),
        b, t, padded_length(t), n_head, d, float(d) ** -0.5, out.data_ptr(),
        build.stream_ptr()), "tt_flash_packed_i8")
    flash_packed_i8.launches += 1
    return out


def flash_packed_i8(qkv: torch.Tensor, n_head: int,
                    kv_valid: Optional[torch.Tensor],
                    bias_table: torch.Tensor,
                    bias_max_distance: int = 64) -> torch.Tensor:
    """Kernel F. qkv (B, T, 3*H*D) per-head interleaved, bf16 or f32;
    kv_valid (B, T) bool, required; bias_table (NB, H), scaled by 8 with
    T5 buckets up to ``bias_max_distance``. Returns (B, T, H*D) in qkv's
    dtype. Head widths 32, 64 and 128 on the card."""
    _check(qkv, n_head, kv_valid)
    if not qkv.is_cuda:
        return flash_packed_i8_plain(qkv, n_head, kv_valid, bias_table,
                                     bias_max_distance)
    mask, bias = i8_side_inputs(qkv, n_head, kv_valid, bias_table,
                                bias_max_distance)
    return launch_i8(qkv, n_head, mask, bias)


flash_packed_i8.launches = 0

__all__ = ["flash_packed_i8", "flash_packed_i8_plain", "quantize_kv",
           "quantize_kv_plain", "quantize_q_plain", "launch_i8", "attend_i8",
           "i8_side_inputs"]
