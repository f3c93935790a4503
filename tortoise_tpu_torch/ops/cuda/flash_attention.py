"""Exact-softmax attention: kernels B, C, D1 and D2.

B ``flash_attention_packed`` replaces
``tortoise_tpu/ops/pallas/flash_attention.py::flash_attention_packed``:
non-causal attention over the denoiser's per-head-interleaved qkv
(c = h*3D + part*D + d) with the T5 rel-pos bias (x8) and a key mask.

C ``flash_attention_causal_qkv`` replaces
``tortoise_tpu/ops/pallas/flash_attention.py::flash_attention_causal_qkv``:
causal attention with key validity over the AR trunk's part-major qkv
(c = part*H*D + h*D + d).

Both return the merged context (B, T, H*D) in qkv's dtype. Their CUDA
kernel (``csrc/flash_attention.cu``) is built for head width 64; at the
other widths the JAX package routes to them (16, 32, 128) they hand
strided views of the same qkv to kernel D.

D ``flash_attention`` replaces
``tortoise_tpu/ops/pallas/flash_attention.py::flash_attention`` over
(B, H, T, D) q, k, v, with both of its bodies: D1, the grouped band-bias
body (``bias_formula``, non-causal, equal query and key lengths; output
in q's dtype), and D2, the generic body (no bias, a materialized
(H, Tq, Tkv) bias, ``bias_buckets`` + table, or the formula bias when
causal or ragged; optional causal flag; output f32). Its CUDA kernel
(``csrc/flash_attention_bhtd.cu``) reads q, k, v and writes the output
through (b, h, t) strides, so views of a fused qkv need no copy, and
takes head width 16, 32, 64 or 128.

The kernels walk the keys in shared-memory tiles with an online softmax,
so the (T, T) scores never reach device memory; they are bound by the
~4*T*T*D multiply-adds per (batch, head), which run on the tensor cores
(``mma.sync`` bf16, f32 sums) for bf16 inputs.

Each wrapper dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version below, a CUDA tensor launches the kernel (and
counts the launch) or raises. The plain versions compute in f32 from
the inputs, round the softmax weights to v's dtype before the P@V
product like the Pallas kernels, and are the kernels' reference. A bias
that depends only on j - i travels as a per-head Toeplitz vector
(H, Tq + Tkv - 1) with element (j - i) + Tq - 1.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from tortoise_tpu_torch.ops.cuda import build
from tortoise_tpu_torch.ops.relpos import bucket_of_delta

NEG_INF = -1e30
HEAD_WIDTHS = (16, 32, 64, 128)  # kernel D's templates


def _additive_mask(kv_valid: Optional[torch.Tensor]):
    if kv_valid is None:
        return None
    return torch.where(kv_valid, 0.0, NEG_INF).to(torch.float32)


@functools.lru_cache(maxsize=16)
def _toeplitz_ids(tq: int, tkv: int, n_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    # built once per length and device: a pageable host-to-device copy
    # would stall the stream on every attention call
    import numpy as np

    return torch.as_tensor(bucket_of_delta(np.arange(-(tq - 1), tkv),
                                           n_buckets, max_distance),
                           device=device)


def relpos_bias_vector(bias_table: torch.Tensor, t: int,
                       scale: float = 8.0, max_distance: int = 64,
                       t_kv: Optional[int] = None) -> torch.Tensor:
    """(NB, H) bucket table -> (H, t + t_kv - 1) f32 Toeplitz bias vector
    with element (j - i) + t - 1 = scale * table[bucket(j - i), h]
    (t_kv defaults to t). Buckets saturate past max_distance, so this is
    the exact bias the Pallas kernels assemble from their band tiles and
    far-field constants."""
    ids = _toeplitz_ids(t, t if t_kv is None else t_kv, bias_table.shape[0],
                        max_distance, bias_table.device)
    return (bias_table.to(torch.float32)[ids] * scale).T.contiguous()


def _bucket_strip_vector(bias_buckets, bias_table, scale):
    """(Tq, Tkv) Toeplitz bucket ids + (NB, H) table -> the (H, Tq+Tkv-1)
    vector, read along the first column and row like the Pallas wrapper's
    strip."""
    strip = torch.cat([bias_buckets[:, 0].flip(0), bias_buckets[0, 1:]])
    return (bias_table.to(torch.float32)[strip.long()] * scale).T.contiguous()


def _toeplitz_full(bias_vec, tq, tkv):
    """(H, Tq+Tkv-1) vector -> the (H, Tq, Tkv) bias it stands for."""
    dev = bias_vec.device
    idx = (torch.arange(tkv, device=dev)[None, :]
           - torch.arange(tq, device=dev)[:, None] + tq - 1)
    return bias_vec[:, idx]


def _split_packed(qkv: torch.Tensor, n_head: int):
    b, t, c3 = qkv.shape
    d = c3 // (3 * n_head)
    x = qkv.reshape(b, t, n_head, 3, d).permute(3, 0, 2, 1, 4)
    return x[0], x[1], x[2]  # (B, H, T, D) views


def _split_part_major(qkv: torch.Tensor, n_head: int):
    b, t, c3 = qkv.shape
    d = c3 // (3 * n_head)
    x = qkv.reshape(b, t, 3, n_head, d).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def _merge(ctx):
    b, h, t, d = ctx.shape
    return ctx.transpose(1, 2).reshape(b, t, h * d)


def _attend(q, k, v, add, scale, out_dtype):
    """softmax(q k^T * scale + add) v in f32 over (B, H, T, D); add
    broadcasts to (B, H, Tq, Tkv). Softmax weights rounded to v's dtype
    before P@V."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + add
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(p.to(v.dtype).float(), v.float())
    return (ctx / l.clamp_min(1e-30)).to(out_dtype)


def _causal_add(tq, tkv, device):
    i = torch.arange(tq, device=device)[:, None]
    j = torch.arange(tkv, device=device)[None, :]
    return torch.where(j <= i, 0.0, NEG_INF).to(torch.float32)


def flash_attention_packed_plain(qkv, n_head, kv_valid=None,
                                 bias_vec=None) -> torch.Tensor:
    """Plain PyTorch twin of kernel B. bias_vec: (H, 2T-1) f32."""
    q, k, v = _split_packed(qkv, n_head)
    t = qkv.shape[1]
    add = torch.zeros((), dtype=torch.float32, device=qkv.device)
    if bias_vec is not None:
        add = add + _toeplitz_full(bias_vec, t, t)[None]     # (1, H, T, T)
    mask = _additive_mask(kv_valid)
    if mask is not None:
        add = add + mask[:, None, None, :]
    d = q.shape[-1]
    return _merge(_attend(q, k, v, add, float(d) ** -0.5, qkv.dtype))


def flash_attention_causal_qkv_plain(qkv, n_head, kv_valid=None
                                     ) -> torch.Tensor:
    """Plain PyTorch twin of kernel C."""
    q, k, v = _split_part_major(qkv, n_head)
    t = qkv.shape[1]
    add = _causal_add(t, t, qkv.device)[None, None]
    mask = _additive_mask(kv_valid)
    if mask is not None:
        add = add + mask[:, None, None, :]
    d = q.shape[-1]
    return _merge(_attend(q, k, v, add, float(d) ** -0.5, qkv.dtype))


def _check_cuda_qkv(qkv, n_head):
    if qkv.dtype != torch.bfloat16 or qkv.dim() != 3:
        raise ValueError(f"kernel wants a (B, T, 3HD) bfloat16 qkv, got "
                         f"{tuple(qkv.shape)} {qkv.dtype}")
    d = qkv.shape[-1] // (3 * n_head)
    if 3 * n_head * d != qkv.shape[-1]:
        raise ValueError(f"{qkv.shape[-1]} qkv channels do not split over "
                         f"{n_head} heads")
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:  # the kernels read 16-byte K/V chunks
        qkv = qkv.clone()
    return qkv, d


def _device_mask(kv_valid, b, t, device):
    mask = _additive_mask(kv_valid)
    if mask is not None:
        mask = mask.to(device).expand(b, t).contiguous()
    return mask


def flash_attention_packed(qkv: torch.Tensor, n_head: int,
                           kv_valid: Optional[torch.Tensor] = None,
                           bias_table: Optional[torch.Tensor] = None,
                           bias_scale: float = 8.0,
                           bias_max_distance: int = 64,
                           bias_vec: Optional[torch.Tensor] = None,
                           ) -> torch.Tensor:
    """Kernel B. qkv (B, T, 3*H*D) per-head interleaved; kv_valid (B, T)
    bool or None; the bias from a (NB, H) bucket table or a prebuilt
    (H, 2T-1) ``bias_vec``. Returns (B, T, H*D) in qkv's dtype. On a card
    a head width other than 64 runs kernel D1 on strided views."""
    t = qkv.shape[1]
    if bias_vec is None and bias_table is not None:
        bias_vec = relpos_bias_vector(bias_table, t, bias_scale,
                                      bias_max_distance)
    if not qkv.is_cuda:
        return flash_attention_packed_plain(qkv, n_head, kv_valid, bias_vec)
    qkv, d = _check_cuda_qkv(qkv, n_head)
    b = qkv.shape[0]
    out = torch.empty((b, t, n_head * d), dtype=qkv.dtype, device=qkv.device)
    bias = None if bias_vec is None else bias_vec.to(
        device=qkv.device, dtype=torch.float32).contiguous()
    if bias is not None and tuple(bias.shape) != (n_head, 2 * t - 1):
        raise ValueError(f"bias_vec must be ({n_head}, {2 * t - 1})")
    mask = _device_mask(kv_valid, b, t, qkv.device)
    if d != 64:
        q, k, v = _split_packed(qkv, n_head)
        _grouped_flash(q, k, v, out.view(b, t, n_head, d).transpose(1, 2),
                       bias, None, mask, False, float(d) ** -0.5)
        return out
    lib = build.library()
    build.check(lib.tt_flash_packed(
        qkv.data_ptr(), b, t, n_head, d,
        None if bias is None else bias.data_ptr(),
        None if mask is None else mask.data_ptr(),
        1.0 / float(d) ** 0.5, out.data_ptr(), build.stream_ptr()),
        "tt_flash_packed")
    flash_attention_packed.launches += 1
    return out


flash_attention_packed.launches = 0


def flash_attention_causal_qkv(qkv: torch.Tensor, n_head: int,
                               kv_valid: Optional[torch.Tensor] = None,
                               ) -> torch.Tensor:
    """Kernel C. qkv (B, S, 3*H*D) part-major; kv_valid (B, S) bool or
    None. Returns (B, S, H*D) in qkv's dtype. On a card a head width
    other than 64 runs kernel D2 (causal) on strided views."""
    if not qkv.is_cuda:
        return flash_attention_causal_qkv_plain(qkv, n_head, kv_valid)
    qkv, d = _check_cuda_qkv(qkv, n_head)
    b, s, _ = qkv.shape
    out = torch.empty((b, s, n_head * d), dtype=qkv.dtype, device=qkv.device)
    mask = _device_mask(kv_valid, b, s, qkv.device)
    if d != 64:
        q, k, v = _split_part_major(qkv, n_head)
        _generic_flash(q, k, v, out.view(b, s, n_head, d).transpose(1, 2),
                       None, None, mask, True, float(d) ** -0.5)
        return out
    lib = build.library()
    build.check(lib.tt_flash_causal_qkv(
        qkv.data_ptr(), b, s, n_head, d,
        None if mask is None else mask.data_ptr(),
        1.0 / float(d) ** 0.5, out.data_ptr(), build.stream_ptr()),
        "tt_flash_causal_qkv")
    flash_attention_causal_qkv.launches += 1
    return out


flash_attention_causal_qkv.launches = 0


def _bias_args(q, k, bias, causal, bias_buckets, bias_table, bias_scale,
               bias_formula, bias_max_distance):
    """-> (Toeplitz vector or None, (H, Tq, Tkv) bias or None, grouped):
    ``grouped`` is the JAX package's rule for the band-bias body D1."""
    tq, tkv = q.shape[2], k.shape[2]
    grouped = bias_formula and not causal and tq == tkv
    vec = full = None
    if bias_formula:
        vec = relpos_bias_vector(bias_table, tq, bias_scale,
                                 bias_max_distance, t_kv=tkv)
    elif bias_buckets is not None:
        vec = _bucket_strip_vector(bias_buckets, bias_table, bias_scale)
    elif bias is not None:
        full = bias.to(torch.float32)
    return vec, full, grouped


def flash_attention_plain(q, k, v, bias=None, kv_valid=None, causal=False,
                          scale=None, bias_buckets=None, bias_table=None,
                          bias_scale=8.0, bias_formula=False,
                          bias_max_distance=64) -> torch.Tensor:
    """Plain PyTorch twin of kernel D (same arguments and output)."""
    tq, tkv, d = q.shape[2], k.shape[2], q.shape[3]
    vec, full, grouped = _bias_args(q, k, bias, causal, bias_buckets,
                                    bias_table, bias_scale, bias_formula,
                                    bias_max_distance)
    add = torch.zeros((), dtype=torch.float32, device=q.device)
    if vec is not None:
        add = add + _toeplitz_full(vec, tq, tkv)[None]
    if full is not None:
        add = add + full[None]
    mask = _additive_mask(kv_valid)
    if mask is not None:
        add = add + mask[:, None, None, :]
    if causal:
        add = add + _causal_add(tq, tkv, q.device)
    scale = float(d) ** -0.5 if scale is None else scale
    return _attend(q, k, v, add, scale,
                   q.dtype if grouped else torch.float32)


def _kernel_operand(x):
    """A view kernel D can read (d contiguous, (b, h, t) strides a
    multiple of 8 elements, 16-byte aligned), else a contiguous copy."""
    ok = x.stride(-1) == 1 and all(s % 8 == 0 for s in x.stride()[:3]) \
        and x.data_ptr() % 16 == 0
    if ok:
        return x
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_d(q, k, v, out, bias_vec, bias_full, mask, causal, scale,
              name):
    b, h, tq, d = q.shape
    tkv = k.shape[2]
    if d not in HEAD_WIDTHS:
        raise ValueError(f"kernel D takes head width {HEAD_WIDTHS}, got {d}")
    if q.dtype not in (torch.bfloat16, torch.float32) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"kernel D wants bf16 or f32 q, k, v of one dtype, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k.shape != (b, h, tkv, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if out.dtype == torch.bfloat16 and q.dtype != torch.bfloat16:
        raise ValueError("kernel D writes bf16 only from bf16 inputs")
    q, k, v = (_kernel_operand(x) for x in (q, k, v))
    dev = q.device
    if bias_vec is not None:
        bias_vec = bias_vec.to(device=dev, dtype=torch.float32).contiguous()
        if tuple(bias_vec.shape) != (h, tq + tkv - 1):
            raise ValueError(f"Toeplitz bias must be ({h}, {tq + tkv - 1})")
    if bias_full is not None:
        bias_full = bias_full.to(device=dev,
                                 dtype=torch.float32).contiguous()
        if tuple(bias_full.shape) != (h, tq, tkv):
            raise ValueError(f"bias must be ({h}, {tq}, {tkv})")
    if mask is not None:
        mask = mask.to(dev).expand(b, tkv).contiguous()
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *out.stride()[:3])

    def ptr(x):
        return None if x is None else x.data_ptr()

    lib = build.library()
    build.check(lib.tt_flash_bhtd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), b, h, tq, tkv, d,
        int(q.dtype == torch.bfloat16), int(out.dtype == torch.bfloat16),
        ptr(bias_vec), ptr(bias_full), ptr(mask), scale, int(causal),
        build.stream_ptr()), name)


def _grouped_flash(q, k, v, out, bias_vec, bias_full, mask, causal, scale):
    """Kernel D1 (the grouped band-bias body) into ``out``."""
    _launch_d(q, k, v, out, bias_vec, bias_full, mask, causal, scale,
              "tt_flash_bhtd (D1)")
    _grouped_flash.launches += 1


def _generic_flash(q, k, v, out, bias_vec, bias_full, mask, causal, scale):
    """Kernel D2 (the generic body) into ``out``."""
    _launch_d(q, k, v, out, bias_vec, bias_full, mask, causal, scale,
              "tt_flash_bhtd (D2)")
    _generic_flash.launches += 1


_grouped_flash.launches = 0
_generic_flash.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    kv_valid: Optional[torch.Tensor] = None,
                    causal: bool = False, scale: Optional[float] = None,
                    bias_buckets: Optional[torch.Tensor] = None,
                    bias_table: Optional[torch.Tensor] = None,
                    bias_scale: float = 8.0, bias_formula: bool = False,
                    bias_max_distance: int = 64) -> torch.Tensor:
    """Kernel D. q (B, H, Tq, D), k and v (B, H, Tkv, D), any strides
    with d contiguous; kv_valid (B, Tkv) bool. The bias: a materialized
    (H, Tq, Tkv) ``bias``, or ``bias_buckets`` (Tq, Tkv) int + a (NB, H)
    ``bias_table`` scaled by ``bias_scale``, or ``bias_formula`` (T5
    buckets of j - i from the table). Returns (B, H, Tq, D): q's dtype on
    the grouped band-bias body D1 (bias_formula, non-causal, Tq == Tkv),
    else f32. On a card the result is a view of (B, Tq, H, D) memory, so
    merging the heads copies nothing."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, bias, kv_valid, causal, scale,
                                     bias_buckets, bias_table, bias_scale,
                                     bias_formula, bias_max_distance)
    vec, full, grouped = _bias_args(q, k, bias, causal, bias_buckets,
                                    bias_table, bias_scale, bias_formula,
                                    bias_max_distance)
    b, h, tq, d = q.shape
    out = torch.empty((b, tq, h, d), device=q.device,
                      dtype=q.dtype if grouped else torch.float32)
    out = out.transpose(1, 2)
    scale = float(d) ** -0.5 if scale is None else scale
    launch = _grouped_flash if grouped else _generic_flash
    launch(q, k, v, out, vec, full, _additive_mask(kv_valid), causal, scale)
    return out


__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_packed", "flash_attention_causal_qkv",
           "flash_attention_packed_plain",
           "flash_attention_causal_qkv_plain", "relpos_bias_vector"]
