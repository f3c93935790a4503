"""Attention straight off a fused qkv tensor: kernels B and C.

B ``flash_attention_packed`` replaces
``tortoise_tpu/ops/pallas/flash_attention.py::flash_attention_packed``:
non-causal attention over the denoiser's per-head-interleaved qkv
(c = h*3D + part*D + d) with the T5 rel-pos bias (x8) and a key mask.

C ``flash_attention_causal_qkv`` replaces
``tortoise_tpu/ops/pallas/flash_attention.py::flash_attention_causal_qkv``:
causal attention with key validity over the AR trunk's part-major qkv
(c = part*H*D + h*D + d).

Both return the merged context (B, T, H*D) in qkv's dtype. The CUDA
kernel (``csrc/flash_attention.cu``) walks the keys in shared-memory
tiles with an online softmax, so the (T, T) scores never reach device
memory; it is bound by the ~4*T*T*D multiply-adds per (batch, head),
which it runs on the tensor cores (``mma.sync`` bf16, f32 sums).

Each wrapper dispatches on the tensor's device: a CPU tensor takes the
plain PyTorch version below, a CUDA tensor launches the kernel (and
counts the launch) or raises. The plain versions compute in f32 from
the bf16 inputs, round the softmax weights to bf16 before the P@V
product like the Pallas kernels, and are the kernels' reference.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from tortoise_tpu_torch.ops.cuda import build
from tortoise_tpu_torch.ops.relpos import toeplitz_bucket_ids

NEG_INF = -1e30


def _additive_mask(kv_valid: Optional[torch.Tensor]):
    if kv_valid is None:
        return None
    return torch.where(kv_valid, 0.0, NEG_INF).to(torch.float32)


@functools.lru_cache(maxsize=16)
def _toeplitz_ids(t: int, n_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    # built once per length and device: a pageable host-to-device copy
    # would stall the stream on every attention call
    return torch.as_tensor(toeplitz_bucket_ids(t, n_buckets, max_distance),
                           device=device)


def relpos_bias_vector(bias_table: torch.Tensor, t: int,
                       scale: float = 8.0, max_distance: int = 64
                       ) -> torch.Tensor:
    """(NB, H) bucket table -> (H, 2T-1) f32 Toeplitz bias vector with
    element (j - i) + T - 1 = scale * table[bucket(j - i), h]. Buckets
    saturate past max_distance, so this is the exact bias the Pallas
    kernel assembles from its band tiles and far-field constants."""
    ids = _toeplitz_ids(t, bias_table.shape[0], max_distance,
                        bias_table.device)
    return (bias_table.to(torch.float32)[ids] * scale).T.contiguous()


def _split_packed(qkv: torch.Tensor, n_head: int):
    b, t, c3 = qkv.shape
    d = c3 // (3 * n_head)
    x = qkv.reshape(b, t, n_head, 3, d).permute(3, 0, 2, 1, 4)
    return x[0], x[1], x[2]  # (B, H, T, D)


def _split_part_major(qkv: torch.Tensor, n_head: int):
    b, t, c3 = qkv.shape
    d = c3 // (3 * n_head)
    x = qkv.reshape(b, t, 3, n_head, d).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def _attend(q, k, v, add, out_dtype):
    """softmax(q k^T / sqrt(D) + add) v in f32; add broadcasts to
    (B, H, T, T). Softmax weights rounded to v's dtype before P@V."""
    d = q.shape[-1]
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / float(d) ** 0.5
    s = s + add
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    ctx = torch.matmul(p.to(v.dtype).float(), v.float())
    ctx = ctx / l.clamp_min(1e-30)
    b, h, t, _ = ctx.shape
    return ctx.permute(0, 2, 1, 3).reshape(b, t, h * d).to(out_dtype)


def flash_attention_packed_plain(qkv, n_head, kv_valid=None,
                                 bias_vec=None) -> torch.Tensor:
    """Plain PyTorch twin of kernel B. bias_vec: (H, 2T-1) f32."""
    q, k, v = _split_packed(qkv, n_head)
    t = qkv.shape[1]
    add = torch.zeros((), dtype=torch.float32, device=qkv.device)
    if bias_vec is not None:
        idx = (torch.arange(t, device=qkv.device)[None, :]
               - torch.arange(t, device=qkv.device)[:, None] + t - 1)
        add = add + bias_vec[:, idx][None]                   # (1, H, T, T)
    mask = _additive_mask(kv_valid)
    if mask is not None:
        add = add + mask[:, None, None, :]
    return _attend(q, k, v, add, qkv.dtype)


def flash_attention_causal_qkv_plain(qkv, n_head, kv_valid=None
                                     ) -> torch.Tensor:
    """Plain PyTorch twin of kernel C."""
    q, k, v = _split_part_major(qkv, n_head)
    t = qkv.shape[1]
    i = torch.arange(t, device=qkv.device)
    add = torch.where(i[None, :] <= i[:, None], 0.0, NEG_INF).to(
        torch.float32)[None, None]
    mask = _additive_mask(kv_valid)
    if mask is not None:
        add = add + mask[:, None, None, :]
    return _attend(q, k, v, add, qkv.dtype)


def _check_cuda_qkv(qkv, n_head):
    if qkv.dtype != torch.bfloat16 or qkv.dim() != 3:
        raise ValueError(f"kernel wants a (B, T, 3HD) bfloat16 qkv, got "
                         f"{tuple(qkv.shape)} {qkv.dtype}")
    d = qkv.shape[-1] // (3 * n_head)
    if 3 * n_head * d != qkv.shape[-1] or d != 64:
        raise ValueError(f"kernel wants head width 64, got "
                         f"{qkv.shape[-1]} channels over {n_head} heads")
    qkv = qkv.contiguous()
    if qkv.data_ptr() % 16:  # the kernel reads 16-byte K/V chunks
        qkv = qkv.clone()
    return qkv, d


def flash_attention_packed(qkv: torch.Tensor, n_head: int,
                           kv_valid: Optional[torch.Tensor] = None,
                           bias_table: Optional[torch.Tensor] = None,
                           bias_scale: float = 8.0,
                           bias_max_distance: int = 64,
                           bias_vec: Optional[torch.Tensor] = None,
                           ) -> torch.Tensor:
    """Kernel B. qkv (B, T, 3*H*D) per-head interleaved; kv_valid (B, T)
    bool or None; the bias from a (NB, H) bucket table or a prebuilt
    (H, 2T-1) ``bias_vec``. Returns (B, T, H*D) in qkv's dtype."""
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
    mask = _additive_mask(kv_valid)
    if mask is not None:
        mask = mask.to(qkv.device).expand(b, t).contiguous()
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
    None. Returns (B, S, H*D) in qkv's dtype."""
    if not qkv.is_cuda:
        return flash_attention_causal_qkv_plain(qkv, n_head, kv_valid)
    qkv, d = _check_cuda_qkv(qkv, n_head)
    b, s, _ = qkv.shape
    out = torch.empty((b, s, n_head * d), dtype=qkv.dtype, device=qkv.device)
    mask = _additive_mask(kv_valid)
    if mask is not None:
        mask = mask.to(qkv.device).expand(b, s).contiguous()
    lib = build.library()
    build.check(lib.tt_flash_causal_qkv(
        qkv.data_ptr(), b, s, n_head, d,
        None if mask is None else mask.data_ptr(),
        1.0 / float(d) ** 0.5, out.data_ptr(), build.stream_ptr()),
        "tt_flash_causal_qkv")
    flash_attention_causal_qkv.launches += 1
    return out


flash_attention_causal_qkv.launches = 0

__all__ = ["flash_attention_packed", "flash_attention_causal_qkv",
           "flash_attention_packed_plain",
           "flash_attention_causal_qkv_plain", "relpos_bias_vector"]
