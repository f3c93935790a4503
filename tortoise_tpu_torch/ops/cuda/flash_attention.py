"""Exact-softmax attention: kernels B, C, D1 and D2.

B ``flash_attention_packed`` replaces
``tortoise_tpu/ops/pallas/flash_attention.py::flash_attention_packed``:
non-causal attention over the denoiser's per-head-interleaved qkv
(c = h*3D + part*D + d) with the T5 rel-pos bias (x8) and a key mask.

C ``flash_attention_causal_qkv`` replaces
``tortoise_tpu/ops/pallas/flash_attention.py::flash_attention_causal_qkv``:
causal attention with key validity over the AR trunk's part-major qkv
(c = part*H*D + h*D + d).

Both return the merged context (B, T, H*D) in qkv's dtype.

D ``flash_attention`` replaces
``tortoise_tpu/ops/pallas/flash_attention.py::flash_attention`` over
(B, H, T, D) q, k, v, with both of its bodies: D1, the grouped band-bias
body (``bias_formula``, non-causal, equal query and key lengths; output
in q's dtype), and D2, the generic body (no bias, a materialized
(H, Tq, Tkv) bias, ``bias_buckets`` + table, or the formula bias when
causal or ragged; optional causal flag; output f32).

Two CUDA sources carry them (``attention_body`` picks one per call):
- ``csrc/flash_attention.cu``, on wgmma + TMA, takes every bf16 call. Its
  generic body runs D1 and D2 at head widths 16, 32, 64 and 128 and B and
  C at 16, 32 and 128, reading each of q, k, v through a tensor map of its
  own strided view (``tma_layout``; q's map runs over Tq rows, k's and
  v's over Tkv), so views of a fused qkv need no copy, and writing the
  output (bf16 for B, C and D1, f32 for D2) through (b, h, t) strides into
  (B, T, H, D) memory. A materialized bias is read as (H, Tq, ld) with
  ld a multiple of 4 (``_bias_operand`` pads it). B and C at width 64 run
  its fused-qkv body (one map over the whole qkv).
- ``csrc/flash_attention_bhtd.cu``: every f32 call, on the tensor cores
  in split TF32 (each f32 operand as hi + lo TF32 values, three TF32
  products a product), over (b, h, t) strides: D1 and D2, and B and C on
  strided views of an f32 qkv, as the Pallas kernels take either dtype.
  It takes any Tkv (the keys stream through shared memory in tiles).

The kernels walk the keys in shared-memory tiles with an online softmax,
so the (Tq, Tkv) scores never reach device memory; they are bound by
the ~4*Tq*Tkv*D multiply-adds per (batch, head) on the tensor cores and,
at head widths 16 and 32, by the Tq*Tkv exps (by its bytes when a
materialized bias is read).

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
HEAD_WIDTHS = (16, 32, 64, 128)  # the head widths every body takes
TMA_WIDTHS = HEAD_WIDTHS  # flash_attention.cu's (the wgmma + TMA body)
TMA_ROWS = 64  # rows of t in one tensor-map box (a K/V tile)
TMA_BQ = 128  # query rows of one block of the TMA body
TMA_SMEM_LIMIT = 232448  # shared memory a block may have on an H100


def _additive_mask(kv_valid: Optional[torch.Tensor]):
    if kv_valid is None:
        return None
    return torch.where(kv_valid, 0.0, NEG_INF).to(torch.float32)


@functools.cache
def _toeplitz_ids(tq: int, tkv: int, n_buckets: int, max_distance: int,
                  device: torch.device) -> torch.Tensor:
    # built once per length and device: a pageable host-to-device copy
    # would stall the stream on every attention call. Never dropped
    # (a few KB a length): a captured step graph (pipeline/graphs.py)
    # reads it by address
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
    if qkv.dtype not in (torch.bfloat16, torch.float32) or qkv.dim() != 3:
        raise ValueError(f"kernel wants a (B, T, 3HD) bfloat16 or float32 "
                         f"qkv, got {tuple(qkv.shape)} {qkv.dtype}")
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
    a bf16 qkv at head width 64 runs the fused-qkv body, at 16, 32 and
    128 the generic wgmma + TMA body on strided views of qkv; an f32 qkv
    runs the split-TF32 body on those views."""
    t = qkv.shape[1]
    if bias_vec is None and bias_table is not None:
        bias_vec = relpos_bias_vector(bias_table, t, bias_scale,
                                      bias_max_distance)
    if not qkv.is_cuda:
        return flash_attention_packed_plain(qkv, n_head, kv_valid, bias_vec)
    return launch_packed(qkv, n_head,
                         _device_mask(kv_valid, qkv.shape[0], t, qkv.device),
                         bias_vec)


flash_attention_packed.launches = 0


def launch_packed(qkv: torch.Tensor, n_head: int,
                  mask: Optional[torch.Tensor],
                  bias_vec: Optional[torch.Tensor]) -> torch.Tensor:
    """Kernel B on the card with its side inputs built: ``mask`` the
    (B, T) f32 additive key mask of ``_device_mask`` or None, ``bias_vec``
    the (H, 2T-1) Toeplitz bias or None. A caller that runs many calls on
    one mask and bias builds them once (the int8 A/B)."""
    qkv, d = _check_cuda_qkv(qkv, n_head)
    b, t = qkv.shape[:2]
    if mask is not None:
        if tuple(mask.shape) != (b, t) or mask.dtype != torch.float32:
            raise ValueError(f"mask must be f32 (B, T) = {(b, t)}, got "
                             f"{tuple(mask.shape)} {mask.dtype}")
        mask = mask.contiguous()
    out = torch.empty((b, t, n_head * d), dtype=qkv.dtype, device=qkv.device)
    body = attention_body(qkv.dtype, d, "B")
    if body == "qkv":
        bias = None if bias_vec is None else bias_vec.to(
            device=qkv.device, dtype=torch.float32).contiguous()
        if bias is not None and tuple(bias.shape) != (n_head, 2 * t - 1):
            raise ValueError(f"bias_vec must be ({n_head}, {2 * t - 1})")
        build.check(build.library().tt_flash_packed(
            qkv.data_ptr(), b, t, n_head, d,
            None if bias is None else bias.data_ptr(),
            None if mask is None else mask.data_ptr(), float(d) ** -0.5,
            out.data_ptr(), build.stream_ptr()), "tt_flash_packed")
        flash_attention_packed.launches += 1
        return out
    q, k, v = _split_packed(qkv, n_head)
    out_bhtd = out.view(b, t, n_head, d).transpose(1, 2)
    _launch_body("B", q, k, v, out_bhtd, bias_vec, None, mask, False,
                 float(d) ** -0.5)
    flash_attention_packed.launches += 1
    return out


def flash_attention_causal_qkv(qkv: torch.Tensor, n_head: int,
                               kv_valid: Optional[torch.Tensor] = None,
                               ) -> torch.Tensor:
    """Kernel C. qkv (B, S, 3*H*D) part-major; kv_valid (B, S) bool or
    None. Returns (B, S, H*D) in qkv's dtype. On a card a bf16 qkv at
    head width 64 runs the fused-qkv body, at 16, 32 and 128 the generic
    wgmma + TMA body (causal) on strided views of qkv; an f32 qkv runs
    the split-TF32 body on those views."""
    if not qkv.is_cuda:
        return flash_attention_causal_qkv_plain(qkv, n_head, kv_valid)
    qkv, d = _check_cuda_qkv(qkv, n_head)
    b, s, _ = qkv.shape
    out = torch.empty((b, s, n_head * d), dtype=qkv.dtype, device=qkv.device)
    mask = _device_mask(kv_valid, b, s, qkv.device)
    body = attention_body(qkv.dtype, d, "C")
    if body == "qkv":
        build.check(build.library().tt_flash_causal_qkv(
            qkv.data_ptr(), b, s, n_head, d,
            None if mask is None else mask.data_ptr(), float(d) ** -0.5,
            out.data_ptr(), build.stream_ptr()), "tt_flash_causal_qkv")
        flash_attention_causal_qkv.launches += 1
        return out
    q, k, v = _split_part_major(qkv, n_head)
    out_bhtd = out.view(b, s, n_head, d).transpose(1, 2)
    _launch_body("C", q, k, v, out_bhtd, None, None, mask, True,
                 float(d) ** -0.5)
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


def _launch_d(q, k, v, out, bias_vec, bias_full, mask, causal, scale,
              name):
    """flash_attention_bhtd.cu's split-TF32 body on (B, H, T, D) f32
    q, k, v (any strides, d contiguous; any Tkv) into the f32 view
    ``out``."""
    b, h, tq, d = q.shape
    tkv = k.shape[2]
    if d not in HEAD_WIDTHS:
        raise ValueError(f"kernel D takes head width {HEAD_WIDTHS}, got {d}")
    if any(x.dtype != torch.float32 for x in (q, k, v, out)):
        raise ValueError(f"the TF32x3 body takes f32 q, k, v and output, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}, {out.dtype}")
    if k.shape != (b, h, tkv, d) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if out.shape != q.shape or out.stride(-1) != 1:
        raise ValueError(f"out {tuple(out.shape)} must match q "
                         f"{tuple(q.shape)} with d contiguous")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
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

    build.check(build.library().tt_flash_bhtd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        ctypes.addressof(strides), b, h, tq, tkv, d, ptr(bias_vec),
        ptr(bias_full), ptr(mask), scale, int(causal), build.stream_ptr()),
        name)
    _launch_d.launches += 1


_launch_d.launches = 0  # f32 calls of any route (B, C, D1 or D2)


def attention_body(dtype: torch.dtype, d: int, route: str) -> str:
    """The CUDA body that runs an attention call of ``route`` ("B", "C",
    "D1" or "D2") on (dtype, head width d): "qkv", the fused-qkv body of
    csrc/flash_attention.cu (bf16 B and C at width 64); "tma", its
    generic body over strided views (every other bf16 call: D1 and D2 at
    widths 16, 32, 64 and 128, B and C at 16, 32 and 128); "tf32x3", the
    split-TF32 tensor-core body of flash_attention_bhtd.cu (every route on
    f32 inputs, at every width). Raises for what no body takes."""
    if route not in ("B", "C", "D1", "D2"):
        raise ValueError(f"unknown attention route {route!r}")
    if d not in HEAD_WIDTHS:
        raise ValueError(f"kernel {route} takes head width {HEAD_WIDTHS}, "
                         f"got {d}")
    if dtype == torch.float32:
        return "tf32x3"
    if dtype != torch.bfloat16:
        raise ValueError(f"kernel {route} does not take {dtype}")
    return "qkv" if route in ("B", "C") and d == 64 else "tma"


def tma_layout(x: torch.Tensor) -> dict:
    """The tensor map through which the wgmma + TMA body reads a
    (B, H, T, D) bf16 view: ``dims`` (D first, then T, H and B sorted by
    stride; a size-1 dim last), ``strides`` (bytes, of map dims 1-3),
    ``box`` (min(D, 64) columns by 64 rows of t) and ``perm`` (the map
    slot, 1-3, of t, h and b in bits 0-1, 2-3, 4-5). Raises ValueError
    for a view TMA cannot read: d not contiguous, a base address or a
    stride that is not a multiple of 16 bytes, dims that overlap in
    memory, or a head width the body does not take."""
    if x.dim() != 4 or x.dtype != torch.bfloat16:
        raise ValueError(f"want a (B, H, T, D) bf16 view, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.data_ptr() % 16:
        raise ValueError(f"base address {x.data_ptr():#x} is not 16-byte "
                         f"aligned")
    return _view_layout(tuple(x.shape), x.stride())


@functools.lru_cache(maxsize=256)
def _view_layout(shape: tuple, stride: tuple) -> dict:
    """tma_layout of a bf16 view of this shape and strides (a view's
    layout is asked for at every call; the model's are few)."""
    b, h, t, d = shape
    if d not in TMA_WIDTHS:
        raise ValueError(f"the TMA body takes head width {TMA_WIDTHS}, "
                         f"got {d}")
    es = 2  # bf16
    if stride[3] != 1:
        raise ValueError("d is not contiguous")
    named = (("t", t, stride[2]), ("h", h, stride[1]), ("b", b, stride[0]))
    big = sorted((n for n in named if n[1] > 1), key=lambda n: n[2])
    order = [n[0] for n in big] + [n[0] for n in named if n[1] == 1]
    dims, strides, span = [d], [], d * es  # span: bytes the dims cover
    for _, size, stride in big:
        sb = stride * es
        if sb % 16:
            raise ValueError(f"stride {sb} bytes is not a multiple of 16")
        if sb < span:
            raise ValueError("dims overlap in memory")
        dims.append(size)
        strides.append(sb)
        span = sb * size
    while len(dims) < 4:  # size-1 dims: any stride past the others
        dims.append(1)
        strides.append(span)
    box = [min(d, 64), 1, 1, 1]
    box[order.index("t") + 1] = TMA_ROWS
    perm = sum((order.index(n) + 1) << (2 * i) for i, n in enumerate("thb"))
    return dict(dims=tuple(dims), strides=tuple(strides), box=tuple(box),
                perm=perm)


def _tma_operand(x):
    """(x or a contiguous copy of it, its tma_layout): a view TMA cannot
    read is copied."""
    try:
        return x, tma_layout(x)
    except ValueError:
        if x.dim() != 4 or x.dtype != torch.bfloat16 or \
                x.shape[-1] not in TMA_WIDTHS:
            raise
    x = x.contiguous()
    if x.data_ptr() % 16:
        x = x.clone()
    return x, tma_layout(x)


def tma_smem_bytes(d: int, tkv: int, window: bool) -> int:
    """Dynamic shared memory of the TMA body's block (``smem_bytes`` in
    csrc/flash_attention.cu): the 1024-byte alignment slack, two Q tiles
    and a 3-stage K/V ring of 64-row tiles, 128 bytes of barriers, the
    key mask over Tkv padded to a tile and, with a Toeplitz bias
    (``window``), its two windows of Tkv + 130 deltas, in f32."""
    tile = TMA_ROWS * d * 2
    tkpad = -(-tkv // TMA_ROWS) * TMA_ROWS
    floats = tkpad + (2 * (tkpad + TMA_BQ + 2) if window else 0)
    return 1024 + 8 * tile + 128 + 4 * floats


def _bias_operand(bias_full, h, tq, tkv, device):
    """(the (H, Tq, ld) f32 bias the TMA body reads, ld): rows of ld >=
    Tkv floats, ld a multiple of 4, so each row starts 16 bytes apart of
    a 16-byte aligned base and a thread's key pairs are 8-byte loads;
    padded with zeros (the body reads no key past Tkv)."""
    bias_full = bias_full.to(device=device, dtype=torch.float32)
    if tuple(bias_full.shape) != (h, tq, tkv):
        raise ValueError(f"bias must be ({h}, {tq}, {tkv})")
    ld = -(-tkv // 4) * 4
    if ld != tkv:
        bias_full = torch.nn.functional.pad(bias_full, (0, ld - tkv))
    bias_full = bias_full.contiguous()
    if bias_full.data_ptr() % 16:
        bias_full = bias_full.clone()
    return bias_full, ld


def _tma_args(q, k, v, out, bias_vec, bias_full, mask, causal):
    """The host side of one call of the TMA body, checked: (q, k, v as
    read, each a view or a copy, the 24 map numbers, the Toeplitz vector,
    the materialized bias and its row length, the mask). q (B, H, Tq, D),
    k and v (B, H, Tkv, D) bf16; out (B, H, Tq, D) bf16 or f32 with d
    contiguous; at most one of bias_vec (H, Tq + Tkv - 1) and bias_full
    (H, Tq, Tkv); mask (B, Tkv) additive or None. Raises ValueError for
    what the body does not take, naming the shared-memory limit when Tkv
    is too long for the block's mask and bias window."""
    b, h, tq, d = q.shape
    tkv = k.shape[2]
    if k.shape != (b, h, tkv, d) or v.shape != k.shape or \
            out.shape != q.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} and out {tuple(out.shape)} "
                         f"do not match")
    if any(x.dtype != torch.bfloat16 for x in (q, k, v)):
        raise ValueError("the TMA body takes bf16 q, k and v")
    if out.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the TMA body writes bf16 or f32, not {out.dtype}")
    if out.stride(3) != 1:
        raise ValueError("the output's d must be contiguous")
    if bias_vec is not None and bias_full is not None:
        raise ValueError("the TMA body takes one bias")
    if out.dtype == torch.bfloat16 and (
            bias_full is not None or (causal and bias_vec is not None)):
        raise ValueError("a bf16 output takes no materialized bias, and no "
                         "bias when causal")
    window = bias_full is None and (bias_vec is not None or not causal)
    need = tma_smem_bytes(d, tkv, window)
    if need > TMA_SMEM_LIMIT:
        raise ValueError(
            f"the TMA body's block needs {need} bytes of shared memory for "
            f"{tkv} keys at head width {d}, over the card's "
            f"{TMA_SMEM_LIMIT}")
    ops, geom = [], []
    for x in (q, k, v):
        x, lay = _tma_operand(x)
        ops.append(x)
        geom += [*lay["dims"], *lay["strides"], lay["perm"]]
    dev = q.device
    if bias_vec is not None:
        bias_vec = bias_vec.to(device=dev, dtype=torch.float32).contiguous()
        if tuple(bias_vec.shape) != (h, tq + tkv - 1):
            raise ValueError(f"Toeplitz bias must be ({h}, {tq + tkv - 1})")
    ld = 0
    if bias_full is not None:
        bias_full, ld = _bias_operand(bias_full, h, tq, tkv, dev)
    if mask is not None:
        mask = mask.to(dev).expand(b, tkv).contiguous()
    return ops, geom, bias_vec, bias_full, ld, mask


def _launch_tma(q, k, v, out, bias_vec, bias_full, mask, causal, scale,
                name):
    """The wgmma + TMA body (``_tma_args`` says what it takes)."""
    b, h, tq, d = q.shape
    ops, geom, bias_vec, bias_full, ld, mask = _tma_args(
        q, k, v, out, bias_vec, bias_full, mask, causal)
    geom = (ctypes.c_longlong * 24)(*geom)  # alive until the call returns
    ostr = (ctypes.c_longlong * 3)(*out.stride()[:3])

    def ptr(x):
        return None if x is None else x.data_ptr()

    build.check(build.library().tt_flash_tma(
        *(x.data_ptr() for x in ops), out.data_ptr(),
        ctypes.addressof(geom), ctypes.addressof(ostr), b, h, tq,
        k.shape[2], d, ptr(bias_vec), ptr(bias_full), ld, ptr(mask), scale,
        int(causal), int(out.dtype == torch.float32), build.stream_ptr()),
        name)


def _launch_body(route, q, k, v, out, bias_vec, bias_full, mask, causal,
                 scale):
    """Kernel ``route`` (B, C, D1 or D2) on strided views into ``out``:
    bf16 q, k, v on the wgmma + TMA body, f32 on flash_attention_bhtd.cu's
    split-TF32 body."""
    if attention_body(q.dtype, q.shape[-1], route) == "tma":
        _launch_tma(q, k, v, out, bias_vec, bias_full, mask, causal, scale,
                    f"tt_flash_tma ({route})")
    else:
        _launch_d(q, k, v, out, bias_vec, bias_full, mask, causal, scale,
                  f"tt_flash_bhtd ({route})")


def _grouped_flash(q, k, v, out, bias_vec, bias_full, mask, causal, scale):
    """Kernel D1 (the grouped band-bias body: non-causal, Tq == Tkv, a
    Toeplitz bias) into ``out`` (q's dtype)."""
    _launch_body("D1", q, k, v, out, bias_vec, bias_full, mask, causal,
                 scale)
    _grouped_flash.launches += 1


def _generic_flash(q, k, v, out, bias_vec, bias_full, mask, causal, scale):
    """Kernel D2 (the generic body) into the f32 ``out``."""
    _launch_body("D2", q, k, v, out, bias_vec, bias_full, mask, causal,
                 scale)
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
           "flash_attention_packed_plain", "launch_packed",
           "flash_attention_causal_qkv_plain", "relpos_bias_vector"]
