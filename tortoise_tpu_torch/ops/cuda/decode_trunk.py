"""AR decode trunk for one token step: kernel A.

``fused_decode_trunk`` replaces
``tortoise_tpu/ops/pallas/decode_trunk.py::fused_decode_trunk``: all GPT-2
layers of one decode step for B <= 16 rows on the int8 + bf16 plane, then
optionally the double-norm int8 lm head and the full sampler (penalty ->
temperature -> top-k <= 128 with first-index ties -> suffix-sum nucleus
drop that never drops the top candidate -> inverse CDF against given
uniforms).

On the card (``csrc/decode_trunk.cu``) a step is ONE cooperative launch
whose co-resident blocks walk every layer, the head and the sampler
together, separated by grid barriers: per layer the int8 qkv matvec,
cache attention with the fresh column folded into the softmax, proj
matvec, residual + LN2, fc matvec + GELU, fc_proj matvec, residual + the
next LN. Each LN runs once per row. A matvec item is a 128-column int8
weight tile that arrives by TMA while the block is still in the phases
before it, and runs on the tensor cores (mma.sync) with the batch rows as
the other operand; its split-K sums are added in a fixed order, so the
step repeats bit for bit. The step is bound by streaming the int8 weights
and the bf16 cache slice once; a weight byte serves all B rows.

The wrapper dispatches on the device of ``x``: CPU takes the plain
PyTorch version below, CUDA launches the kernels (one count per call) or
raises. Layouts are the JAX package's: blocks from
``pipeline.ar_stage.cast_matmul_weights(int8=True)``, cache (L, B, C, HD)
bf16, bias_row (B, C) additive 0/-1e30, x (B, D) f32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from tortoise_tpu_torch.ops.basic import gelu, layer_norm
from tortoise_tpu_torch.ops.cuda import build

F32_LOWEST = -3.4028234663852886e38
MAX_TOPK = 128


def _matvec_q8(y, wq, scale, bias):
    acc = torch.matmul(y.to(torch.bfloat16).float(), wq.float())
    return acc * scale + bias


def head_logits_plain(x, head, eps: float = 1e-5):
    """Double-norm int8 lm head over the padded pack -> (B, Vp) f32."""
    y = layer_norm(x, head["ln_f_w"][0], head["ln_f_b"][0], eps)
    y = layer_norm(y, None, None, eps)
    y = y * head["lm_ln_w"][0] + head["lm_ln_b"][0]
    return _matvec_q8(y, head["lm_wq"], head["lm_sc"], head["lm_b"])


def sample_plain(logits, prev, u, sampler) -> torch.Tensor:
    """The kernel's sampler on (B, Vp) logits, prev (B, 1) int, u (B, 1)
    f32 -> (B, 1) int32 tokens."""
    temperature, top_k, top_p_drop, penalty = sampler
    bsz, vp = logits.shape
    lanes = torch.arange(vp, device=logits.device)
    x = logits.float()
    pen = torch.where(x < 0, x * penalty, x / penalty)
    x = torch.where(lanes == prev.long(), pen, x) * (1.0 / temperature)
    vals, ids = [], []
    for _ in range(top_k):
        m = x.amax(dim=-1, keepdim=True)
        idx = torch.where(x == m, lanes, vp).amin(dim=-1, keepdim=True)
        vals.append(m)
        ids.append(idx)
        x = x.scatter(-1, idx, F32_LOWEST)
    vals = torch.cat(vals, dim=-1)
    ids = torch.cat(ids, dim=-1)
    e = torch.exp(vals - vals[:, :1])
    p = e / e.sum(dim=-1, keepdim=True)
    suffix = torch.flip(torch.cumsum(torch.flip(p, (-1,)), -1), (-1,))
    drop = suffix <= top_p_drop
    drop[:, 0] = False
    e2 = torch.where(drop, 0.0, e)
    cum = torch.cumsum(e2 / e2.sum(dim=-1, keepdim=True), dim=-1)
    pos = torch.clamp((cum < u).sum(dim=-1, keepdim=True), max=top_k - 1)
    return torch.gather(ids, -1, pos).to(torch.int32)


def fused_decode_trunk_plain(blocks, cache_k, cache_v, bias_row, x,
                             head=None, prev_u=None, sampler=None,
                             n_head: int = 16, eps: float = 1e-5):
    """Plain PyTorch twin of kernel A (same arguments and outputs)."""
    n_layer, bsz, c, hd = cache_k.shape
    dh = hd // n_head
    scale = 1.0 / dh ** 0.5
    x = x.float()
    k_rows, v_rows = [], []
    aw, asc = blocks["attn_w"]
    pw, psc = blocks["proj_w"]
    fw, fsc = blocks["fc_w"]
    fpw, fpsc = blocks["fc_proj_w"]
    for l in range(n_layer):
        y = layer_norm(x, blocks["ln1_w"][l], blocks["ln1_b"][l], eps)
        qkv = _matvec_q8(y, aw[l], asc[l], blocks["attn_b"][l])
        q, k_new, v_new = qkv[:, :hd], qkv[:, hd:2 * hd], qkv[:, 2 * hd:]
        k_rows.append(k_new)
        v_rows.append(v_new)
        qs = (q * scale).reshape(bsz, n_head, dh)
        kc = cache_k[l].reshape(bsz, c, n_head, dh).float()
        vc = cache_v[l].reshape(bsz, c, n_head, dh).float()
        s = torch.einsum("bhd,bchd->bhc", qs.to(torch.bfloat16).float(), kc)
        s = s + bias_row[:, None, :]
        self_s = (qs * k_new.reshape(bsz, n_head, dh)).sum(-1, keepdim=True)
        m = torch.maximum(s.amax(dim=-1, keepdim=True), self_s)
        e = torch.exp(s - m)
        e_self = torch.exp(self_s - m)
        denom = e.sum(dim=-1, keepdim=True) + e_self
        ctx = torch.einsum("bhc,bchd->bhd", e.to(torch.bfloat16).float(), vc)
        ctx = (ctx + e_self * v_new.reshape(bsz, n_head, dh)) / denom
        x = x + _matvec_q8(ctx.reshape(bsz, hd), pw[l], psc[l],
                           blocks["proj_b"][l])
        y = layer_norm(x, blocks["ln2_w"][l], blocks["ln2_b"][l], eps)
        h = gelu(_matvec_q8(y, fw[l], fsc[l], blocks["fc_b"][l]))
        x = x + _matvec_q8(h, fpw[l], fpsc[l], blocks["fc_proj_b"][l])
    out = (x, torch.stack(k_rows).to(cache_k.dtype),
           torch.stack(v_rows).to(cache_v.dtype))
    if head is None:
        return out
    logits = head_logits_plain(x, head, eps)
    out = out + (logits,)
    if sampler is not None:
        out = out + (sample_plain(logits, prev_u[0], prev_u[1], sampler),)
    return out


def _arg(t: torch.Tensor, dtype, shape, name: str) -> int:
    if t.device.type != "cuda" or t.dtype != dtype or \
            tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous cuda {dtype} {tuple(shape)}"
                         f", got {t.device} {t.dtype} {tuple(t.shape)}")
    return t.data_ptr()


_scratch: dict = {}


def _step_scratch(bsz: int, d: int, f: int, vp: int, dev) -> dict:
    """The step's scratch buffers, cached per (B, widths, device): the LN
    output and the kernel's zeroed scratch (partial sums, GELU output,
    attention sums, counters; every launch leaves them ready for the
    next). ``vp`` is 0 without the head."""
    key = (bsz, d, f, vp, dev)
    buf = _scratch.get(key)
    if buf is None:
        n = build.library().tt_decode_partial_floats(bsz, d, f, vp)
        if n < 0:
            raise ValueError(f"kernel A does not take B={bsz} D={d} F={f} "
                             f"Vp={vp}")
        bf = torch.bfloat16
        buf = {"y": torch.empty((bsz, d), dtype=bf, device=dev),
               "partial": torch.zeros((n,), dtype=torch.float32,
                                      device=dev)}
        _scratch[key] = buf
    return buf


def fused_decode_trunk(blocks: dict, cache_k: torch.Tensor,
                       cache_v: torch.Tensor, bias_row: torch.Tensor,
                       x: torch.Tensor, head: Optional[dict] = None,
                       prev_u: Optional[tuple] = None,
                       sampler: Optional[tuple] = None, n_head: int = 16,
                       eps: float = 1e-5, split_rows: Optional[int] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """Kernel A. Returns (hidden (B, D) f32, k_rows (L, B, HD), v_rows)
    in the cache dtype; with ``head`` also (B, Vp) f32 logits; with
    ``prev_u`` = ((B, 1) int32 previous tokens, (B, 1) f32 uniforms) and
    ``sampler`` = (temperature, top_k, top_p_drop, penalty) also (B, 1)
    int32 sampled tokens. ``split_rows``: the batch these B rows belong
    to (a dp rank's global batch); the cache attention is split over the
    blocks as for that batch, so each row's bits are those of the whole
    batch's run."""
    if sampler is not None and sampler[1] > MAX_TOPK:
        raise ValueError(f"fused sampler supports top_k <= {MAX_TOPK}; got "
                         f"top_k={sampler[1]}")
    if not x.is_cuda:
        return fused_decode_trunk_plain(blocks, cache_k, cache_v, bias_row,
                                        x, head, prev_u, sampler, n_head, eps)
    n_layer, bsz, c, hd = cache_k.shape
    d = x.shape[-1]
    f = blocks["fc_w"][0].shape[-1]
    if hd != d or d != n_head * 64:
        raise ValueError(f"kernel wants D = H*64, got D={d} H={n_head}")
    dev = x.device
    bf, f32, i8 = torch.bfloat16, torch.float32, torch.int8
    L = n_layer

    def pair(name, k_in, n_out):
        wq, sc = blocks[name]
        return (_arg(wq, i8, (L, k_in, n_out), name),
                _arg(sc, f32, (L, 1, n_out), name + " scale"))

    def vec(name, n):
        return _arg(blocks[name], f32, (L, n), name)

    aw, asc = pair("attn_w", d, 3 * d)
    pw, psc = pair("proj_w", d, d)
    fw, fsc = pair("fc_w", d, f)
    fpw, fpsc = pair("fc_proj_w", f, d)
    lib = build.library()
    xw = x.to(f32).contiguous().clone()
    k_rows = torch.empty((n_layer, bsz, d), dtype=bf, device=dev)
    v_rows = torch.empty((n_layer, bsz, d), dtype=bf, device=dev)
    out = (xw, k_rows, v_rows)
    vp, head_args, logits, tok = 0, [None] * 7, None, None
    smp_args = [None, None, 1.0, 1, 0.0, 1.0]
    if head is not None:
        vp = head["lm_wq"].shape[-1]
        head_args = ([_arg(head[k], f32, (1, d), k)
                      for k in ("ln_f_w", "ln_f_b", "lm_ln_w", "lm_ln_b")]
                     + [_arg(head["lm_wq"], i8, (d, vp), "lm_wq"),
                        _arg(head["lm_sc"], f32, (1, vp), "lm_sc"),
                        _arg(head["lm_b"], f32, (1, vp), "lm_b")])
        logits = torch.empty((bsz, vp), dtype=f32, device=dev)
        out = out + (logits,)
        if sampler is not None:
            temperature, top_k, top_p_drop, penalty = sampler
            prev = prev_u[0].to(torch.int32).contiguous()
            u = prev_u[1].to(f32).contiguous()
            tok = torch.empty((bsz, 1), dtype=torch.int32, device=dev)
            smp_args = [_arg(prev, torch.int32, (bsz, 1), "prev"),
                        _arg(u, f32, (bsz, 1), "u"), 1.0 / temperature,
                        int(top_k), top_p_drop, penalty]
            out = out + (tok,)
    scr = _step_scratch(bsz, d, f, vp, dev)
    build.check(lib.tt_decode_trunk(
        L, bsz, c, d, n_head, f, split_rows or bsz, eps, xw.data_ptr(),
        _arg(bias_row, f32, (bsz, c), "bias_row"),
        vec("ln1_w", d), vec("ln1_b", d), aw, asc, vec("attn_b", 3 * d),
        pw, psc, vec("proj_b", d), vec("ln2_w", d), vec("ln2_b", d),
        fw, fsc, vec("fc_b", f), fpw, fpsc, vec("fc_proj_b", d),
        _arg(cache_k, bf, (L, bsz, c, d), "cache_k"),
        _arg(cache_v, bf, (L, bsz, c, d), "cache_v"),
        k_rows.data_ptr(), v_rows.data_ptr(), vp, *head_args,
        None if logits is None else logits.data_ptr(), *smp_args,
        None if tok is None else tok.data_ptr(), scr["y"].data_ptr(),
        scr["partial"].data_ptr(),
        build.stream_ptr()), "tt_decode_trunk")
    fused_decode_trunk.launches += 1
    return out


fused_decode_trunk.launches = 0
