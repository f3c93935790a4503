"""Autoregressive GPT-2-style speech-token decoder (counterpart of
``tortoise_tpu/models/ar.py``).

Same architecture and public layouts as the JAX package:

- sequence [voice latent | text embeddings | mel embeddings]; decode mel
  position ids are step + 2, the start token uses position 0;
- pre-LN block: LN -> fused qkv (part-major channels c = part*H*D + h*D
  + d) -> causal softmax(QK/sqrt(Dh)) -> proj -> residual -> LN -> GELU
  MLP -> residual;
- head: LN -> ln_f affine -> bare second LN -> lm_head.0 affine ->
  lm_head.1 (the double norm is part of the exported model);
- KV cache (L, B, C, H*Dh), updated in place one slot per step. A step
  writes its row and reads its mel position at DEVICE indices (the
  cache's ``pos`` where a step graph set one, and a ``step`` that may be
  a (1,) long device tensor, as the JAX loops carry a traced step), so
  one captured step can be replayed for every step of a loop
  (``pipeline.graphs``).

Tensor parallelism (``tp``, an ``AxisGroup`` on the mesh's "tp" axis,
with the tree from ``parallel.shard_tree``): each rank holds H/tp heads
(its part of q, k and v, its columns of fc) and the KV cache of those
heads; proj and fc_proj are row-parallel products, all-reduced in f32
before their bias; the lm head holds a vocab slice whose logits are
gathered. Kernel A holds whole layers, so a tp run decodes with
decode_step and the plain sampler; kernel C runs on the local heads.

On the bf16 + int8 plane with a CUDA tensor, the decode step runs kernel
A (``ops.cuda.decode_trunk``) and the full-sequence passes run kernel C
(``ops.cuda.flash_attention``) once B*S^2 reaches
``cfg.flash_prefill_min_score``; on the CPU the same wrappers take their
plain versions. The f32 parity plane never dispatches to a kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from tortoise_tpu_torch.config import ARConfig
from tortoise_tpu_torch.ops import sampling as S
from tortoise_tpu_torch.ops.basic import gelu, layer_norm, pdot
from tortoise_tpu_torch.ops.cuda.decode_trunk import fused_decode_trunk
from tortoise_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_causal_qkv,
)
from tortoise_tpu_torch.parallel.mesh import local_count

NEG_INF = -1e30
DEFAULT_SAMPLER = (0.8, 50, 0.2, 2.0)  # temp, top_k, p_drop, penalty
FUSED_MAX_BATCH = 16
FUSED_MAX_TOPK = 128


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor      # (L, B, C, H*Dh)
    v: torch.Tensor      # (L, B, C, H*Dh)
    valid: torch.Tensor  # (B, C) bool — which slots hold real keys
    length: int          # next write offset
    # the same offset as a (1,) long device tensor, advanced in place by
    # each write (a step graph's cache has one; None: built from length)
    pos: Optional[torch.Tensor] = None


def _row_parallel(x, w, compute_dtype, out_dtype, tp):
    """``pdot(x, w)`` for a row-parallel weight: under tp this rank's
    partial sum, all-reduced in f32, then cast to ``out_dtype``."""
    if tp is None:
        return pdot(x, w, compute_dtype, out_dtype=out_dtype)
    out = tp.all_reduce(pdot(x, w, compute_dtype, out_dtype=torch.float32))
    return out if out_dtype is None else out.to(out_dtype)


def _attn_out_merged(block, merged, x_res, cfg: ARConfig, compute_dtype,
                     tp=None):
    """Project the merged (B, S, H*Dh) context, residual, MLP block; the
    carry stays in x_res's dtype (bf16 on the bf16/int8 planes)."""
    od = x_res.dtype if compute_dtype is not None else None
    attn = _row_parallel(merged, block["proj_w"], compute_dtype, od, tp)
    x = x_res + (attn + block["proj_b"].to(attn.dtype))
    y = layer_norm(x, block["ln2_w"], block["ln2_b"], cfg.ln_eps)
    y = pdot(y, block["fc_w"], compute_dtype, out_dtype=od)
    y = gelu(y + block["fc_b"].to(y.dtype))
    y = _row_parallel(y, block["fc_proj_w"], compute_dtype, od, tp)
    return x + (y + block["fc_proj_b"].to(y.dtype))


def flash_prefill_on(cfg: ARConfig, compute_dtype, qkv_f16: bool, shape,
                     n_head=None) -> bool:
    """True when the full-sequence passes take kernel C: bf16 plane only,
    not the qkv_f16 reproduction plane, an even number of (this rank's)
    heads, and B*S^2 >= cfg.flash_prefill_min_score over this rank's
    rows. (The JAX twin's ``have_valid`` is always true here: the port's
    trunk always has its key-validity row.)"""
    b, s = shape
    return (cfg.flash_prefill and not qkv_f16
            and compute_dtype == torch.bfloat16
            and b * s * s >= cfg.flash_prefill_min_score
            and (n_head or cfg.n_head) % 2 == 0)


def _f16_round_trip(qkv, qkv_f16: bool):
    """The reference's f16 round trip of the qkv activations
    (main.cpp:2789-2790) with ``qkv_f16``: through float16 and on in f32,
    whatever the compute dtype, as the JAX package does."""
    return qkv.to(torch.float16).float() if qkv_f16 else qkv


def _layer(blocks, l: int) -> dict:
    """Layer l of the stacked (L, ...) block tree (int8 pairs sliced
    element-wise)."""
    return {k: (v[0][l], v[1][l]) if isinstance(v, tuple) else v[l]
            for k, v in blocks.items()}


def transformer(params, x, seq_valid, cfg: ARConfig, compute_dtype=None,
                qkv_f16: bool = False, tp=None
                ) -> Tuple[torch.Tensor, list, list]:
    """The trunk over a full sequence. Returns (hidden, per-layer k list,
    per-layer v list) with k/v in the packed (B, S, H*Dh) layout (this
    rank's heads under tp). Where the JAX twin takes an additive (B, 1,
    S, S) ``bias`` third, this takes the (B, S) ``seq_valid`` row and
    builds the causal bias itself."""
    b, s, _ = x.shape
    h, dh = local_count(cfg.n_head, tp, "heads"), cfg.d_head
    hd = h * dh
    use_flash = flash_prefill_on(cfg, compute_dtype, qkv_f16, (b, s), h)
    i = torch.arange(s, device=x.device)
    bias = torch.where((i[:, None] >= i[None, :])[None]
                       & seq_valid[:, None, :], 0.0, NEG_INF)[:, None]
    ks, vs = [], []
    for l in range(cfg.n_layer):
        block = _layer(params["blocks"], l)
        y = layer_norm(x, block["ln1_w"], block["ln1_b"], cfg.ln_eps)
        if use_flash:
            qkv = pdot(y, block["attn_w"], compute_dtype,
                       out_dtype=compute_dtype)
            qkv = qkv + block["attn_b"].to(qkv.dtype)
            merged = flash_attention_causal_qkv(qkv, h, seq_valid)
            ks.append(qkv[:, :, hd:2 * hd])
            vs.append(qkv[:, :, 2 * hd:])
        else:
            qkv = _f16_round_trip(
                pdot(y, block["attn_w"], compute_dtype) + block["attn_b"],
                qkv_f16)
            q, k, v = qkv.reshape(b, s, 3, h, dh).permute(2, 0, 3, 1, 4)
            scores = pdot(q, k.transpose(-1, -2), compute_dtype) / (
                float(dh) ** 0.5)
            probs = torch.softmax((scores + bias).float(), dim=-1)
            ctx = pdot(probs.to(q.dtype), v, compute_dtype)
            merged = ctx.permute(0, 2, 1, 3).reshape(b, s, hd)
            ks.append(qkv[:, :, hd:2 * hd])
            vs.append(qkv[:, :, 2 * hd:])
        x = _attn_out_merged(block, merged, x, cfg, compute_dtype, tp)
    return x, ks, vs


def _head(params, h, cfg: ARConfig, compute_dtype=None, tp=None):
    """Final norm chain + lm head -> logits (under tp each rank's vocab
    slice, gathered)."""
    h = layer_norm(h, params["ln_f_w"], params["ln_f_b"], cfg.ln_eps)
    h = layer_norm(h, None, None, cfg.ln_eps)
    h = h * params["lm_ln_w"] + params["lm_ln_b"]
    lm_w = params["lm_w"]
    if isinstance(lm_w, tuple):  # int8 pair, pre-transposed at cast time
        logits = pdot(h, lm_w, compute_dtype) + params["lm_b"]
    else:
        logits = pdot(h, lm_w.T, compute_dtype) + params["lm_b"]
    if tp is None:
        return logits
    return tp.all_gather(logits, -1, tp.sizes(cfg.n_mel_vocab))


def _latent_head(params, h, cfg: ARConfig):
    h = layer_norm(h, params["ln_f_w"], params["ln_f_b"], cfg.ln_eps)
    h = layer_norm(h, None, None, cfg.ln_eps)
    return h * params["lm_ln_w"] + params["lm_ln_b"]


def _embed(params, text_ids, text_valid, mel_ids, mel_pos, voice, cfg):
    b = text_ids.shape[0]
    voice = voice.float().expand(b, cfg.d_model)
    pos = torch.where(text_valid, torch.cumsum(text_valid.long(), -1) - 1, 0)
    text = params["text_emb"][text_ids.long()] + params["text_pos"][pos]
    mel = params["mel_emb"][mel_ids.long()] + params["mel_pos"][mel_pos]
    return torch.cat([voice[:, None, :], text, mel], dim=1)


def prefill(params, cfg: ARConfig, text_ids, text_valid, voice,
            compute_dtype=None, qkv_f16: bool = False, tp=None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Prefill over [latent | text | start-mel]: returns next-token logits
    (B, V) and the primed KV cache. text_ids/text_valid (B, Tpad);
    voice (D,) or (B, D); ``qkv_f16`` the reference's f16 round trip of
    the qkv activations (kernel C stays off)."""
    b, t = text_ids.shape
    dev = text_ids.device
    start = torch.full((b, 1), cfg.start_mel_token, dtype=torch.long,
                       device=dev)
    x = _embed(params, text_ids, text_valid, start,
               torch.zeros((b, 1), dtype=torch.long, device=dev), voice, cfg)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    ones = torch.ones((b, 1), dtype=torch.bool, device=dev)
    seq_valid = torch.cat([ones, text_valid, ones], dim=1)
    h, ks, vs = transformer(params, x, seq_valid, cfg, compute_dtype,
                            qkv_f16, tp=tp)
    logits = _head(params, h[:, -1, :], cfg, compute_dtype, tp)
    s = x.shape[1]
    cache_dtype = compute_dtype or torch.float32
    k = torch.zeros((cfg.n_layer, b, cfg.cache_len,
                     local_count(cfg.n_head, tp, "heads") * cfg.d_head),
                    dtype=cache_dtype, device=dev)
    v = torch.zeros_like(k)
    k[:, :, :s] = torch.stack(ks).to(cache_dtype)
    v[:, :, :s] = torch.stack(vs).to(cache_dtype)
    valid = torch.zeros((b, cfg.cache_len), dtype=torch.bool, device=dev)
    valid[:, :s] = seq_valid
    return logits, KVCache(k, v, valid, s)


def _fits_fused(batch: int) -> bool:
    return batch <= FUSED_MAX_BATCH


def _int8_plane(params, compute_dtype) -> bool:
    return (compute_dtype == torch.bfloat16
            and isinstance(params["blocks"].get("attn_w"), tuple))


def can_fuse_sampling(params, cfg: ARConfig, compute_dtype, batch: int,
                      sampler: tuple = DEFAULT_SAMPLER) -> bool:
    """True when decode_sample_step's kernel plane applies: B <= 16, bf16
    compute, int8 weights with the padded head pack, top_k <= 128."""
    return (cfg.fused_decode and _fits_fused(batch)
            and sampler[1] <= FUSED_MAX_TOPK
            and _int8_plane(params, compute_dtype)
            and params.get("head_pack") is not None)


def _step_index(step, device) -> torch.Tensor:
    """``step`` (an int, or already a (1,) long device tensor) as a (1,)
    long tensor on ``device``."""
    if isinstance(step, torch.Tensor):
        return step
    return torch.full((1,), step, dtype=torch.long, device=device)


def _write_rows(cache: KVCache, k_rows, v_rows) -> KVCache:
    """Write one step's (L, B, H*Dh) rows in place at the device index
    ``cache.pos`` (advanced in place) or, without one, at slot
    cache.length."""
    slot = _step_index(cache.length if cache.pos is None else cache.pos,
                       cache.k.device)
    cache.k.index_copy_(2, slot, k_rows.to(cache.k.dtype)[:, :, None])
    cache.v.index_copy_(2, slot, v_rows.to(cache.v.dtype)[:, :, None])
    cache.valid.index_fill_(1, slot, True)
    if cache.pos is not None:
        cache.pos.add_(1)
    return KVCache(cache.k, cache.v, cache.valid, cache.length + 1,
                   cache.pos)


def _embed_step(params, tokens, step):
    """The tokens' mel embeddings plus mel position ``step`` + 2, read at
    a device index (``step`` an int or a (1,) long device tensor)."""
    pos = _step_index(step, tokens.device) + 2
    return (params["mel_emb"][tokens.long()]
            + params["mel_pos"].index_select(0, pos))


def decode_step(params, cfg: ARConfig, cache: KVCache, tokens, step: int,
                compute_dtype=None, qkv_f16: bool = False, tp=None,
                split_rows=None) -> Tuple[torch.Tensor, KVCache]:
    """One decode step: tokens (B,) sampled ids, ``step`` the 0-based
    decode index (an int, or a (1,) long device tensor as a step graph
    carries it). Returns (logits (B, V), cache) — the cache tensors are
    updated in place (slot ``cache.pos``, else cache.length) and returned
    in a new KVCache.
    ``qkv_f16``: the reference's f16 round trip of the qkv activations
    (kernel A has none, so it stays off). ``split_rows``: kernel A's
    ``split_rows`` (a dp rank's global batch)."""
    b = tokens.shape[0]
    if (tp is None and not qkv_f16 and cfg.fused_decode
            and _int8_plane(params, compute_dtype) and _fits_fused(b)):
        x = _embed_step(params, tokens, step)
        bias_row = torch.where(cache.valid, 0.0, NEG_INF).float()
        head = params.get("head_pack")
        out = fused_decode_trunk(params["blocks"], cache.k, cache.v,
                                 bias_row, x.float(), head=head,
                                 n_head=cfg.n_head, eps=cfg.ln_eps,
                                 split_rows=split_rows)
        if head is not None:
            _, k_rows, v_rows, logits_pad = out
            logits = logits_pad[:, :params["lm_b"].shape[0]]
        else:
            hidden, k_rows, v_rows = out
            logits = _head(params, hidden, cfg, compute_dtype)
        return logits, _write_rows(cache, k_rows, v_rows)
    h_, dh = local_count(cfg.n_head, tp, "heads"), cfg.d_head
    x = _embed_step(params, tokens, step)
    bias = torch.where(cache.valid, 0.0, NEG_INF)[:, None, :]     # (B,1,C)
    scale = float(dh) ** 0.5
    k_rows, v_rows = [], []
    for l in range(cfg.n_layer):
        block = _layer(params["blocks"], l)
        y = layer_norm(x, block["ln1_w"], block["ln1_b"], cfg.ln_eps)
        qkv = _f16_round_trip(
            pdot(y, block["attn_w"], compute_dtype) + block["attn_b"],
            qkv_f16)
        qkv = qkv.reshape(b, 3, h_, dh)
        q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        k4 = cache.k[l].reshape(b, -1, h_, dh)
        v4 = cache.v[l].reshape(b, -1, h_, dh)
        qc = q.to(compute_dtype) if compute_dtype else q
        scores = torch.einsum("bhd,bchd->bhc", qc.float(),
                              k4.to(qc.dtype).float()) / scale + bias
        self_score = ((q.float() * k_new.float()).sum(-1) / scale)[..., None]
        m = torch.maximum(scores.amax(dim=-1, keepdim=True), self_score)
        e_cache = torch.exp(scores - m)
        e_self = torch.exp(self_score - m)
        denom = e_cache.sum(dim=-1, keepdim=True) + e_self
        ctx = (torch.einsum("bhc,bchd->bhd", e_cache.to(qc.dtype).float(),
                            v4.to(qc.dtype).float())
               + e_self * v_new.float()) / denom
        attn = _row_parallel(ctx.reshape(b, h_ * dh), block["proj_w"],
                             compute_dtype, None, tp) + block["proj_b"]
        x = x + attn
        y = layer_norm(x, block["ln2_w"], block["ln2_b"], cfg.ln_eps)
        y = gelu(pdot(y, block["fc_w"], compute_dtype) + block["fc_b"])
        x = x + _row_parallel(y, block["fc_proj_w"], compute_dtype, None,
                              tp) + block["fc_proj_b"]
        k_rows.append(k_new.reshape(b, h_ * dh))
        v_rows.append(v_new.reshape(b, h_ * dh))
    logits = _head(params, x, cfg, compute_dtype, tp)
    return logits, _write_rows(cache, torch.stack(k_rows),
                               torch.stack(v_rows))


def decode_sample_step(params, cfg: ARConfig, cache: KVCache, tokens,
                       step: int, u, compute_dtype=None,
                       sampler: tuple = DEFAULT_SAMPLER, split_rows=None,
                       qkv_f16: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """decode_step plus the full sampler in kernel A against pre-drawn
    uniforms u (B, 1) f32. Returns (sampled tokens (B,) int32, cache).
    Kernel A has no f16 round trip of the qkv activations, so with
    ``qkv_f16`` this is decode_step(qkv_f16=True) and the plain sampler
    on the same uniforms (the JAX package's sampling loop takes that
    plane there too)."""
    if qkv_f16:
        logits, cache = decode_step(params, cfg, cache, tokens, step,
                                    compute_dtype, qkv_f16)
        probs, ids = S.process_logits_topk(logits, tokens[:, None].long(),
                                           *sampler)
        return S.sample_from_topk_u(u.reshape(-1, 1), probs, ids), cache
    b = tokens.shape[0]
    x = _embed_step(params, tokens, step)
    bias_row = torch.where(cache.valid, 0.0, NEG_INF).float()
    _, k_rows, v_rows, _, tok = fused_decode_trunk(
        params["blocks"], cache.k, cache.v, bias_row, x.float(),
        head=params["head_pack"],
        prev_u=(tokens.reshape(b, 1).to(torch.int32), u.reshape(b, 1)),
        sampler=sampler, n_head=cfg.n_head, eps=cfg.ln_eps,
        split_rows=split_rows)
    return tok[:, 0], _write_rows(cache, k_rows, v_rows)


def latent_forward(params, cfg: ARConfig, text_ids, text_valid, mel_ids,
                   voice, compute_dtype=None, qkv_f16: bool = False,
                   tp=None) -> torch.Tensor:
    """Full-sequence pass over [latent | text | 502 mel codes]; returns
    the (B, 500, D) speech-conditioning latents (mel positions 0..501).
    ``qkv_f16`` as in ``prefill``."""
    b, t = text_ids.shape
    m = mel_ids.shape[1]
    dev = text_ids.device
    mel_pos = torch.arange(m, device=dev).expand(b, m)
    x = _embed(params, text_ids, text_valid, mel_ids, mel_pos, voice, cfg)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    seq_valid = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                           text_valid,
                           torch.ones((b, m), dtype=torch.bool, device=dev)],
                          dim=1)
    h, _, _ = transformer(params, x, seq_valid, cfg, compute_dtype, qkv_f16,
                          tp=tp)
    h = _latent_head(params, h, cfg)
    return h[:, 1 + t:1 + t + m - 2]
