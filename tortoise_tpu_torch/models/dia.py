"""Dia-1.6B: the encoder-decoder speech LM of nari-labs/dia
(``dia/config.py``, ``dia/layers.py``; the Dia-1.6B checkpoint's
``config.json``), a model family of its own beside Tortoise's and F5's.

- text: UTF-8 bytes (``[S1]`` and ``[S2]`` as bytes 0x01 and 0x02,
  ``tokenize``) through an embedding of 256;
- encoder: ``enc_layers`` pre-norm blocks (RMSNorm; self-attention with
  rotary q and k, rotate-half, theta 1e4, scale 1; a gated-SiLU MLP), a
  final RMSNorm;
- decoder: ``dec_layers`` blocks, each GQA self-attention (rotary, scale
  1, causal, over a K/V cache), cross-attention over the encoder's output
  (no rotary, scale 1, its K/V computed once a request), a gated-SiLU
  MLP, three pre-norms; a final RMSNorm and one head to ``channels`` x
  ``vocab`` logits;
- input: the ``channels`` codebooks' embeddings summed (one table, the
  codes offset by c * vocab).

Both CFG rows (conditioned, unconditioned) run as a batch of two. Maps
are time-major (B, T, C). Every attention runs kernel D's generic body
D2 (``ops.cuda.flash_attention.flash_attention``, scale 1, f32 out): the
encoder and every cross-attention with the text's key mask; the
prefill's causal self-attention with each K/V head repeated over its
query heads; the decode step's single query with each K/V head's query
heads folded into as many query rows over the cache, keys past the
step's position masked.

Precision: with ``compute_dtype`` (bf16) every product takes operands in
it with f32 sums (``ops.basic.pdot``, kernel D on bf16 q, k, v); the
residual stream, the norms, the rotary and the softmax's statistics are
f32. Without it, everything is f32.

Layout: the self-attention's q, k and v are one product a layer, each
head's q and k dims in ``pair_order`` so the rotary is one in-place
complex product on adjacent pairs (the K/V cache holds k in that order;
q k is unchanged by it).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops.basic import pdot
from tortoise_tpu_torch.ops.cuda import flash_attention as kernel_d
from tortoise_tpu_torch.ops.cuda.flash_attention import (
    NEG_INF,
    flash_attention,
)


@dataclasses.dataclass(frozen=True)
class DiaConfig:
    """``DiaConfig``'s defaults (the Dia-1.6B widths) and the sampler of
    this port's cell."""
    enc_layers: int = 12
    enc_dim: int = 1024
    enc_heads: int = 16
    enc_kv_heads: int = 16
    enc_head_dim: int = 128
    enc_ffn: int = 4096
    enc_vocab: int = 256
    dec_layers: int = 18
    dec_dim: int = 2048
    dec_heads: int = 16
    dec_kv_heads: int = 4
    dec_head_dim: int = 128
    cross_heads: int = 16
    cross_head_dim: int = 128
    dec_ffn: int = 8192
    channels: int = 9
    vocab: int = 1028
    delay: Tuple[int, ...] = (0, 8, 9, 10, 11, 12, 13, 14, 15)
    eos: int = 1024
    pad: int = 1025
    bos: int = 1026
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_positions: int = 3072
    guidance: float = 3.0
    guidance_top_k: int = 45
    temperature: float = 1.2
    top_p: float = 0.95

    @property
    def max_delay(self) -> int:
        return max(self.delay)


def tiny_dia_config() -> DiaConfig:
    """The CPU tests' size: 2 + 2 layers of width 64, 4 heads of 16 (2
    K/V heads in the decoder's self-attention), 3 channels of 40 codes
    (36 audio codes and the 4 specials), delay (0, 2, 3)."""
    return DiaConfig(enc_layers=2, enc_dim=64, enc_heads=4, enc_kv_heads=4,
                     enc_head_dim=16, enc_ffn=128, dec_layers=2, dec_dim=64,
                     dec_heads=4, dec_kv_heads=2, dec_head_dim=16,
                     cross_heads=4, cross_head_dim=16, dec_ffn=128,
                     channels=3, vocab=40, delay=(0, 2, 3), eos=36, pad=37,
                     bos=38, max_positions=512, guidance_top_k=8)


def param_shapes(cfg: DiaConfig) -> dict:
    """The weight tree's shapes, torch layouts ((out, in) linears), the
    per-layer tensors stacked over the layers. Names ending in ``norm``
    are RMSNorm weights; ``q`` and ``ca_q`` the query projections."""
    e, d = cfg.enc_dim, cfg.dec_dim
    ne, nd = cfg.enc_layers, cfg.dec_layers
    eh, ekv = cfg.enc_heads * cfg.enc_head_dim, \
        cfg.enc_kv_heads * cfg.enc_head_dim
    dh, dkv = cfg.dec_heads * cfg.dec_head_dim, \
        cfg.dec_kv_heads * cfg.dec_head_dim
    ch = cfg.cross_heads * cfg.cross_head_dim
    return {
        "encoder": {"emb": (cfg.enc_vocab, e),
                    "sa_norm": (ne, e), "q": (ne, eh, e), "k": (ne, ekv, e),
                    "v": (ne, ekv, e), "o": (ne, e, eh),
                    "mlp_norm": (ne, e), "gate_up": (ne, 2 * cfg.enc_ffn, e),
                    "down": (ne, e, cfg.enc_ffn),
                    "norm": (e,)},
        "decoder": {"emb": (cfg.channels * cfg.vocab, d),
                    "sa_norm": (nd, d), "q": (nd, dh, d), "k": (nd, dkv, d),
                    "v": (nd, dkv, d), "o": (nd, d, dh),
                    "ca_norm": (nd, d), "ca_q": (nd, ch, d),
                    "ca_k": (nd, ch, e), "ca_v": (nd, ch, e),
                    "ca_o": (nd, d, ch),
                    "mlp_norm": (nd, d), "gate_up": (nd, 2 * cfg.dec_ffn, d),
                    "down": (nd, d, cfg.dec_ffn),
                    "norm": (d,), "head": (cfg.channels * cfg.vocab, d)},
    }


def tokenize(text: str) -> list:
    """DiaTokenizer: the UTF-8 bytes of ``text``, with ``[S1]`` and
    ``[S2]`` as the single bytes 1 and 2."""
    return list(text.replace("[S1]", "\x01").replace("[S2]", "\x02")
                .encode("utf-8"))


def prepare(params, cfg: DiaConfig, compute_dtype=None) -> dict:
    """The device tree the passes read: every product's weight in
    ``compute_dtype`` (f32 without it), the self-attention's q, k and v
    fused into one (out, in) weight a layer, each head's q and k rows in
    ``pair_order`` (so the rotary acts on adjacent pairs; a common order
    of q's and k's dims changes no product q k); norm weights and the
    embeddings in f32."""
    dt = compute_dtype or torch.float32
    out = {}
    for part in ("encoder", "decoder"):
        p = params[part]
        tree = {k: v.float().contiguous() for k, v in p.items()
                if k.endswith("norm") or k == "emb"}
        d = cfg.enc_head_dim if part == "encoder" else cfg.dec_head_dim
        q, k = (pair_order(p[n], d) for n in "qk")
        tree["qkv"] = torch.cat([q, k, p["v"]], dim=1).to(dt).contiguous()
        for k in p:
            if k not in tree and k not in ("q", "k", "v"):
                tree[k] = p[k].to(dt).contiguous()
        out[part] = tree
    return out


def pair_order(w, d: int):
    """The (..., heads * d, in) rows of a q or k projection with each
    head's dims in the order 0, d/2, 1, d/2 + 1, ...: rotate-half's pairs
    (i, i + d/2) side by side."""
    half = torch.arange(d // 2, device=w.device)
    perm = torch.stack([half, half + d // 2], dim=-1).flatten()
    heads = w.shape[-2] // d
    return w.unflatten(-2, (heads, d))[..., perm, :].flatten(-3, -2)


def rms_norm(x, w, eps):
    """RMSNorm in f32: x / sqrt(mean(x^2) + eps) * w (one fused kernel on
    a card)."""
    return F.rms_norm(x.float(), w.shape, w, eps)


def _lin(x, w, cd):
    """``x @ w.T`` with f32 sums and output (operands in ``cd``)."""
    return pdot(x, w.T, cd, torch.float32)


@functools.cache
def rope_table(n: int, d: int, theta: float, device) -> torch.Tensor:
    """(n, d / 2) complex64 e^(i angle) of positions 0..n-1, the angles
    of rotate-half's pairs (inv_freq 1 / theta^(2i / d)). Cached, never
    dropped: a captured step graph reads it by address."""
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.int64,
                                        device=device).float() / d))
    f = torch.arange(n, device=device).float()[:, None] * inv[None]
    return torch.polar(torch.ones_like(f), f)


def rotate_qk(qkv, q_heads, kv_heads, d, cis, dt):
    """(q, k, v) of a fused f32 (B, T, (H + 2 KV) D) product whose q and
    k dims are in ``pair_order``: q and k rotated in place (each adjacent
    pair a complex number times the (T, D / 2) ``cis``), then all three
    in ``dt``, each (B, T, heads, D)."""
    b, t, _ = qkv.shape
    qk = qkv[..., :(q_heads + kv_heads) * d].unflatten(
        -1, (q_heads + kv_heads, d // 2, 2))
    z = torch.view_as_complex(qk)
    z.mul_(cis[..., None, :])
    x = qkv.to(dt).unflatten(-1, (q_heads + 2 * kv_heads, d))
    return x.split([q_heads, kv_heads, kv_heads], dim=-2)


def _heads(x, h):
    """(B, T, H*D) -> (B, H, T, D) view."""
    b, t, _ = x.shape
    return x.view(b, t, h, -1).transpose(1, 2)


def _merge(ctx, dt):
    """(B, H, T, D) f32 context -> (B, T, H*D) in ``dt``."""
    b, h, t, d = ctx.shape
    return ctx.transpose(1, 2).reshape(b, t, h * d).to(dt)


def key_mask(valid):
    """(B, T) bool -> the additive f32 key mask kernel D takes."""
    return torch.where(valid, 0.0, NEG_INF).to(torch.float32)


def _mlp(p, l, x, cfg_ffn, eps, cd):
    h = rms_norm(x, p["mlp_norm"][l], eps)
    gu = _lin(h, p["gate_up"][l], cd)
    g, u = gu.split(cfg_ffn, dim=-1)
    return _lin(F.silu(g) * u, p["down"][l], cd)


def encode(prep, cfg: DiaConfig, rows, valid, compute_dtype=None):
    """The encoder over (B, T) byte ids ``rows`` with (B, T) bool key
    ``valid``: (B, T, enc_dim) f32."""
    p, cd = prep["encoder"], compute_dtype
    dt = cd or torch.float32
    h, kvh, hd = cfg.enc_heads, cfg.enc_kv_heads, cfg.enc_head_dim
    t = rows.shape[1]
    cis = rope_table(cfg.max_positions, hd, cfg.rope_theta,
                     rows.device)[:t]
    x = p["emb"][rows]
    for l in range(cfg.enc_layers):
        y = rms_norm(x, p["sa_norm"][l], cfg.norm_eps)
        q, k, v = rotate_qk(_lin(y, p["qkv"][l], cd), h, kvh, hd, cis, dt)
        ctx = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), kv_valid=valid, scale=1.0)
        x = x + _lin(_merge(ctx, dt), p["o"][l], cd)
        x = x + _mlp(p, l, x, cfg.enc_ffn, cfg.norm_eps, cd)
    return rms_norm(x, p["norm"], cfg.norm_eps)


def cross_kv(prep, cfg: DiaConfig, enc, compute_dtype=None):
    """Every decoder layer's cross-attention K and V of the encoder's
    output ``enc`` (B, T, enc_dim): two (layers, B, heads, T, D) tensors
    in ``compute_dtype``."""
    p, cd = prep["decoder"], compute_dtype
    dt = cd or torch.float32
    h = cfg.cross_heads
    ks, vs = [], []
    for l in range(cfg.dec_layers):
        ks.append(_heads(_lin(enc, p["ca_k"][l], cd).to(dt), h))
        vs.append(_heads(_lin(enc, p["ca_v"][l], cd).to(dt), h))
    return torch.stack(ks), torch.stack(vs)


def embed_codes(prep, cfg: DiaConfig, codes):
    """(..., channels) codes -> (..., dec_dim) f32: the channels'
    embeddings (codes offset by c * vocab in one table), summed."""
    off = torch.arange(cfg.channels, device=codes.device) * cfg.vocab
    return prep["decoder"]["emb"][codes + off].sum(-2)


def logits_of(prep, cfg: DiaConfig, x, compute_dtype=None):
    """The head over the final norm: (..., dec_dim) -> (..., channels,
    vocab) f32."""
    p = prep["decoder"]
    y = rms_norm(x, p["norm"], cfg.norm_eps)
    return _lin(y, p["head"], compute_dtype).unflatten(
        -1, (cfg.channels, cfg.vocab))


def prefill(prep, cfg: DiaConfig, codes, cache_k, cache_v, cross_k,
            cross_v, text_mask, compute_dtype=None):
    """The decoder over positions 0..T-1 of the (T, channels) codes, both
    rows, causal, the cross-attention under the additive ``text_mask``:
    writes each layer's rotated K and V into ``cache_k``/``cache_v``
    (layers, 2, kv_heads, >= T, D) at [0, T)."""
    p, cd = prep["decoder"], compute_dtype
    dt = cd or torch.float32
    h, kvh, hd = cfg.dec_heads, cfg.dec_kv_heads, cfg.dec_head_dim
    t = codes.shape[0]
    cis = rope_table(cfg.max_positions, hd, cfg.rope_theta,
                     codes.device)[:t]
    x = embed_codes(prep, cfg, codes)[None].expand(2, t, -1)
    for l in range(cfg.dec_layers):
        y = rms_norm(x, p["sa_norm"][l], cfg.norm_eps)
        q, k, v = rotate_qk(_lin(y, p["qkv"][l], cd), h, kvh, hd, cis, dt)
        k, v = k.transpose(1, 2), v.transpose(1, 2)
        cache_k[l, :, :, :t].copy_(k)
        cache_v[l, :, :, :t].copy_(v)
        rep = h // kvh
        ctx = flash_attention(q.transpose(1, 2),
                              k.repeat_interleave(rep, dim=1),
                              v.repeat_interleave(rep, dim=1), causal=True,
                              scale=1.0)
        x = x + _lin(_merge(ctx, dt), p["o"][l], cd)
        x = x + _cross(p, l, x, cross_k[l], cross_v[l], text_mask, cfg, cd)
        x = x + _mlp(p, l, x, cfg.dec_ffn, cfg.norm_eps, cd)
    return x


def decode_step(prep, cfg: DiaConfig, codes, pos, cache_k, cache_v,
                cross_k, cross_v, self_mask, text_mask, compute_dtype=None):
    """One position of both rows: ``codes`` (1, channels) long, ``pos``
    (1,) long on the device. Writes the position's K and V into the
    cache at ``pos`` and attends over the cache under the additive
    ``self_mask`` (2, T_cache) (keys past ``pos`` masked), then over the
    text under ``text_mask`` (2, T_text). Returns (2, channels, vocab)
    f32 logits."""
    p, cd = prep["decoder"], compute_dtype
    dt = cd or torch.float32
    h, kvh, hd = cfg.dec_heads, cfg.dec_kv_heads, cfg.dec_head_dim
    rep = h // kvh
    cis = rope_table(cfg.max_positions, hd, cfg.rope_theta,
                     codes.device)[pos]
    x = embed_codes(prep, cfg, codes).expand(2, 1, -1)
    for l in range(cfg.dec_layers):
        y = rms_norm(x, p["sa_norm"][l], cfg.norm_eps)
        q, k, v = rotate_qk(_lin(y, p["qkv"][l], cd), h, kvh, hd, cis, dt)
        cache_k[l].index_copy_(2, pos, k.transpose(1, 2))
        cache_v[l].index_copy_(2, pos, v.transpose(1, 2))
        # each K/V head's query heads as query rows: (2, kv_heads, rep, D)
        ctx = _attend_rows(q.reshape(2, kvh, rep, hd), cache_k[l],
                           cache_v[l], self_mask)
        x = x + _lin(ctx.view(2, 1, h * hd).to(dt), p["o"][l], cd)
        x = x + _cross(p, l, x, cross_k[l], cross_v[l], text_mask, cfg, cd)
        x = x + _mlp(p, l, x, cfg.dec_ffn, cfg.norm_eps, cd)
    return logits_of(prep, cfg, x[:, 0], cd)


def _attend_rows(q, k, v, mask_add):
    """Kernel D2 of query rows ``q`` (B, H, R, D) over (B, H, T, D) keys
    with an additive (B, T) key mask built once by the caller (the
    decode step's masks serve every layer), scale 1: (B, H, R, D) f32,
    contiguous. A CPU q takes D2's plain twin."""
    if not q.is_cuda:
        return kernel_d._attend(q, k, v, mask_add[:, None, None, :], 1.0,
                                torch.float32)
    out = torch.empty(q.shape, device=q.device, dtype=torch.float32)
    kernel_d._generic_flash(q, k, v, out, None, None, mask_add, False, 1.0)
    return out


def _cross(p, l, x, ck, cv, text_mask, cfg, cd):
    """The cross-attention branch of layer ``l`` over the text's K/V
    under the additive (B, T_text) ``text_mask``."""
    dt = cd or torch.float32
    y = rms_norm(x, p["ca_norm"][l], cfg.norm_eps)
    q = _heads(_lin(y, p["ca_q"][l], cd).to(dt), cfg.cross_heads)
    ctx = _attend_rows(q, ck, cv, text_mask)
    return _lin(_merge(ctx, dt), p["ca_o"][l], cd)
