"""F5-TTS v1 Base: the flow-matching DiT of SWivid/F5-TTS
(``src/f5_tts/model/backbones/dit.py``, ``model/modules.py``;
arXiv:2410.06885), a model family of its own beside Tortoise's.

- time: sinusoidal embedding of 1000 t (256 wide), Linear, SiLU, Linear;
- text: char embedding (ids + 1, 0 the filler) plus a [cos | sin]
  position table, then ConvNeXt-V2 blocks (depthwise conv k 7, LN,
  Linear, exact GELU, GRN, Linear, residual), run once a request for
  both CFG rows (the unconditioned row embeds the filler everywhere);
- input: Linear of [noisy mel | cond mel | text], plus the conv position
  embedding: two grouped convs (k 31, 16 groups) with Mish, a residual
  (kernel CP, ``ops.cuda.conv_pos``);
- ``depth`` DiT blocks: AdaLN-Zero on the time embedding (shift, scale,
  gate of each branch), attention with rotary q and k on every head
  through kernel B (``ops.cuda.flash_attention``), tanh-GELU FFN;
- out: AdaLN (scale, shift), Linear to the mel bins.

Maps are time-major (B, T, C). A padded batch (T rounded up to the
loop's bucket) takes ``frame_mask`` (B, T, 1) bool: padded frames are
zeroed before every convolution, are keys no query sees (kernel B's key
mask) and are left out of the GRN's norm over time, so the real frames
equal the unpadded model's. The text's own padding (positions at or
past its length, within T) is zeroed as upstream does.

Precision: with ``compute_dtype`` (bf16) every product takes operands
in that dtype with f32 sums (``ops.basic.pdot``; the convolutions run
in it), and the residual stream is kept in it; norms compute in f32.
Without it, everything is f32. The attention's q, k, v are one fused
product laid out per head as kernel B takes them (c = h*3D + part*D +
d, ``prepare``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from tortoise_tpu_torch.ops.basic import conv1d_tm, pdot, zero_frames
from tortoise_tpu_torch.ops.cuda import conv_pos
from tortoise_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_packed,
    launch_packed,
)

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class F5Config:
    """F5TTS_v1_Base.yaml's model (its ``arch``) and the inference
    defaults of ``infer/utils_infer.py`` (nfe 32, sway -1, CFG 2)."""
    dim: int = 1024
    depth: int = 22
    heads: int = 16
    ff_mult: int = 2
    text_dim: int = 512
    text_vocab: int = 2545
    conv_layers: int = 4
    conv_mult: int = 2
    mel_dim: int = 100
    conv_pos_kernel: int = 31
    conv_pos_groups: int = 16
    freq_embed_dim: int = 256
    text_max_pos: int = 4096
    ln_eps: float = 1e-6
    nfe: int = 32
    sway: float = -1.0
    cfg_strength: float = 2.0
    max_frames: int = 4096

    @property
    def d_head(self) -> int:
        return self.dim // self.heads


def tiny_f5_config() -> F5Config:
    """The CPU tests' size: 2 blocks, dim 64, 4 heads of 16, text 32, one
    ConvNeXt block."""
    return F5Config(dim=64, depth=2, heads=4, text_dim=32, text_vocab=40,
                    conv_layers=1, conv_pos_groups=4)


def param_shapes(cfg: F5Config) -> dict:
    """The weight tree's shapes, torch layouts ((out, in) linears,
    (out, in / groups, k) convs), per-block tensors stacked over the
    blocks."""
    d, td, n, m = cfg.dim, cfg.text_dim, cfg.depth, cfg.mel_dim
    ff, ti, nt = d * cfg.ff_mult, td * cfg.conv_mult, cfg.conv_layers
    conv = (d, d // cfg.conv_pos_groups, cfg.conv_pos_kernel)
    return {
        "time": {"w0": (d, cfg.freq_embed_dim), "b0": (d,),
                 "w1": (d, d), "b1": (d,)},
        "text": {"emb": (cfg.text_vocab + 1, td),
                 "dw_w": (nt, td, 7), "dw_b": (nt, td),
                 "ln_w": (nt, td), "ln_b": (nt, td),
                 "pw1_w": (nt, ti, td), "pw1_b": (nt, ti),
                 "grn_g": (nt, ti), "grn_b": (nt, ti),
                 "pw2_w": (nt, td, ti), "pw2_b": (nt, td)},
        "input": {"w": (d, 2 * m + td), "b": (d,),
                  "pos1_w": conv, "pos1_b": (d,),
                  "pos2_w": conv, "pos2_b": (d,)},
        "blocks": {"ada_w": (n, 6 * d, d), "ada_b": (n, 6 * d),
                   "q_w": (n, d, d), "q_b": (n, d),
                   "k_w": (n, d, d), "k_b": (n, d),
                   "v_w": (n, d, d), "v_b": (n, d),
                   "o_w": (n, d, d), "o_b": (n, d),
                   "ff1_w": (n, ff, d), "ff1_b": (n, ff),
                   "ff2_w": (n, d, ff), "ff2_b": (n, d)},
        "out": {"ada_w": (2 * d, d), "ada_b": (2 * d,),
                "w": (m, d), "b": (m,)},
    }


def _lin(x, w, b, cd=None, out_dtype=None):
    """``x @ w.T + b`` on ``ops.basic.pdot``: with ``cd`` the operands in
    it and f32 sums, out in ``out_dtype`` (default ``cd``)."""
    if cd is None:
        return pdot(x, w.T) + b
    od = out_dtype or cd
    return pdot(x, w.T, cd, od) + b.to(od)


def _layer_norm(x, eps, w=None, b=None):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def prepare(params, cfg: F5Config, compute_dtype=None) -> dict:
    """The device tree the loop reads: every weight in ``compute_dtype``
    (f32 without it); q, k, v fused per head as kernel B takes them;
    every block's AdaLN linear and the output's stacked into one product
    a step (their inputs are the same SiLU(t)); where kernel CP takes
    the conv position embedding's weights, their tap tiles."""
    dt = compute_dtype or torch.float32
    cast = functools.partial(_cast_tree, dtype=dt)
    b = params["blocks"]
    n, d, h = cfg.depth, cfg.dim, cfg.heads

    def per_head(part):  # (n, d, ...) -> (n, h, 1, D, ...)
        return part.reshape(n, h, 1, d // h, *part.shape[2:])

    qkv_w = torch.cat([per_head(b[f"{p}_w"]) for p in "qkv"], dim=2)
    qkv_b = torch.cat([per_head(b[f"{p}_b"]) for p in "qkv"], dim=2)
    out = params["out"]
    blocks = {k: v for k, v in b.items()
              if k[0] not in "qkv" and not k.startswith("ada")}
    blocks["qkv_w"] = qkv_w.reshape(n, 3 * d, d)
    blocks["qkv_b"] = qkv_b.reshape(n, 3 * d)
    inp = cast(params["input"])
    if conv_pos.takes_weights(inp["pos1_w"], cfg.conv_pos_groups):
        inp["pos_tiles"] = tuple(
            conv_pos.weight_tiles(inp[k], cfg.conv_pos_groups)
            for k in ("pos1_w", "pos2_w"))
    return {
        "time": cast(params["time"]),
        "text": {k: v.float() for k, v in params["text"].items()},
        "input": inp,
        "blocks": cast(blocks),
        "ada_w": cast(torch.cat([b["ada_w"].reshape(n * 6 * d, d),
                                 out["ada_w"]])),
        "ada_b": cast(torch.cat([b["ada_b"].reshape(-1), out["ada_b"]])),
        "out_w": cast(out["w"]), "out_b": cast(out["b"]),
    }


def _cast_tree(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    return tree.to(dtype).contiguous()


def time_embedding(prep, cfg: F5Config, t, compute_dtype=None):
    """(B,) times -> (B, dim) time embeddings."""
    half = cfg.freq_embed_dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32,
                                   device=t.device)
                      * -(math.log(10000) / (half - 1)))
    e = 1000.0 * t.float()[:, None] * freqs[None]
    e = torch.cat([e.sin(), e.cos()], dim=-1)
    p = prep["time"]
    h = F.silu(_lin(e, p["w0"], p["b0"], compute_dtype, torch.float32))
    return _lin(h, p["w1"], p["b1"], compute_dtype, torch.float32)


@functools.cache
def text_table(dim: int, end: int, device) -> torch.Tensor:
    """``precompute_freqs_cis(dim, end)``: (end, dim) [cos | sin], f32.
    Cached per device, never dropped (a few MB)."""
    freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, device=device)
                               [:dim // 2].float() / dim))
    f = torch.outer(torch.arange(end, device=device).float(), freqs)
    return torch.cat([torch.cos(f), torch.sin(f)], dim=-1)


def text_embed(prep, cfg: F5Config, idx, text_len: int, frame_mask=None,
               compute_dtype=None):
    """Both CFG rows' text features (2, T, text_dim) in f32. ``idx`` (T,)
    long: the ids + 1 of the text, 0 past its ``text_len``;
    ``frame_mask`` (1, T, 1) marks the request's frames (None: all)."""
    p = prep["text"]
    t = idx.shape[0]
    keep = (torch.arange(t, device=idx.device) < text_len)[None, :, None]
    rows = torch.stack([idx, torch.zeros_like(idx)])
    x = p["emb"][rows] + text_table(cfg.text_dim, cfg.text_max_pos,
                                    idx.device)[:t]
    x = zero_frames(x, keep)
    cd = compute_dtype
    for l in range(cfg.conv_layers):
        y = conv1d_tm(x, p["dw_w"][l][:, None], p["dw_b"][l], cd,
                      groups=cfg.text_dim).float()
        y = _layer_norm(y, cfg.ln_eps, p["ln_w"][l], p["ln_b"][l])
        y = F.gelu(_lin(y, p["pw1_w"][l], p["pw1_b"][l], cd, torch.float32))
        y = grn(y, p["grn_g"][l], p["grn_b"][l], frame_mask)
        x = zero_frames(x + _lin(y, p["pw2_w"][l], p["pw2_b"][l], cd,
                                 torch.float32), keep)
    return x


def grn(x, g, b, frame_mask=None):
    """GRN over (B, T, C): the L2 norm over the frames of ``frame_mask``."""
    gx = torch.linalg.vector_norm(zero_frames(x, frame_mask), dim=1,
                                  keepdim=True)
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    return g * (x * nx) + b + x


@functools.cache
def rope_table(t: int, d: int, device) -> torch.Tensor:
    """(T, D / 2) complex64 e^(i angle) of the rotary angles (base 1e4),
    one a pair. Cached per length, never dropped: a captured step graph
    reads it by address."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, device=device).float()
                             / d))
    f = torch.arange(t, device=device).float()[:, None] * inv[None]
    return torch.polar(torch.ones_like(f), f)


def rotate_qk(qkv, heads: int, cis) -> None:
    """Rotary on the q and k parts of a per-head fused (B, T, 3*H*D) qkv,
    in place: each interleaved pair (x1, x2) -> (x1 cos - x2 sin, x2 cos +
    x1 sin), a complex product in f32, rounded back to qkv's dtype."""
    b, t, c3 = qkv.shape
    d = c3 // (3 * heads)
    qk = qkv.view(b, t, heads, 3, d)[:, :, :, :2]
    z = torch.view_as_complex(qk.float().unflatten(-1, (-1, 2)))
    qk.copy_(torch.view_as_real(z * cis[:t, None, None]).flatten(-2))


def attend(qkv, heads: int, kv_valid=None, mask_add=None):
    """Kernel B over the fused qkv, no bias: ``kv_valid`` (B, T) bool keys
    (the CPU's plain twin), ``mask_add`` its additive f32 form, built
    once a loop for the card's launches (None both: no mask)."""
    if qkv.is_cuda:
        return launch_packed(qkv, heads, mask_add, None)
    return flash_attention_packed(qkv, heads, kv_valid)


def _modulate(x, scale1, shift, eps):
    """LN(x) (1 + scale) + shift in one pass (f32 inside, out in x's
    dtype): ``scale1`` (1 + scale) and ``shift``, (dim,) in x's dtype and
    the same for every row (the CFG rows share their time), are the
    norm's affine."""
    return F.layer_norm(x, x.shape[-1:], scale1, shift, eps)


def block(p, x, mods, cis, cfg: F5Config, kv_valid, mask_add,
          compute_dtype=None):
    """One DiT block over (B, T, dim); ``mods`` (6, dim) its AdaLN shift,
    1 + scale and gate of the attention and of the FFN, in x's dtype and
    the same for every row."""
    cd = compute_dtype
    sh_a, sc_a, g_a, sh_f, sc_f, g_f = mods.unbind(0)
    h = _modulate(x, sc_a, sh_a, cfg.ln_eps)
    qkv = _lin(h, p["qkv_w"], p["qkv_b"], cd)
    rotate_qk(qkv, cfg.heads, cis)
    a = attend(qkv, cfg.heads, kv_valid, mask_add)
    x = torch.addcmul(x, g_a, _lin(a, p["o_w"], p["o_b"], cd))
    h = _modulate(x, sc_f, sh_f, cfg.ln_eps)
    h = F.gelu(_lin(h, p["ff1_w"], p["ff1_b"], cd), approximate="tanh")
    return torch.addcmul(x, g_f, _lin(h, p["ff2_w"], p["ff2_b"], cd))


def conditioning(prep, cfg: F5Config, t, compute_dtype=None):
    """Every block's AdaLN vectors and the output's from one product of
    SiLU(time embedding) at the (1,) time ``t``, formed in f32 and given
    in ``compute_dtype`` (f32 without it): (depth, 6, dim) with 1 + scale
    in the scale slots, and the output's 1 + scale and shift, (dim,)
    each."""
    n, d = cfg.depth, cfg.dim
    temb = time_embedding(prep, cfg, t, compute_dtype)
    m = _lin(F.silu(temb), prep["ada_w"], prep["ada_b"], compute_dtype,
             torch.float32)[0]
    blocks = m[:n * 6 * d].reshape(n, 6, d)
    blocks[:, 1] += 1.0  # the attention's and the FFN's scales
    blocks[:, 4] += 1.0
    m[n * 6 * d:n * 6 * d + d] += 1.0  # the output's scale
    m = m.to(compute_dtype or torch.float32)
    scale1, shift = m[n * 6 * d:].reshape(2, d)
    return m[:n * 6 * d].reshape(n, 6, d), (scale1, shift)


def velocity(prep, cfg: F5Config, x, cond_text, t, frame_mask=None,
             kv_valid=None, mask_add=None, compute_dtype=None):
    """Both CFG rows' velocities (2, T, mel) in f32 at state ``x`` (1, T,
    mel): ``cond_text`` (2, T, mel + text_dim) the rows' [cond mel |
    text] (the unconditioned row's cond is zero); ``t`` a (1,) time."""
    cd = compute_dtype
    dt = cd or torch.float32
    b, tl = cond_text.shape[:2]
    mods, (scale1, shift) = conditioning(prep, cfg, t, cd)
    pi = prep["input"]
    h = torch.cat([x.to(dt).expand(b, tl, -1), cond_text.to(dt)], dim=-1)
    h = _lin(h, pi["w"], pi["b"], cd)
    h = conv_pos.conv_pos_embed(h, pi["pos1_w"], pi["pos1_b"], pi["pos2_w"],
                                pi["pos2_b"], cfg.conv_pos_groups, frame_mask,
                                cd, pi.get("pos_tiles"))
    cis = rope_table(tl, cfg.d_head, h.device)
    for l in range(cfg.depth):
        p = {k: v[l] for k, v in prep["blocks"].items()}
        h = block(p, h, mods[l], cis, cfg, kv_valid, mask_add, cd)
    h = _modulate(h, scale1, shift, cfg.ln_eps)
    return _lin(h, prep["out_w"], prep["out_b"], cd, torch.float32)


def guided(v2, cfg_strength: float):
    """v_c + cfg (v_c - v_u) of stacked (2, ...) rows, as upstream forms
    it."""
    v_c, v_u = v2[:1], v2[1:]
    return v_c + (v_c - v_u) * cfg_strength


def schedule(nfe: int, sway: float, device=None) -> tuple:
    """The Euler loop's times t_k and steps dt_k = t_{k+1} - t_k, (nfe,)
    f32 each: t = s + sway (cos(pi s / 2) - 1 + s) on s = k / nfe,
    formed on the host in f32 and moved to ``device``."""
    s = torch.linspace(0, 1, nfe + 1, dtype=torch.float32)
    t = s + sway * (torch.cos(torch.pi / 2 * s) - 1 + s)
    return t[:-1].to(device), (t[1:] - t[:-1]).to(device)
