"""Plain reference of Dia-1.6B and the DAC 44.1 kHz decoder.

Plain PyTorch in float32: no kernel, cache, step graph, batching or
padding; each CFG row runs alone at the text's own length, and the
decoder runs teacher-forced over a whole token grid, causal, with no
K/V cache. It imports nothing of the port, of JAX or of transformers,
and turns TF32 off.

Sources: nari-labs/dia ``dia/config.py``, ``dia/layers.py``,
``dia/model.py``; the Dia-1.6B ``config.json``; descriptinc/
descript-audio-codec ``dac/model/dac.py`` (arXiv:2306.06546). The
equations (as transformers' ``modeling_dia.py`` and ``modeling_dac.py``
write them):

- RMSNorm: x / sqrt(mean(x^2) + eps) * w, eps 1e-5;
- rotary: rotate-half, inv_freq = 1 / theta^(2i / D), theta 1e4, angles
  [f, f]; positions 0..T-1 of the encoder's bytes and of the decoder's
  grid;
- attention scale 1 (the trained q projections carry 1 / sqrt(D));
- encoder: byte embedding, ``enc_layers`` x (RMSNorm, self-attention
  with rotary q and k, residual; RMSNorm, gated-SiLU MLP down(silu(gate)
  * up), residual), RMSNorm; the unconditioned row embeds byte 0 at every
  position of the text;
- decoder: the ``channels`` codes of a position embedded in one table at
  c * vocab + code and summed; ``dec_layers`` x (RMSNorm, causal GQA
  self-attention with rotary q and k, each K/V head serving ``dec_heads
  / dec_kv_heads`` query heads in order; RMSNorm, cross-attention over
  the encoder's output, no rotary; RMSNorm, gated-SiLU MLP), RMSNorm,
  one head to channels x vocab logits;
- DAC decoder: each codebook's vectors through its 1x1 conv, summed;
  conv k 7; per rate s: Snake, ConvTranspose (kernel 2 s, stride s,
  padding ceil(s / 2)), residual units at dilations 1, 3, 9 (Snake, conv
  k 7 dilated, Snake, conv k 1, added); Snake, conv k 7 to one channel,
  tanh. Snake(x) = x + sin(alpha x)^2 / (alpha + 1e-9).

Departures from upstream, and points not confirmed against its source:

- Upstream runs the encoder and decoder in bf16 (or fp16, f32). Here
  every product (the linears, the head, q k and p v) has its operands
  rounded by ``rounding`` (``"bf16"``: the configuration's plane;
  ``"fp8"``: e4m3 on a power-of-two scale per tensor, one step below)
  and runs in float32; everything between the products (norms, the
  rotary, the softmax, the residual stream) is float32. The DAC's
  products are float32 (``dac_rounding="tf32"`` rounds their operands to
  TF32, one step below).
- The text is not padded (upstream pads it to 1,024 bytes and masks the
  padding, which changes no result).
- The audio prompt enters as codes, not as audio through the DAC
  encoder; weight norm is folded into the weights.
- Only the forward passes are here: the delay pattern, CFG and the
  sampler act on the program's tokens, which the check feeds back.
- Not confirmed: that Dia's own ``dia/layers.py`` orders the gated MLP's
  fused projection as [gate | up] (transformers' ``DiaMLP`` does).

``tests/reference_dia.py`` and ``benchmark/reference/dia.py`` are the
same file; a test holds them equal.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP8_MAX = 448.0
DILATIONS = (1, 3, 9)


# --------------------------------------------------------------- weights

def dia_shapes(c: dict) -> dict:
    e, d = c["enc_dim"], c["dec_dim"]
    ne, nd = c["enc_layers"], c["dec_layers"]
    eq = c["enc_heads"] * c["enc_head_dim"]
    ekv = c["enc_kv_heads"] * c["enc_head_dim"]
    dq = c["dec_heads"] * c["dec_head_dim"]
    dkv = c["dec_kv_heads"] * c["dec_head_dim"]
    cq = c["cross_heads"] * c["cross_head_dim"]
    return {
        "encoder": {"emb": (c["enc_vocab"], e),
                    "sa_norm": (ne, e), "q": (ne, eq, e), "k": (ne, ekv, e),
                    "v": (ne, ekv, e), "o": (ne, e, eq),
                    "mlp_norm": (ne, e), "gate_up": (ne, 2 * c["enc_ffn"], e),
                    "down": (ne, e, c["enc_ffn"]),
                    "norm": (e,)},
        "decoder": {"emb": (c["channels"] * c["vocab"], d),
                    "sa_norm": (nd, d), "q": (nd, dq, d), "k": (nd, dkv, d),
                    "v": (nd, dkv, d), "o": (nd, d, dq),
                    "ca_norm": (nd, d), "ca_q": (nd, cq, d),
                    "ca_k": (nd, cq, e), "ca_v": (nd, cq, e),
                    "ca_o": (nd, d, cq),
                    "mlp_norm": (nd, d), "gate_up": (nd, 2 * c["dec_ffn"], d),
                    "down": (nd, d, c["dec_ffn"]),
                    "norm": (d,), "head": (c["channels"] * c["vocab"], d)},
    }


def dac_shapes(c: dict) -> dict:
    n, lat, ch = c["n_codebooks"], c["latent"], c["dim"]
    tree = {"codebook": (n, c["codebook_size"], c["codebook_dim"]),
            "proj_w": (n, lat, c["codebook_dim"]), "proj_b": (n, lat),
            "conv1_w": (ch, lat, 7), "conv1_b": (ch,)}
    for i, s in enumerate(c["rates"]):
        o = ch // 2
        block = {"alpha": (ch,), "convt_w": (ch, o, 2 * s), "convt_b": (o,)}
        for j in range(len(DILATIONS)):
            block[f"res{j}"] = {"alpha1": (o,), "conv1_w": (o, o, 7),
                                "conv1_b": (o,), "alpha2": (o,),
                                "conv2_w": (o, o, 1), "conv2_b": (o,)}
        tree[f"block{i}"] = block
        ch = o
    tree.update(alpha=(ch,), conv2_w=(1, ch, 7), conv2_b=(1,))
    return tree


def _numel(shapes) -> int:
    if isinstance(shapes, dict):
        return sum(_numel(v) for v in shapes.values())
    return math.prod(shapes)


def _carve(buf, shapes, off, std, centre, prefix=""):
    """The tree of ``shapes`` cut from ``buf`` at ``off``, each tensor
    scaled by ``std(path)`` and shifted by ``centre(path)`` (``path``:
    the names from the root, joined by "/")."""
    out = {}
    for name, s in shapes.items():
        path = prefix + name
        if isinstance(s, dict):
            out[name], off = _carve(buf, s, off, std, centre, path + "/")
            continue
        n = math.prod(s)
        t = buf[off:off + n].view(s).mul_(std(path))
        c = centre(path)
        if c:
            t.add_(c)
        out[name], off = t, off + n
    return out, off


def _leaf(path: str) -> str:
    return path.rsplit("/", 1)[-1]


def random_params(c: dict, dc: dict, w: dict, seed: int, device) -> tuple:
    """(Dia tree, DAC tree) of float32 tensors on ``device`` from
    ``seed``: one generator, one flat N(0, 1) draw a model, carved in the
    trees' order and scaled. ``w``: ``std`` (Dia's tensors; the query
    projections at std / sqrt(their head width)), ``dac_std`` (the DAC's
    convolutions), ``codebook_std``; RMSNorm weights (names ending in
    ``norm``) and Snake's alphas centred at 1."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    q_width = {"encoder/q": c["enc_head_dim"], "decoder/q": c["dec_head_dim"],
               "decoder/ca_q": c["cross_head_dim"]}
    trees = []
    for shapes, std, centre in (
            (dia_shapes(c),
             lambda n: w["std"] / math.sqrt(q_width.get(n, 1)),
             lambda n: 1.0 if n.endswith("norm") else 0.0),
            (dac_shapes(dc),
             lambda n: (w["codebook_std"] if n == "codebook"
                        else w["dac_std"]),
             lambda n: 1.0 if _leaf(n).startswith("alpha") else 0.0)):
        buf = torch.randn(_numel(shapes), generator=gen, device=device,
                          dtype=torch.float32)
        trees.append(_carve(buf, shapes, 0, std, centre)[0])
    return trees[0], trees[1]


# ------------------------------------------------------------ arithmetic

def round_operand(x: torch.Tensor, kind) -> torch.Tensor:
    """``x`` rounded to ``kind`` and back to float32: None (float32),
    ``bf16``, ``fp8`` (e4m3 on a power-of-two scale that fits the
    tensor's absmax) or ``tf32`` (10 mantissa bits, to nearest, ties
    away from zero)."""
    x = x.float()
    if kind is None:
        return x
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    if kind == "fp8":
        s = torch.exp2(torch.ceil(torch.log2(
            x.abs().amax().clamp_min(1e-30) / FP8_MAX)))
        return (x / s).to(torch.float8_e4m3fn).float() * s
    if kind == "tf32":
        i = x.contiguous().view(torch.int32)
        return ((i + 0x1000) & ~0x1FFF).view(torch.float32)
    raise ValueError(f"no rounding named {kind!r}")


def linear(x, w, r=None):
    return round_operand(x, r) @ round_operand(w, r).T


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(t_len: int, d: int, theta: float, device) -> tuple:
    """(cos, sin) of positions 0..T-1, (T, D) each."""
    inv = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.int64,
                                        device=device).float() / d))
    f = torch.arange(t_len, device=device).float()[:, None] * inv[None]
    emb = torch.cat([f, f], dim=-1)
    return emb.cos(), emb.sin()


def rotate(x, cos, sin):
    """x (H, T, D): rotate-half rotary."""
    d = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., d:], x[..., :d]], dim=-1) * sin


def attention(q, k, v, r, causal=False):
    """q (H, Tq, D), k and v (Hkv, Tkv, D), scale 1: each K/V head
    serves H / Hkv query heads in order."""
    rep = q.shape[0] // k.shape[0]
    k, v = k.repeat_interleave(rep, 0), v.repeat_interleave(rep, 0)
    s = round_operand(q, r) @ round_operand(k, r).transpose(-1, -2)
    if causal:
        tq, tk = s.shape[-2:]
        s = s.masked_fill(torch.ones(tq, tk, dtype=torch.bool,
                                     device=s.device).triu(1), -math.inf)
    a = torch.softmax(s, dim=-1)
    return round_operand(a, r) @ round_operand(v, r)


def _split(x, heads):
    """(T, H*D) -> (H, T, D)."""
    return x.view(x.shape[0], heads, -1).transpose(0, 1)


def _join(x):
    return x.transpose(0, 1).reshape(x.shape[1], -1)


def mlp(p, l, x, ffn, eps, r):
    h = rms_norm(x, p["mlp_norm"][l], eps)
    g, u = linear(h, p["gate_up"][l], r).split(ffn, dim=-1)
    return linear(F.silu(g) * u, p["down"][l], r)


# -------------------------------------------------------------- Dia

def encode(params, c, ids, r=None) -> torch.Tensor:
    """One row's encoder output (T, enc_dim) of byte ids ``ids``."""
    p = params["encoder"]
    dev = p["emb"].device
    ids = torch.as_tensor(list(ids), dtype=torch.long, device=dev)
    h, kvh, hd = c["enc_heads"], c["enc_kv_heads"], c["enc_head_dim"]
    cos, sin = rope(len(ids), hd, c["rope_theta"], dev)
    x = p["emb"][ids]
    for l in range(c["enc_layers"]):
        y = rms_norm(x, p["sa_norm"][l], c["norm_eps"])
        q = rotate(_split(linear(y, p["q"][l], r), h), cos, sin)
        k = rotate(_split(linear(y, p["k"][l], r), kvh), cos, sin)
        v = _split(linear(y, p["v"][l], r), kvh)
        x = x + linear(_join(attention(q, k, v, r)), p["o"][l], r)
        x = x + mlp(p, l, x, c["enc_ffn"], c["norm_eps"], r)
    return rms_norm(x, p["norm"], c["norm_eps"])


def decode(params, c, enc, grid, r=None) -> torch.Tensor:
    """One row's logits (T, channels, vocab) of the teacher-forced
    decoder over the (T, channels) code grid, against that row's encoder
    output ``enc``."""
    p = params["decoder"]
    dev = p["emb"].device
    grid = torch.as_tensor(grid, dtype=torch.long, device=dev)
    t, ch = grid.shape
    h, kvh, hd = c["dec_heads"], c["dec_kv_heads"], c["dec_head_dim"]
    cos, sin = rope(t, hd, c["rope_theta"], dev)
    off = torch.arange(ch, device=dev) * c["vocab"]
    x = p["emb"][grid + off].sum(1)
    for l in range(c["dec_layers"]):
        y = rms_norm(x, p["sa_norm"][l], c["norm_eps"])
        q = rotate(_split(linear(y, p["q"][l], r), h), cos, sin)
        k = rotate(_split(linear(y, p["k"][l], r), kvh), cos, sin)
        v = _split(linear(y, p["v"][l], r), kvh)
        x = x + linear(_join(attention(q, k, v, r, causal=True)),
                       p["o"][l], r)
        y = rms_norm(x, p["ca_norm"][l], c["norm_eps"])
        q = _split(linear(y, p["ca_q"][l], r), c["cross_heads"])
        k = _split(linear(enc, p["ca_k"][l], r), c["cross_heads"])
        v = _split(linear(enc, p["ca_v"][l], r), c["cross_heads"])
        x = x + linear(_join(attention(q, k, v, r)), p["ca_o"][l], r)
        x = x + mlp(p, l, x, c["dec_ffn"], c["norm_eps"], r)
    x = rms_norm(x, p["norm"], c["norm_eps"])
    return linear(x, p["head"], r).view(t, ch, c["vocab"])


def logits(params, c, text, grid, r=None) -> torch.Tensor:
    """Both CFG rows' logits (2, T, channels, vocab): the conditioned row
    on the byte ids ``text``, the unconditioned on as many zero bytes,
    each teacher-forced over the same grid."""
    text = list(text)
    return torch.stack([decode(params, c, encode(params, c, ids, r), grid, r)
                        for ids in (text, [0] * len(text))])


# -------------------------------------------------------------- DAC

def snake(x, alpha):
    a = alpha[:, None]
    return x + (a + 1e-9).reciprocal() * torch.sin(a * x).pow(2)


def conv(x, w, b, r=None, **kw):
    """(C, T) map through a conv1d, operands rounded by ``r``."""
    return F.conv1d(round_operand(x, r)[None], round_operand(w, r), b,
                    **kw)[0]


def dac(p, dc, codes, r=None) -> torch.Tensor:
    """Audio (T * hop,) of (n_codebooks, T) codes."""
    codes = torch.as_tensor(codes, dtype=torch.long,
                            device=p["codebook"].device)
    z = 0.0
    for i in range(dc["n_codebooks"]):
        z = z + conv(p["codebook"][i][codes[i]].T, p["proj_w"][i][..., None],
                     p["proj_b"][i], r)
    x = conv(z, p["conv1_w"], p["conv1_b"], r, padding=3)
    for i, s in enumerate(dc["rates"]):
        b = p[f"block{i}"]
        x = F.conv_transpose1d(round_operand(snake(x, b["alpha"]), r)[None],
                               round_operand(b["convt_w"], r), b["convt_b"],
                               stride=s, padding=math.ceil(s / 2))[0]
        for j, d in enumerate(DILATIONS):
            u = b[f"res{j}"]
            y = conv(snake(x, u["alpha1"]), u["conv1_w"], u["conv1_b"], r,
                     dilation=d, padding=3 * d)
            x = x + conv(snake(y, u["alpha2"]), u["conv2_w"], u["conv2_b"],
                         r)
    x = conv(snake(x, p["alpha"]), p["conv2_w"], p["conv2_b"], r, padding=3)
    return torch.tanh(x)[0]
