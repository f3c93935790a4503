"""Plain reference of F5-TTS v1 Base and the Vocos mel-24khz vocoder.

Plain PyTorch in float32: no kernel, cache, step graph, batching or
padding; each CFG row runs alone at the request's own length T. It
imports nothing of the port and nothing of JAX, and turns TF32 off.

Sources: SWivid/F5-TTS ``src/f5_tts/configs/F5TTS_v1_Base.yaml``,
``model/backbones/dit.py``, ``model/modules.py``, ``model/cfm.py``,
``infer/utils_infer.py`` (arXiv:2410.06885); charactr/vocos-mel-24khz
(arXiv:2306.00814). The equations:

- time: ``SinusPositionEmbedding(256)`` of ``1000 t`` ([sin, cos],
  frequencies exp(-ln(1e4) i / 127)), Linear, SiLU, Linear;
- text: ``Embedding(V + 1, 512)`` of ids + 1 (0 the filler) padded to T,
  plus the table [cos, sin] of ``precompute_freqs_cis(512, 4096)``,
  positions at or past the text's length zeroed, then 4 ConvNeXt-V2
  blocks (depthwise conv k 7, LayerNorm eps 1e-6, Linear, exact GELU,
  GRN, Linear, residual), the padding zeroed after each; the
  unconditioned row embeds the filler at every position, under the
  conditioned row's mask;
- input: Linear of [noisy mel | cond mel | text], plus two grouped convs
  (k 31, 16 groups) each followed by Mish;
- 22 blocks: AdaLN-Zero (Linear(SiLU(t)) -> shift, scale, gate of the
  attention and of the FFN; non-affine LN, eps 1e-6), attention with
  rotary q and k on every head (interleaved pairs, base 1e4), scale
  1/8, no mask; FFN with tanh-GELU; each branch added under its gate;
- out: LN modulated by (scale, shift), then Linear to 100 mels;
- sampler: 32 Euler steps on t = s + sway (cos(pi s / 2) - 1 + s), s =
  k / 32; v = v_c + cfg (v_c - v_u); the cond frames put back at the end;
- Vocos: Conv1d k 7, LN, 8 ConvNeXt blocks (layer scale), LN, Linear to
  n_fft + 2; magnitude exp(.) clipped at 100, phase; iSTFT with "same"
  padding (irfft, Hann window, overlap-add, trim, window envelope).

Departures from upstream, and points not confirmed against its source:

- Upstream runs the DiT in fp16. Here every product of the DiT (the
  linears, the convolutions, q k and p v) has its operands rounded by
  ``rounding`` (``"bf16"``: the configuration's plane; ``"fp8"``: e4m3
  on a power-of-two scale per tensor, one step below) and runs in
  float32; Vocos's products are float32 (``vocos_rounding="tf32"``
  rounds their operands to TF32, one step below). Everything between
  the products (norms, activations, the rotary, the residual stream) is
  float32 here.
- The time grid and the ODE state are float32 (upstream: the model's
  dtype).
- The reference clip enters as a log-mel (T_ref x 100), not as audio and
  its mel front end.
- Not confirmed: that the uncond row's text mask is the cond row's (the
  mask is taken before the text is dropped); that the GRN's norm runs
  over all T frames (text padding included); that v1's conv position
  embedding masks nothing at B = 1 (upstream passes no mask at one row).

``tests/reference_f5.py`` and ``benchmark/reference/f5.py`` are the same
file; a test holds them equal.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

FP8_MAX = 448.0
# tree leaves whose names end so are norm weights (centred at 1) and
# Vocos's layer scales (centred at 1 / layers)
NORM_WEIGHTS = ("ln_w", "norm_w", "final_w")


# --------------------------------------------------------------- weights

def f5_shapes(c: dict) -> dict:
    d, td, n, m = c["dim"], c["text_dim"], c["depth"], c["mel_dim"]
    ff, ti, nt = d * c["ff_mult"], td * c["conv_mult"], c["conv_layers"]
    k = c["conv_pos_kernel"]
    return {
        "time": {"w0": (d, c["freq_embed_dim"]), "b0": (d,),
                 "w1": (d, d), "b1": (d,)},
        "text": {"emb": (c["text_vocab"] + 1, td),
                 "dw_w": (nt, td, 7), "dw_b": (nt, td),
                 "ln_w": (nt, td), "ln_b": (nt, td),
                 "pw1_w": (nt, ti, td), "pw1_b": (nt, ti),
                 "grn_g": (nt, ti), "grn_b": (nt, ti),
                 "pw2_w": (nt, td, ti), "pw2_b": (nt, td)},
        "input": {"w": (d, 2 * m + td), "b": (d,),
                  "pos1_w": (d, d // c["conv_pos_groups"], k),
                  "pos1_b": (d,),
                  "pos2_w": (d, d // c["conv_pos_groups"], k),
                  "pos2_b": (d,)},
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


def vocos_shapes(c: dict) -> dict:
    d, di, n = c["dim"], c["intermediate_dim"], c["layers"]
    return {
        "embed_w": (d, c["n_mel"], 7), "embed_b": (d,),
        "norm_w": (d,), "norm_b": (d,),
        "blocks": {"dw_w": (n, d, 7), "dw_b": (n, d),
                   "ln_w": (n, d), "ln_b": (n, d),
                   "pw1_w": (n, di, d), "pw1_b": (n, di),
                   "pw2_w": (n, d, di), "pw2_b": (n, d),
                   "gamma": (n, d)},
        "final_w": (d,), "final_b": (d,),
        "out_w": (c["n_fft"] + 2, d), "out_b": (c["n_fft"] + 2,),
    }


def _numel(shapes) -> int:
    if isinstance(shapes, dict):
        return sum(_numel(v) for v in shapes.values())
    return math.prod(shapes)


def _carve(buf, shapes, off, std, centre):
    out = {}
    for name, s in shapes.items():
        if isinstance(s, dict):
            out[name], off = _carve(buf, s, off, std, centre)
            continue
        n = math.prod(s)
        t = buf[off:off + n].view(s).mul_(std(name))
        c = centre(name)
        if c:
            t.add_(c)
        out[name], off = t, off + n
    return out, off


def random_params(c: dict, vc: dict, w: dict, seed: int, device) -> tuple:
    """(DiT tree, Vocos tree) of float32 tensors on ``device`` from
    ``seed``: one generator, one flat N(0, 1) draw a model, carved in the
    trees' order and scaled. ``w``: ``std`` (the DiT's tensors),
    ``text_emb_std`` (the char embedding), ``vocos_std``; norm weights
    centred at 1, Vocos's layer scales at 1 / layers."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    trees = []
    for shapes, std, centre in (
            (f5_shapes(c),
             lambda n: w["text_emb_std"] if n == "emb" else w["std"],
             lambda n: 1.0 if n.endswith(NORM_WEIGHTS) else 0.0),
            (vocos_shapes(vc), lambda n: w["vocos_std"],
             lambda n: (1.0 if n.endswith(NORM_WEIGHTS) else
                        1.0 / vc["layers"] if n == "gamma" else 0.0))):
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


def linear(x, w, b, r=None):
    return round_operand(x, r) @ round_operand(w, r).T + b


def conv1d(x, w, b, r=None, groups=1):
    """(C, T) map, "same" zero padding, operands rounded by ``r``."""
    return F.conv1d(round_operand(x, r)[None], round_operand(w, r), b,
                    padding=w.shape[-1] // 2, groups=groups)[0]


def layer_norm(x, w=None, b=None, eps=1e-6):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def grn(x, g, b):
    """GRN over a (T, C) map: the L2 norm over time."""
    gx = torch.linalg.vector_norm(x, dim=0, keepdim=True)
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    return g * (x * nx) + b + x


# ----------------------------------------------------------------- F5 DiT

def schedule(nfe: int, sway: float) -> torch.Tensor:
    """The nfe + 1 times of the Euler grid, float32."""
    t = torch.linspace(0, 1, nfe + 1, dtype=torch.float32)
    return t + sway * (torch.cos(torch.pi / 2 * t) - 1 + t)


def frames(ref_frames: int, ref_len: int, gen_len: int,
           max_frames: int = 4096) -> int:
    """utils_infer's duration: the reference's frames plus as many again
    per character of the generated text; at least one frame past the
    text and the reference, at most ``max_frames``."""
    t = ref_frames + int(ref_frames / ref_len * gen_len)
    return min(max(t, max(ref_len + gen_len, ref_frames) + 1), max_frames)


def time_embedding(p, c, t, r):
    half = c["freq_embed_dim"] // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * -(math.log(10000) / (half - 1)))
    e = 1000.0 * t.reshape(1, 1) * freqs[None]
    e = torch.cat([e.sin(), e.cos()], dim=-1)
    return linear(F.silu(linear(e, p["w0"], p["b0"], r)), p["w1"], p["b1"], r)


def text_table(dim: int, end: int, device) -> torch.Tensor:
    """``precompute_freqs_cis(dim, end)``: (end, dim) [cos | sin]."""
    freqs = 1.0 / (10000.0 ** (torch.arange(0, dim, 2, device=device)
                               [:dim // 2].float() / dim))
    f = torch.outer(torch.arange(end, device=device).float(), freqs)
    return torch.cat([torch.cos(f), torch.sin(f)], dim=-1)


def text_embed(p, c, ids, t_len: int, drop: bool, r):
    """(T, text_dim) text features of one row: ``ids`` the raw char ids
    (the filler is id + 1 = 0), cut or padded to T."""
    dev = p["emb"].device
    idx = torch.zeros(t_len, dtype=torch.long, device=dev)
    ids = torch.as_tensor(list(ids)[:t_len], dtype=torch.long, device=dev)
    idx[:len(ids)] = ids + 1
    keep = (idx != 0)[:, None]
    if drop:
        idx = torch.zeros_like(idx)
    x = p["emb"][idx] + text_table(c["text_dim"], c["text_max_pos"],
                                   dev)[:t_len]
    x = torch.where(keep, x, 0.0)
    for l in range(c["conv_layers"]):
        y = conv1d(x.T, p["dw_w"][l][:, None], p["dw_b"][l], r,
                   groups=x.shape[-1]).T
        y = layer_norm(y, p["ln_w"][l], p["ln_b"][l])
        y = F.gelu(linear(y, p["pw1_w"][l], p["pw1_b"][l], r))
        y = grn(y, p["grn_g"][l], p["grn_b"][l])
        x = torch.where(keep, x + linear(y, p["pw2_w"][l], p["pw2_b"][l], r),
                        0.0)
    return x


def rotary(x, pos_freqs):
    """x (H, T, D): interleaved pairs rotated, (-x2, x1)."""
    x1, x2 = x.unflatten(-1, (-1, 2)).unbind(-1)
    rot = torch.stack([-x2, x1], dim=-1).flatten(-2)
    return x * pos_freqs.cos() + rot * pos_freqs.sin()


def rope_freqs(t_len: int, d: int, device) -> torch.Tensor:
    """(T, D) angles, each pair's twice (x-transformers, base 1e4)."""
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, device=device).float()
                             / d))
    f = torch.arange(t_len, device=device).float()[:, None] * inv[None]
    return torch.stack([f, f], dim=-1).flatten(-2)


def attention(p, l, x, c, freqs, r):
    h = c["heads"]
    t_len, d = x.shape
    q, k, v = (linear(x, p[f"{n}_w"][l], p[f"{n}_b"][l], r)
               .view(t_len, h, d // h).transpose(0, 1) for n in "qkv")
    q, k = rotary(q, freqs), rotary(k, freqs)
    s = round_operand(q, r) @ round_operand(k, r).transpose(-1, -2)
    a = torch.softmax(s * (d // h) ** -0.5, dim=-1)
    o = (round_operand(a, r) @ round_operand(v, r)).transpose(0, 1)
    return linear(o.reshape(t_len, d), p["o_w"][l], p["o_b"][l], r)


def dit(params, c, x, cond, text, t, r=None):
    """One row's velocity (T, mel): noisy mel ``x`` and ``cond`` (T, mel),
    ``text`` (T, text_dim) features, ``t`` a float32 scalar tensor."""
    pi, pb = params["input"], params["blocks"]
    temb = time_embedding(params["time"], c, t, r)[0]
    h = linear(torch.cat([x, cond, text], dim=-1), pi["w"], pi["b"], r)
    g = c["conv_pos_groups"]
    y = F.mish(conv1d(h.T, pi["pos1_w"], pi["pos1_b"], r, g))
    y = F.mish(conv1d(y, pi["pos2_w"], pi["pos2_b"], r, g))
    h = h + y.T
    freqs = rope_freqs(h.shape[0], c["dim"] // c["heads"], h.device)
    for l in range(c["depth"]):
        mods = linear(F.silu(temb), pb["ada_w"][l], pb["ada_b"][l], r)
        sh_a, sc_a, g_a, sh_f, sc_f, g_f = mods.chunk(6)
        y = layer_norm(h) * (1 + sc_a) + sh_a
        h = h + g_a * attention(pb, l, y, c, freqs, r)
        y = layer_norm(h) * (1 + sc_f) + sh_f
        y = F.gelu(linear(y, pb["ff1_w"][l], pb["ff1_b"][l], r),
                   approximate="tanh")
        h = h + g_f * linear(y, pb["ff2_w"][l], pb["ff2_b"][l], r)
    po = params["out"]
    scale, shift = linear(F.silu(temb), po["ada_w"], po["ada_b"], r).chunk(2)
    h = layer_norm(h) * (1 + scale) + shift
    return linear(h, po["w"], po["b"], r)


class Request:
    """One request's fixed inputs: the reference mel (T_ref, mel), the
    reference and generated char ids, and the features both CFG rows
    share across the loop."""

    def __init__(self, params, c, ref_mel, ref_ids, gen_ids, r=None):
        self.params, self.c, self.r = params, c, r
        self.ref_frames = ref_mel.shape[0]
        ids = list(ref_ids) + list(gen_ids)
        self.t_len = frames(self.ref_frames, len(ref_ids), len(gen_ids))
        dev = params["text"]["emb"].device
        self.cond = torch.zeros(self.t_len, c["mel_dim"], device=dev)
        self.cond[:self.ref_frames] = torch.as_tensor(ref_mel, device=dev)
        self.text_c = text_embed(params["text"], c, ids, self.t_len, False, r)
        self.text_u = text_embed(params["text"], c, ids, self.t_len, True, r)

    def velocity(self, x, t) -> torch.Tensor:
        """The guided velocity (T, mel) at state ``x`` and time ``t``."""
        v_c = dit(self.params, self.c, x, self.cond, self.text_c, t, self.r)
        v_u = dit(self.params, self.c, x, torch.zeros_like(self.cond),
                  self.text_u, t, self.r)
        return v_c + (v_c - v_u) * self.c["cfg_strength"]

    def sample(self, y0) -> torch.Tensor:
        """The Euler loop from ``y0`` (T, mel); the cond frames put back."""
        ts = schedule(self.c["nfe"], self.c["sway"]).to(y0.device)
        x = y0.float()
        for k in range(self.c["nfe"]):
            x = x + (ts[k + 1] - ts[k]) * self.velocity(x, ts[k])
        x[:self.ref_frames] = self.cond[:self.ref_frames]
        return x


# ------------------------------------------------------------------ Vocos

def vocos(p, vc, mel, r=None) -> torch.Tensor:
    """Audio (n * hop,) of a (mel, n) log-mel."""
    x = conv1d(mel.float(), p["embed_w"], p["embed_b"], r)
    x = layer_norm(x.T, p["norm_w"], p["norm_b"])
    pb = p["blocks"]
    for l in range(vc["layers"]):
        y = conv1d(x.T, pb["dw_w"][l][:, None], pb["dw_b"][l], r,
                   groups=x.shape[-1]).T
        y = layer_norm(y, pb["ln_w"][l], pb["ln_b"][l])
        y = F.gelu(linear(y, pb["pw1_w"][l], pb["pw1_b"][l], r))
        x = x + pb["gamma"][l] * linear(y, pb["pw2_w"][l], pb["pw2_b"][l], r)
    x = layer_norm(x, p["final_w"], p["final_b"])
    mag, ph = linear(x, p["out_w"], p["out_b"], r).T.chunk(2)
    mag = torch.exp(mag).clip(max=1e2)
    return istft(torch.complex(mag * torch.cos(ph), mag * torch.sin(ph)),
                 vc["n_fft"], vc["hop"])


def istft(spec, n_fft: int, hop: int) -> torch.Tensor:
    """(n_fft / 2 + 1, n) complex -> (n * hop,) audio, "same" padding."""
    n = spec.shape[-1]
    win = torch.hann_window(n_fft, device=spec.device)
    frames_ = torch.fft.irfft(spec, n_fft, dim=0) * win[:, None]
    size = (n - 1) * hop + n_fft
    pad = (n_fft - hop) // 2
    y = torch.zeros(size, device=spec.device)
    env = torch.zeros(size, device=spec.device)
    for i in range(n):
        y[i * hop:i * hop + n_fft] += frames_[:, i]
        env[i * hop:i * hop + n_fft] += win.square()
    return (y / env)[pad:size - pad]
