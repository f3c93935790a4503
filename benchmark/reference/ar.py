"""The AR stage: Tortoise's GPT-2 speech-token decoder, one request at a
time over its whole sequence (no KV cache, no padding).

Sequence: [voice latent | text embeddings (+ text positions 0..t-1) |
mel embeddings (+ mel positions)]. Pre-LN blocks: LN -> qkv (channels
part-major: q | k | v, each h * 64 + d) -> causal softmax(q k / 8) ->
proj -> residual -> LN -> tanh-GELU MLP -> residual. Logits: LN (ln_f)
-> bare LN -> affine (lm_head.0) -> lm_head.1. Latents: the same chain
without lm_head.1.

Positions follow Tortoise's decode: the start token takes mel position
0 and the n-th sampled token position n + 2 while it is decoded, while
the latent pass numbers [start | tokens | stop] 0, 1, 2, ...
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.precision import Precision, quantize_weight

MATMULS = ("attn_w", "proj_w", "fc_w", "fc_proj_w")


def prepare(params: dict, prec: Precision) -> dict:
    """The weights as the stated precision rounds them: the block matmul
    weights ((L, in, out), a scale per output column) and the head
    ((V, d), a scale per vocabulary row) quantized when
    ``prec.weight_bits`` is set; everything float32."""
    blocks = {k: (quantize_weight(v, prec.weight_bits, (-2,))
                  if k in MATMULS else v.float())
              for k, v in params["blocks"].items()}
    out = {k: v.float() for k, v in params.items() if k != "blocks"}
    out["lm_w"] = quantize_weight(params["lm_w"], prec.weight_bits, (-1,))
    out["blocks"] = blocks
    return out


def _ln(x, w=None, b=None, eps=1e-5):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    if w is not None:
        y = y * w + b
    return y


def _embed(p, text, voice, mel_ids, mel_pos):
    t = len(text)
    dev = p["text_emb"].device
    text = torch.as_tensor(text, device=dev)
    mel_ids = torch.as_tensor(mel_ids, device=dev)
    mel_pos = torch.as_tensor(mel_pos, device=dev)
    x_text = p["text_emb"][text] + p["text_pos"][torch.arange(t, device=dev)]
    x_mel = p["mel_emb"][mel_ids] + p["mel_pos"][mel_pos]
    voice = torch.as_tensor(voice, device=dev).float().reshape(1, -1)
    return torch.cat([voice, x_text, x_mel], 0)


def trunk(p, cfg: dict, x: torch.Tensor) -> torch.Tensor:
    """The 30 blocks over a (S, d) sequence with a causal mask."""
    s, d = x.shape
    h = cfg["n_head"]
    dh = d // h
    causal = torch.full((s, s), float("-inf"), device=x.device).triu(1)
    blk = p["blocks"]
    for l in range(cfg["n_layer"]):
        y = _ln(x, blk["ln1_w"][l], blk["ln1_b"][l], cfg["ln_eps"])
        qkv = y @ blk["attn_w"][l] + blk["attn_b"][l]
        q, k, v = qkv.reshape(s, 3, h, dh).permute(1, 2, 0, 3)
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh)
                            + causal, dim=-1)
        ctx = (att @ v).permute(1, 0, 2).reshape(s, d)
        x = x + (ctx @ blk["proj_w"][l] + blk["proj_b"][l])
        y = _ln(x, blk["ln2_w"][l], blk["ln2_b"][l], cfg["ln_eps"])
        y = F.gelu(y @ blk["fc_w"][l] + blk["fc_b"][l], approximate="tanh")
        x = x + (y @ blk["fc_proj_w"][l] + blk["fc_proj_b"][l])
    return x


def _final(p, h, eps):
    h = _ln(h, p["ln_f_w"], p["ln_f_b"], eps)
    return _ln(h, eps=eps) * p["lm_ln_w"] + p["lm_ln_b"]


def decode_logits(p, cfg: dict, text, voice, tokens) -> torch.Tensor:
    """(n, V) logits the decoder gives for the n served ``tokens``
    teacher-forced: row i predicts tokens[i] from the text, the start
    token and tokens[:i]."""
    n = len(tokens)
    mel_ids = [cfg["start_mel_token"]] + list(tokens[:n - 1])
    mel_pos = [0] + [i + 2 for i in range(n - 1)]
    h = trunk(p, cfg, _embed(p, text, voice, mel_ids, mel_pos))
    h = _final(p, h[1 + len(text):], cfg["ln_eps"])
    return h @ p["lm_w"].T + p["lm_b"]


def penalized(logits: torch.Tensor, tokens, cfg: dict,
              penalty: float) -> torch.Tensor:
    """Tortoise's repetition penalty (x * p below 0, x / p above) on the
    (n, V) logits of ``decode_logits``: row 0 on the prefill's filler id
    1 and the start token, row i on tokens[i - 1]."""
    n = logits.shape[0]
    prev = torch.empty((n, 2), dtype=torch.long, device=logits.device)
    prev[0] = torch.as_tensor([1, cfg["start_mel_token"]])
    prev[1:] = torch.as_tensor(list(tokens[:n - 1]))[:, None]
    g = logits.gather(1, prev)
    return logits.scatter(1, prev, torch.where(g < 0, g * penalty,
                                               g / penalty))


def pad_sequence(tokens, cfg: dict) -> list:
    """Tortoise's padding of a served sequence for the latent pass: strip
    trailing strip tokens, pad with calm tokens to 500, force the last
    three, then [start] + ... + [stop]."""
    out = list(tokens)
    while out and out[-1] == cfg["strip_token"]:
        out.pop()
    out.extend([cfg["calm_token"]] * (cfg["pad_mel_length"] - len(out)))
    out[-3:] = list(cfg["tail_tokens"])
    return [cfg["start_mel_token"]] + out + [cfg["stop_mel_token"]]


def keep_length(padded, cfg: dict) -> int:
    """Latent frames kept: positions until more than 8 calm tokens in a
    row."""
    calm = keep = 0
    for c, tok in enumerate(padded[1:-1]):
        calm = calm + 1 if tok == cfg["calm_token"] else 0
        if calm > 8:
            break
        keep = c + 1
    return keep


def latents(p, cfg: dict, text, voice, tokens) -> torch.Tensor:
    """(keep, d) speech-conditioning latents of a served sequence."""
    padded = pad_sequence(tokens, cfg)
    m = len(padded)
    h = trunk(p, cfg, _embed(p, text, voice, padded, list(range(m))))
    t = len(text)
    lat = _final(p, h[1 + t:1 + t + m - 2], cfg["ln_eps"])
    return lat[:keep_length(padded, cfg)]
