"""The diffusion stage: Tortoise's conditioned DDPM mel decoder and its
respaced sampling loop with classifier-free guidance, one request at a
time at its own lengths (no buckets, no masks).

Denoiser, time-major (T, C): the latent conditioner (k3 conv, 4
relative-position attention blocks, group norm, FiLM by the stored
conditioning latent), nearest upscale to the mel length; the timestep
MLP; 3 integrator layers over the code; k3 input conv, concat, the
integrating k1 conv, 10 layers (FiLM resblock + attention), 3 tail
resblocks, group norm, SiLU, k3 output conv -> [100 means | 100
variance fractions]. Attention qkv channels are per-head interleaved
(h * 192 + part * 64 + d), the bias a (32, H) bucket table times 8.

Loop: x_T from the first noise draw; at each respaced t = 79 .. 0 one
batch-of-2 eval (conditioned, unconditioned), eps = (1 + k) cond - k
uncond, the learned variance from the conditioned eval, x0 clamped to
[-1, 1], the posterior mean, plus exp(logvar / 2) times that step's
noise draw except at t = 0.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import schedule as S
from benchmark.reference.precision import (
    Precision,
    quantize_rows,
    quantize_weight,
)

# the weights of the products the int8 plane runs int8 x int8, in GROUPS
INT8_PRODUCTS = ("attn_qkv_w", "attn_proj_w", "res_in_conv_w",
                 "res_out_conv_w")
GROUPS = ("layers", "integrator", "tail")


def prepare(params: dict, prec: Precision) -> dict:
    """The weights as the stated precision rounds them: the int8
    products' weights of the layers, the integrator, the tail and the
    integrating conv quantized per output channel (over every input and
    tap) when ``prec.weight_bits`` is set; everything float32. The
    activations of those products are rounded per row by
    ``prec.act_bits`` where they are used."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out[k] = {}
            for kk, vv in v.items():
                if k in GROUPS and kk in INT8_PRODUCTS:
                    dims = (-2, -1) if vv.dim() == 4 else (-1,)
                    out[k][kk] = quantize_weight(vv, prec.weight_bits, dims)
                else:
                    out[k][kk] = vv.float()
        else:
            out[k] = v.float()
    out["integrating_w"] = quantize_weight(params["integrating_w"],
                                           prec.weight_bits, (-1,))
    out["_act_bits"] = prec.act_bits
    return out


def _gn(x, groups, w, b, eps):
    """Group norm of (N, T, C) over (T, C / groups), centered, float32."""
    n, t, c = x.shape
    xg = x.reshape(n, t, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    return ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, t, c) * w + b


def _lin(x, w, b, act_bits=None):
    """x (N, T, in) @ w (out, in) + b, activations rounded per row when
    ``act_bits`` is set."""
    return quantize_rows(x, act_bits) @ w.T + b


def _conv3(x, w, b, act_bits=None):
    """k3 conv, padding 1, over time-major x (N, T, in); w (out, in, 3)."""
    y = F.conv1d(quantize_rows(x, act_bits).transpose(1, 2), w, b,
                 padding=1)
    return y.transpose(1, 2)


def _layer(stack, l):
    return {k: v[l] for k, v in stack.items()}


def _attention(blk, x, cfg, bias, act_bits=None):
    n, t, c = x.shape
    h = cfg["n_head"]
    dh = c // h
    y = _gn(x, cfg["n_groups"], blk["attn_norm_w"], blk["attn_norm_b"],
            cfg["gn_eps"])
    qkv = _lin(y, blk["attn_qkv_w"], blk["attn_qkv_b"], act_bits)
    q, k, v = qkv.reshape(n, t, h, 3, dh).permute(3, 0, 2, 1, 4)
    rel = blk["attn_rel_w"][bias].permute(2, 0, 1) * 8.0
    att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dh) + rel,
                        dim=-1)
    ctx = (att @ v).permute(0, 2, 1, 3).reshape(n, t, c)
    return x + _lin(ctx, blk["attn_proj_w"], blk["attn_proj_b"], act_bits)


def _resblock(blk, x, temb, cfg, act_bits=None):
    g, eps = cfg["n_groups"], cfg["gn_eps"]
    y = _gn(x, g, blk["res_in_norm_w"], blk["res_in_norm_b"], eps)
    y = _lin(F.silu(y), blk["res_in_conv_w"], blk["res_in_conv_b"],
             act_bits)
    emb = F.silu(temb) @ blk["res_emb_w"].T + blk["res_emb_b"]
    scale, shift = emb.chunk(2, dim=-1)
    y = _gn(y, g, blk["res_out_norm_w"], blk["res_out_norm_b"], eps)
    y = F.silu(y * (1.0 + scale[:, None]) + shift[:, None])
    return x + _conv3(y, blk["res_out_conv_w"], blk["res_out_conv_b"],
                      act_bits)


_BUCKETS: dict = {}


def _buckets(t, cfg, device):
    key = (t, cfg["rel_pos_buckets"], cfg["rel_pos_max_distance"],
           str(device))
    if key not in _BUCKETS:
        _BUCKETS[key] = torch.as_tensor(S.relative_position_buckets(
            t, cfg["rel_pos_buckets"], cfg["rel_pos_max_distance"]),
            device=device)
    return _BUCKETS[key]


def code_embedding(p, cfg: dict, latents: torch.Tensor, out_len: int):
    """(L, 1024) latents -> the conditioned (out_len, 1024) code."""
    x = _conv3(latents.float()[None], p["latent_conv_w"], p["latent_conv_b"])
    bias = _buckets(x.shape[1], cfg, x.device)
    for l in range(cfg["n_latent_cond_blocks"]):
        x = _attention(_layer(p["latent_blocks"], l), x, cfg, bias)
    x = _gn(x, cfg["n_groups"], p["code_norm_w"], p["code_norm_b"],
            cfg["gn_eps"])
    x = x * (1.0 + p["cond_scale"]) + p["cond_shift"]
    n_lat = x.shape[1]
    idx = torch.arange(out_len, device=x.device) * n_lat // out_len
    return x[0, idx.clamp(max=n_lat - 1)]


def denoise(p, cfg: dict, x: torch.Tensor, code: torch.Tensor,
            t_orig: float) -> torch.Tensor:
    """One eval: x (N, T, 100) noisy mel, code (N, T, 1024) -> (N, T,
    200)."""
    ab = p["_act_bits"]
    n, t, _ = x.shape
    freqs = torch.as_tensor(S.timestep_freqs(cfg["timestep_dim"],
                                             cfg["timestep_max_period"]),
                            device=x.device)
    args = torch.full((n, 1), float(t_orig), device=x.device) * freqs
    temb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    temb = F.silu(temb @ p["time_w0"].T + p["time_b0"])
    temb = temb @ p["time_w1"].T + p["time_b1"]
    bias = _buckets(t, cfg, x.device)
    for l in range(cfg["n_integrator_layers"]):
        blk = _layer(p["integrator"], l)
        code = _attention(blk, _resblock(blk, code, temb, cfg, ab), cfg,
                          bias, ab)
    h = _conv3(x, p["inp_w"], p["inp_b"])
    h = _lin(torch.cat([h, code], dim=-1), p["integrating_w"],
             p["integrating_b"], ab)
    for l in range(cfg["n_main_layers"]):
        blk = _layer(p["layers"], l)
        h = _attention(blk, _resblock(blk, h, temb, cfg, ab), cfg, bias, ab)
    for l in range(cfg["n_tail_resblocks"]):
        h = _resblock(_layer(p["tail"], l), h, temb, cfg, ab)
    h = F.silu(_gn(h, cfg["n_groups"], p["out_norm_w"], p["out_norm_b"],
                   cfg["gn_eps"]))
    return _conv3(h, p["out_w"], p["out_b"])


def sample(p, cfg: dict, latents: torch.Tensor, noises) -> torch.Tensor:
    """The 80-step loop from one request's latents; ``noises`` yields
    the (100, T) draws in order (x_T first, then one a step). Returns
    the (100, T) normalized mel."""
    n = cfg["n_sample_timesteps"]
    sch = S.schedule(cfg["n_train_timesteps"], n)
    x = next(noises).float()
    out_len = x.shape[-1]
    code = code_embedding(p, cfg, latents, out_len)
    code2 = torch.stack([code, p["uncond"].expand_as(code)])
    x = x.T[None]
    for i in range(n):
        t = n - 1 - i
        noise = next(noises).float().T[None]
        out = denoise(p, cfg, torch.cat([x, x]), code2, sch["tmap"][t])
        k = np.float32(S.cond_free_k(t, n, cfg["cond_free_k"]))
        n_mel = cfg["n_mel"]
        eps = (float(np.float32(1.0) + k) * out[:1, :, :n_mel]
               - float(k) * out[1:, :, :n_mel])
        frac = (out[:1, :, n_mel:] + 1.0) / 2.0
        logvar = (frac * float(np.float32(sch["post_logvar"][t]))
                  + (1.0 - frac) * float(np.float32(sch["log_betas"][t])))
        x0 = torch.clamp(float(np.float32(sch["sqrt_recip_acp"][t])) * x
                         - float(np.float32(sch["sqrt_recipm1_acp"][t])) * eps,
                         -1.0, 1.0)
        mean = (float(np.float32(sch["coef1"][t])) * x0
                + float(np.float32(sch["coef2"][t])) * x)
        x = mean + torch.exp(0.5 * logvar) * noise if t > 0 else mean
    return x[0].T
