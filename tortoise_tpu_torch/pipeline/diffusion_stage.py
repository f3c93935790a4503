"""Stage 2 driver: the 80-step DDPM with classifier-free guidance
(counterpart of ``tortoise_tpu/pipeline/diffusion_stage.py``).

The latent conditioner runs once; each step is one batch-of-2 denoiser
eval (cond rows, then uncond rows). Semantics as in the JAX package:
output length L*4*24000/22050; the variance channel comes from the
conditioned eval only; loop step i handles respaced t = S-1-i; noise is
drawn every step even though the last step discards it; lengths round up
to buckets with masked norms and attention.

Two noise planes: ``diffusion_batch_device`` (and ``diffusion_batch``,
its host-list form) draws from a ``torch.Generator`` through
``draw_normal`` — the initial noise, then one draw a step, like the JAX
package's key chain (diffusion_stage.py:181-182, 237-238);
``diffusion(rng=ReferenceRng)`` consumes the mt19937 stream in the
reference's order.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from tortoise_tpu.config import DiffusionConfig, mel_length_for_latents
from tortoise_tpu_torch.models import diffusion as dmodel
from tortoise_tpu_torch.ops.basic import quantize_cols
from tortoise_tpu_torch.ops.relpos import relative_position_buckets
from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline import common
from tortoise_tpu_torch.pipeline import schedule as ds
from tortoise_tpu_torch.pipeline.common import cached_cast, round_up, sync

LAT_BUCKET = 32
OUT_BUCKET = 64


def quantize_diffusion_weights(params):
    """int8 pairs for the denoiser's hot matmuls (the same tensors, math
    and pairs as the JAX package's quantize_diffusion_weights), on the
    tree's device: the stacked layers/integrator/tail qkv, proj and
    resblock convs, plus the integrating conv, become pre-transposed
    (w_int8, scale) pairs. Pairs pass through."""
    def q_lin(w):  # (..., out, in) -> ((..., in, out) int8, scale)
        if isinstance(w, (tuple, list)):
            return tuple(w)
        return quantize_cols(w.transpose(-1, -2))

    def q_conv(w):  # (..., out, in, k) -> ((..., k*in, out) int8, scale)
        if isinstance(w, (tuple, list)):
            return tuple(w)
        k, c_in, c_out = w.shape[-1], w.shape[-2], w.shape[-3]
        wm = w.transpose(-1, -3).reshape(*w.shape[:-3], k * c_in, c_out)
        return quantize_cols(wm)

    out = dict(params)
    for group in ("layers", "integrator", "tail"):
        blk = dict(out[group])
        for key in ("attn_qkv_w", "attn_proj_w", "res_in_conv_w"):
            if key in blk:
                blk[key] = q_lin(blk[key])
        if "res_out_conv_w" in blk:
            blk["res_out_conv_w"] = q_conv(blk["res_out_conv_w"])
        out[group] = blk
    out["integrating_w"] = q_lin(out["integrating_w"])
    return out


def _prepare_params(params, int8_weights: bool, device="cpu"):
    """Device tree; with int8_weights quantized there after an f32
    upload. Memoized per (tree, device, plane)."""
    if int8_weights:
        return cached_cast(params, "int8", lambda p: (
            quantize_diffusion_weights(tree_to_torch(p, device))), device)
    return cached_cast(params, "device", lambda p: tree_to_torch(p, device),
                       device)


def draw_normal(generator, shape, device) -> torch.Tensor:
    """f32 standard-normal noise (every draw of the stage goes through
    here)."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def _progress_cuts(n: int):
    """The steps [0, ..., n] (~10 chunks) after which the progress callback
    fires, as in the JAX package (diffusion_stage.py:99)."""
    step = max(1, n // 10)
    return sorted({min(n, c) for c in range(0, n + step, step)} | {n})


def schedule_arrays(cfg: DiffusionConfig, device="cpu") -> dict:
    """f32 schedule vectors on the device, plus the host timestep map."""
    s = ds.make_schedule(cfg.n_train_timesteps,
                         n_steps=cfg.n_sample_timesteps)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return {
        "tmap": np.asarray(s.timestep_map, np.int64),
        "log_betas": f32(np.log(s.betas)),
        "post_logvar": f32(s.posterior_log_variance_clipped),
        "sqrt_recip_acp": f32(s.sqrt_recip_alphas_cumprod),
        "sqrt_recipm1_acp": f32(s.sqrt_recipm1_alphas_cumprod),
        "coef1": f32(s.posterior_mean_coef1),
        "coef2": f32(s.posterior_mean_coef2),
    }


def posterior_step(sched, cfg: DiffusionConfig, x, cond_mean, uncond_mean,
                   var_frac, t: int, noise, variance_swap: bool = True):
    """CFG blend, learned variance, x0 prediction, posterior mean,
    ancestral sample (the mean alone at t = 0)."""
    k = ds.cond_free_k(t, cfg.n_sample_timesteps, cfg.cond_free_k)
    k1 = float(np.float32(1.0) + np.float32(k))
    eps = k1 * cond_mean - k * uncond_mean
    logvar = ds.model_log_variance(var_frac, t, sched["log_betas"],
                                   sched["post_logvar"], variance_swap)
    x0 = ds.predict_xstart_from_eps(x, eps, sched["sqrt_recip_acp"][t],
                                    sched["sqrt_recipm1_acp"][t])
    mean = ds.q_posterior_mean(x, x0, sched["coef1"][t], sched["coef2"][t])
    if t > 0:
        return mean + torch.exp(0.5 * logvar) * noise
    return mean


def _masks(lat_lens, out_lens, lat_pad, out_pad, device):
    lat_mask = torch.arange(lat_pad, device=device)[None, :] \
        < torch.as_tensor(lat_lens, device=device)[:, None]
    out_mask = torch.arange(out_pad, device=device)[None, :] \
        < torch.as_tensor(out_lens, device=device)[:, None]
    # rows that fill their bucket exactly need no masking
    return (None if bool(lat_mask.all()) else lat_mask,
            None if bool(out_mask.all()) else out_mask)


def _buckets(length: int, cfg: DiffusionConfig, device):
    """(length, length) rel-pos bucket ids for the plain attention path;
    None when a kernel runs (B and D1 build their own Toeplitz bias)."""
    if cfg.use_flash:
        return None
    return torch.as_tensor(relative_position_buckets(
        length, cfg.rel_pos_buckets, cfg.rel_pos_max_distance),
        device=device)


def _denoise_loop(params, cfg, sched, code_emb2, x, out_buckets, out_mask,
                  draw_noise, compute_dtype, variance_swap, progress=None,
                  report_at=None):
    """The n denoising steps from x; ``progress(done / n)`` fires after
    each step count in ``report_at`` (default: every step)."""
    b = x.shape[0]
    n = cfg.n_sample_timesteps
    for i in range(n):
        t = n - 1 - i
        out = dmodel.denoise(params, cfg, torch.cat([x, x], dim=0),
                             code_emb2, int(sched["tmap"][t]), out_buckets,
                             out_mask, compute_dtype)
        cond_mean, var_frac = out[:b, :cfg.n_mel], out[:b, cfg.n_mel:]
        uncond_mean = out[b:, :cfg.n_mel]
        x = posterior_step(sched, cfg, x, cond_mean, uncond_mean, var_frac,
                           t, draw_noise(), variance_swap)
        if out_mask is not None:
            x = torch.where(out_mask[:, None, :], x, 0.0)
        if progress is not None and (report_at is None
                                     or i + 1 in report_at):
            sync(x.device)  # the callback reports finished steps
            progress((i + 1) / n)
    return x


@torch.inference_mode()
def diffusion_batch_device(params, latents_dev, keep_lens,
                           cfg: DiffusionConfig = DiffusionConfig(),
                           seed: int = 0, variance_swap: bool = True,
                           compute_dtype=None, int8_weights: bool = False,
                           device="cpu", progress=None,
                           substage_timings: Optional[dict] = None):
    """Device latents (B, >=L, D) with per-row keep lengths -> the mel as
    a device (B, n_mel, out_pad) tensor plus per-row lengths (numpy), all
    rows in one masked batch. ``progress(fraction)`` fires at 0 and after
    the steps of ``_progress_cuts``. ``substage_timings`` receives the
    walls of the weight cast and of the rest (conditioner plus the
    denoising loop), synchronising the device at each boundary."""
    st = substage_timings
    t_sub = time.monotonic()
    params = _prepare_params(params, int8_weights, device)
    if st is not None:
        sync(device)
        st["diffusion_cast_s"] = time.monotonic() - t_sub
        t_sub = time.monotonic()
    b = latents_dev.shape[0]
    if b == 0:
        raise ValueError("latents_dev has no rows")
    lat_lens = np.asarray(keep_lens, np.int64)
    out_lens = np.asarray([mel_length_for_latents(int(n)) for n in lat_lens],
                          np.int64)
    lat_pad = round_up(int(lat_lens.max()), LAT_BUCKET)
    out_pad = round_up(int(out_lens.max()), OUT_BUCKET)
    lat_in = latents_dev.to(device).float()[:, :lat_pad]
    if lat_in.shape[1] < lat_pad:
        lat_in = torch.nn.functional.pad(
            lat_in, (0, 0, 0, lat_pad - lat_in.shape[1]))
    lat_mask, out_mask = _masks(lat_lens, out_lens, lat_pad, out_pad, device)
    sched = schedule_arrays(cfg, device)
    cond, uncond = dmodel.code_embeddings(
        params, cfg, lat_in, _buckets(lat_pad, cfg, device), out_pad,
        torch.as_tensor(lat_lens, device=device),
        torch.as_tensor(out_lens, device=device), lat_mask, compute_dtype)
    code_emb2 = torch.cat([cond, uncond], dim=0)
    gen = common.make_generator(seed, device)

    def draw_noise():
        return draw_normal(gen, (b, cfg.n_mel, out_pad), device)

    x = draw_noise()
    if out_mask is not None:
        x = torch.where(out_mask[:, None, :], x, 0.0)
    if progress is not None:
        progress(0.0)
    x = _denoise_loop(params, cfg, sched, code_emb2, x,
                      _buckets(out_pad, cfg, device), out_mask, draw_noise,
                      compute_dtype, variance_swap, progress,
                      set(_progress_cuts(cfg.n_sample_timesteps)[1:]))
    if st is not None:
        sync(device)
        st["diffusion_loop_s"] = time.monotonic() - t_sub
        st["diffusion_steps"] = cfg.n_sample_timesteps
    return x, out_lens


def diffusion_batch(params, latents_list,
                    cfg: DiffusionConfig = DiffusionConfig(), seed: int = 0,
                    variance_swap: bool = True, compute_dtype=None,
                    int8_weights: bool = False, device="cpu", progress=None):
    """Host list of (L_i, 1024) latents -> list of (100, T_i) host mels,
    decoded together in one masked batch (diffusion_batch_device on the
    rows zero-padded to the longest one's bucket)."""
    lats = [np.asarray(l, np.float32) for l in latents_list]
    if not lats:
        raise ValueError("latents_list is empty")
    lens = [l.shape[0] for l in lats]
    lat_in = np.zeros((len(lats), round_up(max(lens), LAT_BUCKET),
                       lats[0].shape[1]), np.float32)
    for i, l in enumerate(lats):
        lat_in[i, :l.shape[0]] = l
    mel, out_lens = diffusion_batch_device(
        params, torch.as_tensor(lat_in), lens, cfg, seed, variance_swap,
        compute_dtype, int8_weights, device, progress)
    mel = mel.float().cpu().numpy()
    return [mel[i, :, :out_lens[i]] for i in range(len(lats))]


@torch.inference_mode()
def diffusion(params, latents: np.ndarray,
              cfg: DiffusionConfig = DiffusionConfig(), seed: int = 0,
              rng=None, variance_swap: bool = True, compute_dtype=None,
              int8_weights: bool = False, device="cpu",
              progress=None) -> np.ndarray:
    """Latents (L, 1024) -> normalized mel (100, T) on the host.

    rng=None: torch.Generator noise (diffusion_batch at B=1);
    rng=ReferenceRng: the reference's mt19937 noise stream, with
    ``progress`` after every step."""
    if rng is None:
        return diffusion_batch(params, [latents], cfg, seed, variance_swap,
                               compute_dtype, int8_weights, device,
                               progress)[0]
    latents = np.asarray(latents, np.float32)
    params = _prepare_params(params, int8_weights, device)
    lat_len = latents.shape[0]
    out_len = mel_length_for_latents(lat_len)
    lat_pad = round_up(lat_len, LAT_BUCKET)
    out_pad = round_up(out_len, OUT_BUCKET)
    lat_in = np.zeros((1, lat_pad, latents.shape[1]), np.float32)
    lat_in[0, :lat_len] = latents
    lat_mask, out_mask = _masks([lat_len], [out_len], lat_pad, out_pad,
                                device)
    sched = schedule_arrays(cfg, device)
    cond, uncond = dmodel.code_embeddings(
        params, cfg, torch.as_tensor(lat_in, device=device),
        _buckets(lat_pad, cfg, device), out_pad, lat_len, out_len, lat_mask,
        compute_dtype)
    code_emb2 = torch.cat([cond, uncond], dim=0)

    def draw_noise():
        x = np.zeros((1, cfg.n_mel, out_pad), np.float32)
        x[0, :, :out_len] = rng.normal_f32(cfg.n_mel * out_len).reshape(
            cfg.n_mel, out_len)
        return torch.as_tensor(x, device=device)

    x = _denoise_loop(params, cfg, sched, code_emb2, draw_noise(),
                      _buckets(out_pad, cfg, device), out_mask, draw_noise,
                      compute_dtype, variance_swap, progress)
    return x[0, :, :out_len].float().cpu().numpy()

