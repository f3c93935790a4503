"""Stage 2 driver: the 80-step DDPM with classifier-free guidance
(counterpart of ``tortoise_tpu/pipeline/diffusion_stage.py``).

The latent conditioner runs once; each step is one batch-of-2 denoiser
eval (cond rows, then uncond rows). Semantics as in the JAX package:
output length L*4*24000/22050; the variance channel comes from the
conditioned eval only; loop step i handles respaced t = S-1-i; noise is
drawn every step even though the last step discards it; lengths round up
to buckets with masked norms and attention (``bucketed=False``: to the
longest row's own lengths, masks dropped when every row fills them).

Two noise planes: ``diffusion_batch_device`` (and ``diffusion_batch``,
its host-list form) draws from a ``torch.Generator`` through
``draw_normal`` — the initial noise, then one draw a step, like the JAX
package's key chain (diffusion_stage.py:181-182, 237-238);
``diffusion(rng=ReferenceRng)`` consumes the mt19937 stream in the
reference's order.

On the card without a mesh the loop replays a CUDA graph of one step
(``_denoise_step``; ``pipeline.graphs``), the counterpart of the JAX
package's ``lax.fori_loop``: the step reads t from a device counter and
every per-step number from the schedule's device tables.

Under a mesh (``mesh=``) each rank denoises its rows of the "dp" split
(lengths, buckets and masks are those of the whole batch), drawing each
GLOBAL noise tensor and keeping its rows, with the heads and channels of
its "tp" place (``models.diffusion``); the mel is gathered, so every
rank returns every row.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from tortoise_tpu_torch.config import DiffusionConfig, mel_length_for_latents
from tortoise_tpu_torch.models import diffusion as dmodel
from tortoise_tpu_torch.ops.basic import quantize_cols, quantize_cols_host
from tortoise_tpu_torch.ops.relpos import relative_position_buckets
from tortoise_tpu_torch.parallel.mesh import axis_group
from tortoise_tpu_torch.parallel.sharding import diffusion_param_specs
from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline import common, graphs
from tortoise_tpu_torch.pipeline import schedule as ds
from tortoise_tpu_torch.pipeline.common import (
    cached_cast,
    download,
    dp_rows,
    draw_rows,
    resolve_device,
    round_up,
    shard_cast,
    substage,
    sync,
)
from tortoise_tpu_torch.utils import profiling

LAT_BUCKET = 32
OUT_BUCKET = 64


def quantize_diffusion_weights(params):
    """int8 pairs for the denoiser's hot matmuls (the same tensors, math
    and pairs as the JAX package's quantize_diffusion_weights): the
    stacked layers/integrator/tail qkv, proj and resblock convs, plus the
    integrating conv, become pre-transposed (w_int8, scale) pairs. Tensor
    leaves are quantized on their device; numpy leaves on the host
    (``quantize_cols_host``), giving numpy pairs for a plane cache
    (``io/plane_cache.py``). Pairs pass through as tuples."""
    def q(wm):
        if isinstance(wm, np.ndarray):
            return quantize_cols_host(wm)
        return quantize_cols(wm)

    def q_lin(w):  # (..., out, in) -> ((..., in, out) int8, scale)
        if isinstance(w, (tuple, list)):
            return tuple(w)
        return q(w.swapaxes(-1, -2))

    def q_conv(w):  # (..., out, in, k) -> ((..., k*in, out) int8, scale)
        if isinstance(w, (tuple, list)):
            return tuple(w)
        k, c_in, c_out = w.shape[-1], w.shape[-2], w.shape[-3]
        return q(w.swapaxes(-1, -3).reshape(*w.shape[:-3], k * c_in, c_out))

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


def _prepare_params(params, int8_weights: bool, device="cpu", mesh=None):
    """Device tree; with int8_weights quantized there after an f32
    upload (the whole tree, before any tp slicing takes its part).
    Memoized per (tree, device, plane, and mesh shape and rank)."""
    key = "int8" if int8_weights else "device"
    if int8_weights:
        full = cached_cast(params, key, lambda p: (
            quantize_diffusion_weights(tree_to_torch(p, device))), device)
    else:
        full = cached_cast(params, key, lambda p: tree_to_torch(p, device),
                           device)
    return shard_cast(params, key, full, diffusion_param_specs, mesh,
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
    """The schedule's per-step device tables, indexed by the respaced
    step t: ``tmap`` (the original timestep ids), ``cfk`` and ``cfk1``
    (the CFG weight k and 1 + k, each in f32 as the reference rounds
    them), ``noisy`` (t > 0: the ancestral noise applies) and the f32
    schedule vectors. A step reads them at a device index, so one
    captured step serves every t."""
    s = ds.make_schedule(cfg.n_train_timesteps,
                         n_steps=cfg.n_sample_timesteps)
    n = cfg.n_sample_timesteps
    k = np.asarray([ds.cond_free_k(t, n, cfg.cond_free_k) for t in range(n)],
                   np.float32)

    def dev(a):
        return torch.as_tensor(np.asarray(a), device=device)

    def f32(a):
        return dev(np.asarray(a, np.float32))

    return {
        "tmap": dev(np.asarray(s.timestep_map, np.int64)),
        "cfk": f32(k),
        "cfk1": f32(np.float32(1.0) + k),
        "noisy": dev(np.arange(n) > 0),
        "log_betas": f32(np.log(s.betas)),
        "post_logvar": f32(s.posterior_log_variance_clipped),
        "sqrt_recip_acp": f32(s.sqrt_recip_alphas_cumprod),
        "sqrt_recipm1_acp": f32(s.sqrt_recipm1_alphas_cumprod),
        "coef1": f32(s.posterior_mean_coef1),
        "coef2": f32(s.posterior_mean_coef2),
    }


def posterior_step(sched, cfg: DiffusionConfig, x, cond_mean, uncond_mean,
                   var_frac, t, noise, variance_swap: bool = True):
    """CFG blend, learned variance, x0 prediction, posterior mean,
    ancestral sample (the mean alone at t = 0). ``t`` is the respaced
    step, an int or a (1,) long device index (the loop's step graph
    carries it on the device, as the JAX loop carries a traced t); every
    per-step number is read from ``sched``'s tables at it, and t = 0's
    mean is selected, not multiplied, so it stays bit for bit."""
    eps = sched["cfk1"][t] * cond_mean - sched["cfk"][t] * uncond_mean
    logvar = ds.model_log_variance(var_frac, t, sched["log_betas"],
                                   sched["post_logvar"], variance_swap)
    x0 = ds.predict_xstart_from_eps(x, eps, sched["sqrt_recip_acp"][t],
                                    sched["sqrt_recipm1_acp"][t])
    mean = ds.q_posterior_mean(x, x0, sched["coef1"][t], sched["coef2"][t])
    return torch.where(sched["noisy"][t],
                       mean + torch.exp(0.5 * logvar) * noise, mean)


def _pads(lat_len: int, out_len: int, bucketed: bool):
    """(lat_pad, out_pad): the lengths rounded up to LAT_BUCKET and
    OUT_BUCKET, or kept as they are with ``bucketed=False``."""
    if not bucketed:
        return lat_len, out_len
    return round_up(lat_len, LAT_BUCKET), round_up(out_len, OUT_BUCKET)


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


def _denoise_step(params, cfg, sched, compute_dtype, variance_swap, tp,
                  bufs) -> None:
    """One denoising step on ``bufs`` in place: the batch-of-2B CFG
    denoiser eval of ``x`` at the respaced step ``t`` (a (1,) device
    index), the posterior step with ``noise``, the out-mask; then t
    counts down. The unit a step graph holds."""
    x, t, mask = bufs["x"], bufs["t"], bufs["out_mask"]
    b = x.shape[0]
    out = dmodel.denoise(params, cfg, torch.cat([x, x], dim=0),
                         bufs["code_emb2"], sched["tmap"][t],
                         bufs["buckets"], mask, compute_dtype, tp)
    cond_mean, var_frac = out[:b, :cfg.n_mel], out[:b, cfg.n_mel:]
    uncond_mean = out[b:, :cfg.n_mel]
    x_next = posterior_step(sched, cfg, x, cond_mean, uncond_mean, var_frac,
                            t, bufs["noise"], variance_swap)
    if mask is not None:
        x_next = torch.where(mask[:, None, :], x_next, 0.0)
    x.copy_(x_next)
    t.sub_(1)


def _denoise_loop(params, cfg, sched, code_emb2, x, out_buckets, out_mask,
                  draw_noise, compute_dtype, variance_swap, progress=None,
                  report_at=None, tp=None, mesh=None, eager=False):
    """The n denoising steps from x; ``progress(done / n)`` fires after
    each step count in ``report_at`` (default: every step). Each step is
    ``_denoise_step``: on a card without a ``mesh`` the replay of one
    captured step (``pipeline.graphs``; ``eager`` runs the eager loop
    there, for A/B runs), else the step run eagerly. Each step's noise
    is drawn by ``draw_noise`` into the step's buffer before it runs."""
    n = cfg.n_sample_timesteps
    inputs = {"x": x, "code_emb2": code_emb2, "out_mask": out_mask,
              "buckets": out_buckets}

    def make_bufs(static):
        bufs = {k: None if v is None else torch.empty_like(v)
                for k, v in inputs.items()} if static else dict(inputs)
        bufs["x"] = torch.empty_like(x)
        bufs["noise"] = torch.empty_like(x)
        bufs["t"] = torch.zeros((1,), dtype=torch.long, device=x.device)
        return bufs

    step = functools.partial(_denoise_step, params, cfg, sched,
                             compute_dtype, variance_swap, tp)
    key = ("diffusion", cfg, str(compute_dtype), variance_swap,
           tuple(x.shape), tuple(code_emb2.shape), code_emb2.dtype,
           code_emb2.stride(), out_mask is None, out_buckets is None)
    with graphs.stepping(not eager and graphs.use_graphs(x.device, mesh),
                         key, params, make_bufs, step, keep=(sched,)) \
            as (bufs, run):
        for k, v in inputs.items():
            if bufs[k] is not v:
                bufs[k].copy_(v)
        bufs["t"].fill_(n - 1)
        for i in range(n):
            bufs["noise"].copy_(draw_noise())
            run()
            if progress is not None and (report_at is None
                                         or i + 1 in report_at):
                sync(x.device)  # the callback reports finished steps
                progress((i + 1) / n)
        return bufs["x"].clone()


@torch.inference_mode()
def diffusion_batch_device(params, latents_dev, keep_lens,
                           cfg: DiffusionConfig = DiffusionConfig(),
                           seed: int = 0, variance_swap: bool = True,
                           compute_dtype=None, mesh=None,
                           int8_weights: bool = False, device=None,
                           progress=None,
                           substage_timings: Optional[dict] = None,
                           bucketed: bool = True):
    """Device latents (B, >=L, D) with per-row keep lengths -> the mel as
    a device (B, n_mel, out_pad) tensor plus per-row lengths (numpy), all
    rows in one masked batch. ``progress(fraction)`` fires at 0 and after
    the steps of ``_progress_cuts``. ``substage_timings`` receives the
    walls of the weight cast and of the rest (the span
    ``diffusion.sample``: the conditioner and the denoising loop),
    synchronising the device at each boundary. ``mesh``: this rank
    denoises its rows and heads and returns every row (see the module
    docstring). ``bucketed=False`` pads to the longest row's own
    lengths instead of LAT_BUCKET / OUT_BUCKET (the JAX package's host
    wrappers reach that; its device entry always rounds up)."""
    device = resolve_device(device)
    st = substage_timings
    with substage("diffusion.cast", st, "diffusion_cast_s", device):
        params = _prepare_params(params, int8_weights, device, mesh)
        tp = axis_group(mesh, "tp")
    n = cfg.n_sample_timesteps
    with substage("diffusion.sample", st, "diffusion_loop_s", device):
        with profiling.span("diffusion.conditioner", device):
            b = latents_dev.shape[0]
            if b == 0:
                raise ValueError("latents_dev has no rows")
            lat_lens = np.asarray(keep_lens, np.int64)
            out_lens = np.asarray([mel_length_for_latents(int(k))
                                   for k in lat_lens], np.int64)
            lat_pad, out_pad = _pads(int(lat_lens.max()),
                                     int(out_lens.max()), bucketed)
            lat_in = latents_dev.to(device).float()[:, :lat_pad]
            if lat_in.shape[1] < lat_pad:
                lat_in = torch.nn.functional.pad(
                    lat_in, (0, 0, 0, lat_pad - lat_in.shape[1]))
            # this rank's rows, padded and masked as in the whole batch
            rows = dp_rows(mesh, b, "diffusion_batch_device")
            lat_mask, out_mask = (None if m is None else m[rows]
                                  for m in _masks(lat_lens, out_lens,
                                                  lat_pad, out_pad, device))
            sched = schedule_arrays(cfg, device)
            cond, uncond = dmodel.code_embeddings(
                params, cfg, lat_in[rows], _buckets(lat_pad, cfg, device),
                out_pad, torch.as_tensor(lat_lens[rows], device=device),
                torch.as_tensor(out_lens[rows], device=device), lat_mask,
                compute_dtype, tp)
            code_emb2 = torch.cat([cond, uncond], dim=0)
        with profiling.span("diffusion.denoise_loop", device, steps=n):
            gen = common.make_generator(seed, device)

            def draw_noise():
                return draw_rows(draw_normal, gen, (b, cfg.n_mel, out_pad),
                                 device, rows)

            x = draw_noise()
            if out_mask is not None:
                x = torch.where(out_mask[:, None, :], x, 0.0)
            if progress is not None:
                progress(0.0)
            x = _denoise_loop(params, cfg, sched, code_emb2, x,
                              _buckets(out_pad, cfg, device), out_mask,
                              draw_noise, compute_dtype, variance_swap,
                              progress, set(_progress_cuts(n)[1:]), tp, mesh)
            if rows != slice(0, b):
                x = axis_group(mesh, "dp").all_gather(x)
    if st is not None:
        st["diffusion_steps"] = n
    return x, out_lens


def diffusion_batch(params, latents_list,
                    cfg: DiffusionConfig = DiffusionConfig(), seed: int = 0,
                    variance_swap: bool = True, compute_dtype=None,
                    bucketed: bool = True, mesh=None, progress=None,
                    int8_weights: bool = False, device=None):
    """Host list of (L_i, 1024) latents -> list of (100, T_i) host mels,
    decoded together in one masked batch (diffusion_batch_device on the
    rows zero-padded to the longest one; ``bucketed`` and ``mesh`` as
    there)."""
    device = resolve_device(device)
    lats = [np.asarray(l, np.float32) for l in latents_list]
    if not lats:
        raise ValueError("latents_list is empty")
    lens = [l.shape[0] for l in lats]
    lat_in = np.zeros((len(lats), max(lens), lats[0].shape[1]), np.float32)
    for i, l in enumerate(lats):
        lat_in[i, :l.shape[0]] = l
    mel, out_lens = diffusion_batch_device(
        params, torch.as_tensor(lat_in), lens, cfg, seed, variance_swap,
        compute_dtype, mesh, int8_weights, device, progress,
        bucketed=bucketed)
    (mel,) = download(mel)
    return [mel[i, :, :out_lens[i]] for i in range(len(lats))]


@torch.inference_mode()
def diffusion(params, latents: np.ndarray,
              cfg: DiffusionConfig = DiffusionConfig(), seed: int = 0,
              rng=None, variance_swap: bool = True, compute_dtype=None,
              bucketed: bool = True, progress=None,
              int8_weights: bool = False, device=None) -> np.ndarray:
    """Latents (L, 1024) -> normalized mel (100, T) on the host.

    rng=None: torch.Generator noise (diffusion_batch at B=1);
    rng=ReferenceRng: the reference's mt19937 noise stream, with
    ``progress`` after every step. ``bucketed=False`` pads to the true
    lengths instead of the buckets."""
    device = resolve_device(device)
    if rng is None:
        return diffusion_batch(params, [latents], cfg, seed, variance_swap,
                               compute_dtype, bucketed, progress=progress,
                               int8_weights=int8_weights, device=device)[0]
    latents = np.asarray(latents, np.float32)
    with profiling.span("diffusion.cast", device):
        params = _prepare_params(params, int8_weights, device)
    n = cfg.n_sample_timesteps
    with profiling.span("diffusion.conditioner", device):
        lat_len = latents.shape[0]
        out_len = mel_length_for_latents(lat_len)
        lat_pad, out_pad = _pads(lat_len, out_len, bucketed)
        lat_in = np.zeros((1, lat_pad, latents.shape[1]), np.float32)
        lat_in[0, :lat_len] = latents
        lat_mask, out_mask = _masks([lat_len], [out_len], lat_pad, out_pad,
                                    device)
        sched = schedule_arrays(cfg, device)
        cond, uncond = dmodel.code_embeddings(
            params, cfg, torch.as_tensor(lat_in, device=device),
            _buckets(lat_pad, cfg, device), out_pad, lat_len, out_len,
            lat_mask, compute_dtype)
        code_emb2 = torch.cat([cond, uncond], dim=0)

    def draw_noise():
        x = np.zeros((1, cfg.n_mel, out_pad), np.float32)
        x[0, :, :out_len] = rng.normal_f32(cfg.n_mel * out_len).reshape(
            cfg.n_mel, out_len)
        return torch.as_tensor(x, device=device)

    with profiling.span("diffusion.denoise_loop", device, steps=n):
        x = _denoise_loop(params, cfg, sched, code_emb2, draw_noise(),
                          _buckets(out_pad, cfg, device), out_mask,
                          draw_noise, compute_dtype, variance_swap, progress)
    return download(x[0, :, :out_len])[0]
