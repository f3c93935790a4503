"""DDPM schedule arrays and sampler math (counterpart of
``tortoise_tpu/pipeline/schedule.py``).

The schedule arrays are the reference's respaced linear schedule,
computed in float64 on the host exactly as the JAX package does
(linear betas over 4000 steps with the reference's float32 quirks, the
80-entry respacing map, the swapped learned-variance interpolation); the
per-step math runs on tensors.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def make_timestep_map(n_steps: int, n_train: int = 4000):
    """Evenly respaced original-timestep ids; at n_steps=80 this reproduces
    the table hardcoded at main.cpp:5641-5648."""
    if n_steps < 2:
        raise ValueError("need at least 2 sampling steps")
    return tuple(
        int(round(i * (n_train - 1) / (n_steps - 1))) for i in range(n_steps)
    )


TIMESTEP_MAP_80 = make_timestep_map(80)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Respaced schedule arrays, indexed by respaced step t (0 = clean)."""

    timestep_map: np.ndarray          # (S,) original timesteps
    betas: np.ndarray                 # (S,)
    alphas_cumprod: np.ndarray        # (S,)
    alphas_cumprod_prev: np.ndarray   # (S,)
    sqrt_recip_alphas_cumprod: np.ndarray
    sqrt_recipm1_alphas_cumprod: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_steps(self) -> int:
        return len(self.betas)


def linear_betas(n: int = 4000) -> np.ndarray:
    scale = 1000.0 / n
    start, end = scale * 0.0001, scale * 0.02
    # the reference computes i * (float)(end-start) / (n-1) with the
    # multiply AND divide in float32 (ints promote to float), then adds the
    # double start (main.cpp:5394-5399)
    frac = (np.arange(n, dtype=np.float32) * np.float32(end - start)
            / np.float32(n - 1)).astype(np.float64)
    return start + frac


def make_schedule(n_train: int = 4000, timestep_map=None,
                  n_steps: int = 80) -> Schedule:
    if timestep_map is None:
        timestep_map = (TIMESTEP_MAP_80 if n_steps == 80
                        else make_timestep_map(n_steps, n_train))
    tmap = np.asarray(timestep_map, np.int64)
    if tmap.size < 2:
        # the guard in make_timestep_map must also cover caller-supplied
        # maps: post_logvar below indexes post_var[1]
        raise ValueError("need at least 2 sampling timesteps, got "
                         f"{tmap.size}")
    acp_full = np.cumprod(1.0 - linear_betas(n_train))
    acp_at = acp_full[tmap]
    # the reference's respacing accumulator is a FLOAT
    # (`float last_alpha_cumulative_product = 1.0`, main.cpp:5654,
    # 5662-5666): each respaced beta divides the double cumprod by the
    # f32-rounded previous one (caught by tests/test_ddpm_oracle.py —
    # ~9e-6 relative without the cast)
    prev_full = np.concatenate(
        [[1.0], acp_at[:-1].astype(np.float32).astype(np.float64)])
    betas = 1.0 - acp_at / prev_full
    acp = np.cumprod(1.0 - betas)
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    post_logvar = np.log(
        np.concatenate([[post_var[1]], post_var[1:]])
    )
    return Schedule(
        timestep_map=tmap,
        betas=betas,
        alphas_cumprod=acp,
        alphas_cumprod_prev=acp_prev,
        sqrt_recip_alphas_cumprod=np.sqrt(1.0 / acp),
        sqrt_recipm1_alphas_cumprod=np.sqrt(1.0 / acp - 1.0),
        posterior_variance=post_var,
        posterior_log_variance_clipped=post_logvar,
        posterior_mean_coef1=betas * np.sqrt(acp_prev) / (1.0 - acp),
        posterior_mean_coef2=(1.0 - acp_prev) * np.sqrt(1.0 - betas)
        / (1.0 - acp),
    )


@functools.cache
def _freqs(half: int, max_period: int, device: torch.device) -> torch.Tensor:
    # uploaded once per device: a pageable host-to-device copy in every
    # denoiser step would stall the stream. Never dropped: a captured
    # step graph (pipeline/graphs.py) reads it by address
    return torch.as_tensor(
        np.exp(-np.log(float(max_period))
               * np.arange(half, dtype=np.float64) / half).astype(np.float32),
        device=device)


def timestep_embedding(timesteps, dim: int = 1024, max_period: int = 10000,
                       device=None) -> torch.Tensor:
    """Sinusoidal embedding, cos half first; frequencies computed in
    float64 and rounded once to float32 like the reference.
    timesteps: (...,) -> (..., dim) float32."""
    freqs = _freqs(dim // 2, max_period, torch.device(device or "cpu"))
    t = torch.as_tensor(timesteps, device=device).to(torch.float32)
    args = t[..., None] * freqs
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[..., :1])], dim=-1)
    return emb


def cond_free_k(t: int, num_steps: int, base: float = 2.0) -> float:
    """k = base * (1 - t/num_steps) with t the respaced step, in float32."""
    return float(np.float32(base) * (np.float32(1.0)
                                     - np.float32(t) / np.float32(num_steps)))


def model_log_variance(var_frac_raw, t: int, sched_betas_log,
                       sched_post_logvar, variance_swap: bool = True):
    """Interpolate the learned variance channel (raw model output in
    [-1, 1]) into a log variance; variance_swap=True is the reference's
    swapped argument order."""
    frac = (var_frac_raw + 1.0) / 2.0
    max_log = sched_betas_log[t]
    min_log = sched_post_logvar[t]
    if variance_swap:
        return frac * min_log + (1.0 - frac) * max_log
    return frac * max_log + (1.0 - frac) * min_log


def predict_xstart_from_eps(x, eps, sqrt_recip_acp_t, sqrt_recipm1_acp_t):
    """x0 = sr*x - srm1*eps, clamped to [-1, 1]."""
    return torch.clamp(sqrt_recip_acp_t * x - sqrt_recipm1_acp_t * eps,
                       -1.0, 1.0)


def q_posterior_mean(x, x0, coef1_t, coef2_t):
    return coef1_t * x0 + coef2_t * x
