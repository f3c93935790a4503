"""The respaced DDPM schedule, the timestep embedding and the relative
position buckets, in float64 numpy where Tortoise computes them so.

The linear betas over 4000 training steps keep the original's float32
step (``i * (end - start) / (n - 1)`` in float32, then the float64
start added), the respacing accumulator is rounded to float32 between
steps, and the 80 sampled timesteps are ``round(i * 3999 / 79)``.
"""

from __future__ import annotations

import numpy as np


def timestep_map(n_steps: int, n_train: int) -> np.ndarray:
    return np.asarray([int(round(i * (n_train - 1) / (n_steps - 1)))
                       for i in range(n_steps)], np.int64)


def schedule(n_train: int, n_steps: int) -> dict:
    """The respaced schedule's float64 arrays, indexed by the respaced
    step t (0 = clean)."""
    scale = 1000.0 / n_train
    start, end = scale * 0.0001, scale * 0.02
    frac = (np.arange(n_train, dtype=np.float32) * np.float32(end - start)
            / np.float32(n_train - 1)).astype(np.float64)
    acp_full = np.cumprod(1.0 - (start + frac))
    tmap = timestep_map(n_steps, n_train)
    acp_at = acp_full[tmap]
    prev = np.concatenate(
        [[1.0], acp_at[:-1].astype(np.float32).astype(np.float64)])
    betas = 1.0 - acp_at / prev
    acp = np.cumprod(1.0 - betas)
    acp_prev = np.concatenate([[1.0], acp[:-1]])
    post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
    return {
        "tmap": tmap,
        "log_betas": np.log(betas),
        "post_logvar": np.log(np.concatenate([[post_var[1]], post_var[1:]])),
        "sqrt_recip_acp": np.sqrt(1.0 / acp),
        "sqrt_recipm1_acp": np.sqrt(1.0 / acp - 1.0),
        "coef1": betas * np.sqrt(acp_prev) / (1.0 - acp),
        "coef2": (1.0 - acp_prev) * np.sqrt(1.0 - betas) / (1.0 - acp),
    }


def cond_free_k(t: int, n_steps: int, base: float) -> float:
    """The guidance weight at respaced step t, in float32."""
    return float(np.float32(base) * (np.float32(1.0)
                                     - np.float32(t) / np.float32(n_steps)))


def timestep_freqs(dim: int, max_period: int) -> np.ndarray:
    half = dim // 2
    return np.exp(-np.log(float(max_period))
                  * np.arange(half, dtype=np.float64) / half
                  ).astype(np.float32)


def relative_position_buckets(length: int, num_buckets: int,
                              max_distance: int) -> np.ndarray:
    """(length, length) T5 bucket ids, bidirectional, for query i and
    key j (the large-distance value truncated through float32)."""
    i = np.arange(length)[:, None]
    j = np.arange(length)[None, :]
    delta = j - i
    half = num_buckets // 2
    rel = np.abs(delta)
    out = np.where(delta > 0, half, 0).astype(np.int64)
    rel_safe = np.maximum(rel, 8)
    large = 8 + (np.log(rel_safe / 8.0) / np.log(max_distance / 8.0)
                 * (16.0 - 8.0)).astype(np.float32).astype(np.int64)
    out += np.where(rel < 8, rel, np.minimum(large, half - 1))
    return out
