"""T5-style relative position buckets (counterpart of
``tortoise_tpu/ops/relpos.py``).

Bidirectional, 32 buckets = 16 "query after key" + 16 "query before or at
key"; exact buckets for |distance| < 8, then log-spaced up to
max_distance 64, clamped to bucket 15. The large-distance value keeps the
reference's C float->int truncation (through float32), so the ids match
the JAX package's exactly.
"""

from __future__ import annotations

import numpy as np
import torch


def bucket_of_delta(delta: np.ndarray, num_buckets: int = 32,
                    max_distance: int = 64) -> np.ndarray:
    """Bucket id of key offset delta = j - i (numpy int array)."""
    half = num_buckets // 2
    delta = np.asarray(delta, np.int64)
    rel = np.abs(delta)
    out = np.where(delta > 0, half, 0).astype(np.int64)
    rel_safe = np.maximum(rel, 8)
    val_if_large = 8 + (
        np.log(rel_safe / 8.0) / np.log(max_distance / 8.0) * (16.0 - 8.0)
    ).astype(np.float32).astype(np.int64)
    val_if_large = np.minimum(val_if_large, half - 1)
    out += np.where(rel < 8, rel, val_if_large)
    return out.astype(np.int32)


def relative_position_buckets(length: int, num_buckets: int = 32,
                              max_distance: int = 64) -> np.ndarray:
    """(length, length) int32 bucket ids; bucket[i, j] for query i, key j."""
    i = np.arange(length)[:, None]
    j = np.arange(length)[None, :]
    return bucket_of_delta(j - i, num_buckets, max_distance)


def relpos_bias(weight: torch.Tensor, buckets: torch.Tensor,
                scale: float = 8.0) -> torch.Tensor:
    """Gather the (buckets, heads) table into an additive (heads, L, L)
    bias, scaled by the reference's x8."""
    return weight[buckets.long()].permute(2, 0, 1) * scale
