"""Logit post-processing and sampling (counterpart of
``tortoise_tpu/ops/sampling.py``).

The reference's decision pipeline: repetition penalty on the previous ids
(x*p if x<0 else x/p) -> /temperature -> top-k -> the ascending-cumsum
"top-p" rule (drop the low tail whose cumulative mass is <= 0.2, never the
largest) -> softmax -> inverse-CDF draw.

Two planes, as in the JAX package:

- tensor plane (on the device), fed explicit uniforms;
- host parity plane, ``host_process_logits_and_sample``: numpy float32 in
  the reference's exact operation order, driven by the mt19937
  ``tortoise_tpu_torch.rng.ReferenceRng``.
"""

from __future__ import annotations

import numpy as np
import torch

F32_LOWEST = float(np.finfo(np.float32).min)


def apply_repetition_penalty(logits: torch.Tensor, prev_ids: torch.Tensor,
                             penalty: float = 2.0) -> torch.Tensor:
    """logits (B, V); prev_ids (B, K). Duplicate ids are idempotent: the
    penalized value depends only on the original one."""
    ids = prev_ids.long()
    g = torch.gather(logits, -1, ids)
    pen = torch.where(g < 0, g * penalty, g / penalty)
    return logits.scatter(-1, ids, pen)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep values >= the kth largest (ties at the threshold survive)."""
    k = min(k, logits.shape[-1])
    thresh = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < thresh, F32_LOWEST, logits)


def top_p_filter(logits: torch.Tensor, p_drop: float = 0.2) -> torch.Tensor:
    """The reference's ascending-cumsum nucleus filter."""
    s, order = torch.sort(logits, dim=-1, stable=True)
    cum = torch.cumsum(torch.softmax(s, dim=-1), dim=-1)
    drop_sorted = cum <= p_drop
    drop_sorted[..., -1] = False  # the largest is never dropped
    drop = torch.zeros_like(drop_sorted).scatter(-1, order, drop_sorted)
    return torch.where(drop, F32_LOWEST, logits)


def process_logits(logits, prev_ids, temperature: float = 0.8,
                   top_k: int = 50, top_p_drop: float = 0.2,
                   repetition_penalty: float = 2.0) -> torch.Tensor:
    """Full filter pipeline -> probabilities (B, V)."""
    x = apply_repetition_penalty(logits, prev_ids, repetition_penalty)
    x = x / temperature
    x = top_k_filter(x, top_k)
    x = top_p_filter(x, top_p_drop)
    return torch.softmax(x, dim=-1)


def process_logits_topk(logits, prev_ids, temperature: float = 0.8,
                        top_k: int = 50, top_p_drop: float = 0.2,
                        repetition_penalty: float = 2.0):
    """process_logits in the k-candidate domain: the nucleus rule as
    suffix sums over the descending top-k values. Returns (probs (B, k),
    ids (B, k))."""
    x = apply_repetition_penalty(logits, prev_ids, repetition_penalty)
    x = x / temperature
    top_k = min(top_k, logits.shape[-1])
    vals, ids = torch.topk(x, top_k, dim=-1)  # descending
    p = torch.softmax(vals, dim=-1)
    suffix = torch.flip(torch.cumsum(torch.flip(p, (-1,)), -1), (-1,))
    drop = suffix <= top_p_drop
    drop[..., 0] = False
    vals = torch.where(drop, F32_LOWEST, vals)
    return torch.softmax(vals, dim=-1), ids


def sample_from_topk_u(u: torch.Tensor, probs: torch.Tensor,
                       ids: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF draw over the top-k candidates against pre-drawn
    uniforms u (B, 1), mapped back to vocab ids (B,) int32."""
    cum = torch.cumsum(probs, dim=-1)
    pos = torch.clamp((cum < u).sum(dim=-1), max=probs.shape[-1] - 1)
    return torch.gather(ids, -1, pos[:, None])[:, 0].to(torch.int32)


# --------------------------------------------------------------------------
# host parity plane (numpy float32, reference operation order)
# --------------------------------------------------------------------------

def _host_softmax_unshifted(x: np.ndarray) -> np.ndarray:
    # no max subtraction, sequential float32 sum (the reference's order)
    e = np.exp(x, dtype=np.float32)
    return e / np.add.accumulate(e)[-1]


def host_process_logits_and_sample(logits: np.ndarray, prev_ids_per_seq,
                                   rng, temperature: float = 0.8,
                                   top_k: int = 50, top_p_drop: float = 0.2,
                                   repetition_penalty: float = 2.0):
    """Reference-exact host sampler. logits (B, V) float32;
    prev_ids_per_seq: B id lists; rng: ReferenceRng. Returns (B,) ids."""
    logits = np.array(logits, dtype=np.float32)
    bsz, v = logits.shape
    samples = np.zeros(bsz, dtype=np.int64)
    for b in range(bsz):
        ids = np.asarray(prev_ids_per_seq[b], dtype=np.int64)
        g = logits[b, ids]
        g = np.where(g < 0, g * np.float32(repetition_penalty),
                     g / np.float32(repetition_penalty))
        logits[b, ids] = g
    for b in range(bsz):
        row = logits[b].copy()
        row /= np.float32(temperature)
        kth = np.sort(row)[-min(top_k, v)]
        row[row < kth] = F32_LOWEST
        order = np.argsort(row, kind="stable")
        p = _host_softmax_unshifted(row[order])
        cum = np.cumsum(p, dtype=np.float32)
        drop = cum <= np.float32(top_p_drop)
        drop[-1] = False
        row[order[drop]] = F32_LOWEST
        samples[b] = rng.multinomial(_host_softmax_unshifted(row))
    return samples
