#!/usr/bin/env python3
"""The sampler's building blocks on the card: the counterpart of
``scripts/ubench_sampler_ops.py``.

    python3 scripts/torch_ubench_sampler_ops.py              # the card
    python3 scripts/torch_ubench_sampler_ops.py --device cpu --small

Over one row of V = 8194 logits (the mel vocabulary) ~ N(0, 3) from
numpy seed 0, with K = 50, 256 (``--small``: 16) chained calls
(each one's input the logits plus the last result, as the JAX loop)
of each of:

  topk      the k-th largest value by ``torch.topk``;
  sort      the same from a full ``torch.sort``;
  bisect    24 bisection steps on the value that ``count(x >= t) >= K``
            (the JAX script's loop, step for step);
  filter    the port's whole ``process_logits_topk`` (penalty,
            temperature, top-k, nucleus, softmax).

Each prints ms a call as its wall (CUDA events around the n calls, best
of 3 after a warmup) and its device-busy time (its kernel
times under ``torch.profiler``): these are launches of a few
microseconds, so the two differ by the host's launch cost.

The last line is ``{"sampler_ops": {...}}`` with every number printed
and the launch counts since the start.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ubench_common as U  # noqa: E402

V = 8194
K = 50
N = 256
BISECT_STEPS = 24


def bisect_threshold(x, k: int = K):
    """The JAX script's 24-step bisection between the row min and max."""
    import torch

    lo = x.amin(dim=-1)
    hi = x.amax(dim=-1)
    for _ in range(BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        cnt = (x >= mid[..., None]).sum(dim=-1)
        hi = torch.where(cnt >= k, mid, hi)
        lo = torch.where(cnt >= k, lo, mid)
    return hi


def ops() -> dict:
    """{name: fn(x (1, V)) -> (1,)}."""
    import torch

    from tortoise_tpu_torch.ops import sampling as S

    def full_filter(x):
        probs, _ = S.process_logits_topk(
            x, torch.zeros((1, 1), dtype=torch.long, device=x.device))
        return probs[..., 0]

    return {"topk": lambda x: torch.topk(x, K).values[..., -1],
            "sort": lambda x: torch.sort(x, dim=-1).values[..., V - K],
            "bisect": bisect_threshold, "filter": full_filter}


def chained(step, x, n: int):
    """n calls, each on x plus the last result: c = c/2 + step(x + c)/2."""
    c = x.new_zeros(x.shape[:-1])
    for _ in range(n):
        c = c * 0.5 + step(x + c[..., None]) * 0.5
    return c


def run(n: int = N, device=None, reps: int = 3, card: str = "") -> dict:
    import torch

    x = torch.as_tensor(np.random.default_rng(0).normal(0, 3, (1, V))
                        .astype(np.float32), device=device)
    out = dict(v=V, k=K, n=n, reps=reps)
    for name, step in ops().items():
        t = U.timed(lambda step=step: chained(step, x, n), device, reps)
        out[name] = dict(ms_per_call=t["ms"] / n, busy_ms_per_call=(
            None if t["busy_ms"] is None else t["busy_ms"] / n))
        print(f"{name:7s}: {U.fmt(t, n, 'ms a call')} [{card}]", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    U.add_device_args(ap)
    args = ap.parse_args(argv)
    dev, card = U.start(args.device)
    result = run(16 if args.small else N, dev, card=card)
    return U.emit("sampler_ops", result, dev, card, args.small)


if __name__ == "__main__":
    main()
