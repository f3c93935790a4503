#!/usr/bin/env python3
"""The AR prefill and latent passes with kernel C against plain scores:
the counterpart of ``scripts/ubench_prefill.py``, and the reading that
``flash_prefill_min_score`` (``tortoise_tpu_torch/config.py``) should
sit at on this card.

    python3 scripts/torch_ubench_prefill.py [batches] [n_text]   # the card
    python3 scripts/torch_ubench_prefill.py --device cpu --small

On production-size random AR weights (bf16 + int8; ``--small``: the
tiny config) at B = 1, 4 and 16 (``batches``, comma-separated) with a
26-id prompt (``n_text``; text bucket 32) and 502 mel codes, from numpy
seed 0 in the JAX script's order, each B in two modes:

  flash  kernel C, with ``flash_prefill_min_score=0`` so that it runs at
         every (B, S), as the JAX script forces it;
  plain  the plain scores (``flash_prefill=False``).

The prefill covers S = 1 + 32 + 1 positions, the latent pass S = 1 + 32
+ 502; their score sizes B*S^2 are what ``flash_prefill_min_score``
compares. Each pass prints its wall (CUDA events, best of ``reps`` (5)
after a warmup) and its device-busy time (its kernel times under
``torch.profiler``), and each mode its kernel launches. The crossover
is the smallest score from which kernel C takes less device-busy time
at every larger score measured: at these sizes the passes are
host-bound, and their walls move with the host's load from call to
call while the busy times do not.

A failure exits non-zero (the JAX script printed FAIL and went on).
The last line is ``{"prefill": {...}}`` with every number printed and
the launch counts since the start.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ubench_common as U  # noqa: E402

BATCHES = (1, 4, 16)
N_TEXT = 26
MEL_CODES = 502


def crossover(points) -> int | None:
    """The smallest score from which flash takes less time at every
    larger score, from (score, flash ms, plain ms) points; None if flash
    loses at the largest."""
    best = None
    for score, flash, plain in sorted(points, reverse=True):
        if flash >= plain:
            break
        best = score
    return best


def run(ar_params, cfg, batches=BATCHES, n_text: int = N_TEXT,
        device=None, reps: int = 5, card: str = "") -> dict:
    """Both passes in both modes on the host AR tree ``ar_params`` (cast
    here to bf16 + int8)."""
    import torch

    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.ops.cuda import launch_counts
    from tortoise_tpu_torch.pipeline import ar_stage

    bf = torch.bfloat16
    params = ar_stage.cast_matmul_weights(ar_params, bf, int8=True,
                                          device=device)
    bucket = ar_stage.pick_bucket(n_text)
    cfg0 = ar_stage.size_cache(cfg, bucket)
    n_mel = min(MEL_CODES, cfg0.pad_mel_length + 2)
    rng = np.random.default_rng(0)
    out = dict(n_text=n_text, bucket=bucket, mel_codes=n_mel, reps=reps,
               flash_prefill_min_score=cfg.flash_prefill_min_score, runs={})
    points = []
    for b in batches:
        text = np.zeros((b, bucket), np.int64)
        text[:, :n_text] = rng.integers(3, min(255, cfg.n_text_vocab),
                                        (b, n_text))
        valid = np.zeros((b, bucket), bool)
        valid[:, :n_text] = True
        voice = rng.normal(0, 0.5, (b, cfg.d_model)).astype(np.float32)
        mel = rng.integers(0, min(8192, cfg.n_mel_vocab), (b, n_mel))
        ti, tv, va, ma = (torch.as_tensor(a, device=device)
                          for a in (text, valid, voice, mel))
        row = {}
        for flash in (False, True):
            c = dataclasses.replace(cfg0, flash_prefill=flash,
                                    flash_prefill_min_score=0)
            before = launch_counts()
            with torch.inference_mode():
                tp = U.timed(lambda: ar.prefill(params, c, ti, tv, va, bf),
                             device, reps)
                tl = U.timed(lambda: ar.latent_forward(params, c, ti, tv, ma,
                                                       va, bf), device, reps)
            tag = "flash" if flash else "plain"
            row[tag] = dict(prefill=tp, latent=tl,
                            launches=U.launch_delta(before))
            print(f"B={b:2d} {tag}: prefill {U.fmt(tp)}; latent "
                  f"{U.fmt(tl)}; launches {row[tag]['launches']} [{card}]",
                  flush=True)
        s_pre, s_lat = 1 + bucket + 1, 1 + bucket + n_mel
        for name, s in (("prefill", s_pre), ("latent", s_lat)):
            points.append((b * s * s, row["flash"][name]["busy_ms"],
                           row["plain"][name]["busy_ms"]))
        row.update(prefill_score=b * s_pre ** 2, latent_score=b * s_lat ** 2)
        out["runs"][str(b)] = row
    out["crossover_score"] = None
    if device.type == "cuda":  # the CPU runs two plain versions
        out["crossover_score"] = crossover(points)
        print(f"kernel C takes less device time from B*S^2 = "
              f"{out['crossover_score']} up (flash_prefill_min_score is "
              f"{cfg.flash_prefill_min_score}; scores measured: "
              f"{sorted(p[0] for p in points)}) [{card}]", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batches", nargs="?", default=None,
                    help="comma-separated batch sizes (1,4,16)")
    ap.add_argument("n_text", type=int, nargs="?", default=None,
                    help="prompt ids (26; --small: 8)")
    U.add_device_args(ap)
    args = ap.parse_args(argv)
    dev, card = U.start(args.device)
    from tortoise_tpu_torch.config import ARConfig, tiny_ar_config
    from tortoise_tpu_torch.io.checkpoint import random_ar_params

    cfg = tiny_ar_config() if args.small else ARConfig()
    params = random_ar_params(cfg, seed=0, fast=True)
    batches = (tuple(int(b) for b in args.batches.split(","))
               if args.batches else BATCHES)
    n_text = args.n_text or (8 if args.small else N_TEXT)
    result = run(params, cfg, batches, n_text, dev, card=card)
    return U.emit("prefill", result, dev, card, args.small)


if __name__ == "__main__":
    main()
