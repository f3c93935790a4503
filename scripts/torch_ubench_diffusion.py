#!/usr/bin/env python3
"""One production-shape denoiser eval with the attention kernel on and
off: the counterpart of ``scripts/ubench_diffusion.py``.

    python3 scripts/torch_ubench_diffusion.py [T]            # the card
    python3 scripts/torch_ubench_diffusion.py --profile      # + by kernel
    python3 scripts/torch_ubench_diffusion.py --device cpu --small

One CFG eval (batch 2: the cond and uncond rows) at T = 2176 frames
(``--small``: the tiny config at T = 64) on the bench's plane, bf16
activations and int8 weights (the JAX script's f32 weights would add a
bf16 cast of every weight to every eval here), with an all-valid key
mask, ``use_flash`` on (kernel B on the card) and off (the plain
scores), then flash with ``mask=None``. Inputs from numpy seed 0 in the
JAX script's order. Each prints ms/CFG-step and x80 (the 80-step loop),
as its wall (CUDA events, best of 5 after a warmup) and its
device-busy time (its kernel times under ``torch.profiler``), and the
kernel launches of its calls: the denoiser is eager, so the gap
between the two is the host's launch cost. ``--profile`` adds device
time by kernel of one flash eval (top 24; trace in ``chiprun_out/``).

The last line is ``{"diffusion": {...}}`` with every number printed and
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

T = 2176
STEPS = 80


def run(params, cfg, t: int = T, device=None, reps: int = 5,
        profile: bool = False, card: str = "") -> dict:
    """The three evals on ``params`` (the f32 tree; quantized here to
    the int8 plane)."""
    import torch

    from tortoise_tpu_torch.models import diffusion as dmodel
    from tortoise_tpu_torch.ops.cuda import launch_counts
    from tortoise_tpu_torch.pipeline import diffusion_stage as DS

    p = DS._prepare_params(params, True, device)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(0, 1, (2, cfg.n_mel, t)).astype(
        np.float32), device=device)
    code = torch.as_tensor(rng.normal(0, 0.5, (2, cfg.d_model, t)).astype(
        np.float32), device=device)
    mask = torch.ones((2, t), dtype=torch.bool, device=device)
    out = dict(t=t, reps=reps)
    evals = {}
    for name, flash, m in (("flash", True, mask), ("plain", False, mask),
                           ("flash_no_mask", True, None)):
        c = dataclasses.replace(cfg, use_flash=flash)
        buckets = DS._buckets(t, c, device)

        def ev(c=c, m=m, buckets=buckets):
            with torch.inference_mode():
                return dmodel.denoise(p, c, x, code, 1234, buckets, m,
                                      torch.bfloat16)

        before = launch_counts()
        tm = U.timed(ev, device, reps)
        evals[name] = ev
        out[name] = dict(tm, x80_s=tm["ms"] * STEPS / 1e3,
                         launches=U.launch_delta(before))
        print(f"{name:13s}: {U.fmt(tm, unit='ms/CFG-step')} (x80 = "
              f"{tm['ms'] * STEPS / 1e3:.3f} s); launches "
              f"{out[name]['launches']} [{card}]", flush=True)
    if profile:
        out["profile"] = U.profile_top(evals["flash"], device,
                                       f"diffusion_eval_t{t}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("t", type=int, nargs="?", default=None,
                    help="frames (2176; --small: 64)")
    ap.add_argument("--profile", action="store_true",
                    help="device time by kernel of one flash eval")
    U.add_device_args(ap)
    args = ap.parse_args(argv)
    dev, card = U.start(args.device)
    from tortoise_tpu_torch.config import (
        DiffusionConfig,
        tiny_diffusion_config,
    )
    from tortoise_tpu_torch.io.checkpoint import random_diffusion_params

    cfg = tiny_diffusion_config() if args.small else DiffusionConfig()
    params = random_diffusion_params(cfg, seed=0, fast=True)
    t = args.t or (64 if args.small else T)
    result = run(params, cfg, t, dev, profile=args.profile, card=card)
    return U.emit("diffusion", result, dev, card, args.small)


if __name__ == "__main__":
    main()
