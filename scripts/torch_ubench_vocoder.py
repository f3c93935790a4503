#!/usr/bin/env python3
"""One production-shape vocoder pass with the fused LVC kernel (E) on
and off: the counterpart of ``scripts/ubench_vocoder.py``.

    python3 scripts/torch_ubench_vocoder.py [T]              # the card
    python3 scripts/torch_ubench_vocoder.py --profile        # + by kernel
    python3 scripts/torch_ubench_vocoder.py --device cpu --small

One pass of ``vocoder_forward`` over T = 2208 mel frames (the bench's
mel plus its 10 pad frames, bucketed; ``--small``: the tiny config at
T = 64), bf16 activations on the f32 tree, with ``use_pallas_lvc`` off
(the batched per-chunk LVC products) and on (kernel E on the card).
Inputs from numpy seed 0 in the JAX script's order: mel ~ N(-6, 2),
noise ~ N(0, 1). Each prints ms/pass as its wall (CUDA events, best of
5 after a warmup) and its device-busy time (its kernel times
under ``torch.profiler``), and its kernel launches. ``--profile`` adds
device time by kernel of one pass with kernel E (top 24; trace in
``chiprun_out/``).

The last line is ``{"vocoder": {...}}`` with every number printed and
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

T = 2208


def run(params, cfg, t: int = T, device=None, reps: int = 5,
        profile: bool = False, card: str = "") -> dict:
    """Both passes on ``params`` (the host or device f32 tree)."""
    import torch

    from tortoise_tpu_torch.models import vocoder as vmodel
    from tortoise_tpu_torch.ops.cuda import launch_counts
    from tortoise_tpu_torch.pipeline.vocoder_stage import device_params

    p = device_params(params, device)
    rng = np.random.default_rng(0)
    mel = torch.as_tensor(rng.normal(-6, 2, (1, cfg.n_mel, t)).astype(
        np.float32), device=device)
    noise = torch.as_tensor(rng.normal(0, 1, (1, cfg.noise_ch, t)).astype(
        np.float32), device=device)
    out = dict(t=t, reps=reps)
    passes = {}
    for lvc in (False, True):
        c = dataclasses.replace(cfg, use_pallas_lvc=lvc)

        def vp(c=c):
            with torch.inference_mode():
                return vmodel.vocoder_forward(p, c, mel, noise, t,
                                              torch.bfloat16)

        name = "fused_lvc" if lvc else "plain_lvc"
        before = launch_counts()
        tm = U.timed(vp, device, reps)
        passes[name] = vp
        out[name] = dict(tm, launches=U.launch_delta(before))
        print(f"{name}: {U.fmt(tm, unit='ms/pass')}; launches "
              f"{out[name]['launches']} [{card}]", flush=True)
    if profile:
        out["profile"] = U.profile_top(passes["fused_lvc"], device,
                                       f"vocoder_t{t}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("t", type=int, nargs="?", default=None,
                    help="mel frames (2208; --small: 64)")
    ap.add_argument("--profile", action="store_true",
                    help="device time by kernel of one pass with kernel E")
    U.add_device_args(ap)
    args = ap.parse_args(argv)
    dev, card = U.start(args.device)
    from tortoise_tpu_torch.config import VocoderConfig, tiny_vocoder_config
    from tortoise_tpu_torch.io.checkpoint import random_vocoder_params

    cfg = tiny_vocoder_config() if args.small else VocoderConfig()
    params = random_vocoder_params(cfg, seed=0, fast=True)
    t = args.t or (64 if args.small else T)
    result = run(params, cfg, t, dev, profile=args.profile, card=card)
    return U.emit("vocoder", result, dev, card, args.small)


if __name__ == "__main__":
    main()
