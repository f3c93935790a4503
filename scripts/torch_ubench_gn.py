#!/usr/bin/env python3
"""What the group-norm chain costs in one denoiser eval: the counterpart
of ``scripts/ubench_gn.py``.

    python3 scripts/torch_ubench_gn.py [T] [reps]       # the card
    python3 scripts/torch_ubench_gn.py --device cpu --small

One CFG denoise eval (batch 2, T = 2304; ``--small``: the tiny config at
T = 64), bf16 + int8, kernel B on the card, in three variants run in
turns, best of ``reps`` (5) each after a warmup call:

  base       the real eval: every group norm one call of
             ``group_norm_act`` (kernel G on the card);
  gn-affine  the norm patched to ``x*w+b``: no statistics pass and no
             normalization;
  gn-skip    the norm patched to the identity.

A patched variant (``as_op``) runs in place of ``group_norm_act``: its
norm on the f32 map, then the op's own FiLM, SiLU and mask in plain
PyTorch (``group_norm.activate``), so on the card it runs eager
elementwise kernels where the base runs kernel G. base - gn-skip is what
kernel G costs beyond such a chain. The port's denoiser is eager, so
each variant prints its wall (CUDA events around the eval) and its
device-busy time (its kernel times summed under ``torch.profiler``),
each with its delta against base: a wall delta without a busy delta is
launch overhead.

The patch replaces ``tortoise_tpu_torch.models.diffusion.group_norm_act``
(the name the denoiser calls) only for the calls of its variant
(``patched``) and puts it back in a ``finally``.

The last line is ``{"gn": {...}}`` with every number printed and the
launch counts since the start.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ubench_common as U  # noqa: E402


def gn_affine(x, n_groups, w=None, b=None, eps=1e-5, mask=None,
              fast=False):
    """The affine part of a group norm alone (the JAX script's)."""
    out = x
    if w is not None:
        out = out * w
    if b is not None:
        out = out + b
    return out


def gn_skip(x, n_groups, w=None, b=None, eps=1e-5, mask=None, fast=False):
    return x


VARIANTS = {"base": None, "gn-affine": gn_affine, "gn-skip": gn_skip}


def as_op(gn):
    """``group_norm_act`` with the norm ``gn`` (a ``group_norm_tc``-like
    function) in place of its own; None for None."""
    if gn is None:
        return None
    from tortoise_tpu_torch.ops.cuda.group_norm import activate

    def op(x, n_groups, w, b, eps=1e-5, mask=None, *, film=None,
           silu=False):
        y = gn(x.float(), n_groups, w, b, eps, mask)
        return activate(y, mask, film, silu).to(x.dtype)
    return op


@contextlib.contextmanager
def patched(module, fn, name="group_norm_act"):
    """``module.<name>`` replaced by ``fn`` (None: left as it is) inside
    the block, and put back after it."""
    if fn is None:
        yield
        return
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, real)


def inputs(cfg, t: int, device):
    """(x (2, n_mel, t), code (2, d_model, t)) from numpy seed 0, in the
    JAX script's order."""
    import torch

    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, cfg.n_mel, t)).astype(np.float32)
    code = rng.normal(0, 0.5, (2, cfg.d_model, t)).astype(np.float32)
    return (torch.as_tensor(x, device=device),
            torch.as_tensor(code, device=device))


def run(params, cfg, t: int, device, reps: int = 5, card: str = "") -> dict:
    """The three variants on ``params`` (the f32 tree; the run quantizes
    it to the int8 plane), in turns, best of ``reps``."""
    import torch

    from tortoise_tpu_torch.models import diffusion as dmodel
    from tortoise_tpu_torch.pipeline import diffusion_stage as DS

    p = DS._prepare_params(params, True, device)
    x, code = inputs(cfg, t, device)
    buckets = DS._buckets(t, cfg, device)

    def call(gn):
        def ev():
            with patched(dmodel, as_op(gn)), torch.inference_mode():
                return dmodel.denoise(p, cfg, x, code, 1234, buckets,
                                      compute_dtype=torch.bfloat16)
        return ev

    evals = {name: call(gn) for name, gn in VARIANTS.items()}
    times = {name: [] for name in evals}
    for name, ev in evals.items():  # warm every variant first
        ev()
    for _ in range(reps):  # in turns: base, affine, skip, base, ...
        for name, ev in evals.items():
            times[name].append(U.timed(ev, device, reps=1, warmup=0,
                                       busy=False)["ms"])
    out = dict(t=t, reps=reps, flash=cfg.use_flash)
    for name, ev in evals.items():
        busy = U.busy_ms(ev) if device.type == "cuda" else None
        out[name] = dict(ms=min(times[name]), busy_ms=busy)
    base = out["base"]
    for name in evals:
        v = out[name]
        v["delta_ms"] = base["ms"] - v["ms"]
        on_card = base["busy_ms"] is not None
        v["busy_delta_ms"] = (base["busy_ms"] - v["busy_ms"] if on_card
                              else None)
        line = (f"{name:9s}: {v['ms']:8.3f} ms/eval (delta vs base "
                f"{v['delta_ms']:+7.3f})")
        if on_card:
            line += (f"; device busy {v['busy_ms']:8.3f} ms (delta "
                     f"{v['busy_delta_ms']:+7.3f})")
        print(line + f" [{card}]", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("t", type=int, nargs="?", default=None,
                    help="frames (2304; --small: 64)")
    ap.add_argument("reps", type=int, nargs="?", default=5)
    U.add_device_args(ap)
    args = ap.parse_args(argv)
    dev, card = U.start(args.device)
    from tortoise_tpu_torch.cli import flash_on
    from tortoise_tpu_torch.config import (
        DiffusionConfig,
        tiny_diffusion_config,
    )
    from tortoise_tpu_torch.io.checkpoint import random_diffusion_params

    cfg = tiny_diffusion_config() if args.small else DiffusionConfig()
    cfg = dataclasses.replace(cfg, use_flash=flash_on(dev))
    t = args.t or (64 if args.small else 2304)
    params = random_diffusion_params(cfg, seed=0, fast=True)
    result = run(params, cfg, t, dev, args.reps, card)
    return U.emit("gn", result, dev, card, args.small)


if __name__ == "__main__":
    main()
