#!/usr/bin/env python3
"""Where the diffusion stage's seconds go, at the bench's shape: the
counterpart of ``scripts/ubench_diffstage.py``.

    python3 scripts/torch_ubench_diffstage.py               # the card
    python3 scripts/torch_ubench_diffstage.py --profile     # + by kernel
    python3 scripts/torch_ubench_diffstage.py --device cpu --small

One utterance's stage 2 as ``diffusion_batch_device`` runs it: 500
latents (the bench's 500-step generation; ``--small``: 32 on the tiny
config), bf16 + int8, kernel B on the card, the stage's own pads
(``_pads``), masks (``_masks``: an all-true mask is None) and rel-pos
buckets (``_buckets``). Each run times, with the device synchronised at
each boundary: the code embedding (the latent conditioner), the noise
draw, the ``n_sample_timesteps`` (80) step ``_denoise_loop`` and the
download, then ms/step. The first of 5 runs warms up; the best of the
rest is printed. Then one more loop under ``torch.profiler``: its
device-busy time (the sum of its kernel times) and that over the best
loop wall, the loop's device-busy share. ``--profile`` adds device time
by kernel of a 2-step loop (trace in ``chiprun_out/``).

The last line is ``{"diffstage": {...}}`` with every number printed and
the launch counts since the start.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ubench_common as U  # noqa: E402

LATENTS = 500
SMALL_LATENTS = 32
PROFILE_STEPS = 2


class Stage:
    """The stage's inputs for one utterance of ``n_lat`` latents, built
    as ``diffusion_batch_device`` builds them."""

    def __init__(self, params, cfg, latents: np.ndarray, device):
        import torch

        from tortoise_tpu_torch.config import mel_length_for_latents
        from tortoise_tpu_torch.pipeline import diffusion_stage as DS

        self.cfg, self.device = cfg, device
        self.params = DS._prepare_params(params, True, device)
        n_lat = latents.shape[0]
        out_len = mel_length_for_latents(n_lat)
        self.lat_lens = np.asarray([n_lat], np.int64)
        self.out_lens = np.asarray([out_len], np.int64)
        self.lat_pad, self.out_pad = DS._pads(n_lat, out_len, True)
        lat_in = np.zeros((1, self.lat_pad, latents.shape[1]), np.float32)
        lat_in[0, :n_lat] = latents
        self.lat_in = torch.as_tensor(lat_in, device=device)
        self.lat_mask, self.out_mask = DS._masks(
            self.lat_lens, self.out_lens, self.lat_pad, self.out_pad, device)
        self.lat_buckets = DS._buckets(self.lat_pad, cfg, device)
        self.out_buckets = DS._buckets(self.out_pad, cfg, device)
        self.sched = DS.schedule_arrays(cfg, device)

    def code_emb(self):
        import torch

        from tortoise_tpu_torch.models import diffusion as dmodel

        dev = self.device
        cond, uncond = dmodel.code_embeddings(
            self.params, self.cfg, self.lat_in, self.lat_buckets,
            self.out_pad, torch.as_tensor(self.lat_lens, device=dev),
            torch.as_tensor(self.out_lens, device=dev), self.lat_mask,
            torch.bfloat16)
        return torch.cat([cond, uncond], dim=0)

    def noise(self, seed: int):
        """(first noise, the per-step draw): the stage's generator and
        draws, so a run gives ``diffusion_batch_device``'s mel."""
        import torch

        from tortoise_tpu_torch.pipeline import common
        from tortoise_tpu_torch.pipeline import diffusion_stage as DS

        gen = common.make_generator(seed, self.device)
        shape = (1, self.cfg.n_mel, self.out_pad)

        def draw():
            return DS.draw_normal(gen, shape, self.device)

        x = draw()
        if self.out_mask is not None:
            x = torch.where(self.out_mask[:, None, :], x, 0.0)
        return x, draw

    def loop(self, code_emb2, x, draw, cfg=None):
        import torch

        from tortoise_tpu_torch.pipeline import diffusion_stage as DS

        return DS._denoise_loop(self.params, cfg or self.cfg, self.sched,
                                code_emb2, x, self.out_buckets,
                                self.out_mask, draw, torch.bfloat16, True)


def one_run(stage: Stage, seed: int) -> tuple:
    """({piece: seconds}, the host mel (1, n_mel, out_pad))."""
    from tortoise_tpu_torch.pipeline.common import sync

    ts = {}
    t0 = time.monotonic()
    code = stage.code_emb()
    sync(stage.device)
    ts["code_emb_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    x, draw = stage.noise(seed)
    sync(stage.device)
    ts["noise_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    x = stage.loop(code, x, draw)
    sync(stage.device)
    ts["loop_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    mel = x.float().cpu().numpy()
    ts["download_s"] = time.monotonic() - t0
    ts["total_s"] = sum(ts.values())
    return ts, mel


def run(params, cfg, latents: np.ndarray, device, runs: int = 5,
        profile: bool = False, card: str = "") -> dict:
    """The stage split on ``params`` (the host or device f32 tree; the
    run quantizes it), ``runs`` runs, the first a warmup."""
    import torch

    stage = Stage(params, cfg, latents, device)
    n = cfg.n_sample_timesteps
    print(f"latents {latents.shape[0]}: lat_pad {stage.lat_pad}, out_pad "
          f"{stage.out_pad}, masks {stage.lat_mask is not None}/"
          f"{stage.out_mask is not None}, flash {cfg.use_flash}, {n} steps "
          f"[{card}]", flush=True)
    best = None
    with torch.inference_mode():
        for i in range(runs):
            ts, _ = one_run(stage, i)
            ts["ms_per_step"] = ts["loop_s"] * 1e3 / n
            print(f"run {i}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                           ts.items()) + f" [{card}]",
                  flush=True)
            if i and (best is None or ts["total_s"] < best["total_s"]):
                best = ts
        out = dict(best or ts, latents=int(latents.shape[0]),
                   out_pad=stage.out_pad, steps=n, runs=runs)
        if device.type == "cuda":
            code = stage.code_emb()

            def loop():
                x, draw = stage.noise(0)
                stage.loop(code, x, draw)

            busy = U.busy_ms(loop)
            out.update(loop_busy_ms=busy, loop_busy_ms_per_step=busy / n,
                       loop_busy_share=busy / (out["loop_s"] * 1e3))
            print(f"loop device busy {busy:.1f} ms ({busy / n:.3f} ms/step) "
                  f"of a {out['loop_s'] * 1e3:.1f} ms wall: busy share "
                  f"{out['loop_busy_share']:.3f} [{card}]", flush=True)
            if profile:
                short = dataclasses.replace(cfg, n_sample_timesteps=
                                            PROFILE_STEPS)

                def short_loop():
                    x, draw = stage.noise(0)
                    stage.loop(code, x, draw, short)

                out["profile"] = U.profile_top(
                    short_loop, device, f"diffstage_{PROFILE_STEPS}_steps")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="device time by kernel of a 2-step loop")
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
    if args.small:
        cfg = dataclasses.replace(cfg, n_sample_timesteps=4)
    cfg = dataclasses.replace(cfg, use_flash=flash_on(dev))
    params = random_diffusion_params(cfg, seed=1, fast=True)
    n_lat = SMALL_LATENTS if args.small else LATENTS
    latents = np.random.default_rng(0).normal(
        0, 0.5, (n_lat, cfg.d_model)).astype(np.float32)
    result = run(params, cfg, latents, dev, profile=args.profile, card=card)
    return U.emit("diffstage", result, dev, card, args.small)


if __name__ == "__main__":
    main()
