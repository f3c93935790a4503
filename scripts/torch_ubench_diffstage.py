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

``loop``: the 80-step loop run eagerly and as a CUDA graph of one step
(``pipeline/graphs.py``), in turns: eager, graph, graph, eager. Each
turn makes one warmup call (the first graph turn's captures), one call
timed on the host clock between two synchronisations (wall) and one
under ``torch.profiler`` (busy); it prints both a step, whether the two
loops gave the same mel bit for bit, and the launches a step of each.
On the CPU the eager loop alone (graphs exist only for CUDA tensors).

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


# the planes a Stage runs: (compute dtype name, int8 weights)
PLANES = {"int8": ("bfloat16", True), "bf16": ("bfloat16", False),
          "f32": (None, False)}


class Stage:
    """The stage's inputs for one utterance of ``n_lat`` latents, built
    as ``diffusion_batch_device`` builds them, on ``plane`` (``PLANES``;
    the bench's bf16 + int8 by default)."""

    def __init__(self, params, cfg, latents: np.ndarray, device,
                 plane: str = "int8"):
        import torch

        from tortoise_tpu_torch.config import mel_length_for_latents
        from tortoise_tpu_torch.pipeline import diffusion_stage as DS

        self.cfg, self.device = cfg, device
        cd, int8 = PLANES[plane]
        self.compute_dtype = None if cd is None else getattr(torch, cd)
        self.params = DS._prepare_params(params, int8, device)
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
            self.compute_dtype)
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

    def loop(self, code_emb2, x, draw, cfg=None, eager=False):
        from tortoise_tpu_torch.pipeline import diffusion_stage as DS

        return DS._denoise_loop(self.params, cfg or self.cfg, self.sched,
                                code_emb2, x, self.out_buckets,
                                self.out_mask, draw, self.compute_dtype,
                                True, eager=eager)


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


# the loop A/B's turns: eager, graph, graph, eager (True: eager)
LOOP_TURNS = (True, False, False, True)


def loop_ab(stage: Stage, card: str = "") -> dict:
    """The denoising loop eager against a step graph, in turns (module
    docstring). Returns {"eager", "graph" (None on the CPU), "same_mel"};
    each loop's entry has its best ``ms_per_step`` and
    ``busy_ms_per_step``, ``turns`` ([wall, busy] ms/step a turn) and
    ``launches_per_step``."""
    from tortoise_tpu_torch.ops.cuda import launch_counts
    from tortoise_tpu_torch.pipeline.common import sync

    dev, n = stage.device, stage.cfg.n_sample_timesteps
    code = stage.code_emb()
    out, mels = {"eager": None, "graph": None}, {}
    turns = LOOP_TURNS if dev.type == "cuda" else LOOP_TURNS[:1]
    for eager in turns:
        name = "eager" if eager else "graph"

        def loop():
            x, draw = stage.noise(0)
            return stage.loop(code, x, draw, eager=eager)

        before = launch_counts()
        loop()
        sync(dev)
        t0 = time.monotonic()
        mels.setdefault(eager, []).append(loop())
        sync(dev)
        wall = (time.monotonic() - t0) * 1e3 / n
        busy = U.busy_ms(loop) / n if dev.type == "cuda" else None
        ent = out[name] or {"turns": []}
        ent["turns"].append([wall, busy])
        ent["launches_per_step"] = {
            k: v / (3 * n) for k, v in U.launch_delta(before).items()}
        out[name] = ent
        print(f"loop {name:5s}: {wall:.3f} ms/step"
              + ("" if busy is None else f" (device busy {busy:.3f} ms/step, "
                 f"share {busy / wall:.3f})") + f" [{card}]", flush=True)
    for ent in (out["eager"], out["graph"]):
        if ent is not None:
            best = min(ent["turns"])
            ent.update(ms_per_step=best[0], busy_ms_per_step=best[1])
    out["same_mel"] = all(m.equal(mels[True][0])
                          for ms in mels.values() for m in ms)
    return out


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
        out["loop"] = loop_ab(stage, card)
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
