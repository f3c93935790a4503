#!/usr/bin/env python3
"""Where the vocoder stage's seconds go: the counterpart of
``scripts/ubench_vocstage.py``.

    python3 scripts/torch_ubench_vocstage.py                 # the card
    python3 scripts/torch_ubench_vocstage.py --device cpu --small

The stage's work for one mel of M = 2176 frames (the bench's; ``--small``:
the tiny config at M = 32), as ``pipeline/vocoder_stage.py`` does it,
with the plain LVC (``use_pallas_lvc`` off, as the JAX script and the
stage's default) and bf16 activations, each piece timed on the host
clock with the device synchronised at its end:

  device_params  the memoized tree on the device (``device_params``);
  host_prep      the padded, denormalized mel with its pad frames;
  upload         the noise draw (the stage's generator and
                 ``draw_normal``) and the mel's upload;
  compute        ``vocoder_forward``;
  download       the audio to the host.

The first of 5 runs pays the first calls; the best of the others
(by total) is printed with each run. The mel ~ N(-0.3, 0.4) from numpy
seed 0.

The last line is ``{"vocstage": {...}}`` with every number printed and
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

M = 2176
SMALL_M = 32


def one_run(params, cfg, mel: np.ndarray, seed: int, device) -> dict:
    """{piece: seconds} of one stage call on the host mel (n_mel, M)."""
    import torch

    from tortoise_tpu_torch.config import MEL_PAD_VALUE
    from tortoise_tpu_torch.models import vocoder as vmodel
    from tortoise_tpu_torch.pipeline import common
    from tortoise_tpu_torch.pipeline import vocoder_stage as vst
    from tortoise_tpu_torch.pipeline.common import sync

    ts = {}
    t0 = time.monotonic()
    p = vst.device_params(params, device)
    sync(device)
    ts["device_params_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    m = mel.shape[1]
    total = m + cfg.mel_pad_frames
    pad_total = vst._pad(total, True)
    mel_in = np.zeros((1, cfg.n_mel, pad_total), np.float32)
    mel_in[0, :, :m] = vst.denormalize_tacotron_mel(mel)
    mel_in[0, :, m:total] = MEL_PAD_VALUE
    ts["host_prep_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    noise = vst.draw_normal(common.make_generator(seed, device),
                            (1, cfg.noise_ch, pad_total), device)
    mel_dev = torch.as_tensor(mel_in, device=device)
    sync(device)
    ts["upload_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    with torch.inference_mode():
        audio = vmodel.vocoder_forward(p, cfg, mel_dev, noise, total,
                                       torch.bfloat16)
    sync(device)
    ts["compute_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    a = audio.float().cpu().numpy()
    ts["download_s"] = time.monotonic() - t0
    ts["total_s"] = sum(ts.values())
    if not np.isfinite(a).all():
        raise RuntimeError("the vocoder gave non-finite audio")
    return ts


def run(params, cfg, m: int = M, device=None, runs: int = 5,
        card: str = "") -> dict:
    cfg = dataclasses.replace(cfg, use_pallas_lvc=False)
    mel = np.random.default_rng(0).normal(-0.3, 0.4, (cfg.n_mel, m)).astype(
        np.float32)
    best = None
    for i in range(runs):
        ts = one_run(params, cfg, mel, i, device)
        print(f"run {i}: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                       ts.items()) + f" [{card}]",
              flush=True)
        if i and (best is None or ts["total_s"] < best["total_s"]):
            best = ts
    return dict(best or ts, mel_frames=m, runs=runs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    U.add_device_args(ap)
    args = ap.parse_args(argv)
    dev, card = U.start(args.device)
    from tortoise_tpu_torch.config import VocoderConfig, tiny_vocoder_config
    from tortoise_tpu_torch.io.checkpoint import random_vocoder_params

    cfg = tiny_vocoder_config() if args.small else VocoderConfig()
    params = random_vocoder_params(cfg, seed=0, fast=True)
    result = run(params, cfg, SMALL_M if args.small else M, dev, card=card)
    return U.emit("vocstage", result, dev, card, args.small)


if __name__ == "__main__":
    main()
