"""Stage 3 driver: mel -> 24 kHz audio (counterpart of
``tortoise_tpu/pipeline/vocoder_stage.py``).

Denormalize the [-1, 1] mel to the Tacotron dB range, append
``mel_pad_frames`` frames of -11.5129, draw 64-channel Gaussian noise,
run the vocoder; audio length is (M + pad frames) * 256 - 6. Lengths
round up to a bucket (``bucketed=False``: to the longest row's frames),
masked, with the reflection written at the true edge. The noise of ``vocoder_batch_device`` / ``vocoder_batch`` is one
(B, 64, bucket) draw through ``draw_normal``, like the JAX package's
``normal(PRNGKey(seed), ...)``; all rows vocode in one pass (the JAX
package splits batches above 8 rows for the TPU's memory).

Under a mesh (``mesh=``) each rank vocodes its rows of the "dp" split
with the noise rows of the one global draw, and its kernel-predictor
channels of the "tp" split (``models.vocoder``); the audio is gathered,
so every rank returns every row.
"""

from __future__ import annotations

import numpy as np
import torch

from tortoise_tpu_torch.config import (
    MEL_PAD_VALUE,
    TACOTRON_MEL_MAX,
    TACOTRON_MEL_MIN,
    VocoderConfig,
)
from tortoise_tpu_torch.models import vocoder as vmodel
from tortoise_tpu_torch.parallel.mesh import axis_group
from tortoise_tpu_torch.parallel.sharding import vocoder_param_specs
from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline import common
from tortoise_tpu_torch.pipeline.common import (
    cached_cast,
    download,
    dp_rows,
    draw_rows,
    resolve_device,
    round_up,
    shard_cast,
)
from tortoise_tpu_torch.utils import profiling

MEL_BUCKET = 32


def denormalize_tacotron_mel(mel):
    """[-1, 1] -> [TACOTRON_MEL_MIN, TACOTRON_MEL_MAX]."""
    return ((mel + 1.0) / 2.0) * (TACOTRON_MEL_MAX - TACOTRON_MEL_MIN) \
        + TACOTRON_MEL_MIN


def audio_length(mel_frames: int, cfg: VocoderConfig = VocoderConfig()
                 ) -> int:
    """Samples the vocoder returns for a mel of ``mel_frames`` frames."""
    return (mel_frames + cfg.mel_pad_frames) * cfg.total_upsample - 6


def device_params(params, device, mesh=None):
    """The vocoder tree on ``device`` (this rank's part of it on a mesh
    with a tp axis), memoized per (tree, device, mesh shape and rank)."""
    full = cached_cast(params, "device", lambda p: tree_to_torch(p, device),
                       device)
    return shard_cast(params, "device", full, lambda m: vocoder_param_specs(
        m, len(full["stages"])), mesh, device)


def _audio_s(mel_lens, cfg: VocoderConfig) -> float:
    """Seconds of audio the vocoder makes from mels of ``mel_lens``
    frames (the ``audio_s`` counter of ``vocoder.forward``)."""
    return sum(audio_length(int(m), cfg) for m in mel_lens) \
        / cfg.sample_rate


def draw_normal(generator, shape, device) -> torch.Tensor:
    """f32 standard-normal noise (every draw of the stage goes through
    here)."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def _pad(total: int, bucketed: bool) -> int:
    """The padded frame count: ``total`` rounded up to MEL_BUCKET, or kept
    with ``bucketed=False``."""
    return round_up(total, MEL_BUCKET) if bucketed else total


def _padded_mel(mel_norm, lens, pad_total, cfg):
    """(B, n_mel, T) normalized mel, zero past per-row ``lens`` ->
    denormalized (B, n_mel, pad_total) with the pad frames written."""
    b, _, t = mel_norm.shape
    mel_can = torch.nn.functional.pad(mel_norm.float(), (0, pad_total - t)) \
        if pad_total > t else mel_norm.float()[:, :, :pad_total]
    idx = torch.arange(pad_total, device=mel_norm.device)[None, None, :]
    ln = torch.as_tensor(lens, device=mel_norm.device)[:, None, None]
    return torch.where(
        idx < ln, denormalize_tacotron_mel(mel_can),
        torch.where(idx < ln + cfg.mel_pad_frames, MEL_PAD_VALUE, 0.0))


@torch.inference_mode()
def vocoder_batch_device(params, mel_dev, mel_lens,
                         cfg: VocoderConfig = VocoderConfig(), seed: int = 0,
                         compute_dtype=None, mesh=None, device=None,
                         bucketed: bool = True):
    """Device (B, n_mel, T) normalized mel with per-row lengths -> list of
    per-row float32 host audio arrays; noise from a torch.Generator.
    ``mesh``: this rank vocodes its rows and returns every row (see the
    module docstring). ``bucketed=False`` pads to the longest row's
    frames instead of MEL_BUCKET (the JAX package's host wrappers reach
    that; its device entry always rounds up)."""
    device = resolve_device(device)
    lens = np.asarray(mel_lens, np.int64)
    b = len(lens)
    with profiling.span("vocoder.forward", device,
                        audio_s=_audio_s(lens, cfg)):
        params = device_params(params, device, mesh)
        totals = lens + cfg.mel_pad_frames
        pad_total = _pad(int(totals.max()), bucketed)
        rows = dp_rows(mesh, b, "vocoder_batch_device")
        mel_v = _padded_mel(mel_dev.to(device)[rows], lens[rows], pad_total,
                            cfg)
        noise = draw_rows(draw_normal, common.make_generator(seed, device),
                          (b, cfg.noise_ch, pad_total), device, rows)
        audio = vmodel.vocoder_forward(
            params, cfg, mel_v, noise,
            torch.as_tensor(totals[rows], device=device), compute_dtype,
            axis_group(mesh, "tp"))
        if rows != slice(0, b):
            audio = axis_group(mesh, "dp").all_gather(audio)
    (audio,) = download(audio)
    return [audio[i, :audio_length(int(lens[i]), cfg)]
            for i in range(len(lens))]


def vocoder_batch(params, mel_list, cfg: VocoderConfig = VocoderConfig(),
                  seed: int = 0, compute_dtype=None, bucketed: bool = True,
                  mesh=None, device=None):
    """Host list of (n_mel, M_i) normalized mels -> list of host audio
    arrays, vocoded together with per-row masked lengths (``mesh`` and
    ``bucketed`` as in ``vocoder_batch_device``)."""
    device = resolve_device(device)
    mels = [np.asarray(m, np.float32) for m in mel_list]
    if not mels:
        raise ValueError("mel_list is empty")
    lens = [m.shape[1] for m in mels]
    mel_in = np.zeros((len(mels), cfg.n_mel, max(lens)), np.float32)
    for i, m in enumerate(mels):
        mel_in[i, :, :m.shape[1]] = m
    return vocoder_batch_device(params, torch.as_tensor(mel_in), lens, cfg,
                                seed, compute_dtype, mesh, device,
                                bucketed=bucketed)


@torch.inference_mode()
def vocoder(params, mel: np.ndarray, cfg: VocoderConfig = VocoderConfig(),
            seed: int = 0, rng=None, compute_dtype=None,
            bucketed: bool = True, device=None) -> np.ndarray:
    """Normalized mel (n_mel, M) -> float32 audio (audio_length(M),).
    rng=None: torch.Generator noise (vocoder_batch at B=1);
    rng=ReferenceRng: the reference's mt19937 noise stream (drawn before
    the model pass). ``bucketed=False`` pads to the true frame count."""
    device = resolve_device(device)
    mel = np.asarray(mel, np.float32)
    if rng is None:
        return vocoder_batch(params, [mel], cfg, seed, compute_dtype,
                             bucketed, device=device)[0]
    n_mel, m = mel.shape
    with profiling.span("vocoder.forward", device,
                        audio_s=_audio_s([m], cfg)):
        params = device_params(params, device)
        total = m + cfg.mel_pad_frames
        pad_total = _pad(total, bucketed)
        mel_in = np.zeros((1, n_mel, pad_total), np.float32)
        mel_in[0, :, :m] = denormalize_tacotron_mel(mel)
        mel_in[0, :, m:total] = MEL_PAD_VALUE
        noise = np.zeros((1, cfg.noise_ch, pad_total), np.float32)
        noise[0, :, :total] = rng.normal_f32(cfg.noise_ch * total).reshape(
            cfg.noise_ch, total)
        audio = vmodel.vocoder_forward(
            params, cfg, torch.as_tensor(mel_in, device=device),
            torch.as_tensor(noise, device=device), total, compute_dtype)
    return download(audio[0, :audio_length(m, cfg)])[0]
