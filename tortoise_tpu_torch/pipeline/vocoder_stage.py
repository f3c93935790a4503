"""Stage 3 driver: mel -> 24 kHz audio (counterpart of
``tortoise_tpu/pipeline/vocoder_stage.py``).

Denormalize the [-1, 1] mel to the Tacotron dB range, append
``mel_pad_frames`` frames of -11.5129, draw 64-channel Gaussian noise,
run the vocoder; audio length is (M + pad frames) * 256 - 6. Lengths
round up to a bucket, masked, with the reflection written at the true
edge. The noise of ``vocoder_batch_device`` / ``vocoder_batch`` is one
(B, 64, bucket) draw through ``draw_normal``, like the JAX package's
``normal(PRNGKey(seed), ...)``; all rows vocode in one pass (the JAX
package splits batches above 8 rows for the TPU's memory).
"""

from __future__ import annotations

import numpy as np
import torch

from tortoise_tpu.config import (
    MEL_PAD_VALUE,
    TACOTRON_MEL_MAX,
    TACOTRON_MEL_MIN,
    VocoderConfig,
)
from tortoise_tpu_torch.models import vocoder as vmodel
from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline import common
from tortoise_tpu_torch.pipeline.common import cached_cast, round_up

MEL_BUCKET = 32


def denormalize_tacotron_mel(mel):
    """[-1, 1] -> [TACOTRON_MEL_MIN, TACOTRON_MEL_MAX]."""
    return ((mel + 1.0) / 2.0) * (TACOTRON_MEL_MAX - TACOTRON_MEL_MIN) \
        + TACOTRON_MEL_MIN


def audio_length(mel_frames: int, cfg: VocoderConfig = VocoderConfig()
                 ) -> int:
    """Samples the vocoder returns for a mel of ``mel_frames`` frames."""
    return (mel_frames + cfg.mel_pad_frames) * cfg.total_upsample - 6


def device_params(params, device):
    """The vocoder tree on ``device``, memoized per (tree, device)."""
    return cached_cast(params, "device", lambda p: tree_to_torch(p, device),
                       device)


def draw_normal(generator, shape, device) -> torch.Tensor:
    """f32 standard-normal noise (every draw of the stage goes through
    here)."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


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
                         compute_dtype=None, device="cpu"):
    """Device (B, n_mel, T) normalized mel with per-row lengths -> list of
    per-row float32 host audio arrays; noise from a torch.Generator."""
    params = device_params(params, device)
    lens = np.asarray(mel_lens, np.int64)
    totals = lens + cfg.mel_pad_frames
    pad_total = round_up(int(totals.max()), MEL_BUCKET)
    mel_v = _padded_mel(mel_dev.to(device), lens, pad_total, cfg)
    noise = draw_normal(common.make_generator(seed, device),
                        (len(lens), cfg.noise_ch, pad_total), device)
    audio = vmodel.vocoder_forward(
        params, cfg, mel_v, noise, torch.as_tensor(totals, device=device),
        compute_dtype).cpu().numpy()
    return [audio[i, :audio_length(int(lens[i]), cfg)]
            for i in range(len(lens))]


def vocoder_batch(params, mel_list, cfg: VocoderConfig = VocoderConfig(),
                  seed: int = 0, compute_dtype=None, device="cpu"):
    """Host list of (n_mel, M_i) normalized mels -> list of host audio
    arrays, vocoded together with per-row masked lengths."""
    mels = [np.asarray(m, np.float32) for m in mel_list]
    if not mels:
        raise ValueError("mel_list is empty")
    lens = [m.shape[1] for m in mels]
    mel_in = np.zeros((len(mels), cfg.n_mel, max(lens)), np.float32)
    for i, m in enumerate(mels):
        mel_in[i, :, :m.shape[1]] = m
    return vocoder_batch_device(params, torch.as_tensor(mel_in), lens, cfg,
                                seed, compute_dtype, device)


@torch.inference_mode()
def vocoder(params, mel: np.ndarray, cfg: VocoderConfig = VocoderConfig(),
            seed: int = 0, rng=None, compute_dtype=None,
            device="cpu") -> np.ndarray:
    """Normalized mel (n_mel, M) -> float32 audio (audio_length(M),).
    rng=None: torch.Generator noise (vocoder_batch at B=1);
    rng=ReferenceRng: the reference's mt19937 noise stream (drawn before
    the model pass)."""
    mel = np.asarray(mel, np.float32)
    if rng is None:
        return vocoder_batch(params, [mel], cfg, seed, compute_dtype,
                             device)[0]
    params = device_params(params, device)
    n_mel, m = mel.shape
    total = m + cfg.mel_pad_frames
    pad_total = round_up(total, MEL_BUCKET)
    mel_in = np.zeros((1, n_mel, pad_total), np.float32)
    mel_in[0, :, :m] = denormalize_tacotron_mel(mel)
    mel_in[0, :, m:total] = MEL_PAD_VALUE
    noise = np.zeros((1, cfg.noise_ch, pad_total), np.float32)
    noise[0, :, :total] = rng.normal_f32(cfg.noise_ch * total).reshape(
        cfg.noise_ch, total)
    audio = vmodel.vocoder_forward(
        params, cfg, torch.as_tensor(mel_in, device=device),
        torch.as_tensor(noise, device=device), total, compute_dtype)
    return audio[0, :audio_length(m, cfg)].cpu().numpy()
