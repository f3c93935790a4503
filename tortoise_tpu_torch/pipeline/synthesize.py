"""Full synthesis: text -> speech tokens -> mel -> audio (counterpart of
``tortoise_tpu/pipeline/synthesize.py``).

Seeding: sampler="jax" seeds one torch.Generator per stage from ``seed``
(seed, seed+1, seed+2); sampler="reference" threads ONE mt19937
ReferenceRng through all stages in the reference's draw order (AR
multinomials, diffusion initial noise, the step noises, vocoder noise),
which is the plane held token for token against the JAX package.
``synthesize_batch`` is the serving path: several utterances, each with
its own voice, through one batched AR / diffusion / vocoder pass.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional

import numpy as np

from tortoise_tpu.config import ARConfig, DiffusionConfig, VocoderConfig
from tortoise_tpu.io.voice import load_voice_latent
from tortoise_tpu.io.wav import write_wav
from tortoise_tpu.text.tokenizer import Tokenizer
from tortoise_tpu_torch.pipeline import ar_stage, diffusion_stage, vocoder_stage
from tortoise_tpu_torch.pipeline.common import resolve_device, sync


@dataclasses.dataclass
class TortoiseModels:
    """Host (numpy) parameter trees in the JAX package's layouts; each
    stage casts and places its tree on the run's device."""

    ar_params: dict
    diffusion_params: dict
    vocoder_params: dict
    ar_cfg: ARConfig = ARConfig()
    diffusion_cfg: DiffusionConfig = DiffusionConfig()
    vocoder_cfg: VocoderConfig = VocoderConfig()
    tokenizer: Optional[Tokenizer] = None

    @classmethod
    def from_ggml_dir(cls, model_dir: str, cache_dir: Optional[str] = None,
                      **cfgs) -> "TortoiseModels":
        """Load the reference's model files from a directory laid out like
        its ``models/`` (ggml-*.bin + tokenizer.json)."""
        from tortoise_tpu.io.checkpoint import (
            convert_ar_checkpoint,
            convert_diffusion_checkpoint,
            convert_vocoder_checkpoint,
        )

        def cache(name):
            return os.path.join(cache_dir, name) if cache_dir else None

        tok_path = os.path.join(model_dir, "tokenizer.json")
        return cls(
            ar_params=convert_ar_checkpoint(
                os.path.join(model_dir, "ggml-model.bin"), cache("ar.npz")),
            diffusion_params=convert_diffusion_checkpoint(
                os.path.join(model_dir, "ggml-diffusion-model.bin"),
                cache("diffusion.npz")),
            vocoder_params=convert_vocoder_checkpoint(
                os.path.join(model_dir, "ggml-vocoder-model.bin"),
                cache("vocoder.npz")),
            tokenizer=(Tokenizer.from_file(tok_path)
                       if os.path.exists(tok_path) else None),
            **cfgs,
        )

    @classmethod
    def random(cls, seed: int = 0, tiny: bool = False,
               diffusion: Optional[dict] = None,
               vocoder: Optional[dict] = None) -> "TortoiseModels":
        """Synthetic weights with the production (or tiny) tensor
        inventory, drawn by the JAX package's own ``random_*_params``
        (float32 stream) — both packages run identical weights.
        ``diffusion`` / ``vocoder`` replace config fields before the
        weights are drawn, e.g. ``diffusion={"n_head": 32,
        "use_flash": True}`` sizes the rel-pos tables for 32 heads."""
        from tortoise_tpu.config import (
            tiny_ar_config,
            tiny_diffusion_config,
            tiny_vocoder_config,
        )
        from tortoise_tpu.io.checkpoint import (
            random_ar_params,
            random_diffusion_params,
            random_vocoder_params,
        )

        acfg = tiny_ar_config() if tiny else ARConfig()
        dcfg = dataclasses.replace(
            tiny_diffusion_config() if tiny else DiffusionConfig(),
            **(diffusion or {}))
        vcfg = dataclasses.replace(
            tiny_vocoder_config() if tiny else VocoderConfig(),
            **(vocoder or {}))
        return cls(
            ar_params=random_ar_params(acfg, seed, fast=True),
            diffusion_params=random_diffusion_params(dcfg, seed + 1,
                                                     fast=True),
            vocoder_params=random_vocoder_params(vcfg, seed + 2, fast=True),
            ar_cfg=acfg, diffusion_cfg=dcfg, vocoder_cfg=vcfg,
        )


@dataclasses.dataclass
class SynthesisResult:
    audio: np.ndarray
    sample_rate: int
    mel: np.ndarray
    sequences: List[List[int]]
    latents: List[np.ndarray]
    tokens: List[int]
    timings: dict

    def save(self, path: str) -> None:
        write_wav(path, self.audio, self.sample_rate)


def _row_voices(voices, d: int):
    """One (d,) latent, a (B, d) array, a path, or a list of paths/arrays
    per row -> a (d,) or (B, d) f32 array."""
    if isinstance(voices, (list, tuple)):
        return np.stack([load_voice_latent(v, d) if isinstance(v, str)
                         else np.asarray(v, np.float32) for v in voices])
    if isinstance(voices, str):
        return load_voice_latent(voices, d)
    if voices is None:
        raise ValueError("voice latents are required")
    return np.asarray(voices, np.float32)


def synthesize_batch(models: TortoiseModels,
                     messages: Optional[List[str]] = None,
                     tokens_list: Optional[List[List[int]]] = None,
                     voices=None, seed: int = 0, compute_dtype=None,
                     tokenizer_method: str = "greedy", progress=None,
                     int8_weights: bool = False, stage_sync: bool = True,
                     materialize: bool = True, sampler_params=None,
                     device=None) -> List[SynthesisResult]:
    """Batched serving path: one utterance per row of ``tokens_list`` (or
    of ``messages``, tokenized), each stage one batched computation with
    per-row masked lengths. ``voices``: one (d,) latent or path shared by
    all rows, a (B, d) array, or a list of paths/arrays per row.
    ``sampler_params`` (ar_stage.normalize_sampler) holds for the whole
    batch. Latents and mel stay on the device between the stages;
    ``progress(fraction)`` reports the diffusion steps at the JAX
    package's cuts. ``materialize=False`` (serving) leaves each row's mel and
    latents None. ``stage_sync`` waits for the device at each stage
    boundary so the stage walls in ``timings`` are true; every row gets
    its own copy of the batch's walls."""
    device = resolve_device(device)
    if tokens_list is None:
        if messages is None:
            raise ValueError("pass messages or tokens_list")
        if models.tokenizer is None:
            raise ValueError("no tokenizer available; pass tokens_list")
        tokens_list = [models.tokenizer.encode_pipeline(m, tokenizer_method)
                       for m in messages]
    b = len(tokens_list)
    voices = _row_voices(voices, models.ar_cfg.d_model)
    timings = {}
    st = timings if stage_sync else None
    kw = dict(compute_dtype=compute_dtype, device=device)
    t0 = time.monotonic()
    lat_dev, keeps, sequences = ar_stage.autoregressive_batch(
        models.ar_params, tokens_list, voices, models.ar_cfg, seed=seed,
        int8_weights=int8_weights, return_device_latents=True,
        substage_timings=st, sampler_params=sampler_params, **kw)
    timings["autoregressive_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    mel_dev, out_lens = diffusion_stage.diffusion_batch_device(
        models.diffusion_params, lat_dev, keeps, models.diffusion_cfg,
        seed=seed + 1, int8_weights=int8_weights, progress=progress,
        substage_timings=st, **kw)
    if stage_sync:
        sync(device)
    timings["diffusion_s"] = time.monotonic() - t0
    t0 = time.monotonic()
    audios = vocoder_stage.vocoder_batch_device(
        models.vocoder_params, mel_dev, out_lens, models.vocoder_cfg,
        seed=seed + 2, **kw)
    if materialize:
        mel_h = mel_dev.float().cpu().numpy()
        lat_h = lat_dev.float().cpu().numpy()
        mels = [mel_h[i, :, :out_lens[i]] for i in range(b)]
        latents = [lat_h[i, :keeps[i]] for i in range(b)]
    else:
        mels = latents = [None] * b
    timings["vocoder_s"] = time.monotonic() - t0
    return [SynthesisResult(audio=audios[i],
                            sample_rate=models.vocoder_cfg.sample_rate,
                            mel=mels[i], sequences=[sequences[i]],
                            latents=[latents[i]],
                            tokens=list(tokens_list[i]),
                            timings=dict(timings))
            for i in range(b)]


def synthesize(models: TortoiseModels, message: Optional[str] = None,
               tokens: Optional[List[int]] = None, voice=None, seed: int = 0,
               batch_size: int = 1, sampler: str = "jax", rng=None,
               compute_dtype=None, tokenizer_method: str = "greedy",
               progress=None, int8_weights: bool = False,
               stage_sync: bool = True, sampler_params=None,
               device=None) -> SynthesisResult:
    """Run the full pipeline on ``device`` (default: the first CUDA card,
    else the CPU). Provide ``message`` (tokenized with the models'
    tokenizer) or raw wrapped ``tokens``; ``voice`` is a 1024-f32 latent
    or a path to a voice .bin. Like the reference CLI, the mel and audio
    come from the first AR candidate. ``stage_sync`` waits for the device
    at each stage boundary so the stage walls in ``timings`` are true."""
    device = resolve_device(device)
    if tokens is None:
        if models.tokenizer is None:
            raise ValueError("no tokenizer available; pass tokens directly")
        tokens = models.tokenizer.encode_pipeline(message, tokenizer_method)
    if isinstance(voice, str):
        voice = load_voice_latent(voice, models.ar_cfg.d_model)
    if voice is None:
        raise ValueError("a voice latent (array or path) is required")
    if sampler == "reference" and rng is None:
        from tortoise_tpu.rng import ReferenceRng

        rng = ReferenceRng(seed)

    timings = {}
    t0 = time.monotonic()
    if sampler == "jax" and rng is None:
        lat_dev, keeps, sequences = ar_stage.autoregressive(
            models.ar_params, tokens, voice, batch_size, models.ar_cfg,
            sampler=sampler, seed=seed, compute_dtype=compute_dtype,
            int8_weights=int8_weights, return_device_latents=True,
            substage_timings=timings if stage_sync else None,
            sampler_params=sampler_params, device=device)
        latents = [lat_dev[b, :keeps[b]].float().cpu().numpy()
                   for b in range(lat_dev.shape[0])]
        timings["autoregressive_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        mel_dev, out_lens = diffusion_stage.diffusion_batch_device(
            models.diffusion_params, lat_dev[0:1], [keeps[0]],
            models.diffusion_cfg, seed=seed + 1, compute_dtype=compute_dtype,
            int8_weights=int8_weights, device=device, progress=progress,
            substage_timings=timings if stage_sync else None)
        if stage_sync:
            sync(device)
        timings["diffusion_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        audio = vocoder_stage.vocoder_batch_device(
            models.vocoder_params, mel_dev, out_lens, models.vocoder_cfg,
            seed=seed + 2, compute_dtype=compute_dtype, device=device)[0]
        mel = mel_dev[0, :, :out_lens[0]].float().cpu().numpy()
    else:
        latents, sequences = ar_stage.autoregressive(
            models.ar_params, tokens, voice, batch_size, models.ar_cfg,
            sampler=sampler, seed=seed, rng=rng, compute_dtype=compute_dtype,
            int8_weights=int8_weights, sampler_params=sampler_params,
            substage_timings=timings if stage_sync else None, device=device)
        timings["autoregressive_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        mel = diffusion_stage.diffusion(
            models.diffusion_params, latents[0], models.diffusion_cfg,
            seed=seed + 1, rng=rng, compute_dtype=compute_dtype,
            int8_weights=int8_weights, device=device, progress=progress)
        timings["diffusion_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        audio = vocoder_stage.vocoder(
            models.vocoder_params, mel, models.vocoder_cfg, seed=seed + 2,
            rng=rng, compute_dtype=compute_dtype, device=device)
    timings["vocoder_s"] = time.monotonic() - t0
    return SynthesisResult(audio=audio,
                           sample_rate=models.vocoder_cfg.sample_rate,
                           mel=mel, sequences=sequences, latents=latents,
                           tokens=list(tokens), timings=timings)
