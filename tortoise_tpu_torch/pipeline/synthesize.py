"""Full synthesis: text -> speech tokens -> mel -> audio (counterpart of
``tortoise_tpu/pipeline/synthesize.py``).

Seeding: sampler="jax" seeds one torch.Generator per stage from ``seed``
(seed, seed+1, seed+2); sampler="reference" threads ONE mt19937
ReferenceRng through all stages in the reference's draw order (AR
multinomials, diffusion initial noise, the step noises, vocoder noise),
which is the plane held token for token against the JAX package.
``synthesize_batch`` is the serving path: several utterances, each with
its own voice, through one batched AR / diffusion / vocoder pass.

Each call is a request span (``synthesize``, ``synthesize_batch``) over
the stage spans ``ar``, ``diffusion`` and ``vocoder``
(``utils.profiling``); the stages' leaf spans, and the ``download`` of the
results, hold every device launch the call makes. ``timings`` holds the
stage spans' host walls.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
from typing import List, Optional

import numpy as np

from tortoise_tpu_torch.config import ARConfig, DiffusionConfig, VocoderConfig
from tortoise_tpu_torch.io.voice import load_voice_latent
from tortoise_tpu_torch.io.wav import write_wav
from tortoise_tpu_torch.text.tokenizer import Tokenizer
from tortoise_tpu_torch.pipeline import ar_stage, diffusion_stage, vocoder_stage
from tortoise_tpu_torch.pipeline.common import download, resolve_device, sync
from tortoise_tpu_torch.utils.profiling import span

# the stage module of each model family beside Tortoise's, imported on use
FAMILY_STAGES = {"f5": "tortoise_tpu_torch.pipeline.f5_stage",
                 "dia": "tortoise_tpu_torch.pipeline.dia_stage"}


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

    def to_device(self, include_ar: bool = True,
                  include_diffusion: bool = True,
                  device=None) -> "TortoiseModels":
        """Move the parameter trees onto ``device`` (default the card), in
        place, and return self. Numpy trees become tensor trees; a tree
        already on the device is left as it is (idempotent), so the
        stages' memoized casts of it are kept. The vocoder tree always
        moves. As in the JAX package, the AR stage casts (or quantizes)
        its tree itself, and on the int8 plane the diffusion stage
        quantizes its own: ``include_ar=False`` and
        ``include_diffusion=False`` leave those trees on the host rather
        than park an f32 copy beside the cast."""
        from tortoise_tpu_torch.pipeline.common import ensure_device

        if include_ar:
            self.ar_params = ensure_device(self.ar_params, device)
        if include_diffusion:
            self.diffusion_params = ensure_device(self.diffusion_params,
                                                  device)
        self.vocoder_params = ensure_device(self.vocoder_params, device)
        return self

    @classmethod
    def from_ggml_dir(cls, model_dir: str, cache_dir: Optional[str] = None,
                      **cfgs) -> "TortoiseModels":
        """Load the reference's model files from a directory laid out like
        its ``models/`` (ggml-*.bin + tokenizer.json)."""
        from tortoise_tpu_torch.io.checkpoint import (
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
               cache_dir: Optional[str] = None,
               diffusion: Optional[dict] = None,
               vocoder: Optional[dict] = None) -> "TortoiseModels":
        """Synthetic weights with the production (or tiny) tensor
        inventory, drawn by the port's copy of ``random_*_params`` (the
        float32 stream, the same values as the JAX package's).
        ``diffusion`` / ``vocoder`` replace config fields before the
        weights are drawn, e.g. ``diffusion={"n_head": 32,
        "use_flash": True}`` sizes the rel-pos tables for 32 heads.
        ``cache_dir`` memoizes the host trees as
        ``{ar,diffusion,vocoder}_{tiny|full}_{seed}.npz``, the JAX
        package's names and format, so either package loads the other's
        cache; a tree whose config is overridden is drawn anew and never
        cached (its shapes may differ from the file's)."""
        from tortoise_tpu_torch.config import (
            tiny_ar_config,
            tiny_diffusion_config,
            tiny_vocoder_config,
        )
        from tortoise_tpu_torch.io.checkpoint import (
            load_npz,
            random_ar_params,
            random_diffusion_params,
            random_vocoder_params,
            save_npz,
        )

        acfg = tiny_ar_config() if tiny else ARConfig()
        dcfg = dataclasses.replace(
            tiny_diffusion_config() if tiny else DiffusionConfig(),
            **(diffusion or {}))
        vcfg = dataclasses.replace(
            tiny_vocoder_config() if tiny else VocoderConfig(),
            **(vocoder or {}))

        def build(name, fn, cfg, s, overridden=False):
            if not cache_dir or overridden:
                return fn(cfg, s, fast=True)
            path = os.path.join(
                cache_dir, f"{name}_{'tiny' if tiny else 'full'}_{s}.npz")
            if os.path.exists(path):
                return load_npz(path)
            params = fn(cfg, s, fast=True)
            save_npz(path, params)
            return params

        return cls(
            ar_params=build("ar", random_ar_params, acfg, seed),
            diffusion_params=build("diffusion", random_diffusion_params,
                                   dcfg, seed + 1, bool(diffusion)),
            vocoder_params=build("vocoder", random_vocoder_params, vcfg,
                                 seed + 2, bool(vocoder)),
            ar_cfg=acfg, diffusion_cfg=dcfg, vocoder_cfg=vcfg,
        )


@dataclasses.dataclass
class SynthesisResult:
    audio: np.ndarray
    sample_rate: int
    mel: Optional[np.ndarray]
    sequences: List[List[int]]
    latents: List[Optional[np.ndarray]]
    tokens: List[int]
    timings: dict
    # the F5 family's loop states and guided velocities, or the Dia
    # family's logits, at the steps a caller asked for (the stages'
    # ``probe_steps``)
    probes: Optional[dict] = None
    # the Dia family's generated audio codes (channels, frames)
    codes: Optional[np.ndarray] = None

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
                     tokenizer_method: str = "greedy", mesh=None,
                     progress=None, int8_weights: bool = False,
                     stage_sync: bool = True, materialize: bool = True,
                     sampler_params=None,
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
    its own copy of the batch's walls. ``mesh`` (``parallel.make_mesh``):
    every rank of the mesh calls this with the same inputs; each stage
    runs this rank's rows ("dp") and heads or channels ("tp"), and every
    rank returns every row's result."""
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
    kw = dict(compute_dtype=compute_dtype, device=device, mesh=mesh)
    with span("synthesize_batch", device):
        with span("ar") as stage:
            lat_dev, keeps, sequences = ar_stage.autoregressive_batch(
                models.ar_params, tokens_list, voices, models.ar_cfg,
                seed=seed, int8_weights=int8_weights,
                return_device_latents=True, substage_timings=st,
                sampler_params=sampler_params, **kw)
        timings["autoregressive_s"] = stage.s
        with span("diffusion") as stage:
            mel_dev, out_lens = diffusion_stage.diffusion_batch_device(
                models.diffusion_params, lat_dev, keeps,
                models.diffusion_cfg, seed=seed + 1,
                int8_weights=int8_weights, progress=progress,
                substage_timings=st, **kw)
            if stage_sync:
                sync(device)
        timings["diffusion_s"] = stage.s
        with span("vocoder") as stage:
            audios = vocoder_stage.vocoder_batch_device(
                models.vocoder_params, mel_dev, out_lens, models.vocoder_cfg,
                seed=seed + 2, **kw)
            if materialize:
                mel_h, lat_h = download(mel_dev, lat_dev)
                mels = [mel_h[i, :, :out_lens[i]] for i in range(b)]
                latents = [lat_h[i, :keeps[i]] for i in range(b)]
            else:
                mels = latents = [None] * b
        timings["vocoder_s"] = stage.s
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
               stage_sync: bool = True, materialize: bool = True,
               sampler_params=None, device=None,
               probe_steps=(), **family_args) -> SynthesisResult:
    """Run the full pipeline on ``device`` (default ``cuda``, which raises
    without a card; pass ``device="cpu"`` for the CPU). Provide
    ``message`` (tokenized with the models' tokenizer) or raw wrapped
    ``tokens``; ``voice`` is a 1024-f32 latent or a path to a voice .bin.
    Like the reference CLI, the mel and audio come from the first AR
    candidate. ``stage_sync`` waits for the device at each stage boundary
    so the stage walls in ``timings`` are true. ``materialize=False``
    (serving) skips the mel and latent downloads of the device-resident
    path: ``mel`` is then None and ``latents`` one None per candidate.

    A bundle of another family (its ``family``) runs that family's
    stage module (``FAMILY_STAGES``, imported only then): an
    ``F5Models`` bundle F5-TTS (``tokens`` the char ids to speak,
    ``voice`` an ``F5Voice``), a ``DiaModels`` bundle Dia (``tokens`` the
    bytes to speak or ``message`` its text, ``voice`` a ``DiaVoice``;
    ``family_args`` its ``min_frames`` and ``max_frames``). ``probe_steps``
    names loop steps whose state comes back in ``probes``. The AR-only
    arguments are unused there."""
    family = getattr(models, "family", "tortoise")
    if family != "tortoise":
        stage = importlib.import_module(FAMILY_STAGES[family])
        if message is not None:
            family_args["message"] = message
        return stage.synthesize(
            models, tokens, voice, seed=seed, compute_dtype=compute_dtype,
            progress=progress, stage_sync=stage_sync,
            materialize=materialize, device=device, probe_steps=probe_steps,
            **family_args)
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
        from tortoise_tpu_torch.rng import ReferenceRng

        rng = ReferenceRng(seed)

    timings = {}
    st = timings if stage_sync else None
    with span("synthesize", device):
        if sampler == "jax" and rng is None:
            with span("ar") as stage:
                lat_dev, keeps, sequences = ar_stage.autoregressive(
                    models.ar_params, tokens, voice, batch_size,
                    models.ar_cfg, sampler=sampler, seed=seed,
                    compute_dtype=compute_dtype, int8_weights=int8_weights,
                    return_device_latents=True, substage_timings=st,
                    sampler_params=sampler_params, device=device)
            timings["autoregressive_s"] = stage.s
            with span("diffusion") as stage:
                mel_dev, out_lens = diffusion_stage.diffusion_batch_device(
                    models.diffusion_params, lat_dev[0:1], [keeps[0]],
                    models.diffusion_cfg, seed=seed + 1,
                    compute_dtype=compute_dtype, int8_weights=int8_weights,
                    device=device, progress=progress, substage_timings=st)
                if stage_sync:
                    sync(device)
            timings["diffusion_s"] = stage.s
            with span("vocoder") as stage:
                audio = vocoder_stage.vocoder_batch_device(
                    models.vocoder_params, mel_dev, out_lens,
                    models.vocoder_cfg, seed=seed + 2,
                    compute_dtype=compute_dtype, device=device)[0]
                # the downloads stay inside the stage walls, so their sum
                # (RTF) counts the same host copies as before
                # ``materialize`` existed
                if materialize:
                    mel, *latents = download(
                        mel_dev[0, :, :out_lens[0]],
                        *(lat_dev[b, :keeps[b]]
                          for b in range(lat_dev.shape[0])))
                else:
                    mel, latents = None, [None] * lat_dev.shape[0]
            timings["vocoder_s"] = stage.s
        else:
            with span("ar") as stage:
                latents, sequences = ar_stage.autoregressive(
                    models.ar_params, tokens, voice, batch_size,
                    models.ar_cfg, sampler=sampler, seed=seed, rng=rng,
                    compute_dtype=compute_dtype, int8_weights=int8_weights,
                    sampler_params=sampler_params, substage_timings=st,
                    device=device)
            timings["autoregressive_s"] = stage.s
            with span("diffusion") as stage:
                mel = diffusion_stage.diffusion(
                    models.diffusion_params, latents[0],
                    models.diffusion_cfg, seed=seed + 1, rng=rng,
                    compute_dtype=compute_dtype, int8_weights=int8_weights,
                    device=device, progress=progress)
            timings["diffusion_s"] = stage.s
            with span("vocoder") as stage:
                audio = vocoder_stage.vocoder(
                    models.vocoder_params, mel, models.vocoder_cfg,
                    seed=seed + 2, rng=rng, compute_dtype=compute_dtype,
                    device=device)
            timings["vocoder_s"] = stage.s
    return SynthesisResult(audio=audio,
                           sample_rate=models.vocoder_cfg.sample_rate,
                           mel=mel, sequences=sequences, latents=latents,
                           tokens=list(tokens), timings=timings)
