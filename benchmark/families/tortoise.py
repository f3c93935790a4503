"""The Tortoise-TTS v2 family: the port's ``TortoiseModels`` (GPT-2 AR
decoder, DDPM denoiser, UnivNet/LVC vocoder) built from a configuration
file's ``ar``, ``diffusion``, ``vocoder``, ``plane`` and ``weights``,
and the numbers that decide its ``correct``.

For each checked request, from the program's own served tokens and the
same inputs and weights:

- ``ar_gap``: the widest gap by which a served token's reference logit
  (repetition penalty applied) lies below the best one for a greedy
  request, or below the 50th best (the sampler's top-k) for a sampled
  one; 0 where the reference agrees;
- ``latent_err``: the relative L2 error of the program's latents
  against the reference's latent pass on the same tokens;
- ``mel_err``: of the program's mel against the reference's 80-step
  loop on the program's latents, with the same noise;
- ``audio_err``: of the program's audio against the reference vocoder
  on the program's mel, with the same noise, each product's operands
  rounded where the configuration rounds them (bf16 on the int8
  plane).

The noise is replayed as the program draws it: one generator per stage
seeded by the batch's seed + 1 (the loop) and + 2 (the vocoder), each
draw the whole padded batch, of which the request's row and its own
frames are taken. The reference (``benchmark/reference``) runs after the
program's state is freed, with TF32 off, on weights it draws again from
the seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from benchmark import check, traffic, weights
from benchmark.reference import ar as R_ar
from benchmark.reference import diffusion as R_diff
from benchmark.reference import vocoder as R_voc
from benchmark.reference.precision import Precision, tf32_mode

# the sampler's defaults: top-k, and the repetition penalty
TOP_K = 50
PENALTY = 2.0
# the program's padding rules of the noise draws: the mel length rounded
# up to 64 frames, the vocoder's (mel + pad frames) up to 32
OUT_BUCKET = 64
MEL_BUCKET = 32
MEL_NUMER, MEL_DENOM = 4 * 24000, 22050


@dataclasses.dataclass
class Served:
    """One finished request as the check needs it: its inputs, what the
    program produced, and how its noise was drawn (the batch's seed, the
    batch's padded row count and this request's row)."""
    text: List[int]
    voice: np.ndarray
    greedy: bool
    tokens: List[int]
    audio: np.ndarray
    latents: Optional[np.ndarray] = None
    mel: Optional[np.ndarray] = None
    seed: int = 0
    rows: int = 1
    row: int = 0
    frames: Optional[List[int]] = None   # mel frames of each batch row

    def pad(self, own: int, extra: int, bucket: int) -> int:
        """The padded length of the batch's noise draw: the longest
        row's frames (this one's alone) plus ``extra``, rounded up."""
        return _round_up(max(self.frames or [own]) + extra, bucket)


def served_tokens(padded, ar: dict) -> List[int]:
    """The sampled tokens a padded sequence (``[start] + tokens + pad +
    tail + [stop]``, as the port hands them out) still shows: those
    before the forced tail, up to the first stop token."""
    out = []
    for t in list(padded[1:-1])[:ar["pad_mel_length"] - len(ar["tail_tokens"])]:
        out.append(int(t))
        if t == ar["stop_mel_token"]:
            break
    return out


def port_configs(config: dict, device):
    """The port's config dataclasses for ``config`` on ``device``: the
    published sizes, and ``use_flash`` by the CLI's rule."""
    from tortoise_tpu_torch.cli import flash_on
    from tortoise_tpu_torch.config import (
        ARConfig,
        DiffusionConfig,
        VocoderConfig,
    )

    def fields(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}

    plane = config["plane"]
    return (ARConfig(**fields(config["ar"])),
            DiffusionConfig(**fields(config["diffusion"]),
                            use_flash=plane["use_flash"]
                            and flash_on(device)),
            VocoderConfig(**fields(config["vocoder"])))


def build(run) -> None:
    """The plan, the weights on the device and the port's models."""
    from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels

    plane = run.config["plane"]
    if plane["tf32"] is not None and run.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = plane["tf32"]
        torch.backends.cudnn.allow_tf32 = plane["tf32"]
    run.compute_dtype = (getattr(torch, plane["compute_dtype"])
                         if plane["compute_dtype"] else None)
    run.int8 = plane["int8_weights"]
    run.plan = traffic.make_plan(run.mix, run.seed,
                                 run.config["ar"]["d_model"])
    w = weights.make(run.config, run.seed, run.device)
    ar, diff, voc = port_configs(run.config, run.device)
    run.models = TortoiseModels(ar_params=w["ar"],
                                diffusion_params=w["diffusion"],
                                vocoder_params=w["vocoder"], ar_cfg=ar,
                                diffusion_cfg=diff, vocoder_cfg=voc)


def free(run) -> None:
    """Drop the program's state: its models, casts and step graphs."""
    import gc

    from tortoise_tpu_torch.pipeline.common import clear_cast_cache

    run.models = None
    clear_cast_cache()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def request_row(record) -> list:
    """A request's row after its index, text length and greedy: its AR
    steps, latent frames and audio seconds (None each where it failed)."""
    if not record.ok:
        return [None, None, None]
    res = record.result
    return [int(res.timings.get("ar_decode_steps", 0)),
            len(res.latents[0]) if res.latents[0] is not None else None,
            len(res.audio) / res.sample_rate]


def _vocoder_operands(config: dict):
    """The type the configuration rounds the vocoder's product operands
    to (its ``products.vocoder``), None for float32."""
    kind = config["products"]["vocoder"]
    return None if kind == "f32" else kind


def reference_precision(config: dict) -> Precision:
    plane = config["plane"]
    voc = _vocoder_operands(config)
    return Precision(8, 8, vocoder=voc) if plane["int8_weights"] else \
        Precision(vocoder=voc)


def control_precision(config: dict) -> Precision:
    """One step below the configuration's precision: int4 weights and an
    fp8 vocoder for the int8 plane, TF32 for the f32 plane."""
    plane = config["plane"]
    if plane["int8_weights"]:
        return Precision(4, 8, vocoder="fp8")
    return Precision(tf32=True)


def _round_up(n, m):
    return (n + m - 1) // m * m


def mel_frames(keep: int) -> int:
    return keep * MEL_NUMER // MEL_DENOM


class Reference:
    """The reference's weights for one run, prepared at ``prec``."""

    def __init__(self, config: dict, seed: int, device, prec: Precision):
        self.config, self.device, self.prec = config, device, prec
        w = weights.make(config, seed, device)
        self.ar = R_ar.prepare(w["ar"], prec)
        self.diff = R_diff.prepare(w["diffusion"], prec)
        self.voc = w["vocoder"]

    def _tf32(self):
        return tf32_mode(self.prec.tf32)

    def logits(self, s: Served) -> torch.Tensor:
        """(n, V) penalized logits of the served tokens, teacher-forced."""
        c = self.config["ar"]
        with self._tf32():
            lg = R_ar.decode_logits(self.ar, c, s.text, s.voice, s.tokens)
        return R_ar.penalized(lg, s.tokens, c, PENALTY)

    def latents(self, s: Served) -> torch.Tensor:
        with self._tf32():
            return R_ar.latents(self.ar, self.config["ar"], s.text, s.voice,
                                s.tokens)

    def mel(self, s: Served, latents) -> torch.Tensor:
        lat = torch.as_tensor(np.asarray(latents), device=self.device)
        out_len = mel_frames(lat.shape[0])
        pad = s.pad(out_len, 0, OUT_BUCKET)
        gen = torch.Generator(device=self.device).manual_seed(s.seed + 1)
        n_mel = self.config["diffusion"]["n_mel"]

        def noises():
            while True:
                yield torch.randn((s.rows, n_mel, pad), generator=gen,
                                  device=self.device)[s.row, :, :out_len]

        with self._tf32():
            return R_diff.sample(self.diff, self.config["diffusion"], lat,
                                 noises())

    def audio(self, s: Served, mel) -> torch.Tensor:
        c = self.config["vocoder"]
        mel = torch.as_tensor(np.asarray(mel), device=self.device)
        total = mel.shape[1] + c["mel_pad_frames"]
        gen = torch.Generator(device=self.device).manual_seed(s.seed + 2)
        pad = s.pad(mel.shape[1], c["mel_pad_frames"], MEL_BUCKET)
        noise = torch.randn((s.rows, c["noise_ch"], pad), generator=gen,
                            device=self.device)[s.row, :, :total]
        # rounded operands are exact in TF32: cuDNN may take the same
        # tensor-core convolutions the program's default settings take
        conv = self.prec.tf32 or self.prec.vocoder is not None
        with tf32_mode(self.prec.tf32, conv):
            return R_voc.forward(self.voc, c, R_voc.padded_mel(mel, c),
                                 noise, self.prec.vocoder)


def reference(config: dict, seed: int, device,
              control: bool = False) -> Reference:
    """The reference for one run: at the configuration's precision, or,
    for the control, one step below it."""
    prec = (control_precision if control else reference_precision)(config)
    return Reference(config, seed, device, prec)


def token_gap(pen: torch.Tensor, tokens, greedy: bool) -> float:
    """The widest gap of the served ``tokens`` below the best penalized
    logit (greedy) or below the TOP_K-th (sampled), 0 where above."""
    ids = torch.as_tensor(tokens, device=pen.device)[:, None]
    got = pen.gather(1, ids)[:, 0]
    k = 1 if greedy else min(TOP_K, pen.shape[-1])
    edge = pen.topk(k, dim=-1).values[:, -1]
    return float((edge - got).clamp_min(0).max())


def numbers(ref: Reference, s: Served, names) -> dict:
    """The check's numbers ``names`` for one request (module
    docstring)."""
    out = {}
    if "ar_gap" in names:
        out["ar_gap"] = token_gap(ref.logits(s), s.tokens, s.greedy)
    if "latent_err" in names:
        out["latent_err"] = check._rel(s.latents, ref.latents(s).cpu())
    if "mel_err" in names:
        out["mel_err"] = check._rel(s.mel, ref.mel(s, s.latents).cpu())
    if "audio_err" in names:
        out["audio_err"] = check._rel(s.audio, ref.audio(s, s.mel).cpu())
    return out


def control_numbers(ref: Reference, ctrl: Reference, s: Served,
                    names) -> dict:
    """The check's numbers of the control: ``ctrl`` (the reference at the
    precision below) in the program's place on the same prompts and
    served tokens, judged against ``ref``. Its AR gap is that of the
    tokens the control's penalized logits put first (greedy) or in its
    top-k; its latents, mel and audio are its own, each from its own
    stage before, as the program's are (asked for its audio alone, it
    vocodes the program's mel, as the program does)."""
    out = {}
    if "ar_gap" in names:
        pen_c, pen_r = ctrl.logits(s), ref.logits(s)
        k = 1 if s.greedy else min(TOP_K, pen_r.shape[-1])
        # the control's top-k set, each judged as a served token
        ids = pen_c.topk(k, dim=-1).indices
        edge = pen_r.topk(k, dim=-1).values[:, -1:]
        out["ar_gap"] = float((edge - pen_r.gather(1, ids)).clamp_min(0)
                              .max())
    mel = s.mel
    if {"latent_err", "mel_err"} & set(names):
        lat = ctrl.latents(s).cpu()
        if "latent_err" in names:
            out["latent_err"] = check._rel(lat, ref.latents(s).cpu())
        mel = ctrl.mel(s, lat).cpu()
        if "mel_err" in names:
            out["mel_err"] = check._rel(mel, ref.mel(s, lat).cpu())
    if "audio_err" in names:
        out["audio_err"] = check._rel(ctrl.audio(s, mel).cpu(),
                                      ref.audio(s, mel).cpu())
    return out
