"""What decides ``correct``: the program's outputs in the window against
the plain reference (``benchmark/reference``), request by request.

A sample of the window's finished requests is drawn from the seed, with
the longest text in it and at least one greedy request where the window
has one. For each, from the program's own served tokens and the same
inputs and weights:

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

A cell compares the numbers its mix's ``check.limits`` name, each the
worst over the sample. The noise is replayed as the
program draws it: one generator per stage seeded by the batch's seed +
1 (the loop) and + 2 (the vocoder), each draw the whole padded batch,
of which the request's row and its own frames are taken. The reference
runs after the program's state is freed, with TF32 off, on weights it
draws again from the seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from benchmark import weights as W
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
        w = W.make(config, seed, device)
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


def _rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got)).double()
    want = torch.as_tensor(np.asarray(want)).double().to(got.device)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


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
        out["latent_err"] = _rel(s.latents, ref.latents(s).cpu())
    if "mel_err" in names:
        out["mel_err"] = _rel(s.mel, ref.mel(s, s.latents).cpu())
    if "audio_err" in names:
        out["audio_err"] = _rel(s.audio, ref.audio(s, s.mel).cpu())
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
            out["latent_err"] = _rel(lat, ref.latents(s).cpu())
        mel = ctrl.mel(s, lat).cpu()
        if "mel_err" in names:
            out["mel_err"] = _rel(mel, ref.mel(s, lat).cpu())
    if "audio_err" in names:
        out["audio_err"] = _rel(ctrl.audio(s, mel).cpu(),
                                ref.audio(s, mel).cpu())
    return out


def sample(served: List[Served], seed: int, n: int) -> List[int]:
    """Indices of ``n`` of the window's finished requests drawn from
    ``seed``: the longest text, a greedy one where there is one, and the
    rest drawn."""
    rng = np.random.default_rng(int(seed) + 7)
    idx = list(range(len(served)))
    pick = [max(idx, key=lambda i: (len(served[i].text), -i))]
    greedy = [i for i in idx if served[i].greedy and i not in pick]
    if greedy and not served[pick[0]].greedy:
        pick.append(int(rng.choice(greedy)))
    rest = [i for i in idx if i not in pick]
    rng.shuffle(rest)
    return (pick + rest)[:min(n, len(idx))]


def worst(readings: List[dict]) -> dict:
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def verdict(nums: dict, limits: dict) -> bool:
    """Every number within its limit, every limit's number read, and no
    number without a limit."""
    return (set(nums) == set(limits)
            and all(limits[k] is not None and nums[k] <= limits[k]
                    for k in limits))
