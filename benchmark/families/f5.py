"""The F5-TTS family: the port's ``F5Models`` (the flow-matching DiT of
F5-TTS v1 Base and the Vocos vocoder) built from a configuration file's
``dit``, ``vocos``, ``weights`` and ``plane``, its plan, and the numbers
that decide its ``correct``.

The plan (``make_plan``): the generated texts and each request's seed
come from the one traffic generator (``traffic.make_plan``: ``text``
lengths in blocks of every quantile, ``wrap`` ids around uniform ids).
Clip c lasts the c-th of ``voices.count`` quantiles of ``ref_s``
seconds (T_ref = int(ref_s * sample_rate) // hop frames); its log-mel is
N(``mel.mean``, ``mel.std``) a frame and bin plus the generator's voice
row c (``voices.std``) over the bins, its transcript
round(``ref_chars_per_s`` * ref_s) ids. The clips, and the clip of each
request (in blocks holding every clip once, drawn apart from the text
lengths' blocks), come from a stream of the seed of their own.

For each checked request, on its real frames, from the same weights:

- ``vel_err``: the worst over the mix's ``probe_steps`` of the relative
  L2 error of the program's guided velocity against the reference's, at
  the program's own state and time;
- ``mel_err``: of the program's generated mel against the reference's
  Euler loop from the same y0 (the request's seed, as the program draws
  it), the generated frames [T_ref, T);
- ``audio_err``: of the program's audio against the reference Vocos on
  the program's mel.

The reference (``benchmark/reference/f5.py``) rounds the DiT's product
operands as the configuration's ``products`` say (bf16) and runs Vocos
in f32; the control one step below: the DiT's operands in fp8 e4m3,
Vocos's in TF32.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from benchmark import check, traffic
from benchmark.reference import f5 as R
from tortoise_tpu_torch.models.f5 import F5Config
from tortoise_tpu_torch.models.vocos import VocosConfig
from tortoise_tpu_torch.pipeline import f5_stage


@dataclasses.dataclass
class Plan:
    requests: list           # traffic.Request each; ``voice`` is the clip
    clips: list              # f5_stage.F5Voice each
    mix: dict


def make_plan(mix: dict, seed: int, vocos: dict) -> Plan:
    """The cell's requests and clips from ``seed`` (module docstring)."""
    plan = traffic.make_plan(mix, seed, vocos["n_mel"])
    rng = np.random.default_rng([int(seed), 1])
    ref, mel, ids = mix["ref_s"], mix["mel"], mix["text"]
    k, n = mix["voices"]["count"], len(plan.requests)
    blocks = np.concatenate([rng.permutation(k) for _ in range(-(-n // k))])
    requests = [dataclasses.replace(r, voice=int(c))
                for r, c in zip(plan.requests, blocks)]
    clips = []
    for c in range(k):
        s = ref["min"] + (c + 0.5) / k * (ref["max"] - ref["min"])
        t_ref = int(s * vocos["sample_rate"]) // vocos["hop"]
        frames = rng.normal(mel["mean"], mel["std"], (t_ref, vocos["n_mel"]))
        clips.append(f5_stage.F5Voice(
            mel=(frames + plan.voices[c]).astype(np.float32),
            text=rng.integers(ids["id_low"], ids["id_high"],
                              int(round(mix["ref_chars_per_s"] * s)))
            .tolist()))
    return Plan(requests, clips, mix)


def shape(run, req) -> tuple:
    """(T, T_ref, text length) of a request, by the port's own rule."""
    clip = run.plan.clips[req.voice]
    t_ref, n_ref = clip.mel.shape[0], len(clip.text)
    return (f5_stage.frames(t_ref, n_ref, len(req.tokens)), t_ref,
            n_ref + len(req.tokens))


def build(run) -> None:
    """The plan, the weights drawn on the device and the port's models."""
    plane = run.config["plane"]
    if run.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = plane["tf32"]
        torch.backends.cudnn.allow_tf32 = plane["tf32"]
    run.compute_dtype = getattr(torch, plane["compute_dtype"])
    run.plan = make_plan(run.mix, run.seed, run.config["vocos"])
    p, v = R.random_params(run.config["dit"], run.config["vocos"],
                           run.config["weights"], run.seed, run.device)
    run.models = f5_stage.F5Models(p, v, F5Config(**run.config["dit"]),
                                   VocosConfig(**run.config["vocos"]))


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
    """A request's row after its index, text length and greedy: its
    generated frames and audio seconds (None each where it failed)."""
    if not record.ok:
        return [None, None]
    res = record.result
    return [int(res.mel.shape[-1]), len(res.audio) / res.sample_rate]


@dataclasses.dataclass
class Served:
    """One finished request: its inputs and what the program produced
    (its probes stay on the device until the check reads them)."""
    text: List[int]          # the whole text: transcript + generated
    greedy: bool
    ref_mel: np.ndarray
    ref_ids: List[int]
    gen_ids: List[int]
    seed: int
    audio: np.ndarray
    mel: np.ndarray          # (n_mel, generated frames)
    probes: dict


class Reference:
    """The reference's weights for one run and its roundings."""

    def __init__(self, config: dict, seed: int, device, dit_rounding,
                 vocos_rounding):
        self.c, self.vc = config["dit"], config["vocos"]
        self.device = device
        self.p, self.v = R.random_params(self.c, self.vc,
                                         config["weights"], seed, device)
        self.r, self.vr = dit_rounding, vocos_rounding

    def request(self, s: Served) -> R.Request:
        return R.Request(self.p, self.c, s.ref_mel, s.ref_ids, s.gen_ids,
                         self.r)

    def velocities(self, s: Served) -> list:
        """The guided velocity at each of the program's probed states."""
        req, ts = self.request(s), R.schedule(self.c["nfe"], self.c["sway"])
        return [req.velocity(x.to(self.device).float(), ts[k].to(self.device))
                for k, x in zip(s.probes["steps"], s.probes["x"])]

    def mel(self, s: Served) -> torch.Tensor:
        """The Euler loop from the program's y0: (n_mel, generated)."""
        req = self.request(s)
        # y0 as the program draws it (f5_stage.draw_normal)
        gen = torch.Generator(device=self.device).manual_seed(s.seed)
        y0 = torch.randn((req.t_len, self.c["mel_dim"]), generator=gen,
                         device=self.device, dtype=torch.float32)
        return req.sample(y0)[req.ref_frames:].T

    def audio(self, mel) -> torch.Tensor:
        mel = torch.as_tensor(np.asarray(mel), device=self.device)
        return R.vocos(self.v, self.vc, mel, self.vr)


def reference(config: dict, seed: int, device,
              control: bool = False) -> Reference:
    """The reference at the configuration's roundings (``products``: the
    DiT's operands in bf16, Vocos in f32), or, for the control, one step
    below (fp8 e4m3 and TF32)."""
    kinds = config["products"]
    dit = kinds["dit_linear"]
    if control:
        return Reference(config, seed, device, "fp8", "tf32")
    return Reference(config, seed, device, dit,
                     None if kinds["vocos"] == "f32" else kinds["vocos"])


def _worst_rel(got, want) -> float:
    return max(check._rel(g.cpu(), w.cpu()) for g, w in zip(got, want))


def numbers(ref: Reference, s: Served, names) -> dict:
    """The check's numbers ``names`` for one request (module
    docstring)."""
    out = {}
    with torch.inference_mode():
        if "vel_err" in names:
            out["vel_err"] = _worst_rel(list(s.probes["v"]),
                                        ref.velocities(s))
        if "mel_err" in names:
            out["mel_err"] = check._rel(s.mel, ref.mel(s).cpu())
        if "audio_err" in names:
            out["audio_err"] = check._rel(s.audio, ref.audio(s.mel).cpu())
    return out


def control_numbers(ref: Reference, ctrl: Reference, s: Served,
                    names) -> dict:
    """The check's numbers of the control in the program's place on the
    same request: its velocities at the program's states, its own loop
    from the same y0, and its Vocos on its own mel (on the program's
    when the mel is not asked for), each judged against ``ref``."""
    out = {}
    mel = s.mel
    with torch.inference_mode():
        if "vel_err" in names:
            out["vel_err"] = _worst_rel(ctrl.velocities(s),
                                        ref.velocities(s))
        if "mel_err" in names:
            mel = ctrl.mel(s).cpu()
            out["mel_err"] = check._rel(mel, ref.mel(s).cpu())
        if "audio_err" in names:
            out["audio_err"] = check._rel(ctrl.audio(mel).cpu(),
                                          ref.audio(mel).cpu())
    return out
