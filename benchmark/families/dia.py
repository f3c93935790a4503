"""The Dia family: the port's ``DiaModels`` (Dia-1.6B and the DAC 44.1
kHz decoder) built from a configuration file's ``dia``, ``dac``,
``weights`` and ``plane``, its plan, and the numbers that decide its
``correct``.

The plan (``make_plan``): the dialogues and each request's seed come
from the one traffic generator (``traffic.make_plan``: ``text`` lengths
in blocks of every quantile, printable bytes wrapped in ``[S1]`` ... "."),
with the middle byte made ``[S2]``. Clip c lasts the c-th of
``voices.count`` quantiles of ``ref_s`` seconds: round(``frames_per_s``
* s) frames of uniform codes on every codebook (the DAC's
``codebook_size``), and a transcript of
round(``ref_bytes_per_s`` * s) printable bytes after ``[S1]``. The clips,
and the clip of each request (in blocks holding every clip once, drawn
apart from the text lengths' blocks), come from a stream of the seed of
their own. A request speaks round(``frames_per_s`` * len /
``gen_bytes_per_s``) frames (its ``min_frames`` and ``max_frames``), then
the delay's tail.

For each checked request, from the same weights:

- ``logit_err``: the worst over the request's probed steps
  (``probe_fractions`` of its steps) of the relative L2 error of the
  program's raw logits (both CFG rows, every channel) against the
  reference's teacher-forced forward over the program's own input grid
  (prompt, then every code the program fed back): prefill and cached
  decode against one full causal pass;
- ``audio_err``: of the program's audio against the reference DAC on the
  program's codes.

The reference (``benchmark/reference/dia.py``) rounds the encoder's and
decoder's product operands as the configuration's ``products`` say
(bf16) and runs the DAC in f32; the control one step below: fp8 e4m3
operands, and the DAC's in TF32.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from benchmark import check, traffic
from benchmark.reference import dia as R
from tortoise_tpu_torch.models.dac import DacConfig
from tortoise_tpu_torch.models.dia import DiaConfig
from tortoise_tpu_torch.pipeline import dia_stage

S1, S2 = 1, 2


@dataclasses.dataclass
class Plan:
    requests: list           # traffic.Request each; ``voice`` is the clip
    clips: list              # dia_stage.DiaVoice each
    mix: dict


def dia_config(c: dict) -> DiaConfig:
    return DiaConfig(**dict(c, delay=tuple(c["delay"])))


def dac_config(c: dict) -> DacConfig:
    return DacConfig(**dict(c, rates=tuple(c["rates"])))


def _printable(rng, mix, n) -> list:
    t = mix["text"]
    return rng.integers(t["id_low"], t["id_high"], n).tolist()


def make_plan(mix: dict, seed: int, config: dict) -> Plan:
    """The cell's requests and clips from ``seed`` (module docstring),
    for the configuration's ``dia`` and ``dac``."""
    dia, book = config["dia"], config["dac"]["codebook_size"]
    plan = traffic.make_plan(mix, seed, dia["channels"])
    rng = np.random.default_rng([int(seed), 1])
    ref = mix["ref_s"]
    k, n = mix["voices"]["count"], len(plan.requests)
    blocks = np.concatenate([rng.permutation(k) for _ in range(-(-n // k))])
    requests = []
    for r, c in zip(plan.requests, blocks):
        tokens = list(r.tokens)
        tokens[len(tokens) // 2] = S2
        requests.append(dataclasses.replace(r, tokens=tokens, voice=int(c)))
    clips = []
    for c in range(k):
        s = ref["min"] + (c + 0.5) / k * (ref["max"] - ref["min"])
        frames = int(round(mix["frames_per_s"] * s))
        codes = rng.integers(0, book, (frames, dia["channels"]))
        text = [S1] + _printable(rng, mix,
                                 int(round(mix["ref_bytes_per_s"] * s)) - 1)
        clips.append(dia_stage.DiaVoice(codes=codes, text=text))
    return Plan(requests, clips, mix)


def frames_of(mix: dict, req) -> int:
    """The frames a request speaks: its seconds at ``gen_bytes_per_s``
    bytes a second, at ``frames_per_s``."""
    return int(round(mix["frames_per_s"] * len(req.tokens)
                     / mix["gen_bytes_per_s"]))


def shape(run, req) -> tuple:
    """(prompt frames P, text bytes, generated frames N, loop steps) of a
    request, by the port's own rule (N + max delay + 1 steps)."""
    clip = run.plan.clips[req.voice]
    n = frames_of(run.mix, req)
    delay = max(run.config["dia"]["delay"])
    return (clip.codes.shape[0], len(clip.text) + len(req.tokens), n,
            n + delay + 1)


def graph_key(run, req) -> tuple:
    """(padded text, padded cache) of a request: its step graph's key."""
    p, text, n, _ = shape(run, req)
    cfg = dia_config(run.config["dia"])
    return (dia_stage.text_length(text),
            dia_stage.cache_length(p, n, cfg))


def probe_steps(mix: dict, steps: int) -> tuple:
    """The loop steps whose logits the check compares: the mix's
    ``probe_fractions`` of the last step."""
    return tuple(sorted({int(round(f * (steps - 1)))
                         for f in mix["probe_fractions"]}))


def build(run) -> None:
    """The plan, the weights drawn on the device and the port's models."""
    plane = run.config["plane"]
    if run.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = plane["tf32"]
        torch.backends.cudnn.allow_tf32 = plane["tf32"]
    run.compute_dtype = getattr(torch, plane["compute_dtype"])
    run.plan = make_plan(run.mix, run.seed, run.config)
    p, d = R.random_params(run.config["dia"], run.config["dac"],
                           run.config["weights"], run.seed, run.device)
    run.models = dia_stage.DiaModels(p, d, dia_config(run.config["dia"]),
                                     dac_config(run.config["dac"]))


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
    return [int(res.codes.shape[-1]), len(res.audio) / res.sample_rate]


@dataclasses.dataclass
class Served:
    """One finished request: its inputs and what the program produced
    (its probes stay on the device until the check reads them)."""
    text: List[int]          # the encoder's bytes: transcript + dialogue
    greedy: bool
    prompt: int              # the prompt's frames P
    codes: np.ndarray        # (channels, frames) the DAC decoded
    audio: np.ndarray
    probes: dict             # steps, logits (k, 2, C, V), grid (P + S, C)


class Reference:
    """The reference's weights for one run and its roundings."""

    def __init__(self, config: dict, seed: int, device, rounding,
                 dac_rounding):
        self.c, self.dc = config["dia"], config["dac"]
        self.device = device
        self.p, self.d = R.random_params(self.c, self.dc, config["weights"],
                                         seed, device)
        self.r, self.dr = rounding, dac_rounding

    def logits(self, s: Served) -> list:
        """The teacher-forced logits (2, C, V) at each probed step."""
        last = s.prompt + max(s.probes["steps"]) + 1
        grid = s.probes["grid"][:last].to(self.device)
        lg = R.logits(self.p, self.c, s.text, grid, self.r)
        return [lg[:, s.prompt + k] for k in s.probes["steps"]]

    def audio(self, codes) -> torch.Tensor:
        codes = torch.as_tensor(np.asarray(codes), device=self.device).long()
        codes = torch.where(codes < self.dc["codebook_size"], codes, 0)
        return R.dac(self.d, self.dc, codes, self.dr)


def reference(config: dict, seed: int, device,
              control: bool = False) -> Reference:
    """The reference at the configuration's roundings (``products``: the
    encoder's and decoder's operands in bf16, the DAC in f32), or, for
    the control, one step below (fp8 e4m3 and TF32)."""
    kinds = config["products"]
    if control:
        return Reference(config, seed, device, "fp8", "tf32")
    return Reference(config, seed, device, kinds["dia_linear"],
                     None if kinds["dac"] == "f32" else kinds["dac"])


def _worst_rel(got, want) -> float:
    return max(check._rel(g.cpu(), w.cpu()) for g, w in zip(got, want))


def numbers(ref: Reference, s: Served, names) -> dict:
    """The check's numbers ``names`` for one request (module
    docstring)."""
    out = {}
    with torch.inference_mode():
        if "logit_err" in names:
            out["logit_err"] = _worst_rel(list(s.probes["logits"]),
                                          ref.logits(s))
        if "audio_err" in names:
            out["audio_err"] = check._rel(s.audio, ref.audio(s.codes).cpu())
    return out


def control_numbers(ref: Reference, ctrl: Reference, s: Served,
                    names) -> dict:
    """The check's numbers of the control in the program's place on the
    same request: its logits over the program's grid, and its DAC on the
    program's codes, each judged against ``ref``."""
    out = {}
    with torch.inference_mode():
        if "logit_err" in names:
            out["logit_err"] = _worst_rel(ctrl.logits(s), ref.logits(s))
        if "audio_err" in names:
            out["audio_err"] = check._rel(ctrl.audio(s.codes).cpu(),
                                          ref.audio(s.codes).cpu())
    return out
