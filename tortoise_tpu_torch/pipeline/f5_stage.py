"""The F5-TTS family's synthesis: reference clip and text -> generated
mel (the flow-matching loop of ``models.f5``) -> audio (Vocos,
``pipeline.vocos_stage``). ``pipeline.synthesize.synthesize`` hands an
``F5Models`` bundle here, so the CLI and the server reach it through
their usual entry.

A request (``infer/utils_infer.py`` and ``model/cfm.py`` upstream): the
reference clip's log-mel (T_ref frames) and its transcript's char ids
(``F5Voice``), and the char ids to speak (``tokens``). The duration is
T = T_ref + T_ref * len(gen) / len(ref) (``frames``); a text too long
for ~22 s of reference plus generation is cut into chunks
(``chunk_texts``), each synthesized on the same clip, the audio joined.

- ``f5.text``: both CFG rows' text features, once a request (v1's text
  cache); the unconditioned row is the filler with the cond mel zeroed.
- ``f5.denoise_loop``: ``nfe`` Euler steps from y0 ~ N(0, 1) (T, mel),
  drawn from ``make_generator(seed)`` through ``draw_normal``. Each step
  is one DiT forward at B = 2 (conditioned, unconditioned), the guided
  velocity v_c + cfg (v_c - v_u) and x += dt_k v, reading t_k and dt_k
  from the schedule's device arrays at its device step index; T is
  padded to a multiple of ``BUCKET`` with the padded frames masked, so
  on a card without a mesh the loop replays one captured step a bucket
  (``pipeline.graphs``). The cond frames are put back at the end and the
  generated frames [T_ref, T) go on.

Spans: the stages ``f5`` and ``vocos``, the leaves ``f5.cast``,
``f5.text``, ``f5.denoise_loop`` (counters ``steps``, ``frames``: the
padded T, and the graph counters), ``vocos.forward`` (``audio_s``) and
``download``; ``timings``: ``f5_s``, ``f5_loop_s``, ``vocos_s``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import ClassVar, List, Sequence

import numpy as np
import torch

from tortoise_tpu_torch.models import f5 as fmodel
from tortoise_tpu_torch.models import vocos as vmodel
from tortoise_tpu_torch.params import seeded_trees
from tortoise_tpu_torch.pipeline import common, graphs, vocos_stage
from tortoise_tpu_torch.pipeline.common import (
    cached_cast,
    download,
    resolve_device,
    round_up,
    substage,
)
from tortoise_tpu_torch.utils import profiling
from tortoise_tpu_torch.utils.profiling import span

# the loop's padded lengths are multiples of this many frames
BUCKET = 256
# reference plus generation, seconds, before a text is cut into chunks
CHUNK_SECONDS = 22.0
# the seeded weights' scale (``F5Models.random``): N(0, std) per tensor,
# the char embedding at ``text_emb_std``, norm weights centred at 1 and
# Vocos's layer scales at 1 / layers
WEIGHTS = {"std": 0.02, "text_emb_std": 1.0, "vocos_std": 0.02}
NORM_WEIGHTS = ("ln_w", "norm_w", "final_w")


@dataclasses.dataclass
class F5Voice:
    """A reference clip: its log-mel (T_ref, n_mel) and its transcript's
    char ids."""
    mel: np.ndarray
    text: List[int]


def random_params(cfg: fmodel.F5Config, vcfg: vmodel.VocosConfig,
                  weights: dict, seed: int, device) -> tuple:
    """(DiT tree, Vocos tree) of f32 tensors on ``device`` from ``seed``:
    one generator, one flat N(0, 1) draw a model, carved in the trees'
    order (``param_shapes``) and scaled by ``weights`` (``WEIGHTS``'s
    keys)."""
    def leaf(path):
        return path.rsplit("/", 1)[-1]

    return tuple(seeded_trees((
        (fmodel.param_shapes(cfg),
         lambda n: (weights["text_emb_std"] if leaf(n) == "emb"
                    else weights["std"]),
         lambda n: 1.0 if n.endswith(NORM_WEIGHTS) else 0.0),
        (vmodel.param_shapes(vcfg), lambda n: weights["vocos_std"],
         lambda n: (1.0 if n.endswith(NORM_WEIGHTS) else
                    1.0 / vcfg.layers if leaf(n) == "gamma" else 0.0))),
        seed, device))


@dataclasses.dataclass
class F5Models:
    """F5-TTS v1 Base and its Vocos: f32 weight trees (tensors or
    arrays, ``param_shapes`` layouts) and their configurations."""
    params: dict
    vocos_params: dict
    cfg: fmodel.F5Config = fmodel.F5Config()
    vocos_cfg: vmodel.VocosConfig = vmodel.VocosConfig()
    family: ClassVar[str] = "f5"

    @classmethod
    def random(cls, seed: int = 0, tiny: bool = False,
               device="cpu") -> "F5Models":
        """Seeded weights drawn on ``device`` (``random_params`` at
        ``WEIGHTS``)."""
        cfg = fmodel.tiny_f5_config() if tiny else fmodel.F5Config()
        vcfg = vmodel.tiny_vocos_config() if tiny else vmodel.VocosConfig()
        p, v = random_params(cfg, vcfg, WEIGHTS, seed, torch.device(device))
        return cls(p, v, cfg, vcfg)


def frames(ref_frames: int, ref_len: int, gen_len: int,
           max_frames: int = 4096) -> int:
    """utils_infer's duration: T_ref + int(T_ref / len(ref) * len(gen)),
    at least one frame past the whole text and the reference (cfm.py), at
    most ``max_frames``."""
    t = ref_frames + int(ref_frames / ref_len * gen_len)
    return min(max(t, max(ref_len + gen_len, ref_frames) + 1), max_frames)


def chunk_texts(gen: Sequence[int], ref_frames: int, ref_len: int,
                vcfg: vmodel.VocosConfig) -> List[list]:
    """``gen`` cut into nearly equal chunks of at most utils_infer's
    ``max_chars`` = len(ref) / ref_s * (22 - ref_s) chars each (the ids
    carry no sentence marks to cut at), so that reference plus chunk
    stays under ~22 s."""
    ref_s = ref_frames * vcfg.hop / vcfg.sample_rate
    max_chars = int(ref_len / ref_s * (CHUNK_SECONDS - ref_s))
    gen = list(gen)
    if max_chars <= 0 or len(gen) <= max_chars:
        return [gen]
    n = -(-len(gen) // max_chars)
    cuts = [round(i * len(gen) / n) for i in range(n + 1)]
    return [gen[a:b] for a, b in zip(cuts, cuts[1:])]


def padded_frames(t: int) -> int:
    """The loop's padded length of a T-frame request."""
    return round_up(t, BUCKET)


def draw_normal(generator, shape, device) -> torch.Tensor:
    """f32 standard-normal noise (the loop's y0)."""
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def _prepare(params, cfg, compute_dtype, device):
    return cached_cast(
        params, ("f5", str(compute_dtype)),
        lambda p: fmodel.prepare(common.ensure_device(p, device), cfg,
                                 compute_dtype), device)


@functools.cache
def _schedule(nfe: int, sway: float, device) -> tuple:
    # read by address by the captured steps: never dropped
    return fmodel.schedule(nfe, sway, device)


def _flow_step(prep, cfg, sched, compute_dtype, bufs) -> None:
    """One Euler step on ``bufs`` in place: the B = 2 DiT forward at t_k,
    the guided velocity (padded frames zeroed) into ``v``, x += dt_k v;
    then k counts up. The unit a step graph holds."""
    k, x, fm = bufs["k"], bufs["x"], bufs["frame_mask"]
    v2 = fmodel.velocity(prep, cfg, x, bufs["cond_text"], sched[0][k], fm,
                         bufs["kv_valid"], bufs["mask_add"], compute_dtype)
    v = fmodel.guided(v2, cfg.cfg_strength)
    if fm is not None:
        v = torch.where(fm, v, 0.0)
    bufs["v"].copy_(v)
    x.add_(sched[1][k] * v)
    k.add_(1)


def _loop(prep, cfg, x, inputs: dict, n_frames: int, compute_dtype,
          probe_steps=(), progress=None):
    """The ``nfe`` steps from x (1, T_pad, mel); returns the final state
    and the probes: the states and guided velocities of ``probe_steps``,
    each (k, n_frames, mel) on the device (None without probes)."""
    sched = _schedule(cfg.nfe, cfg.sway, x.device)
    rope = fmodel.rope_table(x.shape[1], cfg.d_head, x.device)

    def make_bufs(static):
        bufs = {k: None if v is None else torch.empty_like(v)
                for k, v in inputs.items()} if static else dict(inputs)
        bufs["x"] = torch.empty_like(x)
        bufs["v"] = torch.empty_like(x)
        bufs["k"] = torch.zeros((1,), dtype=torch.long, device=x.device)
        return bufs

    step = functools.partial(_flow_step, prep, cfg, sched, compute_dtype)
    ct = inputs["cond_text"]
    key = ("f5", cfg, str(compute_dtype), tuple(x.shape), tuple(ct.shape),
           ct.dtype, inputs["frame_mask"] is None)
    xs, vs = [], []
    with graphs.stepping(graphs.use_graphs(x.device), key,
                         prep, make_bufs, step, keep=(sched, rope)) \
            as (bufs, run):
        for k, v in inputs.items():
            if v is not None and bufs[k] is not v:
                bufs[k].copy_(v)
        bufs["x"].copy_(x)
        bufs["k"].zero_()
        for i in range(cfg.nfe):
            if i in probe_steps:
                xs.append(bufs["x"][0, :n_frames].clone())
            run()
            if i in probe_steps:
                vs.append(bufs["v"][0, :n_frames].clone())
            if progress is not None:
                progress((i + 1) / cfg.nfe)
        probes = None if not xs else {"steps": sorted(probe_steps),
                                      "x": torch.stack(xs),
                                      "v": torch.stack(vs)}
        return bufs["x"].clone(), probes


def generate(prep, cfg: fmodel.F5Config, ref_mel, ref_ids, gen_ids,
             seed: int, compute_dtype=None, device=None, timings=None,
             probe_steps=(), progress=None):
    """One chunk: (1, n_gen, mel) generated log-mel on the device, and the
    loop's probes. ``timings`` (stage-synced) receives ``f5_loop_s``,
    added over chunks."""
    ref_frames = ref_mel.shape[0]
    ids = list(ref_ids) + list(gen_ids)
    t = frames(ref_frames, len(ref_ids), len(gen_ids), cfg.max_frames)
    tp = padded_frames(t)
    dt = compute_dtype or torch.float32
    with profiling.span("f5.text", device):
        text_len = min(len(ids), t)
        idx = torch.zeros(tp, dtype=torch.long)
        idx[:text_len] = torch.as_tensor(ids[:text_len]) + 1
        idx = idx.to(device)
        valid = torch.arange(tp, device=device) < t
        fm = None if t == tp else valid[None, :, None]
        text = fmodel.text_embed(prep, cfg, idx, text_len, fm, compute_dtype)
        cond = torch.zeros((2, tp, cfg.mel_dim), device=device)
        cond[0, :ref_frames] = torch.as_tensor(ref_mel, device=device)
        inputs = {"cond_text": torch.cat([cond, text], dim=-1).to(dt),
                  "frame_mask": fm,
                  "kv_valid": None if fm is None else valid.expand(2, tp),
                  "mask_add": None if fm is None else torch.where(
                      valid, 0.0, fmodel.NEG_INF).expand(2, tp).contiguous()}
    loop_t = {}
    with substage("f5.denoise_loop", None if timings is None else loop_t,
                  "s", device) as sp:
        sp.add("steps", cfg.nfe)
        sp.add("frames", tp)
        gen = common.make_generator(seed, device)
        x = torch.zeros((1, tp, cfg.mel_dim), device=device)
        x[0, :t] = draw_normal(gen, (t, cfg.mel_dim), device)
        x, probes = _loop(prep, cfg, x, inputs, t, compute_dtype,
                          tuple(probe_steps), progress)
        out = x[:, ref_frames:t]
    if timings is not None:
        timings["f5_loop_s"] = timings.get("f5_loop_s", 0.0) + loop_t["s"]
    return out, probes


@torch.inference_mode()
def synthesize(models: F5Models, tokens: Sequence[int], voice: F5Voice,
               seed: int = 0, compute_dtype=None, progress=None,
               stage_sync: bool = True, materialize: bool = True,
               device=None, probe_steps: Sequence[int] = ()):
    """Speak ``tokens`` (char ids) in the voice of ``voice``: a
    ``SynthesisResult`` whose ``mel`` is the generated log-mel (mel,
    n_gen) (None without ``materialize``) and whose ``probes`` hold the
    first chunk's loop states and guided velocities at ``probe_steps``
    (device tensors; the benchmark's check). Chunk i is seeded by
    ``seed + i``."""
    from tortoise_tpu_torch.pipeline.synthesize import SynthesisResult

    device = resolve_device(device)
    if voice is None or not isinstance(voice, F5Voice):
        raise ValueError("F5-TTS takes an F5Voice (reference log-mel and "
                         "its transcript's char ids) as its voice")
    if tokens is None:
        raise ValueError("F5-TTS takes char ids (tokens); it has no "
                         "tokenizer")
    cfg, vcfg = models.cfg, models.vocos_cfg
    ref_mel = np.asarray(voice.mel, np.float32)
    ref_ids = list(voice.text)
    timings = {}
    st = timings if stage_sync else None
    with span("synthesize", device):
        with span("f5") as stage:
            with span("f5.cast", device):
                prep = _prepare(models.params, cfg, compute_dtype, device)
            mels, probes = [], None
            for i, chunk in enumerate(chunk_texts(tokens, ref_mel.shape[0],
                                                  len(ref_ids), vcfg)):
                mel, pr = generate(prep, cfg, ref_mel, ref_ids, chunk,
                                   seed + i, compute_dtype, device, st,
                                   probe_steps if i == 0 else (), progress)
                mels.append(mel)
                probes = probes or pr
        timings["f5_s"] = stage.s
        with span("vocos") as stage:
            audio = torch.cat([vocos_stage.vocos(
                models.vocos_params, m.transpose(1, 2), vcfg, device)[0]
                for m in mels])
            mel = torch.cat(mels, dim=1)[0].T
            if materialize:
                audio, mel = download(audio, mel)
            else:
                (audio,), mel = download(audio), None
        timings["vocos_s"] = stage.s
    return SynthesisResult(audio=audio, sample_rate=vcfg.sample_rate,
                           mel=mel, sequences=[], latents=[],
                           tokens=list(tokens), timings=timings,
                           probes=probes)
