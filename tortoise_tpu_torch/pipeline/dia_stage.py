"""The Dia family's synthesis: dialogue bytes and an audio prompt ->
DAC codes sampled under the delay pattern with CFG (``models.dia``) ->
44.1 kHz audio (``pipeline.dac_stage``). ``pipeline.synthesize
.synthesize`` hands a ``DiaModels`` bundle here, so the CLI reaches it
through its usual entry.

A request (transformers' ``DiaProcessor`` and ``DiaGenerationMixin``,
nari-labs/dia ``dia/model.py``): the prompt's codes (P frames of
``channels`` codebooks) and its transcript's bytes (``DiaVoice``), and
the bytes to speak (``tokens``, or a message through ``dia.tokenize``).

- ``dia.text``: the encoder over transcript + text, once for both CFG
  rows (the unconditioned row all zero bytes under the conditioned row's
  mask), padded to a multiple of ``TEXT_BUCKET`` bytes with the padded
  keys masked; then every layer's cross K/V.
- ``dia.prefill``: the prompt delayed (``delay_grid``: channel c's frame
  t at position t + 1 + delay[c], BOS before, PAD after) and run through
  the decoder, causal, over positions [0, P), filling the K/V cache.
- ``dia.decode_loop``: one step a position from P on: the decoder at the
  step's position (read on the device: ``p0 + s``) over the cache, then
  ``sample_codes`` (CFG, the channel masks, top-p, the EOS countdown)
  draws the next position's 9 codes from uniforms drawn once a request;
  the delayed prompt's codes replace the draws where the grid still
  holds them. ``min_frames`` masks EOS on channel 0 before that frame,
  ``max_frames`` forces it there; after channel 0's EOS at step e,
  channel c takes EOS at e + delay[c] and PAD after, and the loop ends
  after step e + max(delay). The cache is padded to a multiple of
  ``CACHE_BUCKET`` positions (at most the decoder's), so on a card
  without a mesh the loop
  replays one captured step a (text bucket, cache bucket) key
  (``pipeline.graphs``). The host reads the stop flag every
  ``STOP_CHECK_STEPS`` steps once an end is possible.
- ``dac``: the generated frames, delay reverted (``revert``), through
  the DAC decoder.

Spans: the stages ``dia`` and ``dac``, the leaves ``dia.cast``,
``dia.text``, ``dia.prefill``, ``dia.decode_loop`` (counters ``steps``,
``frames``: the cache bucket, ``text_len``: the padded text, ``prompt``
and ``text``: the prompt's frames and the text's bytes, and the graph
counters), ``dac.cast``, ``dac.forward`` (``audio_s``) and
``download``;
``timings``: ``dia_s``, ``dia_loop_s``, ``dac_s``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import ClassVar, List, Optional, Sequence

import numpy as np
import torch

from tortoise_tpu_torch.models import dac as dmodel
from tortoise_tpu_torch.models import dia as model
from tortoise_tpu_torch.ops.sampling import top_p_filter
from tortoise_tpu_torch.params import seeded_trees
from tortoise_tpu_torch.pipeline import common, dac_stage, graphs
from tortoise_tpu_torch.pipeline.common import (
    cached_cast,
    download,
    resolve_device,
    round_up,
    substage,
)
from tortoise_tpu_torch.utils.profiling import span

# the encoder's padded lengths are multiples of this many bytes
TEXT_BUCKET = 128
# the K/V cache's padded lengths are multiples of this many positions, at
# most the decoder's: kernel D2 reads a cache's every position, so a
# bucket this wide gives every request of a length up to it the same
# step (its cost no longer follows the prompt a text happens to follow)
CACHE_BUCKET = 2048
# the host reads the loop's stop flag every this many steps
STOP_CHECK_STEPS = 8
# the seeded weights' scale (``DiaModels.random``): N(0, std) per tensor,
# the query projections at std / sqrt(head width), norm weights centred
# at 1; the DAC's convolutions N(0, dac_std), its codebooks N(0,
# codebook_std), Snake's alphas centred at 1
WEIGHTS = {"std": 0.02, "dac_std": 0.02, "codebook_std": 1.0}


@dataclasses.dataclass
class DiaVoice:
    """An audio prompt: its codes (P, channels), P >= 0, and its
    transcript's bytes."""
    codes: np.ndarray
    text: List[int]


def random_params(cfg: model.DiaConfig, dcfg: dmodel.DacConfig,
                  weights: dict, seed: int, device) -> tuple:
    """(Dia tree, DAC tree) of f32 tensors on ``device`` from ``seed``:
    one generator, one flat N(0, 1) draw a model, carved in the trees'
    order (``param_shapes``) and scaled by ``weights`` (``WEIGHTS``'s
    keys)."""
    q_width = {"encoder/q": cfg.enc_head_dim, "decoder/q": cfg.dec_head_dim,
               "decoder/ca_q": cfg.cross_head_dim}
    return tuple(seeded_trees((
        (model.param_shapes(cfg),
         lambda n: weights["std"] / math.sqrt(q_width.get(n, 1)),
         lambda n: 1.0 if n.endswith("norm") else 0.0),
        (dmodel.param_shapes(dcfg),
         lambda n: (weights["codebook_std"] if n == "codebook"
                    else weights["dac_std"]),
         lambda n: (1.0 if n.rsplit("/", 1)[-1].startswith("alpha")
                    else 0.0))), seed, device))


@dataclasses.dataclass
class DiaModels:
    """Dia-1.6B and its DAC decoder: f32 weight trees (``param_shapes``
    layouts) and their configurations."""
    params: dict
    dac_params: dict
    cfg: model.DiaConfig = model.DiaConfig()
    dac_cfg: dmodel.DacConfig = dmodel.DacConfig()
    family: ClassVar[str] = "dia"

    @classmethod
    def random(cls, seed: int = 0, tiny: bool = False,
               device="cpu") -> "DiaModels":
        """Seeded weights drawn on ``device`` (``random_params`` at
        ``WEIGHTS``)."""
        cfg = model.tiny_dia_config() if tiny else model.DiaConfig()
        dcfg = dmodel.tiny_dac_config() if tiny else dmodel.DacConfig()
        p, d = random_params(cfg, dcfg, WEIGHTS, seed, torch.device(device))
        return cls(p, d, cfg, dcfg)


def delay_grid(codes, cfg: model.DiaConfig) -> np.ndarray:
    """The prompt's delayed decoder grid (1 + P + max delay, channels):
    position t of channel c holds U[t - delay[c]] of U = [BOS, frames...],
    BOS where that index is negative and PAD past the frames
    (``DiaProcessor.apply_audio_delay``)."""
    codes = np.asarray(codes, np.int64).reshape(-1, cfg.channels)
    p = codes.shape[0]
    u = np.concatenate([np.full((1, cfg.channels), cfg.bos), codes])
    n = 1 + p + cfg.max_delay
    out = np.empty((n, cfg.channels), np.int64)
    for c, d in enumerate(cfg.delay):
        j = np.arange(n) - d
        out[:, c] = np.where(j < 0, cfg.bos,
                             u[np.clip(j, 0, p), c])
        out[j > p, c] = cfg.pad
    return out


def revert(steps, cfg: model.DiaConfig, frames: int):
    """The first ``frames`` frames of each channel from the loop's codes
    (S, channels): channel c's frame g was drawn at step g + delay[c].
    Returns (channels, frames)."""
    return torch.stack([steps[d:d + frames, c]
                        for c, d in enumerate(cfg.delay)])


def text_length(n: int) -> int:
    """The encoder's padded length of ``n`` bytes."""
    return round_up(max(n, 1), TEXT_BUCKET)


def cache_length(prompt: int, max_frames: int, cfg: model.DiaConfig) -> int:
    """The K/V cache's padded length: the prompt's ``prompt`` positions,
    at most ``max_frames`` + max delay + 1 steps, and the one a step past
    the end writes, in ``CACHE_BUCKET``s, at most the decoder's
    positions."""
    return min(round_up(prompt + max_frames + cfg.max_delay + 2,
                        CACHE_BUCKET), cfg.max_positions)


def guide(cfg: model.DiaConfig, logits, s, eos_at, min_frames, max_frames):
    """One step's scores (channels, vocab) f32 from both rows' logits (2,
    channels, vocab) at the (1,) step ``s``, with the (1,) EOS step
    ``eos_at`` (-1 before channel 0's EOS); returns (scores, eos_at).

    In transformers' order: CFG (cond + scale (cond - uncond)) picks the
    top ``guidance_top_k`` and keeps the *cond* logits there; EOS masked
    before ``min_frames``; temperature; the channel filter (only channel
    0 may emit EOS, none may emit a code past it; EOS is channel 0's only
    candidate where it leads, else it is masked); top-p (kept mass
    ``top_p``); the EOS countdown (EOS starts where channel 0 leads with
    it, or at ``max_frames``; channel c is forced to EOS at eos_at +
    delay[c])."""
    v, eos = cfg.vocab, cfg.eos
    cond, uncond = logits[0], logits[1]
    guided = cond + (cond - uncond) * cfg.guidance
    top = guided.topk(cfg.guidance_top_k, dim=-1).indices
    keep = torch.zeros_like(guided, dtype=torch.bool).scatter(-1, top, True)
    x = cond.masked_fill(~keep, -math.inf)
    col = torch.arange(v, device=x.device)
    is_eos = col == eos
    x = torch.where(is_eos & (s < min_frames), -math.inf, x)
    x = x / cfg.temperature
    ch0 = (torch.arange(cfg.channels, device=x.device) == 0)[:, None]
    x = torch.where(torch.where(ch0, col > eos, col >= eos), -math.inf, x)
    lead = (x.argmax(-1) == eos)[:, None]
    x = torch.where((lead & (col < eos)) | (~lead & is_eos), -math.inf, x)
    x = top_p_filter(x, 1.0 - cfg.top_p)
    start = (eos_at < 0) & ((x[0].argmax() == eos) | (s == max_frames))
    eos_at = torch.where(start, s, eos_at)
    since = torch.where(eos_at >= 0, s - eos_at, -1)
    force = (since == _delays(cfg.delay, x.device))[:, None]
    return torch.where(force, torch.where(is_eos, 0.0, -math.inf), x), eos_at


def draw(scores, u):
    """Inverse-CDF draws (channels,) long from scores (channels, vocab)
    against uniforms ``u`` (channels,): the first code whose cumulative
    probability passes u times the total (never a code of probability
    0)."""
    cum = torch.softmax(scores, dim=-1).cumsum(-1)
    return (cum <= u[:, None] * cum[:, -1:]).sum(-1).clamp(
        max=scores.shape[-1] - 1)


def sample_codes(cfg: model.DiaConfig, logits, s, eos_at, min_frames,
                 max_frames, u, forced):
    """One step's codes (channels,) long and the new ``eos_at``:
    ``guide`` then ``draw``; a channel past its EOS takes PAD, and
    ``forced`` (channels,; -1 for none) the delayed prompt's codes."""
    scores, eos_at = guide(cfg, logits, s, eos_at, min_frames, max_frames)
    codes = draw(scores, u)
    since = torch.where(eos_at >= 0, s - eos_at, -1)
    codes = torch.where(since > _delays(cfg.delay, codes.device), cfg.pad,
                        codes)
    return torch.where(forced >= 0, forced, codes), eos_at


@functools.cache
def _delays(delay: tuple, device) -> torch.Tensor:
    # read by address by the captured steps: never dropped
    return torch.tensor(delay, device=device)


def _buffers(cfg: model.DiaConfig, dt, text_len: int, cache_len: int,
             device) -> dict:
    """A loop's state at a (text bucket, cache bucket): the step's inputs,
    counters and caches, all updated in place by ``_decode_step``."""
    nd, c = cfg.dec_layers, cfg.channels

    def longs(*shape, fill=0):
        return torch.full(shape, fill, dtype=torch.long, device=device)

    return {
        "tok": longs(1, c), "s": longs(1), "p0": longs(1),
        "eos_at": longs(1, fill=-1), "min_frames": longs(1),
        "max_frames": longs(1),
        "done": torch.zeros(1, dtype=torch.bool, device=device),
        "u": torch.zeros(cache_len, c, device=device),
        "forced": longs(max(cfg.max_delay, 1), c, fill=-1),
        "out": longs(cache_len, c),
        "text_mask": torch.zeros(2, text_len, device=device),
        "logits": torch.zeros(2, c, cfg.vocab, device=device),
        "cache_k": torch.zeros(nd, 2, cfg.dec_kv_heads, cache_len,
                               cfg.dec_head_dim, dtype=dt, device=device),
        "cache_v": torch.zeros(nd, 2, cfg.dec_kv_heads, cache_len,
                               cfg.dec_head_dim, dtype=dt, device=device),
        "cross_k": torch.zeros(nd, 2, cfg.cross_heads, text_len,
                               cfg.cross_head_dim, dtype=dt, device=device),
        "cross_v": torch.zeros(nd, 2, cfg.cross_heads, text_len,
                               cfg.cross_head_dim, dtype=dt, device=device),
    }


def _decode_step(prep, cfg: model.DiaConfig, compute_dtype, bufs) -> None:
    """One step on ``bufs`` in place: the decoder at position p0 + s, the
    codes of the next position (``sample_codes``) into ``tok`` and
    ``out[s]``; s counts up until the loop is done, after which a step
    changes nothing the loop returns. The unit a step graph holds."""
    s, tok = bufs["s"], bufs["tok"]
    pos = bufs["p0"] + s
    tc = bufs["cache_k"].shape[3]
    self_mask = model.key_mask(
        torch.arange(tc, device=s.device).expand(2, tc) <= pos)
    logits = model.decode_step(prep, cfg, tok, pos, bufs["cache_k"],
                               bufs["cache_v"], bufs["cross_k"],
                               bufs["cross_v"], self_mask, bufs["text_mask"],
                               compute_dtype)
    bufs["logits"].copy_(logits)
    nf = bufs["forced"].shape[0]
    forced = bufs["forced"][s.clamp(max=nf - 1)][0]
    forced = torch.where(s < nf, forced, -1)
    codes, eos_at = sample_codes(cfg, logits, s, bufs["eos_at"],
                                 bufs["min_frames"], bufs["max_frames"],
                                 bufs["u"][s][0], forced)
    live = ~bufs["done"]
    row = bufs["out"].index_select(0, s)
    bufs["out"].index_copy_(0, s, torch.where(live, codes[None], row))
    tok.copy_(torch.where(live, codes[None], tok))
    bufs["eos_at"].copy_(eos_at)
    s.add_(live.long())
    bufs["done"].copy_((eos_at >= 0) & (s > eos_at + cfg.max_delay))


def _prepare(params, cfg, compute_dtype, device):
    return cached_cast(
        params, ("dia", str(compute_dtype)),
        lambda p: model.prepare(common.ensure_device(p, device), cfg,
                                compute_dtype), device)


def draw_uniform(generator, shape, device) -> torch.Tensor:
    """A request's f32 uniforms in [0, 1), one a step and channel."""
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def generate(prep, cfg: model.DiaConfig, prompt, text_ids, seed: int,
             min_frames: int = 0, max_frames: Optional[int] = None,
             compute_dtype=None, device=None, timings=None, probe_steps=(),
             progress=None):
    """One request's codes: (channels, frames) long on the device (the
    generated frames, delay reverted) and the probes (with
    ``probe_steps``: the raw logits of both rows at those steps, and the
    decoder's input grid; else None). ``timings`` (stage-synced) receives
    ``dia_loop_s``."""
    dt = compute_dtype or torch.float32
    grid = delay_grid(prompt, cfg)
    p = grid.shape[0] - cfg.max_delay - 1
    if max_frames is None:
        max_frames = cfg.max_positions - p - cfg.max_delay - 2
    if not 0 <= min_frames <= max_frames:
        raise ValueError(f"want 0 <= min_frames <= max_frames, got "
                         f"{min_frames} and {max_frames}")
    tt = text_length(len(text_ids))
    need = p + max_frames + cfg.max_delay + 2
    if need > cfg.max_positions:
        raise ValueError(f"a prompt of {p} frames and up to {max_frames} "
                         f"more need {need} positions, past the decoder's "
                         f"{cfg.max_positions}")
    tc = cache_length(p, max_frames, cfg)
    graphed = graphs.use_graphs(device)
    step = functools.partial(_decode_step, prep, cfg, compute_dtype)
    if graphed:
        key = ("dia", cfg, str(compute_dtype), tt, tc)
        graph = graphs.cached(key, prep, lambda: graphs.StepGraph(
            _buffers(cfg, dt, tt, tc, device), step))
        bufs, run, lock = graph.bufs, graph, graph.lock
    else:
        graph = None
        bufs = _buffers(cfg, dt, tt, tc, device)
        run, lock = functools.partial(step, bufs), contextlib.nullcontext()
    with lock:
        with span("dia.text", device):
            n = len(text_ids)
            ids = torch.zeros(tt, dtype=torch.long)
            ids[:n] = torch.as_tensor(list(text_ids), dtype=torch.long)
            ids = ids.to(device)
            valid = (torch.arange(tt, device=device) < n).expand(2, tt)
            enc = model.encode(prep, cfg, torch.stack(
                [ids, torch.zeros_like(ids)]), valid, compute_dtype)
            ck, cv = model.cross_kv(prep, cfg, enc, compute_dtype)
            bufs["cross_k"].copy_(ck)
            bufs["cross_v"].copy_(cv)
            bufs["text_mask"].copy_(model.key_mask(valid))
            del enc, ck, cv
        with span("dia.prefill", device):
            g = torch.as_tensor(grid, device=device)
            if p:
                model.prefill(prep, cfg, g[:p], bufs["cache_k"],
                              bufs["cache_v"], bufs["cross_k"],
                              bufs["cross_v"], bufs["text_mask"],
                              compute_dtype)
            forced = g[p + 1:p + 1 + cfg.max_delay]
            bufs["forced"].fill_(-1)
            bufs["forced"][:forced.shape[0]].copy_(
                torch.where(forced == cfg.pad, -1, forced))
            bufs["tok"].copy_(g[p:p + 1])
            for name, value in (("s", 0), ("p0", p), ("eos_at", -1),
                                ("min_frames", min_frames),
                                ("max_frames", max_frames)):
                bufs[name].fill_(value)
            bufs["done"].fill_(False)
            gen = common.make_generator(seed, device)
            bufs["u"].copy_(draw_uniform(gen, tuple(bufs["u"].shape),
                                         device))
        loop_t = {}
        with substage("dia.decode_loop", None if timings is None else loop_t,
                      "s", device) as sp:
            before = (0, 0, 0) if graph is None else (
                graph.warmups, graph.captures, graph.replays)
            earliest = min_frames + cfg.max_delay + 1
            cap = max_frames + cfg.max_delay + 1
            logits, steps = [], 0
            for i in range(cap):
                run()
                steps += 1
                if i in probe_steps:
                    logits.append(bufs["logits"].clone())
                if progress is not None:
                    progress(min(1.0, (i + 1) / earliest))
                if i + 1 >= earliest and \
                        (i + 1 - earliest) % STOP_CHECK_STEPS == 0 and \
                        bool(bufs["done"]):
                    break
            sp.add("steps", steps)
            sp.add("frames", tc)
            sp.add("text_len", tt)
            sp.add("prompt", p)
            sp.add("text", len(text_ids))
            if graph is not None:
                for name, n0, n1 in zip(
                        ("graph_warmups", "graph_captures",
                         "graph_replays"), before,
                        (graph.warmups, graph.captures, graph.replays)):
                    sp.add(name, n1 - n0)
            s_end, eos_at = (int(x) for x in torch.cat(
                [bufs["s"], bufs["eos_at"]]).tolist())
            codes = revert(bufs["out"][:s_end], cfg, eos_at)
            probes = None
            if probe_steps:
                probes = {"steps": [i for i in sorted(probe_steps)
                                    if i < steps],
                          "logits": torch.stack(logits) if logits else None,
                          "grid": torch.cat([g[:p + 1],
                                             bufs["out"][:s_end - 1]])}
    if timings is not None:
        timings["dia_loop_s"] = timings.get("dia_loop_s", 0.0) + loop_t["s"]
    return codes, probes


def _text_ids(tokens, message, voice) -> list:
    if tokens is None:
        if message is None:
            raise ValueError("Dia takes bytes (tokens) or a message")
        tokens = model.tokenize(message)
    return list(voice.text) + list(tokens)


@torch.inference_mode()
def synthesize(models: DiaModels, tokens: Optional[Sequence[int]] = None,
               voice: Optional[DiaVoice] = None, seed: int = 0,
               compute_dtype=None, progress=None, stage_sync: bool = True,
               materialize: bool = True, device=None,
               probe_steps: Sequence[int] = (), message: Optional[str] = None,
               min_frames: int = 0, max_frames: Optional[int] = None):
    """Speak ``tokens`` (bytes; or ``message`` through ``dia.tokenize``)
    after the prompt ``voice`` (a ``DiaVoice``; None for no prompt): a
    ``SynthesisResult`` at 44.1 kHz whose ``codes`` are the generated
    frames (channels, frames) and whose ``probes`` hold the raw logits at
    ``probe_steps`` and the decoder's input grid (device tensors; the
    benchmark's check). ``min_frames`` / ``max_frames`` bound the frames
    before channel 0's EOS."""
    from tortoise_tpu_torch.pipeline.synthesize import SynthesisResult

    device = resolve_device(device)
    cfg, dcfg = models.cfg, models.dac_cfg
    if voice is None:
        voice = DiaVoice(np.zeros((0, cfg.channels), np.int64), [])
    if not isinstance(voice, DiaVoice):
        raise ValueError("Dia takes a DiaVoice (prompt codes and its "
                         "transcript's bytes) as its voice")
    text = _text_ids(tokens, message, voice)
    timings = {}
    st = timings if stage_sync else None
    with span("synthesize", device):
        with span("dia") as stage:
            with span("dia.cast", device):
                prep = _prepare(models.params, cfg, compute_dtype, device)
            codes, probes = generate(prep, cfg, voice.codes, text, seed,
                                     min_frames, max_frames, compute_dtype,
                                     device, st, tuple(probe_steps),
                                     progress)
        timings["dia_s"] = stage.s
        with span("dac") as stage:
            audio = dac_stage.dac(models.dac_params, codes[None], dcfg,
                                  device)[0]
            if materialize:
                audio, codes_h = download(audio, codes)
                codes_h = codes_h.astype(np.int64)
            else:
                (audio,), codes_h = download(audio), None
        timings["dac_s"] = stage.s
    return SynthesisResult(audio=audio, sample_rate=dcfg.sample_rate,
                           mel=None, sequences=[], latents=[],
                           tokens=list(text), timings=timings,
                           probes=probes, codes=codes_h)
