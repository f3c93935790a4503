"""Streaming synthesis: first audio before the utterance finishes
(counterpart of ``tortoise_tpu/pipeline/streaming.py``).

After the AR stage the denoising loop runs over overlapping WINDOWS of
the mel timeline instead of the whole utterance, and the vocoder turns
each finalized mel span into audio at once. Same exactness contract as
the JAX package:

- The AR stage and the diffusion conditioner (latent conditioner and the
  upsampled code embedding) run globally, as in the batch path.
- Each window's denoising loop sees only its slice of the timeline, so
  attention across a window edge is cut: the mel approximates the
  global decode. Adjacent windows overlap by ``overlap_frames`` and
  crossfade linearly.
- Vocoding is exact for every emitted sample: each chunk is vocoded with
  ``vocoder_margin`` context frames on both sides and the edges are
  dropped.
- The initial mel noise and the vocoder noise are drawn ONCE over the
  full timeline and sliced, so window and chunk edges never change the
  noise a frame sees. The step noise of window i comes from its own
  generator (``window_generator``, the counterpart of
  ``fold_in(key, i)``); a single window continues the initial noise's
  generator, so it equals the global loop.

On a card with ``use_flash`` every window's attention runs kernel B at
the window's length (the defaults give 96 for the first window and 384
after it), and a vocoder with ``use_pallas_lvc`` runs kernel E on every
chunk.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Optional

import numpy as np
import torch

from tortoise_tpu.config import (
    MEL_PAD_VALUE,
    DiffusionConfig,
    VocoderConfig,
    mel_length_for_latents,
)
from tortoise_tpu_torch.models import diffusion as dmodel
from tortoise_tpu_torch.models import vocoder as vmodel
from tortoise_tpu_torch.pipeline import ar_stage, common
from tortoise_tpu_torch.pipeline import diffusion_stage as dst
from tortoise_tpu_torch.pipeline import vocoder_stage as vst
from tortoise_tpu_torch.pipeline.common import resolve_device, round_up


@dataclasses.dataclass
class StreamChunk:
    """One contiguous span of finalized audio."""

    audio: np.ndarray        # float32 samples
    start_sample: int        # absolute offset in the utterance
    final: bool              # True on the last chunk
    # wall seconds from stream start to this chunk being ready
    latency_s: float = 0.0


def window_generator(generator, i: int):
    """The step-noise generator of window i of a multi-window stream,
    derived from the stream's generator (the JAX package folds i into its
    key)."""
    seed = (generator.initial_seed() * 1_000_003 + i + 1) % (1 << 63)
    return common.make_generator(seed, generator.device)


def _check_geometry(window_frames, overlap_frames, first_window_frames):
    w, ov = int(window_frames), int(overlap_frames)
    if w <= 0 or ov < 0 or ov >= w:
        raise ValueError(f"need window_frames > overlap_frames >= 0, got "
                         f"{window_frames}/{overlap_frames}")
    # the RAW value is checked (first_window_frames=0 is rejected, not
    # read as "unset"); clamping to the timeline comes later
    if first_window_frames is not None and int(first_window_frames) <= ov:
        raise ValueError(f"first_window_frames={first_window_frames} must "
                         f"exceed overlap_frames={ov}")
    return w, ov


def _denoise_window(params, cfg, sched, code_emb2, noise_w, buckets_w,
                    mask_w, generator, variance_swap, compute_dtype):
    """The full n-step loop over one window (1, n_mel, wp)."""
    shape, dev = tuple(noise_w.shape), noise_w.device
    return dst._denoise_loop(
        params, cfg, sched, code_emb2, noise_w, buckets_w, mask_w,
        lambda: dst.draw_normal(generator, shape, dev), compute_dtype,
        variance_swap)


@torch.inference_mode()
def stream_mel_windows(params, cfg: DiffusionConfig, latents_dev, keep_len,
                       seed: int, window_frames: int, overlap_frames: int,
                       compute_dtype=None, int8_weights: bool = False,
                       variance_swap: bool = True,
                       first_window_frames: Optional[int] = None,
                       device="cpu"):
    """Yield (start, end, mel_block (n_mel, end-start) np.f32) spans of
    FINALIZED normalized mel, in order, covering [0, out_len).

    latents_dev: (1, >=L, 1024) latents of one candidate; keep_len: its
    true latent count. Window i denoises [a_i, a_i + wp) and finalizes
    frames up to its emit edge minus the crossfade span; the crossfade
    region of two adjacent windows blends linearly.
    first_window_frames: an optional smaller FIRST window — first-audio
    latency is about the first window's loop, which scales with its
    width."""
    w, ov = _check_geometry(window_frames, overlap_frames,
                            first_window_frames)
    params = dst._prepare_params(params, int8_weights, device)
    lat_len = int(keep_len)
    out_len = mel_length_for_latents(lat_len)
    # out_pad as in the batch path, so the one global noise draw has the
    # one-shot decode's shape; no window exceeds it
    out_pad = round_up(out_len, dst.OUT_BUCKET)
    wp = min(w + ov, out_pad)

    lat_pad = round_up(lat_len, dst.LAT_BUCKET)
    lat_in = latents_dev.to(device).float()[:, :lat_pad]
    if lat_in.shape[1] < lat_pad:
        lat_in = torch.nn.functional.pad(
            lat_in, (0, 0, 0, lat_pad - lat_in.shape[1]))
    lat_mask, _ = dst._masks([lat_len], [out_len], lat_pad, out_pad, device)
    sched = dst.schedule_arrays(cfg, device)
    # the global conditioner, as in the batch path
    cond, uncond = dmodel.code_embeddings(
        params, cfg, lat_in, dst._buckets(lat_pad, cfg, device), out_pad,
        lat_len, out_len, lat_mask, compute_dtype)
    code_emb2 = torch.cat([cond, uncond], dim=0)        # (2, C, out_pad)

    # one global initial-noise draw, sliced per window
    gen = common.make_generator(seed, device)
    noise_full = dst.draw_normal(gen, (1, cfg.n_mel, out_pad), device)
    in_len = torch.arange(out_pad, device=device) < out_len
    noise_full = torch.where(in_len[None, None, :], noise_full, 0.0)

    mel_buf = np.zeros((cfg.n_mel, out_len), np.float32)
    ramp = (np.arange(1, ov + 1, dtype=np.float32) / (ov + 1))[None, :] \
        if ov else None
    # a short utterance may clamp w0 below ov; then w0 >= out_len and the
    # single window never crossfades
    w0 = min(w if first_window_frames is None else int(first_window_frames),
             out_pad)
    starts = [0] + list(range(w0, out_len, w))
    done_upto = 0
    for i, s in enumerate(starts):
        e = min((w0 if i == 0 else s + w), out_len)
        wp_i = w0 if i == 0 else wp
        a = max(0, min(s - ov, out_pad - wp_i)) if i else 0
        mask_np = np.arange(a, a + wp_i) < out_len
        mask_w = None if mask_np.all() else torch.as_tensor(
            mask_np[None, :], device=device)
        wgen = gen if len(starts) == 1 else window_generator(gen, i)
        x = _denoise_window(params, cfg, sched, code_emb2[:, :, a:a + wp_i],
                            noise_full[:, :, a:a + wp_i],
                            dst._buckets(wp_i, cfg, device), mask_w, wgen,
                            variance_swap, compute_dtype)
        mel_w = x[0].float().cpu().numpy()              # (n_mel, wp_i)
        lo = s - a                                      # emit offset
        new = mel_w[:, lo:lo + (e - s)]
        if i > 0 and ov:
            # the whole crossfade span exists: s >= w0 > ov for every later
            # window, and a <= s - ov, so mel_w covers [s - ov, s)
            prev = mel_buf[:, s - ov:s]
            cur = mel_w[:, lo - ov:lo]
            mel_buf[:, s - ov:s] = (1.0 - ramp) * prev + ramp * cur
        mel_buf[:, s:e] = new
        last = e >= out_len
        # frames the NEXT window still crossfades stay held
        final_upto = out_len if last else max(done_upto, e - ov)
        if final_upto > done_upto:
            yield (done_upto, final_upto,
                   mel_buf[:, done_upto:final_upto].copy())
            done_upto = final_upto


@torch.inference_mode()
def _vocode_chunk(vparams, vcfg, mel_in, noise, span, compute_dtype):
    return vmodel.vocoder_forward(vparams, vcfg, mel_in, noise, span,
                                  compute_dtype)[0].float().cpu().numpy()


def stream_audio_chunks(vparams, vcfg: VocoderConfig, mel_spans,
                        out_len: int, seed: int, margin: int = 32,
                        compute_dtype=None, device="cpu"
                        ) -> Iterator[StreamChunk]:
    """Consume (start, end, mel_block) spans and yield audio chunks.

    Each chunk vocodes its mel span plus ``margin`` finalized context
    frames on both sides and keeps only the interior samples, so every
    emitted sample equals the full pass's (the conv/LVC stack is local
    and shift-equivariant at the upsample stride). The right margin
    delays emission by ``margin`` frames. The vocoder noise is one global
    draw sliced per chunk."""
    m = int(margin)
    if m < 0:
        # a negative margin would slice past the finalized mel span
        raise ValueError(f"margin must be >= 0, got {margin}")
    vparams = vst.device_params(vparams, device)
    u = vcfg.total_upsample
    total = out_len + vcfg.mel_pad_frames
    # one bucket of slack: the last chunk's context slice starts at
    # ctxa > 0 and its rounded-up width can reach one bucket past
    # round_up(total)
    pad_total = round_up(total, vst.MEL_BUCKET) + vst.MEL_BUCKET
    noise_full = vst.draw_normal(common.make_generator(seed, device),
                                 (1, vcfg.noise_ch, pad_total), device)

    mel_buf = np.zeros((vcfg.n_mel, out_len), np.float32)
    emitted = 0       # mel frames whose audio has been yielded
    t0 = time.monotonic()
    for (s, e, block) in mel_spans:
        mel_buf[:, s:e] = block
        last = e >= out_len
        q = out_len if last else e - m      # emit audio for [emitted, q)
        if q <= emitted:
            continue
        p = emitted
        ctxa = max(0, p - m)
        ctxb = out_len if last else min(out_len, q + m)
        span = ctxb - ctxa + (vcfg.mel_pad_frames if last else 0)
        vw = round_up(span, vst.MEL_BUCKET)
        mel_in = np.zeros((1, vcfg.n_mel, vw), np.float32)
        mel_in[0, :, :ctxb - ctxa] = vst.denormalize_tacotron_mel(
            mel_buf[:, ctxa:ctxb])
        if last:
            mel_in[0, :, ctxb - ctxa:span] = MEL_PAD_VALUE
        audio = _vocode_chunk(vparams, vcfg,
                              torch.as_tensor(mel_in, device=device),
                              noise_full[:, :, ctxa:ctxa + vw], span,
                              compute_dtype)
        if last:
            chunk = audio[(p - ctxa) * u:span * u - 6]
        else:
            chunk = audio[(p - ctxa) * u:(q - ctxa) * u]
        yield StreamChunk(audio=chunk.astype(np.float32),
                          start_sample=p * u, final=last,
                          latency_s=time.monotonic() - t0)
        emitted = q
        if last:
            return


def stream_synthesize(models, message: Optional[str] = None,
                      tokens: Optional[List[int]] = None, voice=None,
                      seed: int = 0, compute_dtype=None,
                      int8_weights: bool = False, window_frames: int = 352,
                      overlap_frames: int = 32, vocoder_margin: int = 32,
                      first_window_frames: Optional[int] = None,
                      sampler_params=None, tokenizer_method: str = "greedy",
                      device=None) -> Iterator[StreamChunk]:
    """Full streaming pipeline on ``device``: yields StreamChunk objects
    in order; they concatenate (no gaps or overlaps) to the utterance, and
    the first one's ``latency_s`` is the time to first audio. Stage seeds
    are seed, seed+1, seed+2, as in synthesize().

    A plain function returning a generator, so the inputs and the window
    geometry are checked when it is called, before any device work."""
    from tortoise_tpu.io.voice import load_voice_latent

    _check_geometry(window_frames, overlap_frames, first_window_frames)
    if int(vocoder_margin) < 0:
        raise ValueError(
            f"vocoder_margin must be >= 0, got {vocoder_margin}")
    device = resolve_device(device)
    if tokens is None:
        if models.tokenizer is None:
            raise ValueError("no tokenizer available; pass tokens directly")
        tokens = models.tokenizer.encode_pipeline(message, tokenizer_method)
    if isinstance(voice, str):
        voice = load_voice_latent(voice, models.ar_cfg.d_model)
    if voice is None:
        raise ValueError("a voice latent (array or path) is required")
    return _stream_synthesize_gen(
        models, tokens, voice, seed, compute_dtype, int8_weights,
        window_frames, overlap_frames, vocoder_margin, first_window_frames,
        sampler_params, device)


def _stream_synthesize_gen(models, tokens, voice, seed, compute_dtype,
                           int8_weights, window_frames, overlap_frames,
                           vocoder_margin, first_window_frames,
                           sampler_params, device) -> Iterator[StreamChunk]:
    t0 = time.monotonic()
    lat_dev, keeps, _ = ar_stage.autoregressive(
        models.ar_params, tokens, voice, 1, models.ar_cfg, sampler="jax",
        seed=seed, compute_dtype=compute_dtype, int8_weights=int8_weights,
        return_device_latents=True, sampler_params=sampler_params,
        device=device)
    out_len = mel_length_for_latents(int(keeps[0]))
    spans = stream_mel_windows(
        models.diffusion_params, models.diffusion_cfg, lat_dev[0:1],
        keeps[0], seed + 1, window_frames, overlap_frames,
        compute_dtype=compute_dtype, int8_weights=int8_weights,
        first_window_frames=first_window_frames, device=device)
    for chunk in stream_audio_chunks(
            models.vocoder_params, models.vocoder_cfg, spans, out_len,
            seed + 2, margin=vocoder_margin, compute_dtype=compute_dtype,
            device=device):
        chunk.latency_s = time.monotonic() - t0
        yield chunk


def collect_stream(chunks) -> np.ndarray:
    """Concatenate a chunk iterator into the full utterance, checking that
    the chunks are contiguous."""
    parts = []
    n = 0
    for c in chunks:
        if c.start_sample != n:
            raise ValueError(f"chunk starts at {c.start_sample}, want {n}")
        parts.append(c.audio)
        n += len(c.audio)
    return np.concatenate(parts) if parts else np.zeros((0,), np.float32)
