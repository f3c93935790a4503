"""Stage 1 driver: sample speech tokens, then extract conditioning latents
(counterpart of ``tortoise_tpu/pipeline/ar_stage.py``).

Two sampler planes:

- ``sampler="jax"`` (the production plane's name in both packages): the
  whole loop stays on the device, drawing per-row uniforms from a
  ``torch.Generator`` seeded by ``seed``. On the bf16 + int8 plane each
  step is one call of kernel A with its in-kernel sampler (B <= 16,
  top_k <= 128). The uniforms are not jax.random's, so token streams
  differ from the JAX package's on this plane unless a test replays the
  JAX key chain through ``draw_uniform``.
- ``sampler="reference"``: host loop driven by the mt19937
  ``tortoise_tpu.rng.ReferenceRng``, reproducing the reference's seeded
  decision stream — the plane the port is held to token for token.

Sequence post-processing (apply_padding, trim_keep_lengths, trim_latents)
and the text-bucket rules are pure-Python copies of the JAX package's.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tortoise_tpu.config import ARConfig
from tortoise_tpu_torch.models import ar
from tortoise_tpu_torch.ops import sampling as S
from tortoise_tpu_torch.ops.basic import quantize_cols
from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline import common
from tortoise_tpu_torch.pipeline.common import cached_cast, sync

_MATMUL_WEIGHTS = ("attn_w", "proj_w", "fc_w", "fc_proj_w")
TEXT_BUCKETS = (32, 64, 128, 192, 256, 320, 404)


def _build_head_pack(params, lm_pair):
    """Lane-padded lm-head tensors for kernel A: the (D, V) int8 weight
    and scale padded to a 128-multiple Vp (8194 -> 8320) with zero
    columns, the bias padded with -1e30 so padded logits never win, norm
    params as (1, D) rows. Tensors in, tensors out, on their device."""
    wq, sc = lm_pair
    d, v = wq.shape
    pad = (0, ((v + 127) // 128) * 128 - v)

    def row(name):
        return params[name].float().reshape(1, d)

    return {
        "ln_f_w": row("ln_f_w"), "ln_f_b": row("ln_f_b"),
        "lm_ln_w": row("lm_ln_w"), "lm_ln_b": row("lm_ln_b"),
        "lm_wq": F.pad(wq, pad),
        "lm_sc": F.pad(sc.reshape(1, v), pad),
        "lm_b": F.pad(params["lm_b"].float().reshape(1, v), pad,
                      value=-1e30),
    }


def quantize_ar(params) -> dict:
    """int8-quantize the AR tensor tree's matmul weights on their device
    (same math and pairs as the JAX package's quantize_ar_host) and
    attach the kernel head pack. Pairs pass through."""
    def q(w):
        return tuple(w) if isinstance(w, (tuple, list)) else quantize_cols(w)

    blocks = dict(params["blocks"])
    for k in _MATMUL_WEIGHTS:
        blocks[k] = q(blocks[k])
    out = dict(params, blocks=blocks)
    lm = params["lm_w"]
    out["lm_w"] = tuple(lm) if isinstance(lm, (tuple, list)) \
        else quantize_cols(lm.T)
    hp = params.get("head_pack")
    out["head_pack"] = dict(hp) if hp is not None \
        else _build_head_pack(params, out["lm_w"])
    return out


def cast_matmul_weights(params, dtype, int8: bool = False, device="cpu"):
    """Device AR tree from the host numpy tree: the big matmul weights in
    the compute dtype, or as int8 pairs with the head pack (quantized on
    the device after an f32 upload), everything else f32. Memoized per
    (tree, device, dtype, int8): a second call returns the same tree."""
    return cached_cast(params, ("armw", str(dtype), int8),
                       lambda p: _cast_matmul_weights(p, dtype, int8, device),
                       device)


def _cast_matmul_weights(params, dtype, int8: bool, device):
    out = tree_to_torch(params, device)
    if int8:
        return quantize_ar(out)
    if dtype is not None:
        blocks = dict(out["blocks"])
        for k in _MATMUL_WEIGHTS:
            blocks[k] = blocks[k].to(dtype)
        out = dict(out, blocks=blocks, lm_w=out["lm_w"].to(dtype))
    return out


def _check_token_range(tokens_list, cfg: ARConfig) -> None:
    for seq in tokens_list:
        for tok in seq:
            if not 0 <= tok < cfg.n_text_vocab:
                raise ValueError(f"text token id {tok} outside vocab "
                                 f"[0, {cfg.n_text_vocab})")


def pick_bucket(n: int, buckets: Sequence[int] = TEXT_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"text too long: {n} > {buckets[-1]}")


def size_cache(cfg: ARConfig, bucket: int) -> ARConfig:
    """Shrink the KV cache to what this text bucket can reach: 1 (voice) +
    bucket + 1 (start) + max_decode_steps, rounded up to 128."""
    need = bucket + 2 + cfg.max_decode_steps
    fitted = min(cfg.cache_len, (need + 127) // 128 * 128)
    if fitted == cfg.cache_len:
        return cfg
    return dataclasses.replace(cfg, cache_len=fitted)


def apply_padding(seq: List[int], cfg: ARConfig = ARConfig()) -> List[int]:
    """Strip trailing strip tokens, pad with calm tokens to
    pad_mel_length, force the tail, append stop, prepend start."""
    out = list(seq)
    while out and out[-1] == cfg.strip_token:
        out.pop()
    if len(out) > cfg.pad_mel_length:
        raise ValueError(f"sequence too long after strip: {len(out)}")
    out.extend([cfg.calm_token] * (cfg.pad_mel_length - len(out)))
    out[-3:] = list(cfg.tail_tokens)
    out.append(cfg.stop_mel_token)
    out.insert(0, cfg.start_mel_token)
    return out


def trim_keep_lengths(padded_sequences: Sequence[Sequence[int]],
                      cfg: ARConfig = ARConfig()) -> List[int]:
    """Per-sequence latent keep count: positions until more than 8
    consecutive calm tokens have accumulated."""
    out = []
    for seq in padded_sequences:
        calm = 0
        keep = 0
        for c, tok in enumerate(list(seq)[1:-1]):
            calm = calm + 1 if tok == cfg.calm_token else 0
            if calm > 8:
                break
            keep = c + 1
        out.append(keep)
    return out


def trim_latents(latents: np.ndarray, padded_sequences, cfg=ARConfig()
                 ) -> List[np.ndarray]:
    """latents (B, pad_mel_length, D) -> per-sequence (n_i, D) arrays."""
    keeps = trim_keep_lengths(padded_sequences, cfg)
    return [np.asarray(latents[b, :keep]) for b, keep in enumerate(keeps)]


def sampler_overrides(temperature=None, top_k=None, top_p_drop=None,
                      repetition_penalty=None):
    """Per-request sampler overrides in the dict form normalize_sampler
    takes; None fields keep the defaults, and no override at all gives
    None (shared by cli.py and serve.py)."""
    d = {k: v for k, v in (
        ("temperature", temperature), ("top_k", top_k),
        ("top_p_drop", top_p_drop),
        ("repetition_penalty", repetition_penalty)) if v is not None}
    return d or None


def normalize_sampler(sampler_params) -> tuple:
    """(temperature, top_k, top_p_drop, repetition_penalty); None -> the
    reference's defaults. Accepts a 4-sequence or a dict."""
    if sampler_params is None:
        return ar.DEFAULT_SAMPLER
    if isinstance(sampler_params, dict):
        names = ("temperature", "top_k", "top_p_drop", "repetition_penalty")
        unknown = set(sampler_params) - set(names)
        if unknown:
            raise ValueError(f"unknown sampler params: {sorted(unknown)}")
        d = dict(zip(names, ar.DEFAULT_SAMPLER))
        d.update(sampler_params)
        sampler_params = tuple(d[n] for n in names)
    t, k, p, r = sampler_params
    t, k, p, r = float(t), int(k), float(p), float(r)
    if not (t > 0 and k >= 1 and 0 <= p < 1 and r > 0):
        raise ValueError(f"bad sampler params ({t}, {k}, {p}, {r})")
    return (t, k, p, r)


def draw_uniform(generator, shape, device) -> torch.Tensor:
    """One step's f32 uniforms in [0, 1) (every draw of the sampling loop
    goes through here)."""
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def _generate(params, cfg: ARConfig, first_logits, first_penalty_ids,
              cache, generator, compute_dtype, sampler):
    """On-device sampling loop. Returns (tokens (B, steps) int32 on the
    host, lengths (B,)): lengths[b] counts ids appended to sequence b
    (stop included) under the reference's append-unless-finished rule;
    the loop ends when every row samples stop in the same step. One
    (B, 1) uniform draw per step, the first one included, like the JAX
    package's key chain (ar_stage.py:299-325)."""
    b = first_logits.shape[0]
    dev = first_logits.device
    stop = cfg.stop_mel_token

    def draw_u():
        return draw_uniform(generator, (b, 1), dev)

    probs, ids = S.process_logits_topk(first_logits, first_penalty_ids,
                                       *sampler)
    tok = S.sample_from_topk_u(draw_u(), probs, ids)
    tokens = [tok]
    finished = tok == stop
    lengths = torch.ones((b,), dtype=torch.int32, device=dev)
    fuse = ar.can_fuse_sampling(params, cfg, compute_dtype, b, sampler)
    step = 1
    while step < cfg.max_decode_steps and not bool((tok == stop).all()):
        prev = tok
        u = draw_u()
        if fuse:
            tok, cache = ar.decode_sample_step(params, cfg, cache, prev,
                                               step - 1, u, compute_dtype,
                                               sampler=sampler)
        else:
            logits, cache = ar.decode_step(params, cfg, cache, prev,
                                           step - 1, compute_dtype)
            probs, ids = S.process_logits_topk(logits, prev[:, None].long(),
                                               *sampler)
            tok = S.sample_from_topk_u(u, probs, ids)
        tokens.append(tok)
        lengths = torch.where(finished, lengths, lengths + 1)
        finished = finished | (tok == stop)
        step += 1
    return (torch.stack(tokens, dim=1).cpu().numpy(),
            lengths.cpu().numpy())


@torch.inference_mode()
def autoregressive_batch(params, tokens_list, voices, cfg: ARConfig =
                         ARConfig(), seed: int = 0, compute_dtype=None,
                         int8_weights: bool = False,
                         return_device_latents: bool = False,
                         substage_timings: Optional[dict] = None,
                         sampler_params=None, device="cpu") -> Tuple:
    """On-device ("jax"-plane) AR stage over the rows of ``tokens_list``
    (ragged lengths share the longest row's text bucket, masked), with
    one shared (d,) voice or per-row (B, d) voices. Returns
    (trimmed_latents, padded) or, with return_device_latents, (latents
    (B, 500, D) on the device, keep_lens, padded). On the bf16 + int8
    plane each decode step is one kernel-A call when B <= 16 and top_k <=
    128 (``ar.can_fuse_sampling``); otherwise decode_step and the plain
    sampler."""
    sampler = normalize_sampler(sampler_params)
    tokens_list = [list(map(int, t)) for t in tokens_list]
    if not tokens_list:
        raise ValueError("tokens_list is empty")
    _check_token_range(tokens_list, cfg)
    b = len(tokens_list)
    bucket = pick_bucket(max(len(t) for t in tokens_list))
    cfg = size_cache(cfg, bucket)
    text_ids = np.zeros((b, bucket), np.int64)
    text_valid = np.zeros((b, bucket), bool)
    for i, toks in enumerate(tokens_list):
        text_ids[i, :len(toks)] = toks
        text_valid[i, :len(toks)] = True
    st = substage_timings
    t_sub = time.monotonic()
    voices = np.asarray(voices, np.float32)
    if voices.ndim == 1:
        voices = np.repeat(voices[None], b, axis=0)
    voices = torch.as_tensor(voices, device=device)
    params = cast_matmul_weights(params, compute_dtype, int8_weights, device)
    text_ids = torch.as_tensor(text_ids, device=device)
    text_valid = torch.as_tensor(text_valid, device=device)
    if st is not None:
        sync(device)
        st["ar_cast_s"] = time.monotonic() - t_sub
        t_sub = time.monotonic()
    logits, cache = ar.prefill(params, cfg, text_ids, text_valid, voices,
                               compute_dtype)
    if st is not None:
        sync(device)
        st["ar_prefill_s"] = time.monotonic() - t_sub
        t_sub = time.monotonic()
    # the first step penalizes the prefill filler ids {1, start}
    first_ids = torch.ones((b, bucket + 2), dtype=torch.long, device=device)
    first_ids[:, -1] = cfg.start_mel_token
    gen = common.make_generator(seed, device)
    toks, lengths = _generate(params, cfg, logits, first_ids, cache, gen,
                              compute_dtype, sampler)
    if st is not None:
        st["ar_decode_loop_s"] = time.monotonic() - t_sub
        st["ar_decode_steps"] = int(toks.shape[1])
        t_sub = time.monotonic()
    sequences = [[int(t) for t in toks[i, :lengths[i]]] for i in range(b)]
    padded = [apply_padding(s, cfg) for s in sequences]
    mel_ids = torch.as_tensor(np.asarray(padded, np.int64), device=device)
    latents = ar.latent_forward(params, cfg, text_ids, text_valid, mel_ids,
                                voices, compute_dtype)
    if st is not None:
        sync(device)
        st["ar_latent_s"] = time.monotonic() - t_sub
    if return_device_latents:
        return latents, trim_keep_lengths(padded, cfg), padded
    return trim_latents(latents.float().cpu().numpy(), padded, cfg), padded


@torch.inference_mode()
def autoregressive(params, tokens: Sequence[int], voice, batch_size: int = 1,
                   cfg: ARConfig = ARConfig(), sampler: str = "jax",
                   seed: int = 0, rng=None, compute_dtype=None,
                   int8_weights: bool = False,
                   return_device_latents: bool = False,
                   substage_timings: Optional[dict] = None,
                   sampler_params=None, device="cpu") -> Tuple:
    """Run stage 1 for ``batch_size`` candidates of one text. Returns
    (trimmed_latents, padded_sequences) — or, with
    return_device_latents, (latents (B, 500, D) on the device, keep_lens,
    padded_sequences).

    sampler="jax": on-device loop seeded by ``seed``;
    sampler="reference": host loop driven by ``rng`` (a ReferenceRng)."""
    tokens = list(map(int, tokens))
    _check_token_range([tokens], cfg)
    if sampler == "jax":
        return autoregressive_batch(
            params, [tokens] * batch_size, np.asarray(voice, np.float32),
            cfg, seed=seed, compute_dtype=compute_dtype,
            int8_weights=int8_weights,
            return_device_latents=return_device_latents,
            substage_timings=substage_timings,
            sampler_params=sampler_params, device=device)
    if sampler != "reference":
        raise ValueError(f"unknown sampler '{sampler}'")
    t = len(tokens)
    bucket = pick_bucket(t)
    cfg = size_cache(cfg, bucket)
    text_ids = torch.zeros((batch_size, bucket), dtype=torch.long,
                           device=device)
    text_valid = torch.zeros((batch_size, bucket), dtype=torch.bool,
                             device=device)
    text_ids[:, :t] = torch.as_tensor(tokens, device=device)
    text_valid[:, :t] = True
    st = substage_timings
    t_sub = time.monotonic()
    voice = torch.as_tensor(np.asarray(voice, np.float32), device=device)
    params = cast_matmul_weights(params, compute_dtype, int8_weights, device)
    if st is not None:
        sync(device)
        st["ar_cast_s"] = time.monotonic() - t_sub
        t_sub = time.monotonic()
    logits, cache = ar.prefill(params, cfg, text_ids, text_valid, voice,
                               compute_dtype)
    if st is not None:
        sync(device)
        st["ar_prefill_s"] = time.monotonic() - t_sub
        t_sub = time.monotonic()
    if rng is None:
        from tortoise_tpu.rng import ReferenceRng

        rng = ReferenceRng(seed)
    first_ids = [1] * (bucket + 1) + [cfg.start_mel_token]
    prev_ids = [first_ids] * batch_size
    sequences = [[] for _ in range(batch_size)]
    sp = normalize_sampler(sampler_params)
    step = 0
    while True:
        samples = S.host_process_logits_and_sample(
            logits.float().cpu().numpy(), prev_ids, rng, *sp)
        for b in range(batch_size):
            if not (sequences[b] and sequences[b][-1] == cfg.stop_mel_token):
                sequences[b].append(int(samples[b]))
        if all(s == cfg.stop_mel_token for s in samples):
            break
        if step >= cfg.max_decode_steps - 1:
            break
        tok = torch.as_tensor(samples, device=device)
        logits, cache = ar.decode_step(params, cfg, cache, tok, step,
                                       compute_dtype)
        prev_ids = [[int(s)] for s in samples]
        step += 1
    if st is not None:
        st["ar_decode_loop_s"] = time.monotonic() - t_sub
        st["ar_decode_steps"] = step + 1
        t_sub = time.monotonic()
    padded = [apply_padding(s, cfg) for s in sequences]
    mel_ids = torch.as_tensor(np.asarray(padded, np.int64), device=device)
    latents = ar.latent_forward(params, cfg, text_ids, text_valid, mel_ids,
                                voice, compute_dtype)
    if st is not None:
        sync(device)
        st["ar_latent_s"] = time.monotonic() - t_sub
    if return_device_latents:
        return latents, trim_keep_lengths(padded, cfg), padded
    return trim_latents(latents.float().cpu().numpy(), padded, cfg), padded
