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
  ``tortoise_tpu_torch.rng.ReferenceRng``, reproducing the reference's seeded
  decision stream — the plane the port is held to token for token.

On the card without a mesh both planes' loops replay a CUDA graph of one
step (``pipeline.graphs``), as the JAX package runs its loop as one
program on the device: the step reads its decode index from a device
counter (``_sampling_step``, ``_decode_only_step``).

Sequence post-processing (apply_padding, trim_keep_lengths, trim_latents)
and the text-bucket rules are pure-Python copies of the JAX package's.

Under a mesh (``autoregressive_batch(mesh=)``) each rank runs its rows
of the "dp" split, and the heads of its "tp" place (``models.ar``). Every
rank draws each step's GLOBAL (B, 1) uniforms and keeps its rows; the
all-rows-stopped rule is global (a MIN over dp of each step's flag);
tokens, lengths and latents are gathered, so every rank returns every
row. On a pure-dp mesh kernel A runs on each rank's rows (the dp
plane); under tp it cannot (it holds whole layers and the whole-vocab
head pack) and the loop takes decode_step and the plain sampler; kernel
C runs on each rank's rows and heads when they pass
``ar.flash_prefill_on``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tortoise_tpu_torch.config import ARConfig
from tortoise_tpu_torch.models import ar
from tortoise_tpu_torch.ops import sampling as S
from tortoise_tpu_torch.ops.basic import quantize_cols, quantize_cols_host
from tortoise_tpu_torch.parallel.mesh import axis_group
from tortoise_tpu_torch.parallel.sharding import ar_param_specs
from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline import common, graphs
from tortoise_tpu_torch.pipeline.common import (
    cached_cast,
    download,
    draw_rows,
    dp_rows,
    resolve_device,
    shard_cast,
    substage,
)

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


def quantize_ar_host(params) -> dict:
    """int8-quantize the AR numpy tree's matmul weights on the host (the
    JAX package's quantize_ar_host pairs, bit for bit) for a plane cache
    (``io/plane_cache.py``). No head pack is built: ``quantize_ar``
    builds it on the device from these pairs (one carried in the tree,
    as the JAX package's planes hold it, passes through). Pairs pass
    through as tuples."""
    def q(w):
        return tuple(w) if isinstance(w, (tuple, list)) \
            else quantize_cols_host(w)

    blocks = dict(params["blocks"])
    for k in _MATMUL_WEIGHTS:
        blocks[k] = q(blocks[k])
    out = dict(params, blocks=blocks)
    lm = params["lm_w"]
    out["lm_w"] = tuple(lm) if isinstance(lm, (tuple, list)) \
        else quantize_cols_host(np.asarray(lm).T)
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


# steps between the sampling loop's reads of its all-stop flag
STOP_CHECK_STEPS = 8


def draw_uniform(generator, shape, device) -> torch.Tensor:
    """One step's f32 uniforms in [0, 1) (every draw of the sampling loop
    goes through here)."""
    return torch.rand(shape, generator=generator, device=device,
                      dtype=torch.float32)


def _first_stop(flags, dp):
    """Index of the first step whose all-rows-stopped flag holds on every
    dp rank (a MIN over dp of the window ``flags``), or None."""
    if dp is not None:
        flags = dp.all_reduce(flags, op=torch.distributed.ReduceOp.MIN)
    hit = torch.nonzero(flags).flatten()
    return int(hit[0]) if hit.numel() else None


def _sampling_buffers(cache, b: int, max_steps: int, dev) -> dict:
    """The sampling loop's state, worked on in place by
    ``_sampling_step``: ``cache`` (a step graph's has a device write index
    ``pos``), ``step`` (the next decode index), ``tok`` (the last sampled
    ids, the next step's ``prev``), ``u`` (the step's uniforms),
    ``toks`` (B, max_steps) (column n: the n-th sampled ids),
    ``lengths``, ``finished`` and ``flags`` (flags[n]: every row sampled
    stop in column n)."""
    def z(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return {"cache": cache, "step": z((1,), torch.long),
            "tok": z((b,), torch.int32), "u": z((b, 1), torch.float32),
            "toks": z((b, max_steps), torch.int32),
            "lengths": z((b,), torch.int32), "finished": z((b,), torch.bool),
            "flags": z((max_steps,), torch.int32)}


def _static_cache(cache) -> "ar.KVCache":
    """A step graph's own KV cache, shaped as ``cache``, with a device
    write index (its contents are copied in by ``_start``)."""
    return ar.KVCache(torch.empty_like(cache.k), torch.empty_like(cache.v),
                      torch.empty_like(cache.valid), cache.length,
                      torch.zeros((1,), dtype=torch.long,
                                  device=cache.k.device))


def _start(bufs, cache) -> None:
    """Start a loop's ``bufs`` from the primed ``cache`` at decode index
    0: a step graph's own cache gets the contents copied in."""
    static = bufs["cache"]
    if static is not cache:
        static.k.copy_(cache.k)
        static.v.copy_(cache.v)
        static.valid.copy_(cache.valid)
        static.pos.fill_(cache.length)
        bufs["cache"] = ar.KVCache(static.k, static.v, static.valid,
                                   cache.length, static.pos)
    bufs["step"].zero_()


def _sampling_step(params, cfg: ARConfig, compute_dtype, sampler, fuse,
                   qkv_f16, tp, split, bufs) -> None:
    """One step of the sampling loop on ``bufs`` (``_sampling_buffers``),
    in place: the decode step and the sampler (kernel A's
    ``decode_sample_step`` when ``fuse``) at the device index
    ``bufs["step"]``, then the row lengths, the stop flags and the
    token column. The unit a step graph holds."""
    prev, step = bufs["tok"], bufs["step"]
    if fuse:
        tok, cache = ar.decode_sample_step(params, cfg, bufs["cache"], prev,
                                           step, bufs["u"], compute_dtype,
                                           sampler=sampler, split_rows=split)
    else:
        logits, cache = ar.decode_step(params, cfg, bufs["cache"], prev,
                                       step, compute_dtype, qkv_f16, tp=tp,
                                       split_rows=split)
        probs, ids = S.process_logits_topk(logits, prev[:, None].long(),
                                           *sampler)
        tok = S.sample_from_topk_u(bufs["u"], probs, ids)
    bufs["cache"] = cache
    stop = tok == cfg.stop_mel_token
    col = step + 1
    lengths, finished = bufs["lengths"], bufs["finished"]
    lengths.copy_(torch.where(finished, lengths, lengths + 1))
    finished.logical_or_(stop)
    bufs["flags"].index_copy_(0, col, stop.all().to(torch.int32).reshape(1))
    bufs["toks"].index_copy_(1, col, tok.to(torch.int32)[:, None])
    prev.copy_(tok)
    step.add_(1)


def _generate(params, cfg: ARConfig, first_logits, first_penalty_ids,
              cache, generator, compute_dtype, sampler, rows=None, dp=None,
              tp=None, qkv_f16=False, mesh=None, eager=False):
    """On-device sampling loop over this rank's rows. Returns (tokens
    (B, steps) int32, lengths (B,)) on the device: lengths[b] counts ids
    appended to sequence b (stop included) under the reference's
    append-unless-finished rule; the loop ends when every row (of every
    dp rank) samples stop in the same step. One global (B, 1) uniform
    draw per step, the first one included, like the JAX package's key
    chain (ar_stage.py:299-325); ``rows`` picks this rank's part of it.

    Each step is ``_sampling_step``: on a card without a ``mesh`` the
    replay of one captured step (``pipeline.graphs``; ``eager`` runs the
    eager loop there, for A/B runs), else the step run eagerly. It
    records its all-rows-stopped flag on the device; the host reads the
    flags of the last ``STOP_CHECK_STEPS`` steps at once (a read waits
    for the device, so reading each step would keep the host's enqueue
    from overlapping the step before), after a MIN over ``dp``. Steps
    run past the stop step are dropped (their draws come after every
    kept one)."""
    b = first_logits.shape[0]
    dev = first_logits.device
    stop = cfg.stop_mel_token
    n = cfg.max_decode_steps
    rows = rows or slice(0, b)
    n_global = b if dp is None else b * dp.size
    # kernel A splits its work as for the whole batch: a row's bits do
    # not depend on the dp size
    split = None if dp is None else n_global

    def draw_u():
        return draw_rows(draw_uniform, generator, (n_global, 1), dev, rows)

    probs, ids = S.process_logits_topk(first_logits, first_penalty_ids,
                                       *sampler)
    tok = S.sample_from_topk_u(draw_u(), probs, ids)
    # false under tp (a tp rank's params hold no head pack) and with
    # qkv_f16 (kernel A has no f16 round trip), as in the JAX package
    fuse = not qkv_f16 and ar.can_fuse_sampling(params, cfg, compute_dtype,
                                                b, sampler)
    step_fn = functools.partial(_sampling_step, params, cfg, compute_dtype,
                                sampler, fuse, qkv_f16, tp, split)

    def make_bufs(static):
        return _sampling_buffers(_static_cache(cache) if static else cache,
                                 b, n, dev)

    with graphs.stepping(
            not eager and graphs.use_graphs(dev, mesh),
            ("ar", cfg, str(compute_dtype), sampler, fuse, qkv_f16, b),
            params, make_bufs, step_fn) as (bufs, run):
        _start(bufs, cache)
        first_stop = tok == stop
        bufs["tok"].copy_(tok)
        bufs["toks"][:, 0] = tok
        bufs["lengths"].fill_(1)
        bufs["finished"].copy_(first_stop)
        bufs["flags"][0] = first_stop.all()
        end, checked, step = None, 0, 1
        while step < n:
            if step % STOP_CHECK_STEPS == 1:
                hit = _first_stop(bufs["flags"][checked:step], dp)
                if hit is not None:
                    end = checked + hit + 1
                    break
                checked = step
            bufs["u"].copy_(draw_u())
            run()
            step += 1
        if end is None:
            hit = _first_stop(bufs["flags"][checked:step], dp)
            end = step if hit is None else checked + hit + 1
        return bufs["toks"][:, :end].clone(), bufs["lengths"].clone()


@torch.inference_mode()
def autoregressive_batch(params, tokens_list, voices, cfg: ARConfig =
                         ARConfig(), seed: int = 0, compute_dtype=None,
                         qkv_f16: bool = False, mesh=None,
                         int8_weights: bool = False,
                         return_device_latents: bool = False,
                         substage_timings: Optional[dict] = None,
                         sampler_params=None, device=None) -> Tuple:
    """On-device ("jax"-plane) AR stage over the rows of ``tokens_list``
    (ragged lengths share the longest row's text bucket, masked), with
    one shared (d,) voice or per-row (B, d) voices. Returns
    (trimmed_latents, padded) or, with return_device_latents, (latents
    (B, 500, D) on the device, keep_lens, padded). On the bf16 + int8
    plane each decode step is one kernel-A call when B <= 16 and top_k <=
    128 (``ar.can_fuse_sampling``); otherwise decode_step and the plain
    sampler. ``qkv_f16``: the reference's f16 round trip of the qkv
    activations (kernels A and C stay off, as in the JAX package).
    ``mesh`` (``parallel.make_mesh``): this rank runs its rows and heads
    and returns every row (see the module docstring)."""
    device = resolve_device(device)
    sampler = normalize_sampler(sampler_params)
    tokens_list = [list(map(int, t)) for t in tokens_list]
    if not tokens_list:
        raise ValueError("tokens_list is empty")
    _check_token_range(tokens_list, cfg)
    b = len(tokens_list)
    bucket = pick_bucket(max(len(t) for t in tokens_list))
    cfg = size_cache(cfg, bucket)
    rows = dp_rows(mesh, b, "autoregressive_batch")
    dp = axis_group(mesh, "dp") if rows != slice(0, b) else None
    tp = axis_group(mesh, "tp")
    text_ids = np.zeros((b, bucket), np.int64)
    text_valid = np.zeros((b, bucket), bool)
    for i, toks in enumerate(tokens_list):
        text_ids[i, :len(toks)] = toks
        text_valid[i, :len(toks)] = True
    st = substage_timings
    with substage("ar.cast", st, "ar_cast_s", device):
        voices = np.asarray(voices, np.float32)
        if voices.ndim == 1:
            voices = np.repeat(voices[None], b, axis=0)
        voices = torch.as_tensor(voices[rows], device=device)
        full = cast_matmul_weights(params, compute_dtype, int8_weights,
                                   device)
        if tp is not None:  # the head pack holds the whole vocab
            full = dict(full, head_pack=None)
        params = shard_cast(params, ("armw", str(compute_dtype),
                                     int8_weights),
                            full, ar_param_specs, mesh, device)
        text_ids = torch.as_tensor(text_ids[rows], device=device)
        text_valid = torch.as_tensor(text_valid[rows], device=device)
    with substage("ar.prefill", st, "ar_prefill_s", device):
        logits, cache = ar.prefill(params, cfg, text_ids, text_valid,
                                   voices, compute_dtype, qkv_f16, tp=tp)
    with substage("ar.decode_loop", st, "ar_decode_loop_s", device) as sp:
        # the first step penalizes the prefill filler ids {1, start}
        n = text_ids.shape[0]
        first_ids = torch.ones((n, bucket + 2), dtype=torch.long,
                               device=device)
        first_ids[:, -1] = cfg.start_mel_token
        gen = common.make_generator(seed, device)
        toks, lengths = _generate(params, cfg, logits, first_ids, cache, gen,
                                  compute_dtype, sampler, rows, dp, tp,
                                  qkv_f16, mesh)
        if dp is not None:
            toks, lengths = dp.all_gather(toks), dp.all_gather(lengths)
        toks, lengths = toks.cpu().numpy(), lengths.cpu().numpy()
        sp.add("steps", int(toks.shape[1]))
    if st is not None:
        st["ar_decode_steps"] = int(toks.shape[1])
    with substage("ar.latent", st, "ar_latent_s", device):
        sequences = [[int(t) for t in toks[i, :lengths[i]]]
                     for i in range(b)]
        padded = [apply_padding(s, cfg) for s in sequences]
        mel_ids = torch.as_tensor(np.asarray(padded, np.int64)[rows],
                                  device=device)
        latents = ar.latent_forward(params, cfg, text_ids, text_valid,
                                    mel_ids, voices, compute_dtype, qkv_f16,
                                    tp=tp)
        if dp is not None:
            latents = dp.all_gather(latents)
    if return_device_latents:
        return latents, trim_keep_lengths(padded, cfg), padded
    return trim_latents(download(latents)[0], padded, cfg), padded


def _decode_buffers(cache, logits) -> dict:
    """The reference plane's decode state, worked on in place by
    ``_decode_only_step``: ``cache``, ``step`` (the next decode index),
    ``tok`` (the ids the host sampled) and ``logits`` (the step's
    output)."""
    dev = logits.device
    return {"cache": cache,
            "step": torch.zeros((1,), dtype=torch.long, device=dev),
            "tok": torch.zeros((logits.shape[0],), dtype=torch.long,
                               device=dev),
            "logits": torch.empty_like(logits)}


def _decode_only_step(params, cfg: ARConfig, compute_dtype, qkv_f16,
                      bufs) -> None:
    """One decode step of the reference plane on ``bufs``
    (``_decode_buffers``), in place: the logits of ``bufs["tok"]`` at the
    device index ``bufs["step"]``; the host samples from them (the unit
    its step graph holds)."""
    logits, bufs["cache"] = ar.decode_step(params, cfg, bufs["cache"],
                                           bufs["tok"], bufs["step"],
                                           compute_dtype, qkv_f16)
    bufs["logits"].copy_(logits)
    bufs["step"].add_(1)


def _reference_loop(params, cfg: ARConfig, logits, cache, batch_size: int,
                    bucket: int, seed: int, rng, compute_dtype, qkv_f16,
                    sampler_params, device) -> Tuple[List[List[int]], int]:
    """The reference plane's host-sampled loop from the prefill's
    ``logits``: each step's logits are read back and sampled on the host
    from ``rng`` (a ReferenceRng, seeded by ``seed`` when None), then the
    decode step runs (a step graph's replay on the card). Returns each
    candidate's sampled ids and the steps sampled."""
    if rng is None:
        from tortoise_tpu_torch.rng import ReferenceRng

        rng = ReferenceRng(seed)
    first_ids = [1] * (bucket + 1) + [cfg.start_mel_token]
    prev_ids = [first_ids] * batch_size
    sequences = [[] for _ in range(batch_size)]
    sp = normalize_sampler(sampler_params)
    step_fn = functools.partial(_decode_only_step, params, cfg,
                                compute_dtype, qkv_f16)

    def make_bufs(static):
        return _decode_buffers(_static_cache(cache) if static else cache,
                               logits)

    step = 0
    with graphs.stepping(
            graphs.use_graphs(device),
            ("ar_reference", cfg, str(compute_dtype), qkv_f16, batch_size),
            params, make_bufs, step_fn) as (bufs, run):
        _start(bufs, cache)
        while True:
            samples = S.host_process_logits_and_sample(
                logits.float().cpu().numpy(), prev_ids, rng, *sp)
            for b in range(batch_size):
                if not (sequences[b] and
                        sequences[b][-1] == cfg.stop_mel_token):
                    sequences[b].append(int(samples[b]))
            if all(s == cfg.stop_mel_token for s in samples):
                break
            if step >= cfg.max_decode_steps - 1:
                break
            bufs["tok"].copy_(torch.as_tensor(samples))
            run()
            logits = bufs["logits"]
            prev_ids = [[int(s)] for s in samples]
            step += 1
    return sequences, step + 1


@torch.inference_mode()
def autoregressive(params, tokens: Sequence[int], voice, batch_size: int = 1,
                   cfg: ARConfig = ARConfig(), sampler: str = "jax",
                   seed: int = 0, rng=None, compute_dtype=None,
                   qkv_f16: bool = False, int8_weights: bool = False,
                   return_device_latents: bool = False,
                   substage_timings: Optional[dict] = None,
                   sampler_params=None, device=None) -> Tuple:
    """Run stage 1 for ``batch_size`` candidates of one text. Returns
    (trimmed_latents, padded_sequences) — or, with
    return_device_latents, (latents (B, 500, D) on the device, keep_lens,
    padded_sequences).

    sampler="jax": on-device loop seeded by ``seed``;
    sampler="reference": host loop driven by ``rng`` (a ReferenceRng).
    ``qkv_f16``: the reference's f16 round trip of the qkv activations
    (kernels A and C stay off)."""
    device = resolve_device(device)
    tokens = list(map(int, tokens))
    _check_token_range([tokens], cfg)
    if sampler == "jax":
        return autoregressive_batch(
            params, [tokens] * batch_size, np.asarray(voice, np.float32),
            cfg, seed=seed, compute_dtype=compute_dtype, qkv_f16=qkv_f16,
            int8_weights=int8_weights,
            return_device_latents=return_device_latents,
            substage_timings=substage_timings,
            sampler_params=sampler_params, device=device)
    if sampler != "reference":
        raise ValueError(f"unknown sampler '{sampler}'")
    t = len(tokens)
    bucket = pick_bucket(t)
    cfg = size_cache(cfg, bucket)
    st = substage_timings
    with substage("ar.cast", st, "ar_cast_s", device):
        text_ids = torch.zeros((batch_size, bucket), dtype=torch.long,
                               device=device)
        text_valid = torch.zeros((batch_size, bucket), dtype=torch.bool,
                                 device=device)
        text_ids[:, :t] = torch.as_tensor(tokens, device=device)
        text_valid[:, :t] = True
        voice = torch.as_tensor(np.asarray(voice, np.float32), device=device)
        params = cast_matmul_weights(params, compute_dtype, int8_weights,
                                     device)
    with substage("ar.prefill", st, "ar_prefill_s", device):
        logits, cache = ar.prefill(params, cfg, text_ids, text_valid, voice,
                                   compute_dtype, qkv_f16)
    with substage("ar.decode_loop", st, "ar_decode_loop_s", device) as loop:
        sequences, steps = _reference_loop(
            params, cfg, logits, cache, batch_size, bucket, seed, rng,
            compute_dtype, qkv_f16, sampler_params, device)
        loop.add("steps", steps)
    if st is not None:
        st["ar_decode_steps"] = steps
    with substage("ar.latent", st, "ar_latent_s", device):
        padded = [apply_padding(s, cfg) for s in sequences]
        mel_ids = torch.as_tensor(np.asarray(padded, np.int64),
                                  device=device)
        latents = ar.latent_forward(params, cfg, text_ids, text_valid,
                                    mel_ids, voice, compute_dtype, qkv_f16)
    if return_device_latents:
        return latents, trim_keep_lengths(padded, cfg), padded
    return trim_latents(download(latents)[0], padded, cfg), padded
