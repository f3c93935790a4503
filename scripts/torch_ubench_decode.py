#!/usr/bin/env python3
"""Where an AR decode step spends its time on the card: the counterpart
of ``scripts/ubench_decode.py``, with ``scripts/ubench_fused_step.py``'s
question (kernel A against the plain step) folded in.

    python3 scripts/torch_ubench_decode.py [steps]            # the card
    python3 scripts/torch_ubench_decode.py --sampler          # + sampler
    python3 scripts/torch_ubench_decode.py --device cpu --small

On production-size random AR weights (``--small``: the tiny config) and
a cache primed by a prefill of 32 random text ids (text bucket 32, the
cache sized as the AR stage sizes it), at B = 1 and 4, each over
``steps`` (64) chained steps:

  decode    the int8 plane's step, kernel A on the card (trunk, head and
            the in-kernel sampler; ``decode_sample_step`` on fixed
            uniforms); on the bf16-weights plane the plain
            ``decode_step`` and an argmax, as the JAX script's loop;
  wstream   the chained matvecs through the same stacked blocks'
            ``attn_w``/``proj_w``/``fc_w``/``fc_proj_w`` (``pdot``, the
            plain path's products; int8 pairs widen to bf16): the
            plain path's weight-streaming floor;
  cacheatt  attention of one query a head over the (L, B, C, H*Dh)
            cache alone.

Bytes as the JAX script counts them (``byte_counts``): ``nbytes`` every
leaf of the cast tree, ``wb`` the four block weights (pairs with their
scales), ``cb`` the K and V caches at 2 bytes an element. Each prints
ms/step (wall: CUDA events around the chained steps, best of ``reps``
after a warmup; and device busy: the kernel times of one more call
under ``torch.profiler``) and GB/s against the card's 3.35 TB/s.
Each call's cache is a copy of the primed one, made outside the timing.

``loop`` (each plane and B): the sampling loop itself
(``ar_stage._generate``, ``steps`` steps from the primed cache, the
stage's uniforms) run eagerly and as a CUDA graph of one step
(``pipeline/graphs.py``), in turns: eager, graph, graph, eager, each
turn timed as above (the first graph turn's warmup call captures). It
prints wall and busy ms/step of every turn, whether the two loops gave
the same tokens, and the launches a step of each; on the CPU the eager
loop alone (graphs exist only for CUDA tensors).

``--sampler`` (the JAX script's ``bench_sampler_paths``): on the
bf16-weights plane at B = 1, the plain generate loop
(``ar_stage._generate``: ``decode_step`` and the plain sampler, reading
its stop flag every 8 steps) against the sampler alone
(``process_logits_topk`` and ``sample_from_topk_u``, chained through
the previous token), in ms/step.

The last line is ``{"decode": {...}}`` with every number printed and the
launch counts since the start (kernel A on the int8 plane only).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ubench_common as U  # noqa: E402

BATCHES = (1, 4)
TEXT_BUCKET = 32
BLOCK_WEIGHTS = ("attn_w", "proj_w", "fc_w", "fc_proj_w")
PLANES = ("int8", "bf16")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def byte_counts(params, cache) -> dict:
    """The JAX script's byte formulas on the cast tree ``params`` and a
    KVCache: ``nbytes`` (every leaf), ``wb`` (the four stacked block
    weights, scales included) and ``cb`` (K and V at 2 bytes an
    element)."""
    def size(tree):
        return sum(int(t.numel()) * t.element_size() for t in _leaves(tree))

    return {"nbytes": size(params),
            "wb": sum(size(params["blocks"][k]) for k in BLOCK_WEIGHTS),
            "cb": (cache.k.numel() + cache.v.numel()) * 2}


def _prompt(cfg, b: int, rng, device):
    """(text ids (b, 32), valid (b, 32), voice (d,)) from ``rng`` in the
    JAX script's order: random ids in [0, 255), every position valid (on
    the tiny config only its ``n_text_pos`` first)."""
    import torch

    text = torch.as_tensor(rng.integers(0, min(255, cfg.n_text_vocab),
                                        (b, TEXT_BUCKET)), device=device)
    valid = torch.zeros((b, TEXT_BUCKET), dtype=torch.bool, device=device)
    valid[:, :min(TEXT_BUCKET, cfg.n_text_pos)] = True
    voice = torch.as_tensor(rng.normal(0, .5, (cfg.d_model,)).astype(
        np.float32), device=device)
    return text, valid, voice


def _fresh(cache):
    from tortoise_tpu_torch.models.ar import KVCache

    return KVCache(cache.k.clone(), cache.v.clone(), cache.valid.clone(),
                   cache.length)


def _plane(params, cfg, b: int, plane: str, steps: int, device, reps: int,
           card: str) -> dict:
    """decode, wstream and cacheatt at batch ``b`` on one plane."""
    import torch

    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.ops.basic import pdot
    from tortoise_tpu_torch.ops.cuda import launch_counts

    bf = torch.bfloat16
    rng = np.random.default_rng(0)
    _, cache = ar.prefill(params, cfg, *_prompt(cfg, b, rng, device), bf)
    counts = byte_counts(params, cache)
    # a copy of the primed cache for each of decode's calls: its warmup,
    # reps and the profiled one
    caches = [_fresh(cache) for _ in range(reps + 2)]
    u = torch.full((b, 1), 0.5, device=device)

    def decode():
        c = caches.pop()
        tok = torch.full((b,), 5, dtype=torch.int32, device=device)
        for i in range(steps):
            if plane == "int8":
                tok, c = ar.decode_sample_step(params, cfg, c, tok, i, u, bf)
            else:
                logits, c = ar.decode_step(params, cfg, c, tok, i, bf)
                tok = logits.argmax(-1).to(torch.int32)
        return tok

    blocks = params["blocks"]
    layers = [ar._layer(blocks, l) for l in range(cfg.n_layer)]
    d = cfg.d_model

    def wstream():
        x = x0
        for i in range(steps):
            h = x
            for blk in layers:
                a = pdot(h, blk["attn_w"], bf)
                p = pdot(a[:, :d].to(bf), blk["proj_w"], bf)
                f = pdot(p.to(bf), blk["fc_w"], bf)
                h = pdot(f.to(bf), blk["fc_proj_w"], bf).to(bf)
            x = h * (1.0 / (1.0 + i))
        return x

    hh, dh = cfg.n_head, cfg.d_head
    k4 = [cache.k[l].reshape(b, -1, hh, dh) for l in range(cfg.n_layer)]
    v4 = [cache.v[l].reshape(b, -1, hh, dh) for l in range(cfg.n_layer)]

    def cacheatt():
        q = q0
        for _ in range(steps):
            for kl, vl in zip(k4, v4):
                s = torch.einsum("bhd,bchd->bhc", q, kl).float()
                p = torch.softmax(s, dim=-1)
                q = torch.einsum("bhc,bchd->bhd", p.to(vl.dtype), vl)
        return q

    x0 = torch.as_tensor(rng.normal(0, 1, (b, d)).astype(np.float32),
                         device=device).to(bf)
    q0 = torch.as_tensor(rng.normal(0, 1, (b, hh, dh)).astype(np.float32),
                         device=device).to(bf)
    out = dict(bytes=counts)
    for name, fn, nb in (("decode", decode, counts["nbytes"]),
                         ("wstream", wstream, counts["wb"]),
                         ("cacheatt", cacheatt, counts["cb"])):
        before = launch_counts()
        with torch.inference_mode():
            t = U.timed(fn, device, reps)
        if name == "decode":
            out["decode_launches"] = U.launch_delta(before)
        per = t["ms"] / steps
        out[name] = dict(ms_per_step=per, busy_ms_per_step=(
            None if t["busy_ms"] is None else t["busy_ms"] / steps),
            gb_per_s=None, hbm_share=None)
        rate = ""
        if device.type == "cuda":  # a rate of the card's memory only
            gbs = nb / (per * 1e-3) / 1e9
            out[name].update(gb_per_s=gbs,
                             hbm_share=gbs * 1e9 / U.HBM_BYTES_PER_S)
            rate = (f": {gbs:7.1f} GB/s ({out[name]['hbm_share']:.4f} of "
                    f"3.35 TB/s)")
        print(f"B={b} {plane} {name:8s}: {U.fmt(t, steps, 'ms/step')}, "
              f"{nb / 1e6:.1f} MB a step{rate} [{card}]", flush=True)
    return out


# the loop A/B's turns: eager, graph, graph, eager (True: eager)
LOOP_TURNS = (True, False, False, True)


def loop_ab(params, cfg, b: int, steps: int, device, reps: int,
            card: str, compute_dtype, label: str = "") -> dict:
    """The sampling loop at batch ``b`` on the cast tree ``params`` (on
    the plane of ``compute_dtype``), eager against a step graph in turns
    (module docstring). Returns
    {"steps", "eager", "graph" (None on the CPU), "same_tokens"}; each
    loop's entry has its best ``ms_per_step`` and ``busy_ms_per_step``,
    ``turns`` ([wall, busy] ms/step a turn) and ``launches_per_step``."""
    import torch

    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.ops.cuda import launch_counts
    from tortoise_tpu_torch.pipeline import ar_stage, common

    cd = compute_dtype
    cfg = dataclasses.replace(cfg, max_decode_steps=steps)
    logits, cache = ar.prefill(params, cfg, *_prompt(
        cfg, b, np.random.default_rng(0), device), cd)
    first = torch.ones((b, TEXT_BUCKET + 2), dtype=torch.long, device=device)
    toks = {}

    def gen(eager):
        t, _ = ar_stage._generate(params, cfg, logits, first, _fresh(cache),
                                  common.make_generator(0, device), cd,
                                  ar.DEFAULT_SAMPLER, eager=eager)
        toks.setdefault(eager, []).append(t)
        return t

    out = {"steps": steps, "eager": None, "graph": None}
    turns = LOOP_TURNS if device.type == "cuda" else LOOP_TURNS[:1]
    for eager in turns:
        name = "eager" if eager else "graph"
        before, done = launch_counts(), len(toks.get(eager, []))
        with torch.inference_mode():
            t = U.timed(lambda: gen(eager), device, reps)
        n = toks[eager][-1].shape[1] - 1  # decode steps a call
        calls = len(toks[eager]) - done
        ent = out[name] or {"turns": []}
        ent["turns"].append([t["ms"] / n, None if t["busy_ms"] is None
                             else t["busy_ms"] / n])
        ent["launches_per_step"] = {
            k: v / (calls * n) for k, v in U.launch_delta(before).items()}
        out[name] = ent
        print(f"B={b} {label} loop {name:5s}: {U.fmt(t, n, 'ms/step')} over "
              f"{n} steps [{card}]", flush=True)
    for ent in (out["eager"], out["graph"]):
        if ent is not None:
            best = min(ent["turns"])
            ent.update(ms_per_step=best[0], busy_ms_per_step=best[1])
    out["same_tokens"] = all(torch.equal(t, toks[True][0])
                             for ts in toks.values() for t in ts)
    return out


def sampler_paths(params, cfg, steps: int, device, reps: int,
                  card: str) -> dict:
    """The plain generate loop against the sampler alone, B = 1, on the
    bf16-weights tree ``params`` (module docstring)."""
    import torch

    from tortoise_tpu_torch.models import ar
    from tortoise_tpu_torch.ops import sampling as S
    from tortoise_tpu_torch.pipeline import ar_stage, common

    bf = torch.bfloat16
    cfg = dataclasses.replace(cfg, max_decode_steps=steps)
    rng = np.random.default_rng(0)
    logits, cache = ar.prefill(params, cfg, *_prompt(cfg, 1, rng, device),
                               bf)
    first_ids = torch.ones((1, TEXT_BUCKET + 2), dtype=torch.long,
                           device=device)
    caches = [_fresh(cache) for _ in range(reps + 2)]
    out = {}

    def gen():
        toks, _ = ar_stage._generate(
            params, cfg, logits, first_ids, caches.pop(),
            common.make_generator(0, device), bf, ar.DEFAULT_SAMPLER)
        out["generate_steps"] = int(toks.shape[1])
        return toks

    u = torch.full((1, 1), 0.5, device=device)

    def sample_loop():
        tok = torch.full((1,), 5, dtype=torch.int32, device=device)
        for _ in range(steps):
            probs, ids = S.process_logits_topk(logits, tok[:, None].long(),
                                               *ar.DEFAULT_SAMPLER)
            tok = S.sample_from_topk_u(u, probs, ids)
        return tok

    with torch.inference_mode():
        t_gen = U.timed(gen, device, reps)
        n = out["generate_steps"]
        t_smp = U.timed(sample_loop, device, reps)
    for name, t, per in (("generate", t_gen, n), ("sampler", t_smp, steps)):
        out[name] = dict(ms_per_step=t["ms"] / per, busy_ms_per_step=(
            None if t["busy_ms"] is None else t["busy_ms"] / per))
        print(f"B=1 bf16 {name:8s}: {U.fmt(t, per, 'ms/step')} over {per} "
              f"steps [{card}]", flush=True)
    return out


def run(ar_params, cfg, steps: int = 64, device=None, reps: int = 3,
        batches=BATCHES, sampler: bool = False, card: str = "") -> dict:
    """The decode breakdown on the host AR tree ``ar_params`` (cast here
    to the int8 plane and the bf16-weights plane)."""
    import torch

    from tortoise_tpu_torch.pipeline import ar_stage

    cfg = ar_stage.size_cache(cfg, TEXT_BUCKET)
    if TEXT_BUCKET + 2 + steps > cfg.cache_len:
        raise ValueError(f"{steps} steps overrun the {cfg.cache_len}-slot "
                         f"cache")
    out = dict(steps=steps, reps=reps, cache_len=cfg.cache_len)
    for plane in PLANES:
        params = ar_stage.cast_matmul_weights(
            ar_params, torch.bfloat16, int8=plane == "int8", device=device)
        out[plane] = {str(b): _plane(params, cfg, b, plane, steps, device,
                                     reps, card) for b in batches}
        for b in batches:
            out[plane][str(b)]["loop"] = loop_ab(
                params, cfg, b, steps, device, reps, card, torch.bfloat16,
                plane)
        if sampler and plane == "bf16":
            out["sampler"] = sampler_paths(params, cfg, steps, device, reps,
                                           card)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", type=int, nargs="?", default=None,
                    help="chained steps a call (64; --small: 8)")
    ap.add_argument("--sampler", action="store_true",
                    help="also the plain generate loop against the "
                         "sampler alone")
    U.add_device_args(ap)
    args = ap.parse_args(argv)
    dev, card = U.start(args.device)
    from tortoise_tpu_torch.config import ARConfig, tiny_ar_config
    from tortoise_tpu_torch.io.checkpoint import random_ar_params

    cfg = tiny_ar_config() if args.small else ARConfig()
    params = random_ar_params(cfg, seed=0, fast=True)
    steps = args.steps or (8 if args.small else 64)
    result = run(params, cfg, steps, dev, sampler=args.sampler, card=card)
    return U.emit("decode", result, dev, card, args.small)


if __name__ == "__main__":
    main()
