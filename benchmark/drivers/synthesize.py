"""Entry ``synthesize``: ``tortoise_tpu_torch.pipeline.synthesize
.synthesize()`` called as the CLI calls it (``batch_size=1``, the
``jax`` sampler, stage walls synced, mel and latents handed back), by
one client in a closed loop: each request is sent when the one before
it has returned.

Warm-up: the AR stage alone for each text bucket and each (KV-cache
length, sampler) step graph that the plan's requests reach beyond the
first request's, then the first request whole, which the window sends
again first; so the window builds, captures and allocates nothing new,
and starts from the state a whole call leaves.
"""

from __future__ import annotations

import numpy as np

from benchmark import harness, trace
from benchmark.families.tortoise import Served, served_tokens


def _call(run, req, ar_only=False):
    from tortoise_tpu_torch.pipeline import ar_stage
    from tortoise_tpu_torch.pipeline.synthesize import synthesize

    m = run.models
    voice = run.plan.voices[req.voice]
    if ar_only:
        return ar_stage.autoregressive(
            m.ar_params, req.tokens, voice, 1, m.ar_cfg, sampler="jax",
            seed=req.seed, compute_dtype=run.compute_dtype,
            int8_weights=run.int8, return_device_latents=True,
            sampler_params=req.sampler, device=run.device)
    return synthesize(m, tokens=req.tokens, voice=voice, seed=req.seed,
                      batch_size=1, sampler="jax",
                      compute_dtype=run.compute_dtype,
                      int8_weights=run.int8, stage_sync=True,
                      materialize=True, sampler_params=req.sampler,
                      device=run.device)


def warm_set(run) -> list:
    """Requests of the plan that together reach every text bucket and
    every (KV-cache length, sampler) step-graph key of its first REACH
    at one row (the port's own bucket rules)."""
    from tortoise_tpu_torch.pipeline import ar_stage

    buckets, keys, pick = set(), set(), []
    for req in run.plan.requests[:harness.REACH]:
        b = ar_stage.pick_bucket(len(req.tokens))
        key = (ar_stage.size_cache(run.models.ar_cfg, b).cache_len,
               req.greedy)
        if b not in buckets or key not in keys:
            pick.append(req)
            buckets.add(b)
            keys.add(key)
    return pick


def setup(run):
    import gc

    warm = warm_set(run)
    for req in warm[1:]:
        _call(run, req, ar_only=True)
    _call(run, warm[0])
    harness.sync(run.device)
    gc.collect()
    return {"warmed": len(warm)}


def window(run, state, seconds):
    reqs = iter(run.plan.requests)
    run.opened = harness.now()
    while harness.now() - run.opened < seconds:
        req = next(reqs)
        rec = harness.Record(request=req, start=harness.now())
        with trace.span("synthesize"):
            try:
                rec.result = _call(run, req)
            except Exception as e:  # a failed request counts as failed
                rec.error = f"{type(e).__name__}: {e}"
        rec.end = harness.now()
        run.records.append(rec)
        harness.request_done(run)
    run.closed = harness.now()


def served(run, rec) -> Served:
    req, res = rec.request, rec.result
    return Served(
        text=req.tokens, voice=run.plan.voices[req.voice],
        greedy=req.greedy,
        tokens=served_tokens(res.sequences[0], run.config["ar"]),
        audio=res.audio,
        latents=np.asarray(res.latents[0]), mel=np.asarray(res.mel),
        seed=req.seed)


def close(state):
    pass
