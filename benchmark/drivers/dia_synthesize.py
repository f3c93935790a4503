"""Entry ``dia_synthesize``: ``tortoise_tpu_torch.pipeline.synthesize
.synthesize()`` on a ``DiaModels`` bundle, as the CLI calls it (one
utterance after its prompt, stage walls synced, the codes handed back),
each request's length fixed (``min_frames`` = ``max_frames``) and its
raw logits at the mix's probed steps kept on the device for the check;
one client in a closed loop.

Warm-up: a whole request for each step-graph key (padded text, padded
cache) the plan's requests reach beyond the first one's, the DAC alone
on each generated length they reach, then the first request whole, which
the window sends again first; so the window builds, captures and
allocates nothing new.
"""

from __future__ import annotations

from benchmark import harness, trace
from benchmark.families.dia import Served, frames_of, graph_key, \
    probe_steps, shape


def _call(run, req):
    from tortoise_tpu_torch.pipeline.synthesize import synthesize

    n = frames_of(run.mix, req)
    return synthesize(run.models, tokens=req.tokens,
                      voice=run.plan.clips[req.voice], seed=req.seed,
                      compute_dtype=run.compute_dtype, stage_sync=True,
                      materialize=True, device=run.device,
                      probe_steps=probe_steps(run.mix,
                                              shape(run, req)[3]),
                      min_frames=n, max_frames=n)


def warm_set(run) -> tuple:
    """(requests reaching every step-graph key of the plan, one each;
    the generated lengths of the plan's requests)."""
    keys, pick, gens = set(), [], set()
    for req in run.plan.requests:
        gens.add(frames_of(run.mix, req))
        key = graph_key(run, req)
        if key not in keys:
            keys.add(key)
            pick.append(req)
    return pick, sorted(gens)


def setup(run):
    import gc

    import torch

    from tortoise_tpu_torch.pipeline import dac_stage

    pick, gens = warm_set(run)
    for req in pick[1:]:
        _call(run, req)
    m = run.models
    for n in gens:
        dac_stage.dac(m.dac_params,
                      torch.zeros((1, m.dac_cfg.n_codebooks, n),
                                  dtype=torch.long, device=run.device),
                      m.dac_cfg, run.device)
    _call(run, pick[0])
    harness.sync(run.device)
    gc.collect()
    return {"warmed": len(pick), "dac_lengths": len(gens)}


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
    clip = run.plan.clips[req.voice]
    return Served(text=list(res.tokens), greedy=False,
                  prompt=clip.codes.shape[0], codes=res.codes,
                  audio=res.audio, probes=res.probes)


def close(state):
    pass
