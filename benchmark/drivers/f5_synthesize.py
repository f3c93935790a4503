"""Entry ``f5_synthesize``: ``tortoise_tpu_torch.pipeline.synthesize
.synthesize()`` on an ``F5Models`` bundle, as the CLI calls it (one
utterance, stage walls synced, the generated mel handed back), with the
loop's states and guided velocities at the mix's ``probe_steps`` kept on
the device for the check; one client in a closed loop.

Warm-up: a whole request for each padded length (step-graph key) the
plan's requests reach beyond the first one's, Vocos alone on each
generated length they reach, then the first request whole, which the
window sends again first; so the window builds, captures and allocates
nothing new.
"""

from __future__ import annotations

from benchmark import harness, trace
from benchmark.families.f5 import Served, shape


def _call(run, req):
    from tortoise_tpu_torch.pipeline.synthesize import synthesize

    return synthesize(run.models, tokens=req.tokens,
                      voice=run.plan.clips[req.voice], seed=req.seed,
                      compute_dtype=run.compute_dtype, stage_sync=True,
                      materialize=True, device=run.device,
                      probe_steps=tuple(run.mix["probe_steps"]))


def warm_set(run) -> tuple:
    """(requests reaching every padded length of the plan, one each;
    the generated lengths of the plan's requests)."""
    from tortoise_tpu_torch.pipeline import f5_stage

    pads, pick, gens = set(), [], set()
    for req in run.plan.requests:
        t, t_ref, _ = shape(run, req)
        gens.add(t - t_ref)
        if f5_stage.padded_frames(t) not in pads:
            pads.add(f5_stage.padded_frames(t))
            pick.append(req)
    return pick, sorted(gens)


def setup(run):
    import gc

    import torch

    from tortoise_tpu_torch.pipeline import vocos_stage

    pick, gens = warm_set(run)
    for req in pick[1:]:
        _call(run, req)
    m = run.models
    for n in gens:
        vocos_stage.vocos(m.vocos_params,
                          torch.zeros((1, m.vocos_cfg.n_mel, n),
                                      device=run.device),
                          m.vocos_cfg, run.device)
    _call(run, pick[0])
    harness.sync(run.device)
    gc.collect()
    return {"warmed": len(pick), "vocos_lengths": len(gens)}


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
    return Served(text=list(clip.text) + list(req.tokens), greedy=False,
                  ref_mel=clip.mel, ref_ids=list(clip.text),
                  gen_ids=list(req.tokens), seed=req.seed, audio=res.audio,
                  mel=res.mel, probes=res.probes)


def close(state):
    pass
