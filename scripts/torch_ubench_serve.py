#!/usr/bin/env python3
"""Load test of the port's dynamic-batching server
(``tortoise_tpu_torch/serve.py``), the counterpart of
``scripts/ubench_serve.py``:

    python3 scripts/torch_ubench_serve.py [n_requests] [rate_per_s] \\
        [max_batch] [max_wait_ms]                      # the card
    python3 scripts/torch_ubench_serve.py 4 50 2 20 --device cpu --small

Submits ``n_requests`` (32) requests with Poisson arrivals at
``rate_per_s`` (2.0) to a ``SynthesisServer`` (``max_batch`` 8,
``max_wait_ms`` 100) on production-size random weights (bf16 + int8;
the bench's weight cache, ``bench.weights_dir``, serves a second run)
and reports the wall, the audio seconds, the aggregate RTF (wall / audio
seconds), latency percentiles from submit to result, and the batches,
mean rows and padded rows of the timed window (``stats()`` deltas).

The request mix comes from one ``numpy.random.default_rng(seed)``, drawn
in the JAX script's order (``request_plan``): the default voice, every
request's tokens on the main thread, then the arrival times.

Warmup: ``server.warmup()``, one single-row batch (the weight casts,
the kernel build, the first calls), as the server's own. ``--warm-check``
instead times that warmup and then two batches of ``max_batch`` rows
back to back, and stops: the first batch's wall over the second's is
what a first batch at that size still pays after the single-row warmup
(the JAX script warms one batch per B bucket for its compiles; eager
PyTorch compiles nothing).

The last line is ``{"serve": {...}}`` with every number printed and the
launch counts since the start.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ubench_common as U  # noqa: E402

SMALL_LENGTHS = (4, 16)  # the tiny config has 24 text positions


def request_plan(n: int, rate: float, vocab: int, d_model: int,
                 seed: int = 0, lengths=(16, 30)):
    """(voice (d_model,) f32, n token lists, n cumulative arrival delays
    in seconds), drawn from one ``default_rng(seed)`` in the JAX
    script's order: the voice N(0, 0.5), then each request's [start] +
    ``lengths`` (16-29) ids in [3, vocab) + [0] (its length drawn before
    its ids), then the exponential gaps at ``rate`` per second."""
    rng = np.random.default_rng(seed)
    voice = rng.normal(0, 0.5, (d_model,)).astype(np.float32)
    start_tok = min(255, vocab - 1)
    tokens = []
    for _ in range(n):
        size = int(rng.integers(*lengths))
        tokens.append([start_tok] + rng.integers(3, vocab, size=size)
                      .tolist() + [0])
    delays = np.cumsum(rng.exponential(1.0 / rate, n))
    return voice, tokens, delays


def run(models, n_requests: int = 32, rate: float = 2.0, max_batch: int = 8,
        max_wait_ms: float = 100.0, device=None, card: str = "",
        lengths=(16, 30)) -> dict:
    """The load test on ``models`` (host trees; the server casts them to
    bf16 + int8 on ``device``), ``lengths`` as in ``request_plan``.
    Returns the numbers it printed."""
    import torch

    from tortoise_tpu_torch import serve

    voice, tokens, delays = request_plan(
        n_requests, rate, models.ar_cfg.n_text_vocab, models.ar_cfg.d_model,
        lengths=lengths)
    server = serve.SynthesisServer(
        models, compute_dtype=torch.bfloat16, int8_weights=True,
        max_batch=max_batch, max_wait_ms=max_wait_ms, default_voice=voice,
        device=device)
    lat, audio_s, errors = [], [0.0], []
    lock = threading.Lock()

    def client(i, delay):
        time.sleep(delay)
        t = time.monotonic()
        try:
            r = server.submit(tokens=tokens[i], seed=i).result()
        except Exception as e:  # reported below; the run then fails
            with lock:
                errors.append(repr(e))
            return
        dt = time.monotonic() - t
        with lock:
            if not np.isfinite(r.audio).all() or r.audio.size == 0:
                errors.append(f"request {i}: empty or non-finite audio")
            lat.append(dt)
            audio_s[0] += len(r.audio) / r.sample_rate

    with server:  # stopped (queue drained) on the way out
        t0 = time.monotonic()
        server.warmup()
        warm = time.monotonic() - t0
        print(f"warmup: {warm:.3f} s [{card}]", flush=True)
        base = server.stats()
        threads = [threading.Thread(target=client, args=(i, d))
                   for i, d in enumerate(delays)]
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.monotonic() - t0
    if errors:
        raise RuntimeError(f"{len(errors)} requests failed: {errors[:3]}")
    st = server.stats()
    batches = st["batches"] - base["batches"]
    rows = st["rows"] - base["rows"]
    lat = np.sort(lat)
    out = dict(
        n_requests=n_requests, rate_per_s=rate, max_batch=max_batch,
        max_wait_ms=max_wait_ms, warmup_s=warm, wall_s=wall,
        audio_s=audio_s[0],
        aggregate_rtf=wall / max(audio_s[0], 1e-9),
        p50_s=float(np.percentile(lat, 50)),
        p90_s=float(np.percentile(lat, 90)),
        p99_s=float(np.percentile(lat, 99)), max_s=float(lat[-1]),
        batches=batches, mean_rows=rows / max(batches, 1),
        padded_rows=st["padded_rows"] - base["padded_rows"],
        failed_batches=st["failed_batches"] - base["failed_batches"])
    print(f"requests={n_requests} arrival={rate}/s wall={wall:.3f}s "
          f"audio={audio_s[0]:.3f}s aggregate_rtf={out['aggregate_rtf']:.5f} "
          f"[{card}]", flush=True)
    print(f"latency p50={out['p50_s']:.3f}s p90={out['p90_s']:.3f}s "
          f"p99={out['p99_s']:.3f}s max={out['max_s']:.3f}s; "
          f"batches={batches} mean_rows={out['mean_rows']:.2f} "
          f"padded_rows={out['padded_rows']} [{card}]", flush=True)
    return out


def warm_check(models, max_batch: int = 8, device=None, card: str = "",
               lengths=(16, 30)) -> dict:
    """``server.warmup()`` and then two batches of ``max_batch`` rows of
    the plan's first texts, each timed from submit to its last result."""
    import torch

    from tortoise_tpu_torch import serve

    voice, tokens, _ = request_plan(
        2 * max_batch, 2.0, models.ar_cfg.n_text_vocab,
        models.ar_cfg.d_model, lengths=lengths)
    server = serve.SynthesisServer(
        models, compute_dtype=torch.bfloat16, int8_weights=True,
        max_batch=max_batch, default_voice=voice, device=device)
    with server:
        t0 = time.monotonic()
        server.warmup()
        out = dict(warmup_s=time.monotonic() - t0, max_batch=max_batch)
        for k in (1, 2):
            t0 = time.monotonic()
            futs = [server.submit(tokens=t, seed=i) for i, t in enumerate(
                tokens[(k - 1) * max_batch:k * max_batch])]
            for f in futs:
                f.result()
            out[f"batch_{k}_s"] = time.monotonic() - t0
        out["batches"] = server.stats()["batches"]
    print(f"warm check: warmup {out['warmup_s']:.3f} s, then batches of "
          f"{max_batch} rows {out['batch_1_s']:.3f} s and "
          f"{out['batch_2_s']:.3f} s ({out['batches']} batches) [{card}]",
          flush=True)
    return out


def main(argv=None) -> dict:
    """Parse ``argv``, run the load test, print the JSON line; returns
    its object."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_requests", type=int, nargs="?", default=32)
    ap.add_argument("rate", type=float, nargs="?", default=2.0)
    ap.add_argument("max_batch", type=int, nargs="?", default=8)
    ap.add_argument("max_wait_ms", type=float, nargs="?", default=100.0)
    ap.add_argument("--warm-check", action="store_true",
                    help="time the warmup and two max_batch batches, then "
                         "stop")
    U.add_device_args(ap)
    args = ap.parse_args(argv)
    dev, card = U.start(args.device)
    import dataclasses

    from tortoise_tpu_torch.bench import build_models

    models, _ = build_models(args.small, True, int8=True, device=dev)
    if args.small:
        models.diffusion_cfg = dataclasses.replace(models.diffusion_cfg,
                                                   n_sample_timesteps=4)
    lengths = SMALL_LENGTHS if args.small else (16, 30)
    if args.warm_check:
        result = warm_check(models, args.max_batch, dev, card, lengths)
    else:
        result = run(models, args.n_requests, args.rate, args.max_batch,
                     args.max_wait_ms, dev, card, lengths)
    return U.emit("serve", result, dev, card, args.small)


if __name__ == "__main__":
    main()
