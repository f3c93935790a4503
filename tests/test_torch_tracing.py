"""The port's spans and counters (``tortoise_tpu_torch/utils/profiling.py``)
on tiny CPU models: they record only under an active ``torch.profiler``,
nest under the request span with one request id (in the caller's thread
and the server's worker), reach the profiler as unmirrored ``tt.``
ranges, hold every launch a request makes in a leaf span, count a
loop's graph steps where they happen, and give
``SynthesisResult.timings`` its walls with the same keys as before. The
device-clock intervals are checked with stand-in timing events."""

import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_graph_steps import FakeGraph, stub_cuda  # noqa: F401
from tortoise_tpu_torch import serve
from tortoise_tpu_torch.pipeline import graphs, streaming
from tortoise_tpu_torch.pipeline.synthesize import (
    TortoiseModels,
    synthesize,
    synthesize_batch,
)
from tortoise_tpu_torch.utils import profiling

torch.set_num_threads(1)  # several pytest workers share the cores

WAIT = 60  # seconds a future may take
TOKENS = [1, 5, 9, 0]
LEAVES = {"ar.cast", "ar.prefill", "ar.decode_loop", "ar.latent",
          "diffusion.cast", "diffusion.conditioner", "diffusion.denoise_loop",
          "vocoder.forward", "download"}
# SynthesisResult.timings' keys, as before the spans carried them
STAGE_KEYS = {"autoregressive_s", "diffusion_s", "vocoder_s"}
AR_KEYS = {"ar_cast_s", "ar_prefill_s", "ar_decode_loop_s",
           "ar_decode_steps", "ar_latent_s"}
DIFFUSION_KEYS = {"diffusion_cast_s", "diffusion_loop_s", "diffusion_steps"}


@pytest.fixture(scope="module")
def models():
    m = TortoiseModels.random(seed=0, tiny=True)
    m.ar_cfg = dataclasses.replace(m.ar_cfg, max_decode_steps=6,
                                   pad_mel_length=8)
    m.diffusion_cfg = dataclasses.replace(m.diffusion_cfg,
                                          n_sample_timesteps=4)
    return m


@pytest.fixture(scope="module")
def voice(models):
    return np.random.default_rng(3).normal(
        0, 0.5, (models.ar_cfg.d_model,)).astype(np.float32)


def _call(kind, models, voice, **kw):
    if kind == "batch":
        return synthesize_batch(models, tokens_list=[TOKENS, [1, 7, 0]],
                                voices=voice, seed=4, device="cpu", **kw)[0]
    return synthesize(models, tokens=TOKENS, voice=voice, seed=4,
                      sampler=kind, device="cpu", **kw)


def _profiled(fn):
    """fn() under a CPU profiler: (its value, the spans it recorded, the
    profiler)."""
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = profiling.records()
    profiling.clear()
    return out, spans, prof


def _ancestors(span, by_id):
    """The names of the spans above ``span``, innermost first."""
    out = []
    while span.parent is not None:
        span = by_id[span.parent]
        out.append(span.name)
    return out


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


@pytest.mark.parametrize("kind", ["jax", "reference", "batch"])
def test_spans_nest_under_the_request(models, voice, kind):
    """One request span, the three stage spans under it, each leaf under
    its stage (the batch path's conditioner and denoising loop inside its
    ``diffusion.sample``); every span carries the request span's id, and
    its host interval lies inside its parent's."""
    _, spans, _ = _profiled(lambda: _call(kind, models, voice))
    named = _by_name(spans)
    root_name = "synthesize_batch" if kind == "batch" else "synthesize"
    (root,) = named[root_name]
    assert root.parent is None and root.request == root.id
    by_id = {s.id: s for s in spans}
    assert all(s.request == root.id for s in spans)
    for stage in ("ar", "diffusion", "vocoder"):
        (s,) = named[stage]
        assert s.parent == root.id
    for s in spans:
        if s is not root:
            p = by_id[s.parent]
            assert p.t0 <= s.t0 <= s.t1 <= p.t1
    want = {"ar": ("ar.cast", "ar.prefill", "ar.decode_loop", "ar.latent"),
            "diffusion": ("diffusion.cast", "diffusion.conditioner",
                          "diffusion.denoise_loop"),
            "vocoder": ("vocoder.forward", "download")}
    for stage, leaves in want.items():
        for leaf in leaves:
            under = [s for s in named[leaf]
                     if stage in _ancestors(s, by_id)]
            assert under and all(LEAVES.isdisjoint(_ancestors(s, by_id))
                                 for s in under)
    sample = "diffusion.sample" if kind != "reference" else "diffusion"
    for leaf in ("diffusion.conditioner", "diffusion.denoise_loop"):
        assert by_id[named[leaf][0].parent].name == sample
    assert named["ar.decode_loop"][0].counters["steps"] >= 1
    assert named["diffusion.denoise_loop"][0].counters["steps"] == 4
    audio_s = named["vocoder.forward"][0].counters["audio_s"]
    assert audio_s > 0
    assert all(s.dev is None for s in spans)  # no card, no device clock


class _Launches(TorchDispatchMode):
    """Every op that is not a view, with the names of the spans open in
    this thread when it ran."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.ops.append((str(func),
                             [s.name for s in profiling._stack()]))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("kind", ["jax", "reference", "batch"])
def test_leaf_spans_hold_every_launch(models, voice, kind):
    """Each op a request runs (views aside, which launch nothing) runs
    inside a leaf span: only host glue falls between them."""
    mode = _Launches()

    def run():
        with mode:
            return _call(kind, models, voice)

    _profiled(run)
    assert len(mode.ops) > 100
    outside = [(op, names) for op, names in mode.ops
               if not LEAVES & set(names)]
    assert outside == []


@pytest.mark.parametrize("stage_sync", [True, False],
                         ids=["synced", "async"])
@pytest.mark.parametrize("kind", ["jax", "reference"])
def test_timings_keep_their_keys_and_read_the_spans(models, voice, kind,
                                                    stage_sync):
    """The same key sets as before the spans (sub-stage walls only when
    stage-synced; the reference plane's diffusion reports none), each
    wall the host duration of its span, and the same set unprofiled."""
    res, spans, _ = _profiled(
        lambda: _call(kind, models, voice, stage_sync=stage_sync))
    keys = set(STAGE_KEYS)
    if stage_sync:
        keys |= AR_KEYS | (DIFFUSION_KEYS if kind == "jax" else set())
    t = res.timings
    assert set(t) == keys
    named = {k: v[0] for k, v in _by_name(spans).items()}
    for key, name in (("autoregressive_s", "ar"),
                      ("diffusion_s", "diffusion"),
                      ("vocoder_s", "vocoder")):
        assert t[key] == named[name].s
    if stage_sync:
        for key, name in (("ar_cast_s", "ar.cast"),
                          ("ar_prefill_s", "ar.prefill"),
                          ("ar_decode_loop_s", "ar.decode_loop"),
                          ("ar_latent_s", "ar.latent")):
            assert t[key] == named[name].s
        assert t["ar_decode_steps"] \
            == named["ar.decode_loop"].counters["steps"] >= 1
    if stage_sync and kind == "jax":
        assert t["diffusion_cast_s"] == named["diffusion.cast"].s
        assert t["diffusion_loop_s"] == named["diffusion.sample"].s
        assert t["diffusion_steps"] == 4
    plain = _call(kind, models, voice, stage_sync=stage_sync)
    assert set(plain.timings) == keys
    assert all(v >= 0 for v in plain.timings.values())


def test_nothing_recorded_without_a_profiler(models, voice):
    """No profiler session: the ring stays empty and the counters go
    nowhere, yet the timings are filled."""
    profiling.clear()
    assert not torch.autograd.profiler._is_profiler_enabled
    res = _call("jax", models, voice)
    with profiling.span("outer") as s:
        profiling.count("n", 3)
    assert s.counters == {} and s.id is None and s.s >= 0
    assert profiling.records() == []
    assert set(res.timings) >= STAGE_KEYS | AR_KEYS | DIFFUSION_KEYS


def test_program_ranges_reach_the_profiler_unmirrored(models, voice):
    """The profile holds a ``tt.<name>`` CPU range for every span, none
    a user annotation (kineto mirrors those onto the device timeline)."""
    _, spans, prof = _profiled(lambda: _call("jax", models, voice))
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith(profiling.PREFIX)]
    assert sorted(e.name() for e in events) \
        == sorted(profiling.PREFIX + s.name for s in spans)
    assert not any(e.is_user_annotation() for e in events)
    assert {e.device_type() for e in events} \
        == {torch.autograd.DeviceType.CPU}


def test_graph_counters_on_the_loop_span(stub_cuda):  # noqa: F811
    """Each step of a graph loop counts once, on the span the loop runs
    in: a new entry warms up, captures, then replays; a second loop on
    it only replays. The warm-up and the capture are spans of their
    own."""
    tree = object()

    def loop(n):
        with profiling.span("loop") as sp:
            with graphs.stepping(True, ("k",), tree,
                                 lambda static: {"n": torch.zeros(())},
                                 lambda bufs: bufs["n"].add_(1)) \
                    as (bufs, run):
                for _ in range(n):
                    run()
        return sp

    def both():
        return loop(5), loop(3)

    (first, second), spans, _ = _profiled(both)
    assert first.counters == {"graph_warmups": 1, "graph_captures": 1,
                              "graph_replays": 3}
    assert second.counters == {"graph_warmups": 0, "graph_captures": 0,
                               "graph_replays": 3}
    named = _by_name(spans)
    assert [s.parent for s in named["graph.warmup"]] == [first.id]
    assert [s.parent for s in named["graph.capture"]] == [first.id]
    (g,) = [g for _, g in graphs.entries()]
    assert (g.warmups, g.captures, g.replays) == (1, 1, 6)
    # the capture's own run is a replay of the fake graph
    assert float(g.bufs["n"]) == 8 and FakeGraph.made[0].replays == 7


def test_server_records_queue_waits_and_batches(models, voice):
    """stats() counts each admitted request and sums its wait in the
    queue, from its submit to its admission; the worker thread records
    each batch, the batch's synthesize_batch under it with the batch
    span's request id."""
    server = serve.SynthesisServer(models, device="cpu", max_batch=4,
                                   max_wait_ms=200)

    def serve_two():
        with server:
            futs = [server.submit(tokens=TOKENS, voice=voice, seed=i)
                    for i in range(2)]
            for f in futs:
                f.result(timeout=WAIT)
            return futs, server.stats()

    t0 = time.monotonic()
    (futs, stats), spans, _ = _profiled(serve_two)
    elapsed = time.monotonic() - t0
    named = _by_name(spans)
    assert stats["admitted"] == 2 == stats["rows"]
    assert 0 <= stats["queue_wait_max_s"] <= stats["queue_wait_s"] \
        <= 2 * elapsed
    batches = named["serve.batch"]
    assert len(batches) == stats["batches"] \
        and all(s.parent is None for s in batches)
    batch_ids = {s.id for s in batches}
    for s in named["synthesize_batch"]:
        assert s.parent in batch_ids and s.request == s.parent
    assert all(s.request in batch_ids for s in spans)


def test_server_stats_without_a_profiler(models, voice):
    """The queue-wait sums are always on."""
    server = serve.SynthesisServer(models, device="cpu", max_batch=1)
    profiling.clear()
    with server:
        server.submit(tokens=TOKENS, voice=voice).result(timeout=WAIT)
        stats = server.stats()
    assert stats["admitted"] == 1
    assert stats["queue_wait_max_s"] == stats["queue_wait_s"] >= 0
    assert profiling.records() == []


def test_stream_spans_close_before_each_yield(models, voice):
    """A stream records its AR stage, one ``stream.window`` a window and
    one ``stream.chunk`` a chunk, each holding its download, and leaves
    no span open while the consumer holds a chunk."""
    def run():
        open_at_yield = []
        chunks = []
        for c in streaming.stream_synthesize(
                models, tokens=TOKENS, voice=voice, seed=2,
                window_frames=24, overlap_frames=8, first_window_frames=16,
                vocoder_margin=8, device="cpu"):
            open_at_yield.append(len(profiling._stack()))
            chunks.append(c)
        return chunks, open_at_yield

    (chunks, open_at_yield), spans, _ = _profiled(run)
    named = _by_name(spans)
    assert open_at_yield == [0] * len(chunks)
    assert len(named["stream.window"]) >= 1
    assert len(named["stream.chunk"]) == len(chunks)
    by_id = {s.id: s for s in spans}
    assert sorted(by_id[s.parent].name for s in named["download"]) \
        == sorted(["stream.window"] * len(named["stream.window"])
                  + ["stream.chunk"] * len(chunks))
    assert len(named["ar"]) == 1 and "ar.decode_loop" in named
    # the window's denoising loop counts its steps on the window span
    # only when it runs on a graph; on the CPU it runs eagerly
    assert all(s.parent is None for s in named["stream.window"])


class _Event:
    """A timing event at a fixed device time (ms)."""

    clock = [0.0]

    def __init__(self):
        _Event.clock[0] += 1.5
        self.at = _Event.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.at - self.at


def test_device_intervals_against_the_request_start(monkeypatch):
    """On a CUDA device each span takes a timing event at its start and
    end; ``records()`` gives its interval in seconds from its request
    span's start event, children inheriting the device."""
    monkeypatch.setattr(profiling, "_timing_event", lambda device: _Event())
    _Event.clock[0] = 100.0

    def run():
        with profiling.span("req", "cuda") as r:
            with profiling.span("leaf") as a:
                pass
            with profiling.span("leaf") as b:
                pass
        return r, a, b

    (r, a, b), spans, _ = _profiled(run)
    assert r.dev == (0.0, 7.5e-3) and a.dev == (1.5e-3, 3e-3)
    assert b.dev == (4.5e-3, 6e-3) and b.device == torch.device("cuda")

    def on_cpu():
        with profiling.span("x", "cpu") as x:
            pass
        return x

    x, _, _ = _profiled(on_cpu)
    assert x.dev is None and x._ref is None


def test_no_event_while_the_stream_captures(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    assert profiling._timing_event(torch.device("cuda")) is None


def test_the_ring_keeps_the_newest_spans(monkeypatch):
    """Past ``RING`` spans the oldest go; ``clear`` empties the ring."""
    monkeypatch.setattr(profiling, "_ring",
                        type(profiling._ring)(maxlen=3))

    def run():
        for i in range(5):
            with profiling.span(f"s{i}"):
                pass

    _, spans, _ = _profiled(run)
    assert [s.name for s in spans] == ["s2", "s3", "s4"]
    assert profiling.records() == []


def test_spans_of_two_threads_keep_their_own_requests():
    """Each thread's outermost span starts its own request."""
    got = {}

    def work(name):
        with profiling.span(name) as r:
            with profiling.span("inner") as i:
                got[name] = (r, i)

    def run():
        ts = [threading.Thread(target=work, args=(n,)) for n in "ab"]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=WAIT)
        return [t.is_alive() for t in ts]

    alive, spans, _ = _profiled(run)
    assert alive == [False, False] and len(spans) == 4
    for r, i in got.values():
        assert r.request == r.id and i.parent == r.id == i.request
    assert got["a"][0].request != got["b"][0].request


def test_trace_writes_the_program_ranges(tmp_path, models, voice):
    """``trace(dir)`` around a call: the Chrome trace holds the program's
    ``tt.`` ranges beside the ops."""
    with profiling.trace(str(tmp_path)):
        _call("jax", models, voice)
    (f,) = os.listdir(tmp_path)
    with open(tmp_path / f) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    assert {"tt.synthesize", "tt.ar.decode_loop", "tt.download"} <= names


class _OneRequestHttp:
    """Stands in for the HTTP front end: serving sends one request
    through the server and returns."""

    server_address = ("127.0.0.1", 0)

    def __init__(self, server):
        self.server = server

    def serve_forever(self):
        self.server.submit(tokens=TOKENS).result(timeout=WAIT)

    def server_close(self):
        pass


def test_server_main_traces_its_worker(monkeypatch, tmp_path):
    """With ``TORTOISE_TRACE_DIR`` set the server serves under the
    profiler and writes a Chrome trace when it stops, holding the
    worker thread's batch and request ranges."""
    monkeypatch.setattr(serve, "make_http_server",
                        lambda server, host, port: _OneRequestHttp(server))
    monkeypatch.setenv("TORTOISE_TRACE_DIR", str(tmp_path))
    assert serve.main(["--random-weights", "--tiny", "--device", "cpu"]) == 0
    (f,) = os.listdir(tmp_path)
    with open(tmp_path / f) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    assert {"tt.serve.batch", "tt.synthesize_batch",
            "tt.ar.decode_loop", "tt.vocoder.forward"} <= names
