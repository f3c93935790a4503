"""The port's dynamic-batching server (``tortoise_tpu_torch/serve.py``):
the behaviours tests/test_serve.py pins on the JAX package — B-bucket
padding, batching, validation, error isolation, worker death, mixed
sampler settings, cancelled futures, streams beside batches, the HTTP
front end — on tiny CPU models, plus the chunked-request-body answer
(411 on a closing connection) the JAX front end lacks.

Every future and HTTP call waits at most 60 s, so a hang fails the test
instead of eating the suite's time.
"""

import dataclasses
import http.client
import json
import socket
import threading

import numpy as np
import pytest
import torch

from tortoise_tpu_torch import serve
from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels

# the suite runs several pytest workers on the same cores; torch's
# OpenMP pool at its default width in each of them oversubscribes the CPU
# (the tiny models' ops then run ~10x slower), so one thread a process
torch.set_num_threads(1)

WAIT = 60  # seconds


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


def _tokens(rng, n):
    # in-vocab for the tiny 32-entry text vocab
    return [1] + rng.integers(3, 30, size=n).tolist() + [0]


def _server(models, **kw):
    return serve.SynthesisServer(models, device="cpu", **kw)


class _Http:
    """A started SynthesisServer behind the HTTP front end on an
    ephemeral port; stops both on exit."""

    def __init__(self, server, drain=True):
        self.server, self.drain = server, drain

    def __enter__(self):
        self.server.start()
        self.httpd = serve.make_http_server(self.server, "127.0.0.1", 0)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        return self

    def conn(self):
        return http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=WAIT)

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.server.stop(drain=self.drain)


def _post(conn, path, obj):
    conn.request("POST", path, json.dumps(obj),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp, resp.read()


def test_bucketing(models):
    s = _server(models, max_batch=16)
    assert [s._bucket(n) for n in (1, 2, 3, 5, 8, 9, 16, 99)] == \
        [1, 2, 4, 8, 8, 16, 16, 16]
    with pytest.raises(ValueError):
        _server(models, max_batch=32)  # above the largest bucket
    with pytest.raises(ValueError):
        _server(models, max_batch=0)


def test_batched_requests(models, voice):
    """Concurrent ragged submits land in one batch padded to its bucket;
    every future resolves with audio of its own mel's length; pad rows
    never surface."""
    rng = np.random.default_rng(0)
    server = _server(models, max_batch=8, max_wait_ms=3000,
                     default_voice=voice)
    rows = [_tokens(rng, 3 + 2 * i) for i in range(5)]
    with server:
        futs = [server.submit(tokens=t, seed=7) for t in rows]
        results = [f.result(timeout=WAIT) for f in futs]
    assert [r.tokens for r in results] == rows
    for r in results:
        assert r.sample_rate == models.vocoder_cfg.sample_rate
        assert r.mel is None and r.latents == [None]  # serving mode
        assert np.isfinite(r.audio).all() and len(r.audio) > 0
        assert (len(r.audio) + 6) % models.vocoder_cfg.total_upsample == 0
    st = server.stats()
    assert (st["batches"], st["rows"], st["padded_rows"],
            st["failed_batches"]) == (1, 5, 3, 0)  # 5 rows -> bucket 8


def test_submit_validation(models, voice):
    """Malformed input fails its own submit() call and never reaches the
    queue."""
    from tortoise_tpu_torch.pipeline.ar_stage import TEXT_BUCKETS

    server = _server(models, default_voice=voice)
    with server:
        with pytest.raises(ValueError, match="voice latent"):
            server.submit(tokens=[1, 5, 0],
                          voice=np.zeros((3,), np.float32))
        with pytest.raises(ValueError, match="text too long"):
            server.submit(tokens=[3] * (max(TEXT_BUCKETS) + 1))
        with pytest.raises(ValueError, match="empty"):
            server.submit(tokens=[])
        with pytest.raises(ValueError, match="outside vocab"):
            server.submit(tokens=[255, 5, 0])  # the tiny vocab is 32
        with pytest.raises(ValueError, match="pass message or tokens"):
            server.submit()
        with pytest.raises(ValueError, match="tokenizer"):
            server.submit(message="no tokenizer here")
    assert server.stats()["rows"] == 0
    no_voice = _server(models)
    with no_voice:
        with pytest.raises(ValueError, match="default_voice"):
            no_voice.submit(tokens=[1, 5, 0])


def test_error_isolation(models, voice, monkeypatch):
    """A failing batch resolves its futures with the exception and the
    worker keeps serving."""
    rng = np.random.default_rng(1)
    real = serve.synthesize_batch
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected batch failure")
        return real(*args, **kwargs)

    monkeypatch.setattr(serve, "synthesize_batch", flaky)
    server = _server(models, max_batch=2, max_wait_ms=10,
                     default_voice=voice)
    with server:
        bad = server.submit(tokens=_tokens(rng, 4))
        with pytest.raises(RuntimeError, match="injected"):
            bad.result(timeout=WAIT)
        good = server.submit(tokens=_tokens(rng, 4))
        assert len(good.result(timeout=WAIT).audio) > 0
    assert server.stats()["failed_batches"] == 1


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_worker_death_fails_futures_not_hangs(models, voice, monkeypatch):
    """A defect outside the per-batch isolation fails every outstanding
    future and closes the server; stop(drain=True) still returns."""
    rng = np.random.default_rng(5)

    def boom(self, batch, sampler):
        raise AttributeError("injected worker defect")

    monkeypatch.setattr(serve.SynthesisServer, "_run_batch", boom)
    server = _server(models, max_batch=4, max_wait_ms=2000,
                     default_voice=voice)
    with server:
        futs = [server.submit(tokens=_tokens(rng, 4 + i)) for i in range(3)]
        for f in futs:
            with pytest.raises(AttributeError, match="injected"):
                f.result(timeout=30)
        with pytest.raises(RuntimeError):
            server.submit(tokens=_tokens(rng, 4))  # closed to new submits
        with pytest.raises(RuntimeError):
            server.stream(tokens=_tokens(rng, 4))


def test_warmup_runs_every_reachable_bucket(models, voice, monkeypatch):
    """warmup() runs one single-row batch directly (the queue and the
    stats untouched): eager PyTorch specializes on no batch size, so that
    one batch serves every reachable B bucket. It needs a default
    voice."""
    seen = []
    real = serve.synthesize_batch

    def spy(*args, **kwargs):
        seen.append(len(kwargs["tokens_list"]))
        return real(*args, **kwargs)

    monkeypatch.setattr(serve, "synthesize_batch", spy)
    server = _server(models, max_batch=3, max_wait_ms=10,
                     default_voice=voice)
    with server:
        server.warmup()
    assert seen == [1]
    st = server.stats()
    assert st["rows"] == 0 and st["queued"] == 0
    no_voice = _server(models, max_batch=2)
    with no_voice:
        with pytest.raises(ValueError, match="default_voice"):
            no_voice.warmup()


def test_submit_requires_start(models, voice):
    server = _server(models, default_voice=voice)
    with pytest.raises(RuntimeError):
        server.submit(tokens=[1, 5, 0])
    server.start()
    with pytest.raises(RuntimeError, match="already started"):
        server.start()
    server.stop()
    server.stop()  # a second stop is a no-op
    with pytest.raises(RuntimeError):
        server.submit(tokens=[1, 5, 0])


def test_mixed_sampler_settings_split_batches(models, voice):
    """One admission window with two sampler settings runs as one batch
    per setting; top_k > 128 is accepted (the plain sampler's route)."""
    rng = np.random.default_rng(1)
    toks = _tokens(rng, 5)
    server = _server(models, max_batch=4, max_wait_ms=3000,
                     default_voice=voice)
    with server:
        futs = [server.submit(tokens=toks, seed=9),
                server.submit(tokens=toks, seed=9, temperature=5.0,
                              top_k=200, repetition_penalty=1.0),
                server.submit(tokens=toks, seed=9)]
        results = [f.result(timeout=WAIT) for f in futs]
    assert all(len(r.audio) > 0 for r in results)
    st = server.stats()
    assert (st["rows"], st["batches"], st["padded_rows"],
            st["failed_batches"]) == (3, 2, 0, 0)


def test_submit_rejects_bad_sampler(models, voice):
    server = _server(models, default_voice=voice)
    with server:
        for kw in ({"temperature": 0.0}, {"top_k": 0},
                   {"top_p_drop": 1.5}):
            with pytest.raises(ValueError):
                server.submit(tokens=[1, 4, 0], **kw)


def test_out_of_range_seed_rejected_at_submit(models, voice):
    server = _server(models, default_voice=voice)
    with server:
        with pytest.raises(ValueError, match="seed"):
            server.submit(tokens=[1, 4, 0], seed=2 ** 64)
        with pytest.raises(ValueError, match="seed"):
            server.stream(tokens=[1, 4, 0], seed=-(2 ** 70))
        ok = server.submit(tokens=[1, 4, 0], seed=2 ** 62)
        assert len(ok.result(timeout=WAIT).audio) > 0
    assert server.stats()["failed_batches"] == 0


def test_cancelled_future_skipped_not_fatal(models, voice, monkeypatch):
    """A future the client cancelled while queued drops out of its batch;
    the worker survives and stop(drain=True) returns."""
    gate, entered = threading.Event(), threading.Event()
    real = serve.synthesize_batch
    calls = {"n": 0}

    def gated(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            entered.set()
            assert gate.wait(timeout=WAIT)
        return real(*args, **kwargs)

    monkeypatch.setattr(serve, "synthesize_batch", gated)
    rng = np.random.default_rng(9)
    server = _server(models, max_batch=2, max_wait_ms=10,
                     default_voice=voice)
    with server:
        blocker = server.submit(tokens=_tokens(rng, 4))
        assert entered.wait(timeout=WAIT)
        doomed = server.submit(tokens=_tokens(rng, 4))
        assert doomed.cancel()
        survivor = server.submit(tokens=_tokens(rng, 4))
        gate.set()
        assert len(blocker.result(timeout=WAIT).audio) > 0
        assert len(survivor.result(timeout=WAIT).audio) > 0
        assert doomed.cancelled()
    st = server.stats()
    assert st["failed_batches"] == 0 and st["rows"] == 2


def test_stop_without_drain_fails_queued_requests(models, voice,
                                                  monkeypatch):
    gate, entered = threading.Event(), threading.Event()
    real = serve.synthesize_batch

    def gated(*args, **kwargs):
        entered.set()
        assert gate.wait(timeout=WAIT)
        return real(*args, **kwargs)

    monkeypatch.setattr(serve, "synthesize_batch", gated)
    rng = np.random.default_rng(4)
    server = _server(models, max_batch=1, max_wait_ms=0,
                     default_voice=voice).start()
    running = server.submit(tokens=_tokens(rng, 4))
    assert entered.wait(timeout=WAIT)
    queued = server.submit(tokens=_tokens(rng, 4))
    stopper = threading.Thread(target=server.stop, kwargs={"drain": False})
    stopper.start()
    gate.set()
    stopper.join(timeout=WAIT)
    assert not stopper.is_alive()
    assert len(running.result(timeout=WAIT).audio) > 0
    with pytest.raises(serve.ServerStopped, match="stopped"):
        queued.result(timeout=WAIT)


def test_voice_forms(models, tmp_path):
    """A voice path, a bare name and a file name in voice_dir resolve to
    the same latent."""
    d = models.ar_cfg.d_model
    lat = np.random.default_rng(4).normal(0, 0.5, (d,)).astype(np.float32)
    lat.tofile(tmp_path / "mol.bin")
    server = _server(models, voice_dir=str(tmp_path))
    for name in ("mol", "mol.bin", str(tmp_path / "mol.bin")):
        np.testing.assert_array_equal(server._load_voice(name), lat)
    with_default = _server(models, voice_dir=str(tmp_path),
                           default_voice="mol")
    np.testing.assert_array_equal(with_default.default_voice, lat)


def test_stream_beside_batches(models, voice):
    """server.stream() yields ordered chunks that concatenate to one
    utterance; a batch in flight beside it completes; streams are not
    batch rows."""
    rng = np.random.default_rng(5)
    server = _server(models, max_batch=2, max_wait_ms=50,
                     default_voice=voice)
    with server:
        fut = server.submit(tokens=_tokens(rng, 4), seed=3)
        chunks = list(server.stream(tokens=_tokens(rng, 5), seed=7,
                                    window_frames=24, overlap_frames=8,
                                    first_window_frames=16))
        batch_result = fut.result(timeout=WAIT)
    assert chunks and chunks[-1].final
    assert not any(c.final for c in chunks[:-1])
    total = np.concatenate([c.audio for c in chunks])
    assert total.dtype == np.float32 and np.isfinite(total).all()
    assert (len(total) + 6) % models.vocoder_cfg.total_upsample == 0
    assert len(batch_result.audio) > 0
    st = server.stats()
    assert st.get("streams") == 1 and st.get("streams_completed") == 1
    assert st["rows"] == 1


def test_stream_validation(models, voice):
    server = _server(models)  # no default voice
    with pytest.raises(RuntimeError):
        server.stream(tokens=[1, 4, 0])  # not started
    with server:
        bad = [dict(), dict(tokens=[1, 4, 0]),
               dict(tokens=[1, 4, 0], voice=voice, temperature=0.0),
               dict(tokens=[], voice=voice),
               dict(tokens=[999_999], voice=voice),
               dict(tokens=[1, 4, 0], voice=voice, window_frames=16,
                    overlap_frames=16),
               dict(tokens=[1, 4, 0], voice=voice, window_frames=24,
                    overlap_frames=8, first_window_frames=8),
               dict(tokens=[1, 4, 0], voice=voice, vocoder_margin=-1)]
        for kw in bad:
            with pytest.raises(ValueError):
                server.stream(**kw)  # at call time, before any next()
    assert server.stats().get("streams") is None


def test_stream_does_not_starve_batches(models, voice):
    """A stream paused between chunks (a slow client) holds no device
    lock: a batch submitted meanwhile completes first."""
    rng = np.random.default_rng(11)
    server = _server(models, max_batch=2, max_wait_ms=10,
                     default_voice=voice)
    with server:
        gen = server.stream(tokens=_tokens(rng, 5), seed=1, window_frames=8,
                            overlap_frames=2, first_window_frames=4,
                            vocoder_margin=2)
        assert len(next(gen).audio) > 0
        res = server.submit(tokens=_tokens(rng, 4), seed=2) \
            .result(timeout=WAIT)
        assert len(res.audio) > 0
        rest = list(gen)
    assert rest and rest[-1].final
    st = server.stats()
    assert st.get("streams_completed") == 1 and st["rows"] == 1


def test_two_streams_interleave(models, voice):
    rng = np.random.default_rng(19)
    server = _server(models, default_voice=voice)
    kw = dict(window_frames=8, overlap_frames=2, first_window_frames=4,
              vocoder_margin=2)
    with server:
        gens = [server.stream(tokens=_tokens(rng, 5), seed=s, **kw)
                for s in (1, 2)]
        got = [[], []]
        live = [True, True]
        while any(live):
            for i, g in enumerate(gens):
                if live[i]:
                    try:
                        got[i].append(next(g))
                    except StopIteration:
                        live[i] = False
    a1, a2 = (np.concatenate([c.audio for c in cs]) for cs in got)
    assert got[0][-1].final and got[1][-1].final
    assert len(a1) != len(a2) or not np.array_equal(a1, a2)
    assert server.stats().get("streams_completed") == 2


def test_serving_chaos_mix(models, voice):
    """Submits with two sampler settings, a live stream and a malformed
    request at once: the good futures resolve, the bad one fails alone."""
    rng = np.random.default_rng(23)
    server = _server(models, max_batch=4, max_wait_ms=50,
                     default_voice=voice)
    with server:
        gen = server.stream(tokens=_tokens(rng, 5), seed=9, window_frames=8,
                            overlap_frames=2, first_window_frames=4,
                            vocoder_margin=2)
        chunks = [next(gen)]
        futs = [server.submit(tokens=_tokens(rng, 4 + i), seed=i,
                              **({} if i % 2 else {"temperature": 1.1,
                                                   "top_k": 9}))
                for i in range(6)]
        with pytest.raises(ValueError):
            server.submit(tokens=[10 ** 9])
        results = [f.result(timeout=WAIT) for f in futs]
        chunks += list(gen)
    assert all(len(r.audio) > 0 for r in results)
    assert chunks[-1].final
    st = server.stats()
    assert st["rows"] == 6 and st["failed_batches"] == 0
    assert st["batches"] >= 2 and st.get("streams_completed") == 1


def test_stop_during_a_stream(models, voice):
    """A stream in flight when stop() lands raises RuntimeError at its
    next chunk; a stream asked for after stop() is refused at call
    time."""
    rng = np.random.default_rng(13)
    server = _server(models, default_voice=voice).start()
    gen = server.stream(tokens=_tokens(rng, 5), seed=1, window_frames=8,
                        overlap_frames=2, first_window_frames=4,
                        vocoder_margin=2)
    assert len(next(gen).audio) > 0
    server.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        next(gen)
    with pytest.raises(RuntimeError):
        server.stream(tokens=_tokens(rng, 4), seed=2)
    assert server.stats().get("streams_completed") is None


def test_http_synthesize_and_healthz(models, voice):
    rng = np.random.default_rng(2)
    with _Http(_server(models, max_batch=2, max_wait_ms=10,
                       default_voice=voice)) as h:
        conn = h.conn()
        resp, body = _post(conn, "/synthesize",
                           {"tokens": _tokens(rng, 4), "seed": 1})
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "audio/wav"
        assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
        samples = np.frombuffer(body[44:], dtype=np.float32)  # f32 WAV
        assert int.from_bytes(body[40:44], "little") == 4 * len(samples)
        assert np.isfinite(samples).all()
        assert (len(samples) + 6) % models.vocoder_cfg.total_upsample == 0
        conn.request("GET", "/healthz")  # the same keep-alive connection
        r = conn.getresponse()
        health = json.loads(r.read())
        assert r.status == 200 and health["ok"]
        assert health["stats"]["rows"] == 1
        for bad in ({}, {"tokens": [1, 999, 0]},
                    {"tokens": [1, 4, 0], "seed": "x"}):
            resp, body = _post(conn, "/synthesize", bad)
            assert resp.status == 400 and "error" in json.loads(body)
        resp, body = _post(conn, "/synthesize", [1, 2])
        assert resp.status == 400
        resp, body = _post(conn, "/nope", {})
        assert resp.status == 404
        conn.request("GET", "/nope")
        r = conn.getresponse()
        r.read()
        assert r.status == 404


def test_http_batch_failure_is_500(models, voice, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("injected synthesis failure")

    monkeypatch.setattr(serve, "synthesize_batch", boom)
    rng = np.random.default_rng(5)
    with _Http(_server(models, max_batch=2, max_wait_ms=10,
                       default_voice=voice), drain=False) as h:
        resp, body = _post(h.conn(), "/synthesize",
                           {"tokens": _tokens(rng, 4)})
        assert resp.status == 500
        assert "injected" in json.loads(body)["error"]


def test_http_stream_failure_is_500_and_stopped_server_is_503(
        models, voice, monkeypatch):
    """Only a stopped server is a retryable 503. A RuntimeError raised by
    the synthesis itself (as CUDA faults and kernel build failures are)
    in a stream's first window is a 500."""
    from tortoise_tpu_torch.pipeline import streaming

    def broken(*args, **kwargs):
        raise RuntimeError("injected first-window failure")
        yield  # a generator, like stream_synthesize

    monkeypatch.setattr(streaming, "stream_synthesize", broken)
    rng = np.random.default_rng(6)
    with _Http(_server(models, default_voice=voice)) as h:
        conn = h.conn()
        resp, body = _post(conn, "/stream", {"tokens": _tokens(rng, 4)})
        assert resp.status == 500
        assert "injected" in json.loads(body)["error"]
        h.server.stop()
        for path in ("/synthesize", "/stream"):
            resp, body = _post(conn, path, {"tokens": _tokens(rng, 4)})
            assert resp.status == 503, path
            assert "not started" in json.loads(body)["error"]


def test_http_stream_endpoint(models, voice):
    """POST /stream: a chunked streaming-WAV body (unknown-length RIFF
    header, then float32 frames) of one utterance; bad input is a 400
    before the 200 goes out; JSON null on first_window_frames means
    uniform windows, on another geometry key a 400 naming it."""
    rng = np.random.default_rng(8)
    with _Http(_server(models, max_batch=2, max_wait_ms=10,
                       default_voice=voice)) as h:
        conn = h.conn()
        for first in (16, None):
            resp, body = _post(conn, "/stream", {
                "tokens": _tokens(rng, 5), "seed": 2, "window_frames": 24,
                "overlap_frames": 8, "first_window_frames": first})
            assert resp.status == 200
            assert resp.getheader("Transfer-Encoding") == "chunked"
            assert resp.getheader("Content-Type") == "audio/wav"
            assert body[:4] == b"RIFF" and body[8:12] == b"WAVE"
            assert body[4:8] == b"\xff\xff\xff\xff"
            samples = np.frombuffer(body[44:], dtype=np.float32)
            assert len(samples) > 0 and np.isfinite(samples).all()
            assert (len(samples) + 6) % \
                models.vocoder_cfg.total_upsample == 0
        for bad, field in (({"temperature": 0.0}, "sampler"),
                           ({"tokens": [1, 4, 0], "window_frames": None},
                            "window_frames"),
                           ({"tokens": [1, 4, 0], "overlap_frames": 1.5},
                            "overlap_frames")):
            resp, body = _post(conn, "/stream", bad)
            assert resp.status == 400, body
            assert field in json.loads(body)["error"]
    assert h.server.stats().get("streams") == 2


def test_http_chunked_request_body_is_411_and_closes(models, voice):
    """A request body sent with Transfer-Encoding: chunked has no
    Content-Length. The front end answers 411 and closes the connection,
    so the unread chunk bytes are never parsed as a next request."""
    with _Http(_server(models, default_voice=voice)) as h:
        payload = json.dumps({"tokens": [1, 4, 0]}).encode()
        raw = (b"POST /synthesize HTTP/1.1\r\nHost: x\r\n"
               b"Content-Type: application/json\r\n"
               b"Transfer-Encoding: chunked\r\n\r\n"
               + f"{len(payload):x}\r\n".encode() + payload
               + b"\r\n0\r\n\r\n"
               # a pipelined request the server must not answer
               + b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        with socket.create_connection(("127.0.0.1", h.port),
                                      timeout=WAIT) as s:
            s.sendall(raw)
            got = b""
            while True:
                part = s.recv(65536)
                if not part:
                    break  # the server closed the connection
                got += part
        head, _, body = got.partition(b"\r\n\r\n")
        assert head.startswith(b"HTTP/1.1 411")
        assert b"Connection: close" in head
        assert got.count(b"HTTP/1.1") == 1  # the GET was never served
        assert "Content-Length" in json.loads(body)["error"]
        assert h.server.stats()["rows"] == 0


def test_http_oversized_body_is_413(models, voice):
    with _Http(_server(models, default_voice=voice)) as h:
        conn = h.conn()
        conn.putrequest("POST", "/synthesize")
        conn.putheader("Content-Length", str(serve.MAX_BODY + 1))
        conn.endheaders()
        r = conn.getresponse()
        assert r.status == 413 and r.getheader("Connection") == "close"


def test_main_refuses_cuda_without_a_card(monkeypatch):
    """The server's --device defaults to cuda and never falls back to the
    CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert serve.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.main(["--random-weights", "--tiny"])


# ---- the server on the card at full width (cuda-marked; skip here) ----


@pytest.fixture(scope="module")
def card_models():
    """TortoiseModels.random(0) at the published widths, the denoiser on
    its kernel (the server turns it on on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return TortoiseModels.random(0, diffusion={"use_flash": True})


@pytest.mark.cuda
def test_http_batch_on_card_launches_a_b_and_c(card_models, tmp_path):
    """Six concurrent POST /synthesize (3 text lengths in the 32-bucket, 2
    voice files) form ONE batch padded to 8 on the bf16 + int8 plane:
    every reply a WAV of its row's one-shot length with finite samples;
    the batch launches A, B and C (its prefill and latent passes)."""
    from test_torch_device import STANDIN_TOKENS, assert_launched
    from torch_mesh_ranks import card_audio_length

    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    voices = []
    for i in range(2):
        path = str(tmp_path / f"voice{i}.bin")
        np.random.default_rng(10 + i).normal(0, 0.5, (1024,)).astype(
            np.float32).tofile(path)
        voices.append(path)
    # the two rows of one length differ in one id, so every reply maps to
    # its own row
    bodies = [{"tokens": [255, 20 + i % 2] + STANDIN_TOKENS[2:n - 1] + [0],
               "voice": voices[i % 2], "seed": 4}
              for i, n in enumerate((30, 30, 22, 22, 14, 14))]
    server = serve.SynthesisServer(card_models, compute_dtype=torch.bfloat16,
                                   int8_weights=True, max_batch=8,
                                   max_wait_ms=2000, device="cuda")
    futures, submit = [], server.submit

    def recording_submit(*a, **k):
        futures.append(submit(*a, **k))
        return futures[-1]

    server.submit = recording_submit
    replies = [None] * len(bodies)
    with _Http(server) as h:
        def post(i):
            conn = http.client.HTTPConnection("127.0.0.1", h.port,
                                              timeout=600)
            replies[i] = _post(conn, "/synthesize", bodies[i])
            conn.close()

        reset_launch_counts()
        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        torch.cuda.synchronize()
        counts = launch_counts()
        stats = h.server.stats()
    assert all(r is not None and r[0].status == 200 for r in replies)
    assert (stats["batches"], stats["rows"], stats["padded_rows"]) == (1, 6, 2)
    by_tokens = {tuple(f.result(timeout=WAIT).tokens): f.result()
                 for f in futures}
    for body, (_, wav) in zip(bodies, replies):
        audio = np.frombuffer(wav[44:], dtype=np.float32)
        res = by_tokens[tuple(body["tokens"])]
        assert wav[:4] == b"RIFF" and np.isfinite(audio).all()
        assert len(audio) == card_audio_length(card_models, res.sequences[0])
    assert_launched(counts, ("A", "B", "C", "G"))


@pytest.mark.cuda
def test_http_stream_on_card_launches_a_b_and_e(card_models):
    """POST /stream at the default geometry (window 352, overlap 32, first
    window 96, margin 32) on the fused-LVC vocoder: a chunked WAV whose
    float32 frames have the one-shot path's length; it launches A, B and
    E."""
    from test_torch_device import STANDIN_TOKENS, assert_launched

    from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from tortoise_tpu_torch.pipeline.synthesize import synthesize

    models = dataclasses.replace(card_models, vocoder_cfg=dataclasses.replace(
        card_models.vocoder_cfg, use_pallas_lvc=True))
    voice = np.random.default_rng(10).normal(0, 0.5, (1024,)).astype(
        np.float32)
    server = serve.SynthesisServer(models, compute_dtype=torch.bfloat16,
                                   int8_weights=True, default_voice=voice,
                                   device="cuda")
    with _Http(server) as h:
        reset_launch_counts()
        conn = http.client.HTTPConnection("127.0.0.1", h.port, timeout=600)
        resp, body = _post(conn, "/stream", {"tokens": STANDIN_TOKENS,
                                             "seed": 5})
        conn.close()
        torch.cuda.synchronize()
        counts = launch_counts()
        stats = h.server.stats()
    assert resp.status == 200
    assert resp.getheader("Transfer-Encoding") == "chunked"
    assert body[:4] == b"RIFF" and stats.get("streams_completed") == 1
    audio = np.frombuffer(body[44:], dtype=np.float32)
    one_shot = synthesize(models, tokens=STANDIN_TOKENS, voice=voice, seed=5,
                          compute_dtype=torch.bfloat16, int8_weights=True,
                          device="cuda")
    assert audio.shape == one_shot.audio.shape and np.isfinite(audio).all()
    assert_launched(counts, ("A", "B", "E", "G"))


class _NumpyStream:
    """A numpy-seeded random source standing where a stage keeps its
    torch.Generator, so the card and the CPU draw the same numbers."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.seed = seed


@pytest.mark.cuda
def test_tiny_serving_on_card_agrees_with_cpu(monkeypatch):
    """The tiny f32 plane's synthesize_batch (3 ragged rows, per-row
    voices) and stream_synthesize on the card against the CPU, every
    uniform and normal draw of both from one numpy source: the same
    tokens, mel and audio within 1e-3 of max |out|."""
    from test_torch_device import _agree

    from tortoise_tpu_torch.pipeline import ar_stage, common, streaming
    from tortoise_tpu_torch.pipeline import diffusion_stage as dst
    from tortoise_tpu_torch.pipeline import vocoder_stage as vst
    from tortoise_tpu_torch.pipeline.streaming import (
        collect_stream,
        stream_synthesize,
    )
    from tortoise_tpu_torch.pipeline.synthesize import synthesize_batch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")

    def draw(kind):
        def fn(gen, shape, device):
            x = (gen.rng.random(shape, np.float32) if kind == "u"
                 else gen.rng.standard_normal(shape, np.float32))
            return torch.as_tensor(x).to(device)
        return fn

    for mod, name, fn in (
            (common, "make_generator", lambda seed, dev: _NumpyStream(seed)),
            (ar_stage, "draw_uniform", draw("u")),
            (dst, "draw_normal", draw("n")), (vst, "draw_normal", draw("n")),
            (streaming, "window_generator",
             lambda gen, i: _NumpyStream([gen.seed, i]))):
        monkeypatch.setattr(mod, name, fn)
    models = TortoiseModels.random(4, tiny=True)
    models.diffusion_cfg = dataclasses.replace(models.diffusion_cfg,
                                               n_sample_timesteps=20)
    rows = [[1, 5, 9, 4, 0], [1, 3, 9, 4, 12, 7, 20, 0],
            [1, 11, 2, 6, 8, 30, 17, 9, 22, 4, 0]]
    voices = np.random.default_rng(1).normal(0, 0.5, (3, 64)).astype(
        np.float32)
    runs = {dev: synthesize_batch(models, tokens_list=rows, voices=voices,
                                  seed=6, device=dev)
            for dev in ("cpu", "cuda")}
    geom = dict(window_frames=24, overlap_frames=8, first_window_frames=16,
                vocoder_margin=8)
    streams = {dev: list(stream_synthesize(
        models, tokens=rows[2], voice=voices[2], seed=7, device=dev, **geom))
        for dev in ("cpu", "cuda")}
    for g, c in zip(runs["cuda"], runs["cpu"]):
        assert g.sequences == c.sequences
        _agree(g.mel, c.mel)
        _agree(g.audio, c.audio)
    assert 2 <= len(streams["cuda"]) == len(streams["cpu"])
    _agree(collect_stream(streams["cuda"]), collect_stream(streams["cpu"]))
