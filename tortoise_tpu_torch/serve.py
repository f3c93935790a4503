"""Dynamic-batching synthesis server (counterpart of
``tortoise_tpu/serve.py``).

- ``SynthesisServer`` owns a request queue and one worker thread. The
  worker takes the first waiting request, then holds the batch open for
  up to ``max_wait_ms`` to admit more, up to ``max_batch`` rows.
- Batch sizes round UP to a bucket of ``B_BUCKETS`` (1, 2, 4, 8, 16) by
  repeating the last row; pad rows are dropped before the futures resolve
  (``stats()["padded_rows"]`` counts them). Up to 16 rows the AR decode
  runs kernel A on the bf16 + int8 plane (``ar.FUSED_MAX_BATCH``).
- Requests with different sampler settings never share a batch: the
  worker splits an admission window into one batch per setting.
- A device lock serializes the worker's batches and the streams' chunks;
  a stream holds it only while a chunk is computed.
- Each request carries its own voice latent.

Determinism: a batch is seeded by its FIRST request's seed and row b
draws row b of the batch's streams, so a request's output depends on the
batch it lands in. For reproducible output, synthesize alone.

The HTTP front end (``python -m tortoise_tpu_torch.serve``) is stdlib
only: POST /synthesize returns audio/wav, POST /stream a chunked
streaming WAV, GET /healthz the stats.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

from tortoise_tpu.io.voice import load_voice_latent
from tortoise_tpu.io.wav import streaming_wav_header, wav_bytes
from tortoise_tpu_torch.models.ar import FUSED_MAX_BATCH
from tortoise_tpu_torch.pipeline.common import resolve_device
from tortoise_tpu_torch.pipeline.synthesize import (
    TortoiseModels,
    synthesize_batch,
)

B_BUCKETS = (1, 2, 4, 8, FUSED_MAX_BATCH)
MAX_BODY = 16 << 20  # bytes of JSON a request may send


class ServerStopped(RuntimeError):
    """The server is not started, is stopping or has stopped: the request
    never ran and may be retried (HTTP 503). Every other failure is the
    synthesis's own (HTTP 500)."""


def _check_seed(seed) -> int:
    """A request seed at submit time: stage seeds go up to seed + 2 and
    must fit a torch.Generator, so an out-of-range seed fails its own
    caller, never the batch it would have joined."""
    s = int(seed)
    if not -(2 ** 63) <= s <= 2 ** 63 - 3:
        raise ValueError(f"seed outside the int64 range: {seed}")
    return s


def _fail_future(fut: Future, exc: BaseException) -> None:
    """Set ``exc`` on a future in any client-visible state: claim it if
    still pending, take it as it is when already RUNNING (claimed by a
    batch that died before resolving it), skip it when cancelled or
    done."""
    try:
        if fut.cancelled() or fut.done():
            return
        if not fut.running():
            try:
                if not fut.set_running_or_notify_cancel():
                    return  # the client cancelled it
            except RuntimeError:
                pass  # raced to RUNNING: set_exception is still legal
        fut.set_exception(exc)
    except Exception:
        pass  # raced with completion or cancellation: nothing to report


@dataclass
class _Request:
    tokens: List[int]
    voice: np.ndarray
    seed: int
    sampler: tuple = None  # normalized (temp, top_k, p_drop, penalty)
    future: Future = field(default_factory=Future)


class SynthesisServer:
    """Queue + worker around ``synthesize_batch`` on one device.

        server = SynthesisServer(models, compute_dtype=torch.bfloat16,
                                 int8_weights=True, device="cuda")
        with server:
            fut = server.submit(tokens=[...], voice="mol.bin")
            result = fut.result(timeout=60)
    """

    def __init__(self, models: TortoiseModels, compute_dtype=None,
                 int8_weights: bool = False, max_batch: int = 8,
                 max_wait_ms: float = 50.0, default_voice=None,
                 voice_dir: Optional[str] = None, device=None):
        if not 1 <= max_batch <= B_BUCKETS[-1]:
            raise ValueError(f"max_batch must be in [1, {B_BUCKETS[-1]}]")
        self.models = models
        self.voice_dir = voice_dir
        self.compute_dtype = compute_dtype
        self.int8_weights = int8_weights
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.device = resolve_device(device)
        self.default_voice = (self._load_voice(default_voice)
                              if default_voice is not None else None)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()
        # serializes device work between the batch worker and the streams
        # (a stream takes it once per chunk, so they interleave)
        self._device_lock = threading.Lock()
        # serializes stop() callers. Not _lock: the worker's death handler
        # takes _lock while stop() joins the worker
        self._stop_lock = threading.Lock()
        self._closed = True  # set by start()/stop() under _lock
        self._stats = {"batches": 0, "rows": 0, "padded_rows": 0,
                       "failed_batches": 0}

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SynthesisServer":
        if self._worker is not None:
            raise RuntimeError("server already started")
        self._stop.clear()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="tortoise-torch-serve-worker")
        self._worker.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the worker. With drain=True queued requests are served
        first; otherwise they fail with ServerStopped. Safe to call from
        several threads and more than once."""
        with self._stop_lock:
            worker = self._worker
            if worker is None:
                return
            with self._lock:
                # submit checks _closed under the same lock, so no request
                # lands between the drain and the worker's exit
                self._closed = True
            if drain:
                self._queue.join()
            self._stop.set()
            worker.join()
            self._worker = None
            while True:  # fail what is left (drain=False)
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                _fail_future(req.future, ServerStopped("server stopped"))
                self._queue.task_done()

    def __enter__(self) -> "SynthesisServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- client API --------------------------------------------------------

    def submit(self, message: Optional[str] = None,
               tokens: Optional[Sequence[int]] = None, voice=None,
               seed: int = 0, temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p_drop: Optional[float] = None,
               repetition_penalty: Optional[float] = None) -> Future:
        """Enqueue one utterance; returns a Future of its SynthesisResult
        (mel and latents None). ``voice``: a (d,) latent, a path, a name
        in ``voice_dir``, or None for ``default_voice``. The sampler
        fields override the defaults for this request. Inputs are checked
        here, so a bad request fails its own caller and never the batch it
        would have joined."""
        if self._worker is None:
            raise ServerStopped("server not started")
        tokens, voice_arr, sampler = self._normalize_request(
            message, tokens, voice, temperature, top_k, top_p_drop,
            repetition_penalty)
        req = _Request(tokens, voice_arr, _check_seed(seed), sampler)
        with self._lock:
            if self._closed or self._worker is None:
                raise ServerStopped("server not started")
            self._queue.put(req)
        return req.future

    def stream(self, message: Optional[str] = None,
               tokens: Optional[Sequence[int]] = None, voice=None,
               seed: int = 0, temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p_drop: Optional[float] = None,
               repetition_penalty: Optional[float] = None,
               window_frames: int = 352, overlap_frames: int = 32,
               first_window_frames: Optional[int] = 96,
               vocoder_margin: int = 32):
        """Streaming synthesis: yields StreamChunk objects as audio
        finalizes, bypassing the batches. Every input, the window geometry
        included, is checked here before any device work. The device lock
        is held only while a chunk is computed, so a slow consumer cannot
        starve the batches. A stream in flight when the server stops
        raises ServerStopped at its next chunk."""
        with self._lock:
            if self._closed or self._worker is None:
                raise ServerStopped("server not started")
        from tortoise_tpu_torch.pipeline.streaming import stream_synthesize

        tokens, voice_arr, sampler = self._normalize_request(
            message, tokens, voice, temperature, top_k, top_p_drop,
            repetition_penalty)
        it = stream_synthesize(
            self.models, tokens=tokens, voice=voice_arr,
            seed=_check_seed(seed), compute_dtype=self.compute_dtype,
            int8_weights=self.int8_weights,
            window_frames=int(window_frames),
            overlap_frames=int(overlap_frames),
            vocoder_margin=int(vocoder_margin),
            first_window_frames=first_window_frames,
            sampler_params=sampler, device=self.device)

        def gen():
            with self._lock:
                self._stats["streams"] = self._stats.get("streams", 0) + 1
            while True:
                # device work runs inside next(); the yield below runs
                # with the lock released
                with self._device_lock:
                    with self._lock:
                        if self._closed:
                            raise ServerStopped("server stopped")
                    try:
                        chunk = next(it)
                    except StopIteration:
                        break
                yield chunk
            with self._lock:
                self._stats["streams_completed"] = (
                    self._stats.get("streams_completed", 0) + 1)

        return gen()

    def _normalize_request(self, message, tokens, voice, temperature,
                           top_k, top_p_drop, repetition_penalty):
        """Resolve and check tokens, voice and sampler overrides ->
        (tokens, voice_arr, sampler)."""
        from tortoise_tpu_torch.pipeline.ar_stage import (
            TEXT_BUCKETS,
            normalize_sampler,
            sampler_overrides,
        )

        sampler = normalize_sampler(sampler_overrides(
            temperature, top_k, top_p_drop, repetition_penalty))
        if tokens is None:
            if message is None:
                raise ValueError("pass message or tokens")
            if self.models.tokenizer is None:
                raise ValueError("models have no tokenizer; pass tokens")
            tokens = self.models.tokenizer.encode_pipeline(message)
        tokens = list(map(int, tokens))
        if not tokens:
            raise ValueError("empty token sequence")
        if len(tokens) > max(TEXT_BUCKETS):
            raise ValueError(f"text too long: {len(tokens)} tokens > bucket "
                             f"max {max(TEXT_BUCKETS)}")
        v = self.models.ar_cfg.n_text_vocab
        bad = [t for t in tokens if not 0 <= t < v]
        if bad:
            raise ValueError(
                f"text token ids outside vocab [0, {v}): {bad[:5]}")
        voice_arr = (self._load_voice(voice) if voice is not None
                     else self.default_voice)
        if voice_arr is None:
            raise ValueError("no voice given and no default_voice set")
        d = self.models.ar_cfg.d_model
        if voice_arr.shape != (d,):
            raise ValueError(f"voice latent must have shape ({d},), got "
                             f"{voice_arr.shape}")
        return tokens, voice_arr, sampler

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
        s["queued"] = self._queue.qsize()
        return s

    def warmup(self) -> None:
        """One dummy single-row batch, run directly under the device lock:
        it caches the weight casts and pays the first calls' one-time
        costs (kernel build, cuBLAS and allocator warm-up) before traffic
        arrives. Eager PyTorch specializes on no batch or text length, so
        one batch covers every bucket. Needs a default voice."""
        if self.default_voice is None:
            raise ValueError("warmup needs a default_voice")
        with self._device_lock:
            # ids 1 and 0 are in every vocab, the tiny test configs' too
            synthesize_batch(
                self.models, tokens_list=[[1] * 7 + [0]],
                voices=[self.default_voice], seed=0,
                compute_dtype=self.compute_dtype,
                int8_weights=self.int8_weights, materialize=False,
                device=self.device)

    # -- worker ------------------------------------------------------------

    def _load_voice(self, voice) -> np.ndarray:
        if isinstance(voice, str):
            path = voice
            if not os.path.exists(path) and self.voice_dir:
                # a bare name (voice_dir/<name>.bin) or a file name in
                # voice_dir, like the CLI
                for cand in (os.path.join(self.voice_dir, voice + ".bin"),
                             os.path.join(self.voice_dir, voice)):
                    if os.path.exists(cand):
                        path = cand
                        break
            return load_voice_latent(path, self.models.ar_cfg.d_model)
        return np.asarray(voice, np.float32)

    @staticmethod
    def _bucket(n: int) -> int:
        return next((b for b in B_BUCKETS if n <= b), B_BUCKETS[-1])

    def _collect(self) -> List[_Request]:
        """Block for the first request, then hold the batch open for up to
        max_wait_ms (or until max_batch rows)."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _run(self) -> None:
        admitted: List[_Request] = []
        try:
            while not self._stop.is_set():
                admitted = self._collect()
                if not admitted:
                    continue
                # one batch per distinct sampler setting, arrival order
                # kept within each
                groups: dict = {}
                for r in admitted:
                    groups.setdefault(r.sampler, []).append(r)
                for sampler, batch in groups.items():
                    self._run_batch(batch, sampler)
                for _ in range(len(admitted)):
                    self._queue.task_done()
                admitted = []
        except BaseException as e:  # the worker must never die silently
            # a defect outside the per-batch isolation would strand every
            # outstanding future and hang stop(drain=True) on the queue's
            # join: close to new submits FIRST (a client woken by its
            # failed future must not slip a request into the dead server),
            # then fail the admitted and the queued requests, keeping the
            # queue's task count balanced
            with self._lock:
                self._closed = True
            for r in admitted:
                _fail_future(r.future, e)
                self._queue.task_done()
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                _fail_future(req.future, e)
                self._queue.task_done()
            raise

    def _run_batch(self, batch: List[_Request], sampler: tuple) -> None:
        # claim each future before any device work: a cancelled one drops
        # out here (set_result on it would raise and kill the worker)
        batch = [r for r in batch if r.future.set_running_or_notify_cancel()]
        if not batch:
            return
        n = len(batch)
        bucket = self._bucket(n)
        rows = batch + [batch[-1]] * (bucket - n)  # repeat-pad rows
        try:
            with self._device_lock:
                results = synthesize_batch(
                    self.models, tokens_list=[r.tokens for r in rows],
                    voices=[r.voice for r in rows], seed=batch[0].seed,
                    compute_dtype=self.compute_dtype,
                    int8_weights=self.int8_weights, materialize=False,
                    sampler_params=sampler, device=self.device)
        except Exception as e:  # resolve the batch, keep the worker
            for r in batch:
                r.future.set_exception(e)
            with self._lock:
                self._stats["failed_batches"] += 1
        else:
            for r, res in zip(batch, results):  # pad rows dropped
                r.future.set_result(res)
            with self._lock:
                self._stats["batches"] += 1
                self._stats["rows"] += n
                self._stats["padded_rows"] += bucket - n


# -- HTTP front end (stdlib only) -----------------------------------------


def make_http_server(server: SynthesisServer, host: str = "127.0.0.1",
                     port: int = 8757):
    """ThreadingHTTPServer around a started SynthesisServer.

    POST /synthesize  {"message": str | "tokens": [int], "voice": path or
                       name, "seed": int, "temperature" / "top_k" /
                       "top_p_drop" / "repetition_penalty": optional}
                                               -> 200 audio/wav
    POST /stream      the same body plus optional "window_frames" /
                      "overlap_frames" / "first_window_frames" /
                      "vocoder_margin"         -> 200 audio/wav, chunked:
                      a streaming-WAV header, then float32 frames as each
                      span finalizes
    GET  /healthz                              -> 200 application/json

    Bad input is a 400 for that request alone; a synthesis failure a 500
    (mid-stream: a truncated chunked body); a stopping server a 503. A
    body must come with Content-Length: a chunked request body gets 411
    on a closing connection (its bytes are never read, so keeping the
    connection would parse them as the next request).
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        # chunked responses (/stream) need HTTP/1.1; every other response
        # sends Content-Length
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet by default
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self.close_connection:
                # tell keep-alive clients the connection is going away
                self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                return self._json(404, {"error": "not found"})
            self._json(200, {"ok": True, "stats": server.stats()})

        @staticmethod
        def _request_kwargs(req: dict) -> dict:
            """Request fields shared by /synthesize and /stream."""
            return dict(
                message=req.get("message"), tokens=req.get("tokens"),
                voice=req.get("voice"), seed=int(req.get("seed", 0)),
                temperature=req.get("temperature"), top_k=req.get("top_k"),
                top_p_drop=req.get("top_p_drop"),
                repetition_penalty=req.get("repetition_penalty"))

        def _chunk(self, payload: bytes) -> None:
            self.wfile.write(f"{len(payload):x}\r\n".encode())
            self.wfile.write(payload)
            self.wfile.write(b"\r\n")

        def _do_stream(self, req: dict) -> None:
            try:
                # JSON null on first_window_frames means uniform windows;
                # null or a non-integer elsewhere is a 400 naming the field
                def geom(k):
                    v = req[k]
                    if v is None and k == "first_window_frames":
                        return None
                    if not isinstance(v, int) or isinstance(v, bool):
                        raise ValueError(f"{k} must be an integer, got "
                                         f"{v!r}")
                    return v

                kw = {k: geom(k) for k in ("window_frames", "overlap_frames",
                                           "first_window_frames",
                                           "vocoder_margin") if k in req}
                chunks = server.stream(**self._request_kwargs(req), **kw)
            except ServerStopped as e:  # retryable
                return self._json(503, {"error": str(e)})
            except Exception as e:
                return self._json(400, {"error": str(e)})
            # the AR stage and the first window run BEFORE the 200 goes
            # out: once it has, a failure can only truncate the body
            try:
                first = next(chunks, None)
            except ServerStopped as e:
                return self._json(503, {"error": str(e)})
            except Exception as e:
                return self._json(500, {"error": str(e)})
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            try:
                self._chunk(streaming_wav_header(
                    server.models.vocoder_cfg.sample_rate))
                if first is not None:
                    self._chunk(np.asarray(first.audio, np.float32)
                                .tobytes())
                    for c in chunks:
                        self._chunk(np.asarray(c.audio, np.float32)
                                    .tobytes())
                self._chunk(b"")  # the terminating empty chunk
            except Exception:
                # the 200 is on the wire: drop the connection so the
                # client sees a truncated body, not silence
                self.close_connection = True
                raise

        def do_POST(self):
            # read the whole body before replying: unread bytes would be
            # parsed as the connection's next request. A chunked body has
            # no Content-Length; refuse it unread and close.
            if self.headers.get("Transfer-Encoding") is not None:
                self.close_connection = True
                return self._json(411, {"error": "send the body with "
                                        "Content-Length"})
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError as e:
                self.close_connection = True
                return self._json(400, {"error": str(e)})
            if length < 0 or length > MAX_BODY:
                # not drained: answer on a closing connection
                self.close_connection = True
                return self._json(413, {"error": "request body too large"})
            raw = self.rfile.read(length)
            if self.path not in ("/synthesize", "/stream"):
                return self._json(404, {"error": "not found"})
            try:
                req = json.loads(raw or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("the body must be a JSON object")
            except ValueError as e:
                return self._json(400, {"error": str(e)})
            if self.path == "/stream":
                return self._do_stream(req)
            try:
                fut = server.submit(**self._request_kwargs(req))
            except ServerStopped as e:  # retryable
                return self._json(503, {"error": str(e)})
            except Exception as e:  # this request's input was bad
                return self._json(400, {"error": str(e)})
            try:
                result = fut.result()
            except ServerStopped as e:  # stopped before its batch ran
                return self._json(503, {"error": str(e)})
            except Exception as e:  # the synthesis's own failure
                return self._json(500, {"error": str(e)})
            body = wav_bytes(result.audio, result.sample_rate)
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    return ThreadingHTTPServer((host, port), Handler)


def build_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog="tortoise_tpu_torch.serve",
        description="dynamic-batching synthesis server, PyTorch + CUDA port")
    p.add_argument("--models", default="models",
                   help="directory with the GGML model files + tokenizer")
    p.add_argument("--cache-dir", default=None,
                   help="directory for the converted .npz checkpoints")
    p.add_argument("--voice", default="mol",
                   help="default voice (name in the models dir, or path)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8757)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=50.0)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--f32", dest="bf16", action="store_false")
    p.add_argument("--int8-weights", action="store_true", default=True)
    p.add_argument("--no-int8-weights", dest="int8_weights",
                   action="store_false")
    p.add_argument("--warmup", action="store_true",
                   help="run one small batch before serving")
    p.add_argument("--random-weights", action="store_true",
                   help="synthetic weights and a random default voice")
    p.add_argument("--tiny", action="store_true",
                   help="with --random-weights: tiny test-size models")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; fails without a card)")
    return p


def main(argv=None) -> int:
    import dataclasses

    import torch

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    if args.random_weights:
        models = TortoiseModels.random(0, tiny=args.tiny)
        voice = np.random.default_rng(0).normal(
            0, 0.5, (models.ar_cfg.d_model,)).astype(np.float32)
    else:
        models = TortoiseModels.from_ggml_dir(args.models, args.cache_dir)
        voice = args.voice  # resolved against voice_dir by the server
    compute_dtype = torch.bfloat16 if args.bf16 else None
    if device.type == "cuda" and compute_dtype is None:
        # the f32 plane: true f32 products in cuBLAS and cuDNN
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    models.diffusion_cfg = dataclasses.replace(
        models.diffusion_cfg, use_flash=device.type == "cuda" and args.bf16)
    server = SynthesisServer(
        models, compute_dtype=compute_dtype,
        int8_weights=args.int8_weights and args.bf16,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        default_voice=voice,
        voice_dir=None if args.random_weights else args.models,
        device=device)
    server.start()
    httpd = None
    try:
        if args.warmup:
            print("warming up (one small batch)...", flush=True)
            server.warmup()
        httpd = make_http_server(server, args.host, args.port)
        print(f"serving on http://{args.host}:{httpd.server_address[1]} "
              f"({device}, max_batch={args.max_batch}, "
              f"wait={args.max_wait_ms}ms)", flush=True)
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        if httpd is not None:
            httpd.server_close()
        server.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
