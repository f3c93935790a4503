"""CUDA graphs of one loop step: the port's counterpart of the JAX
package's on-device stage loops (the AR sampling ``lax.while_loop``,
``tortoise_tpu/pipeline/ar_stage.py``, and the denoising
``lax.fori_loop``, ``tortoise_tpu/pipeline/diffusion_stage.py``).

A loop on the card captures ONE step and replays it for every step. The
step works on static buffers in place and reads its step index from a
device counter that it advances itself, as the JAX loops carry a traced
step. Between replays the host does what it did in the eager loop: it
draws the step's random numbers into the step's buffer (the same
generator, in the same order), reads the AR stop flags every
``STOP_CHECK_STEPS`` steps and fires the progress callback.

- **Routing** (``use_graphs``): every CUDA call without a mesh replays a
  graph; the CPU and a mesh run the eager loop (gloo stages every
  collective through the host, which a graph cannot hold). The loops
  take a private ``eager`` argument for A/B runs on the card. A failed
  capture or replay raises: there is no eager fallback.
- **Capture** (``StepGraph``): the first step on a new entry is its
  warm-up. It runs eagerly on a side stream, as ``torch.cuda.graph``
  requires (this also builds the kernels and their scratch at first
  use), and is the loop's real step; the next step is captured and
  replayed, and so is every step after it.
- **Launch counts**: the kernel wrappers count launches in Python, which
  a replay does not run. The counts a capture adds are taken back and
  recorded, and each replay adds them again, so
  ``ops.cuda.launch_counts()`` reads what ran.
- **The cache** (``cached``): an entry per (stage, plane, B, padded
  length, route, ...) key and device weight tree, at most ``MAX_GRAPHS``,
  the least recently used dropped first. An entry holds its tree, which
  its graph reads by address, and goes with it: ``clear_cast_cache`` and
  the cast cache's eviction (``pipeline.common``) drop the tree's
  entries, so no graph outlives the weights it reads. An entry's buffers
  serve one loop at a time (``StepGraph.lock``).
- **Spans and counters** (``utils.profiling``): a warm-up and a capture
  are the spans ``graph.warmup`` and ``graph.capture``; each step of a
  loop counts as one of ``graph_warmups``, ``graph_captures`` or
  ``graph_replays`` on the span the loop runs in.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
from typing import Callable, Optional

import torch

from tortoise_tpu_torch.ops import cuda as kernels
from tortoise_tpu_torch.utils import profiling

MAX_GRAPHS = 8


def use_graphs(device, mesh=None) -> bool:
    """The routing rule: a graph loop for a CUDA device without a mesh,
    the eager loop on the CPU or under a mesh."""
    return torch.device(device).type == "cuda" and mesh is None


class StepGraph:
    """One loop step on static buffers: ``bufs`` (the tensors the step
    reads and writes in place) and ``step(bufs)``. Calling it runs one
    step: the first call warms up, the second captures, every later call
    replays. ``keep`` holds what the captured kernels read by address
    beside the weights (the schedule tables). ``warmups``, ``captures``
    and ``replays`` count the steps run each way."""

    def __init__(self, bufs: dict, step: Callable[[dict], None], keep=()):
        self.bufs = bufs
        self.lock = threading.Lock()
        self.launches: dict = {}   # kernel launches a replay makes
        self.capture_s: Optional[float] = None
        self.warmups = self.captures = self.replays = 0
        self._step = step
        self._keep = keep
        self._warm = False
        self._graph = None

    def __call__(self) -> None:
        if self._graph is not None:
            self.replays += 1
            self._replay()
        elif not self._warm:
            self.warmups += 1
            self._warm_up()
        else:
            self.captures += 1
            self._capture()

    def _replay(self) -> None:
        self._graph.replay()
        kernels.add_launch_counts(self.launches)

    def _warm_up(self) -> None:
        with profiling.span("graph.warmup"):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._step(self.bufs)
            torch.cuda.current_stream().wait_stream(side)
        self._warm = True

    def _capture(self) -> None:
        """Capture the step and run it once (a capture records without
        running)."""
        with profiling.span("graph.capture") as sp:
            graph = torch.cuda.CUDAGraph()
            before = kernels.launch_counts()
            with torch.cuda.graph(graph):
                self._step(self.bufs)
            after = kernels.launch_counts()
            self.launches = {k: n - before[k] for k, n in after.items()
                             if n != before[k]}
            kernels.add_launch_counts(
                {k: -n for k, n in self.launches.items()})
            self._graph = graph
            self._replay()
        self.capture_s = sp.s


_graphs: "collections.OrderedDict" = collections.OrderedDict()
_lock = threading.Lock()


def cached(key: tuple, tree, build: Callable[[], StepGraph]) -> StepGraph:
    """The step graph of ``key`` on the device weight tree ``tree``;
    ``build()`` makes it on a miss (the LRU bound applies)."""
    full = (id(tree),) + tuple(key)
    with _lock:
        ent = _graphs.get(full)
        if ent is not None and ent[0] is tree:
            _graphs.move_to_end(full)
            return ent[1]
        graph = build()
        _graphs[full] = (tree, graph)
        while len(_graphs) > MAX_GRAPHS:
            _graphs.popitem(last=False)
        return graph


def drop_tree(tree) -> None:
    """Drop the entries whose graphs read ``tree``."""
    with _lock:
        for k in [k for k, (t, _) in _graphs.items() if t is tree]:
            del _graphs[k]


def clear() -> None:
    """Drop every entry (their pools and buffers are freed once no loop
    holds them)."""
    with _lock:
        _graphs.clear()


@contextlib.contextmanager
def stepping(graphed: bool, key: tuple, tree, make_bufs: Callable,
             step: Callable[[dict], None], keep=()):
    """Yield (bufs, run) for one loop, where ``run()`` runs one step on
    ``bufs``. With ``graphed`` (``use_graphs``): the cached StepGraph of
    ``key`` on ``tree``, built over ``make_bufs(True)`` (buffers of its
    own) on a miss and held for the loop; else ``make_bufs(False)`` with
    ``step`` run eagerly. A graph loop adds the steps it warmed up,
    captured and replayed to the span it runs in."""
    if not graphed:
        bufs = make_bufs(False)
        yield bufs, functools.partial(step, bufs)
        return
    graph = cached(key, tree, lambda: StepGraph(make_bufs(True), step, keep))
    with graph.lock:
        before = (graph.warmups, graph.captures, graph.replays)
        try:
            yield graph.bufs, graph
        finally:
            for name, n0, n1 in zip(
                    ("graph_warmups", "graph_captures", "graph_replays"),
                    before, (graph.warmups, graph.captures, graph.replays)):
                profiling.count(name, n1 - n0)


def entries() -> list:
    """The cached (key, StepGraph) pairs, least recently used first."""
    with _lock:
        return [(k[1:], g) for k, (_, g) in _graphs.items()]
