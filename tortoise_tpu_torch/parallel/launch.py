"""Start the ranks of one process group on this host: the counterpart,
for tests and smoke checks, of ``torchrun --nproc-per-node N``.

``run_ranks(fn, n, args)`` starts n fresh processes (the ``spawn``
method: the caller may hold threads or an initialized JAX), joins them
to one group that rendezvouses on a FileStore in ``workdir`` (no TCP
port, so concurrent runs never collide), runs ``fn(rank, n, *args)`` in
each and returns their return values in rank order. Each rank's output
goes to ``workdir/rank<r>.log``; a rank that fails, or a run that
outlasts ``timeout``, kills every rank and raises with their logs.
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Sequence


def _rank_main(fn, rank: int, world: int, args, workdir: str,
               backend: str, threads: int, store: str) -> None:
    log = open(os.path.join(workdir, f"rank{rank}.log"), "w", buffering=1)
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    sys.stdout = sys.stderr = log
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method="file://" + store,
                                rank=rank, world_size=world)
        out = fn(rank, world, *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        log.flush()
        os._exit(1)
    log.flush()


def _logs(workdir: str, world: int, tail: int = 4000) -> str:
    out = []
    for r in range(world):
        path = os.path.join(workdir, f"rank{r}.log")
        text = open(path).read()[-tail:] if os.path.exists(path) else ""
        out.append(f"--- rank {r} ---\n{text}")
    return "\n".join(out)


def run_ranks(fn: Callable, world: int, args: Sequence = (),
              workdir: Optional[str] = None, timeout: float = 120.0,
              backend: str = "gloo", threads: int = 1) -> List:
    """Run ``fn(rank, world, *args)`` on ``world`` spawned ranks of one
    ``backend`` group; returns the ranks' return values. ``fn`` and
    ``args`` are pickled (``fn`` by its import path)."""
    own = workdir is None
    tmp = tempfile.TemporaryDirectory() if own else None
    workdir = tmp.name if own else workdir
    os.makedirs(workdir, exist_ok=True)
    # a FileStore's file must not outlive its group: a new one each run
    fd, store = tempfile.mkstemp(prefix="store", dir=workdir)
    os.close(fd)
    os.remove(store)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(
        fn, r, world, tuple(args), workdir, backend, threads, store),
        daemon=True) for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed or time.monotonic() > deadline:
                why = (f"rank(s) {failed} failed" if failed
                       else f"timed out after {timeout:.0f} s")
                raise RuntimeError(f"run_ranks: {why}\n"
                                   f"{_logs(workdir, world)}")
            time.sleep(0.05)
        failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
        if failed:
            raise RuntimeError(f"run_ranks: rank(s) {failed} failed\n"
                               f"{_logs(workdir, world)}")
        out = []
        for r in range(world):
            with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
        if tmp is not None:
            tmp.cleanup()
