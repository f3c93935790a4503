"""Profiling (the reference's wall-clock printfs around model load,
main.cpp:5073-5093):

- ``trace``: a context manager around ``torch.profiler.profile`` that
  writes a Chrome trace (Perfetto, TensorBoard) of the enclosed block
  when a directory is given or ``TORTOISE_TRACE_DIR`` is set; a no-op
  otherwise.
- ``StageTimer``: named wall-clock sections with a summary.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the enclosed block with torch.profiler (CPU activity, and
    CUDA activity when a card is present) into
    ``<log_dir>/trace_<pid>_<n>.json`` when a directory is configured;
    no-op otherwise. Yields the profiler (None when off)."""
    log_dir = log_dir or os.environ.get("TORTOISE_TRACE_DIR")
    if not log_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = sum(f.startswith(f"trace_{os.getpid()}_") for f in os.listdir(log_dir))
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{n}.json"))


class StageTimer:
    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.monotonic() - t0
            )

    def summary(self) -> str:
        total = sum(self.times.values())
        parts = [f"{k}={v:.3f}s" for k, v in self.times.items()]
        return ", ".join(parts) + f" (total {total:.3f}s)"
