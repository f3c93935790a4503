"""What the port's microbenchmarks (``scripts/torch_ubench_*.py``) share:
the device rule, the card line, the timing rule, the profile table and
the JSON result line.

- The device: ``--device cuda`` (the default) raises without a card;
  ``--device cpu`` runs the plain versions, with ``--small`` on the tiny
  configs, so the CPU tests can run each script to its JSON line.
- Timing (``timed``): one warmup call, then best of N. On the card each
  call sits between two CUDA events (``ms``, what a caller waits for:
  on a host-bound path it includes the host's launch gaps) and one more
  call runs under ``torch.profiler``, whose kernel times summed give the
  device-busy time (``busy_ms``): a delta of ``ms`` that ``busy_ms`` does
  not show is launch overhead, not device work. On the CPU, the host
  clock and no busy time.
- ``profile_top``: device time by kernel (top 24) of one call, with its
  Chrome trace under ``chiprun_out/``.
- ``emit``: the last line, ``{"<script>": {...}}``, with the launch
  counts of ``tortoise_tpu_torch.ops.cuda`` since the script's start.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# published peaks of one H100 SXM (NVIDIA's data sheet, dense rates)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
TOP_KERNELS = 24


def add_device_args(ap) -> None:
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu "
                         "(the plain versions)")
    ap.add_argument("--small", action="store_true",
                    help="the tiny configs and cut shapes (CPU tests)")


def start(device: str):
    """(torch.device, card line) for a run on ``device``; sets the launch
    counters to 0. Raises on ``cuda`` without a card."""
    from tortoise_tpu_torch.ops.cuda import reset_launch_counts
    from tortoise_tpu_torch.pipeline.common import resolve_device

    dev = resolve_device(device)
    reset_launch_counts()
    return dev, card_line(dev)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or
    ``cpu (no card)``."""
    if device.type != "cuda":
        return "cpu (no card)"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _device_us(prof) -> list:
    """(device us, launches, name) of every device-side event of a
    profile, largest first (an op's own row would count its kernels'
    time twice, so only device events)."""
    from torch.autograd import DeviceType

    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    return sorted(rows, reverse=True)


def _profiled(fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return prof


def busy_ms(fn) -> float:
    """Device-busy ms of one call of ``fn`` on the card: the sum of its
    kernel times under ``torch.profiler``."""
    return sum(r[0] for r in _device_us(_profiled(fn))) / 1e3


def timed(fn, device, reps: int = 3, warmup: int = 1,
          busy: bool = True) -> dict:
    """Best-of-``reps`` ms of ``fn()`` after ``warmup`` calls (module
    docstring). ``busy``: also the device-busy ms of one profiled call,
    and its share of ``ms``. Returns {"ms", "busy_ms", "busy_share"}
    (the last two None on the CPU or without ``busy``)."""
    import torch

    for _ in range(warmup):
        fn()
    best = float("inf")
    if device.type == "cuda":
        torch.cuda.synchronize()
        for _ in range(reps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            torch.cuda.synchronize()
            best = min(best, t0.elapsed_time(t1))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            best = min(best, (time.perf_counter() - t0) * 1e3)
    out = {"ms": best, "busy_ms": None, "busy_share": None}
    if busy and device.type == "cuda":
        busy = busy_ms(fn)
        out.update(busy_ms=busy, busy_share=busy / best)
    return out


def fmt(t: dict, per: float = 1.0, unit: str = "ms") -> str:
    """``t`` from ``timed`` divided by ``per`` (a call's steps), as text."""
    s = f"{t['ms'] / per:9.3f} {unit}"
    if t["busy_ms"] is not None:
        s += (f" (device busy {t['busy_ms'] / per:.3f} {unit}, share "
              f"{t['busy_share']:.3f})")
    return s


def profile_top(fn, device, label: str) -> list:
    """Device time by kernel of one call of ``fn`` (after a warmup
    call), the top ``TOP_KERNELS`` printed, the Chrome trace written to
    ``chiprun_out/ubench_<label>.json``. Returns the rows printed as
    [device ms, launches, name]. Needs the card."""
    if device.type != "cuda":
        raise RuntimeError("--profile needs the card")
    fn()
    prof = _profiled(fn)
    rows = _device_us(prof)
    total = sum(r[0] for r in rows) / 1e3
    print(f"profile {label}: device busy {total:.3f} ms in "
          f"{sum(r[1] for r in rows)} device events; top {TOP_KERNELS}:",
          flush=True)
    top = [[us / 1e3, n, key[:100]] for us, n, key in rows[:TOP_KERNELS]]
    for ms, n, key in top:
        print(f"  {ms:9.3f} ms x{n:<6d} {key}", flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, f"ubench_{label}.json"))
    return top


def launch_delta(before: dict) -> dict:
    """The kernels launched since ``before`` (a ``launch_counts()``)."""
    from tortoise_tpu_torch.ops.cuda import launch_counts

    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


def emit(name: str, result: dict, device, card: str, small: bool) -> dict:
    """Print the last line, ``{name: result}`` with the device, the card
    line, ``small`` and the launch counts since ``start``; returns the
    result with them."""
    from tortoise_tpu_torch.ops.cuda import launch_counts

    result.update(device=str(device), card=card, small=small,
                  launches=launch_counts())
    print(json.dumps({name: result}), flush=True)
    return result
