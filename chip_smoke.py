#!/usr/bin/env python3
"""The card check of the PyTorch + CUDA port on one NVIDIA card, from the
root of a checkout:

    python3 chip_smoke.py

It holds no check of its own; it runs, in turn:

1. the card suite, ``python -m pytest --noconftest -m cuda`` over the
   files of ``tests/test_torch_*.py`` that hold ``cuda``-marked tests (the
   others import JAX, which a card's machine need not have). They hold
   each hand-written kernel against its plain version at the main paths'
   shapes, and each path's kernel launches, read from the path's own run
   with the counters set to 0 just before it;
2. the kernel timer, ``scripts/torch_kernel_times.py``: one JSON row a
   row of PERF.md's kernel table, with the plain version's time, SDPA's
   where it has one, and the bound.

Their whole output goes under ``--out`` (``chip_smoke_out/``, git-ignored):
``card_tests.log``, ``kernel_times.jsonl`` and ``kernel_times.err``. It
prints the card's name and power limit, each step's exit code and wall,
the suite's last lines, and last one line ``{"kernels": [...]}``: for
every row the timer measured in this run, its kernel, shape, ``ms``,
``bound_ms`` and ``bound_by``. Exits nonzero if either step fails and,
without a card, before anything is built.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ROW_KEYS = ("kernel", "shape", "ms", "bound_ms", "bound_by")


def card_files() -> list:
    """The port's test files that hold ``cuda``-marked tests."""
    files = []
    for path in sorted(glob.glob(os.path.join(ROOT, "tests",
                                              "test_torch_*.py"))):
        with open(path) as f:
            if "pytest.mark.cuda" in f.read():
                files.append(os.path.relpath(path, ROOT))
    return files


def run(cmd, out, err=None) -> tuple:
    """``cmd`` from the root with its output in the file ``out`` and its
    errors in the file ``err`` (None: with the output); (exit code, wall
    seconds)."""
    t0 = time.monotonic()
    with open(out, "w") as f, open(err or os.devnull, "w") as e:
        rc = subprocess.call(cmd, cwd=ROOT, stdout=f,
                             stderr=e if err else subprocess.STDOUT)
    return rc, time.monotonic() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "chip_smoke_out"))
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    log = os.path.join(args.out, "card_tests.log")
    suite = [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda",
             *card_files(), "-q", "-rfE", "-p", "no:cacheprovider",
             "--durations=15"]
    rc_suite, wall = run(suite, log)
    print(f"card suite rc={rc_suite} wall={wall:.1f} s", flush=True)
    with open(log) as f:
        print("".join(f.readlines()[-30:]), end="", flush=True)
    rows = os.path.join(args.out, "kernel_times.jsonl")
    rc_timer, wall = run([sys.executable, os.path.join(
        "scripts", "torch_kernel_times.py"), "--label", "chip_smoke"], rows,
        os.path.join(args.out, "kernel_times.err"))
    print(f"kernel timer rc={rc_timer} wall={wall:.1f} s", flush=True)
    with open(rows) as f:
        measured = [json.loads(ln) for ln in f if ln.startswith("{")]
    print(json.dumps({"card": card, "kernels": [
        {k: r[k] for k in ROW_KEYS if k in r}
        for r in measured if "ms" in r]}), flush=True)
    return 1 if rc_suite or rc_timer else 0


if __name__ == "__main__":
    sys.exit(main())
