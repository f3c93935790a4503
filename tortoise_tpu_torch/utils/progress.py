"""Progress reporting (the reference's progressBar, main.cpp:5023-5035);
a copy of the JAX package's ``utils/progress.py``."""

from __future__ import annotations

import sys


def progress_bar(fraction: float, width: int = 50, out=None) -> None:
    # resolve sys.stderr at call time: a default bound at import would
    # bypass redirect_stderr and pytest's capture
    out = sys.stderr if out is None else out
    fraction = min(max(fraction, 0.0), 1.0)
    filled = int(width * fraction)
    bar = "=" * filled + " " * (width - filled)
    out.write(f"\r[{bar}] {int(fraction * 100):3d}%")
    if fraction >= 1.0:
        out.write("\n")
    out.flush()
