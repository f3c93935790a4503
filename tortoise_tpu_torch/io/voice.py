"""Voice conditioning latents.

The reference does not implement the conditioning encoder; voices are
precomputed 1024-float32 latents loaded raw from `.bin` files
(main.cpp:5004-5021, 5179-5184; README.md:59-83).
"""

from __future__ import annotations

import os

import numpy as np


def load_voice_latent(path: str, dim: int = 1024) -> np.ndarray:
    """Load a raw float32 voice latent, validating its size."""
    size = os.path.getsize(path)
    expect = dim * 4
    if size < expect:
        raise ValueError(f"{path}: expected >= {expect} bytes, got {size}")
    return np.fromfile(path, dtype=np.float32, count=dim)
