"""Facade over the reference-parity RNG plane.

Picks the native (g++/libstdc++) implementation when built, else the
pure-Python twin. Both expose the exact draw streams the reference's global
``std::mt19937`` produces (main.cpp:39-50), so seeded runs and the seeded
regression fixtures reproduce.

This plane is host-side only; the port's on-device sampler plane draws
from a ``torch.Generator`` (see pipeline/ar_stage.py).
"""

from __future__ import annotations

import numpy as np

from tortoise_tpu_torch.rng.mt19937 import PyStdRng


def _make_backend(seed: int, force_python: bool):
    if not force_python:
        try:
            from tortoise_tpu_torch.native import StdRng, available

            if available():
                return StdRng(seed)
        except Exception:
            pass
    return PyStdRng(seed)


class ReferenceRng:
    def __init__(self, seed: int = 0, force_python: bool = False):
        self._rng = _make_backend(seed, force_python)

    @property
    def backend(self) -> str:
        return type(self._rng).__name__

    def load_state(self, text: str) -> None:
        self._rng.load_state(text)

    def load_state_file(self, path: str) -> None:
        with open(path, "r") as f:
            self._rng.load_state(f.read())

    def load_normal_state_file(self, path: str) -> None:
        with open(path, "r") as f:
            self._rng.load_normal_state(f.read())

    def raw_u32(self, n: int) -> np.ndarray:
        return self._rng.raw_u32(n)

    def uniform(self, n: int) -> np.ndarray:
        """uniform_real_distribution<float>(0,1) stream."""
        return self._rng.uniform_float(n)

    def normal(self, n: int) -> np.ndarray:
        """normal_distribution<double>(0,1) stream (float64)."""
        return self._rng.normal_double(n)

    def normal_f32(self, n: int) -> np.ndarray:
        """Noise as the reference stores it: double draws cast to float32
        (e.g. sample_normal_noise, main.cpp:4695-4701)."""
        return self.normal(n).astype(np.float32)

    def multinomial(self, probs: np.ndarray) -> int:
        """The reference's sampler: draws two uniforms, keeps the second,
        returns the first index whose cumulative probability reaches it
        (main.cpp:4703-4720)."""
        u = np.float32(self.uniform(2)[1])
        # sequential float32 accumulation, exactly like the reference's
        # `float cumulative_probability += probs[i]` loop
        cum = np.add.accumulate(np.asarray(probs, dtype=np.float32))
        hits = np.nonzero(cum >= u)[0]
        return int(hits[0]) if hits.size else len(probs) - 1
