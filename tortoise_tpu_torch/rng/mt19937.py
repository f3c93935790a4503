"""Pure-Python std::mt19937 + libstdc++ distribution semantics.

The reference consumes one process-global ``std::mt19937`` through
``std::uniform_real_distribution<float>(0,1)`` (sampling) and
``std::normal_distribution<double>(0,1)`` (all noise) in a specific
interleaved order (main.cpp:39-50, 4695-4720), and its seeded tests restore
the serialized engine state from fixture files (main.cpp:6260-6265).

This module reproduces those streams bit-for-bit:

- ``MT19937``: the engine, including libstdc++'s ``operator<<``/``>>``
  textual state format (624 words + position index).
- ``uniform_real<float>``: ``generate_canonical<float, 24>`` → one 32-bit
  draw, ``x * 2^-32`` rounded in float32, clamped to nextafter(1, 0).
- ``normal<double>``: Marsaglia polar with libstdc++'s saved-value state;
  each candidate consumes two ``generate_canonical<double, 53>`` values
  (two 32-bit draws each, low word first), returns ``y*mult`` and saves
  ``x*mult``.

Validated bit-for-bit against the g++-compiled native/stdrng.cpp in
tests/test_rng.py.
"""

from __future__ import annotations

import math

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF

_F32_ONE_BELOW = np.nextafter(np.float32(1.0), np.float32(0.0))
_F64_ONE_BELOW = np.nextafter(1.0, 0.0)


class MT19937:
    def __init__(self, seed: int = 5489):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        mt = np.empty(_N, dtype=np.uint64)
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            prev = int(mt[i - 1])
            mt[i] = (1812433253 * (prev ^ (prev >> 30)) + i) & 0xFFFFFFFF
        self._mt = mt
        self._pos = _N  # force twist on first draw

    # -- state (libstdc++ operator<< / operator>>) ------------------------
    def load_state_text(self, text: str) -> None:
        parts = text.split()
        if len(parts) < _N + 1:
            raise ValueError(f"mt19937 state needs {_N + 1} fields, got {len(parts)}")
        self._mt = np.array([int(p) for p in parts[:_N]], dtype=np.uint64)
        self._pos = int(parts[_N])

    def state_text(self) -> str:
        return " ".join(str(int(v)) for v in self._mt) + f" {self._pos}"

    # -- generation --------------------------------------------------------
    def _twist(self) -> None:
        # In-place sequential semantics, staged so each slice only reads
        # values that are final (indices >= N-M read already-twisted words).
        mt = self._mt

        def mix(cur, nxt, base):
            y = (cur & _UPPER) + (nxt & _LOWER)
            return (
                base
                ^ (y >> np.uint64(1))
                ^ np.where(
                    (y & np.uint64(1)).astype(bool),
                    np.uint64(_MATRIX_A),
                    np.uint64(0),
                )
            ) & np.uint64(0xFFFFFFFF)

        k = _N - _M  # 227; each stage's `base` slice is final before use
        mt[:k] = mix(mt[:k], mt[1 : k + 1], mt[_M:_N])
        mt[k : 2 * k] = mix(mt[k : 2 * k], mt[k + 1 : 2 * k + 1], mt[:k])
        mt[2 * k : _N - 1] = mix(
            mt[2 * k : _N - 1], mt[2 * k + 1 : _N], mt[k : _M - 1]
        )
        mt[_N - 1 : _N] = mix(mt[_N - 1 : _N], mt[0:1], mt[_M - 1 : _M])
        self._pos = 0

    def raw(self, n: int) -> np.ndarray:
        """Next n tempered 32-bit outputs."""
        out = np.empty(n, dtype=np.uint64)
        filled = 0
        while filled < n:
            if self._pos >= _N:
                self._twist()
            take = min(n - filled, _N - self._pos)
            out[filled : filled + take] = self._mt[self._pos : self._pos + take]
            self._pos += take
            filled += take
        y = out
        y = y ^ (y >> 11)
        y = (y ^ ((y << 7) & 0x9D2C5680)) & 0xFFFFFFFF
        y = (y ^ ((y << 15) & 0xEFC60000)) & 0xFFFFFFFF
        y = y ^ (y >> 18)
        return y.astype(np.uint32)

    def __call__(self) -> int:
        return int(self.raw(1)[0])


def canonical_float(engine: MT19937, n: int) -> np.ndarray:
    """generate_canonical<float, 24> over mt19937: one draw per value."""
    x = engine.raw(n)
    vals = (x.astype(np.float32)) * np.float32(2.0**-32)
    return np.minimum(vals, _F32_ONE_BELOW)


def canonical_double(engine: MT19937, n: int) -> np.ndarray:
    """generate_canonical<double, 53>: two draws per value, low word first."""
    x = engine.raw(2 * n).astype(np.float64)
    sums = x[0::2] + x[1::2] * 2.0**32
    vals = sums / 2.0**64
    return np.minimum(vals, _F64_ONE_BELOW)


class PyStdRng:
    """Drop-in pure-Python twin of native.StdRng."""

    def __init__(self, seed: int = 0):
        self.engine = MT19937(seed)
        self._normal_saved: float | None = None
        # libstdc++ scales at return: ret = raw * stddev + mean (the
        # saved value is stored UNscaled). The reference only ever uses
        # N(0,1), but a restored state must honor its parameters — the
        # native backend (stdrng.cpp) already does
        self._normal_mean = 0.0
        self._normal_stddev = 1.0

    def load_state(self, text: str) -> None:
        self.engine.load_state_text(text)

    def load_normal_state(self, text: str) -> None:
        """Parse libstdc++ normal_distribution serialization.

        Format: ``<mean> <stddev> <saved_available> [<saved>]`` (e.g. the
        reference fixture ``test_diffusion_normal_distribution.bin``).
        """
        parts = text.split()
        if len(parts) < 3:
            raise ValueError("bad normal_distribution state")
        avail = bool(int(float(parts[2])))
        if avail and len(parts) < 4:
            raise ValueError("bad normal_distribution state: "
                             "saved flag set but no saved value")
        self._normal_mean = float(parts[0])
        self._normal_stddev = float(parts[1])
        self._normal_saved = float(parts[3]) if avail else None

    def raw_u32(self, n: int) -> np.ndarray:
        return self.engine.raw(n)

    def uniform_float(self, n: int) -> np.ndarray:
        return canonical_float(self.engine, n)

    def normal_double(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        i = 0
        if self._normal_saved is not None and n > 0:
            out[0] = self._normal_saved
            self._normal_saved = None
            i = 1
        while i < n:
            # Each polar candidate consumes exactly two canonical doubles
            # (4 engine words) and, if accepted, produces two outputs.
            # Drawing ceil(remaining / 2) candidates therefore never
            # over-consumes the engine stream, keeping later draws aligned
            # with libstdc++.
            groups = (n - i + 1) // 2
            u = canonical_double(self.engine, 2 * groups)
            x = 2.0 * u[0::2] - 1.0
            y = 2.0 * u[1::2] - 1.0
            r2 = x * x + y * y
            ok = (r2 <= 1.0) & (r2 != 0.0)
            if not ok.any():
                continue
            r2_ok = r2[ok]
            # log must be libm's (as libstdc++ uses); numpy's SIMD log
            # differs by 1 ulp on ~0.1% of inputs, breaking bit-parity.
            logs = np.fromiter(
                (math.log(v) for v in r2_ok), dtype=np.float64, count=len(r2_ok)
            )
            mult = np.sqrt(-2.0 * logs / r2_ok)
            ret = y[ok] * mult   # returned first
            sav = x[ok] * mult   # saved for the next call
            pair = np.empty(2 * len(mult), dtype=np.float64)
            pair[0::2] = ret
            pair[1::2] = sav
            take = min(len(pair), n - i)
            out[i : i + take] = pair[:take]
            i += take
            if take < len(pair):  # odd tail: last x*mult becomes saved state
                self._normal_saved = float(pair[take])
        if self._normal_mean != 0.0 or self._normal_stddev != 1.0:
            # libstdc++ scales at return; the saved value stays raw
            out = out * self._normal_stddev + self._normal_mean
        return out
