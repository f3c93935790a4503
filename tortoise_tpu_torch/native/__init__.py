"""Native (C++) host components of the port, bound via ctypes.

The port's own copy of ``tortoise_tpu/native`` (sources in ``src/``):

- ``ggml_index``: mmap-free fast scan of a GGML weight file returning
  (name, ttype, shape, byte_offset) records (zero-copy loading).
- ``wav_encode``: float32 PCM -> RIFF/WAVE bytes.
- ``StdRng``: exact std::mt19937 + libstdc++ uniform_real<float> /
  normal<double> stream reproduction for parity with the reference's seeded
  fixtures (main.cpp:39-50).
- ``NativeTokenizer``: the greedy longest-substring word encoder.

Every entry point has a pure-Python fallback; ``build()`` compiles the
shared library with g++ at first use into ``tortoise_tpu_torch/_build/``
(git-ignored), under a name keyed on a hash of the sources, never next to
the sources.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_build_failed = False


def _sources():
    return sorted(
        os.path.join(_SRC, f) for f in os.listdir(_SRC) if f.endswith(".cpp")
    )


def library_path() -> str:
    """Where this checkout's build of the sources lives."""
    h = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    for src in _sources():
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libtortoise_native_{h.hexdigest()[:16]}.so")


def build(force: bool = False) -> str | None:
    """Compile the native library if needed. Returns its path or None."""
    global _build_failed
    sources = _sources()
    if not sources:
        return None
    lib_path = library_path()
    if not force and os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # compile to a private tmp path and atomically publish: a killed or
    # concurrent build must never leave a truncated .so at lib_path
    tmp = f"{lib_path}.tmp.{os.getpid()}"
    cmd = ["g++", *_CXX_FLAGS, *sources, "-o", tmp]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, lib_path)
    except Exception:
        _build_failed = True
        if os.path.exists(tmp):
            try:
                os.unlink(tmp)
            except OSError:
                pass
        return None
    return lib_path


def _get_lib():
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
            _configure(lib)
        except Exception:
            # a bad artifact won't get better by reloading: remember the
            # failure (callers fall back to the pure-Python planes) and
            # drop the artifact so the NEXT process rebuilds cleanly
            _build_failed = True
            try:
                os.unlink(path)
            except OSError:
                pass
            return None
        _lib = lib
    return _lib


def _configure(lib):
    lib.ggml_index_open.restype = ctypes.c_void_p
    lib.ggml_index_open.argtypes = [ctypes.c_char_p]
    lib.ggml_index_count.restype = ctypes.c_int
    lib.ggml_index_count.argtypes = [ctypes.c_void_p]
    lib.ggml_index_record.restype = ctypes.c_int
    lib.ggml_index_record.argtypes = [
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),                 # ttype
        ctypes.POINTER(ctypes.c_int),                 # n_dims
        ctypes.POINTER(ctypes.c_longlong * 4),        # ne
        ctypes.POINTER(ctypes.c_longlong),            # offset
    ]
    lib.ggml_index_close.argtypes = [ctypes.c_void_p]

    lib.wav_encoded_size.restype = ctypes.c_longlong
    lib.wav_encoded_size.argtypes = [ctypes.c_longlong]
    lib.wav_encode.restype = ctypes.c_int
    lib.wav_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_longlong, ctypes.c_int,
        ctypes.c_char_p,
    ]

    lib.stdrng_new.restype = ctypes.c_void_p
    lib.stdrng_new.argtypes = [ctypes.c_ulonglong]
    lib.stdrng_free.argtypes = [ctypes.c_void_p]
    lib.stdrng_load_state.restype = ctypes.c_int
    lib.stdrng_load_state.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.stdrng_uniform_float.restype = ctypes.c_int
    lib.stdrng_uniform_float.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_float), ctypes.c_longlong]
    lib.stdrng_normal_double.restype = ctypes.c_int
    lib.stdrng_normal_double.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_longlong]
    lib.stdrng_load_normal_state.restype = ctypes.c_int
    lib.stdrng_load_normal_state.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.stdrng_raw_u32.restype = ctypes.c_int
    lib.stdrng_raw_u32.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint32), ctypes.c_longlong]


    lib.tok_create.restype = ctypes.c_void_p
    lib.tok_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.tok_free.argtypes = [ctypes.c_void_p]
    lib.tok_encode_word.restype = ctypes.c_int
    lib.tok_encode_word.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]

def available() -> bool:
    return _get_lib() is not None


def ggml_index(path: str):
    """Return [(name, ttype, numpy_shape, offset)] or None if unavailable."""
    lib = _get_lib()
    if lib is None:
        return None
    handle = lib.ggml_index_open(path.encode())
    if not handle:
        raise ValueError(f"{path}: native GGML index failed")
    try:
        count = lib.ggml_index_count(handle)
        out = []
        name_buf = ctypes.create_string_buffer(4096)
        ttype = ctypes.c_int()
        n_dims = ctypes.c_int()
        ne = (ctypes.c_longlong * 4)()
        offset = ctypes.c_longlong()
        for i in range(count):
            ok = lib.ggml_index_record(
                handle, i, name_buf, 4096,
                ctypes.byref(ttype), ctypes.byref(n_dims),
                ctypes.byref(ne), ctypes.byref(offset),
            )
            if not ok:
                raise ValueError(f"{path}: bad native record {i}")
            shape = tuple(int(ne[d]) for d in range(n_dims.value))[::-1]
            out.append(
                (name_buf.value.decode(), ttype.value, shape, offset.value)
            )
        return out
    finally:
        lib.ggml_index_close(handle)


def wav_encode(data: np.ndarray, sample_rate: int):
    lib = _get_lib()
    if lib is None:
        return None
    if 36 + 4 * np.size(data) > 0xFFFFFFFF:
        # RIFF sizes are u32: refuse before allocating the buffer (the
        # caller takes the pure-Python writer, which raises)
        return None
    data = np.ascontiguousarray(data, dtype=np.float32)
    size = lib.wav_encoded_size(data.size)
    buf = ctypes.create_string_buffer(size)
    ok = lib.wav_encode(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        data.size, sample_rate, buf,
    )
    if not ok:
        return None
    return buf.raw


class StdRng:
    """Native std::mt19937 + libstdc++ distribution streams (parity plane)."""

    def __init__(self, seed: int = 0):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._h = lib.stdrng_new(seed)

    def __del__(self):
        try:
            self._lib.stdrng_free(self._h)
        except Exception:
            pass

    def load_state(self, text: str) -> None:
        """Restore mt19937 state from the `operator>>` textual serialization."""
        if not self._lib.stdrng_load_state(self._h, text.encode()):
            raise ValueError("bad mt19937 state text")

    def load_normal_state(self, text: str) -> None:
        """Restore normal_distribution state (params + saved value)."""
        if not self._lib.stdrng_load_normal_state(self._h, text.encode()):
            raise ValueError("bad normal_distribution state text")

    def raw_u32(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.uint32)
        self._lib.stdrng_raw_u32(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), n)
        return out

    def uniform_float(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float32)
        self._lib.stdrng_uniform_float(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        return out

    def normal_double(self, n: int) -> np.ndarray:
        out = np.empty(n, dtype=np.float64)
        self._lib.stdrng_normal_double(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
        return out


class NativeTokenizer:
    """Greedy longest-substring encoder backed by the C++ component.

    Word splitting stays in Python (one regex for both planes); per-word
    encoding runs native. Falls back to raising if the lib is unbuilt —
    callers use tortoise_tpu_torch.text.Tokenizer as the pure-Python plane.
    """

    def __init__(self, vocab: dict):
        lib = _get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        parts = []
        import struct as _struct

        for token, idx in vocab.items():
            tb = token.encode("utf-8")
            parts.append(_struct.pack("<II", idx, len(tb)) + tb)
        blob = b"".join(parts)
        self._lib = lib
        self._handle = lib.tok_create(blob, len(blob))

    def encode_word(self, word: str):
        # per-call buffer: a shared instance buffer raced under threaded
        # serving (two HTTP handler threads tokenizing concurrently read
        # each other's ids). Every emitted id consumes >= 1 input byte,
        # so len(word_bytes) bounds the output exactly — no retry loop.
        wb = word.encode("utf-8")  # UnicodeEncodeError (lone surrogates)
        # is handled by the caller, which falls back to the pure plane
        buf = (ctypes.c_int * max(1, len(wb)))()
        n = self._lib.tok_encode_word(self._handle, wb, len(wb), buf,
                                      len(buf))
        return list(buf[:n])

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.tok_free(self._handle)
        except Exception:
            pass
