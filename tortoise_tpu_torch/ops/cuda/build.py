"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs
at first use, into ``tortoise_tpu_torch/_build/`` (git-ignored), under a
name keyed on a hash of the sources and flags: a checkout builds once,
and an edited source rebuilds. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

_PKG = pathlib.Path(__file__).resolve().parents[2]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_LL = ctypes.c_longlong
# argument types of every C entry point (pointers and the stream as
# c_void_p: a bare Python int would be passed as a 32-bit int)
SIGNATURES = {
    "tt_flash_packed": (_P, _I, _I, _I, _I, _P, _P, _F, _P, _P),
    "tt_flash_causal_qkv": (_P, _I, _I, _I, _I, _P, _F, _P, _P),
    "tt_flash_tma": (_P,) * 6 + (_I,) * 5 + (_P, _P, _LL, _P, _F, _I, _I,
                                            _P),
    "tt_flash_bhtd": (_P,) * 5 + (_I,) * 5 + (_P,) * 3 + (_F, _I, _P),
    "tt_int8_quantize_kv": (_P,) + (_I,) * 6 + (_P,) * 4,
    "tt_flash_packed_i8": (_P, _I) + (_P,) * 5 + (_I,) * 5 + (_F, _P, _P),
    "tt_lvc_gated_residual": (_P,) * 5 + (_I,) * 9 + (_LL, _LL, _P),
    "tt_group_norm_act": (_P, _I, _P, _LL) + (_P,) * 4 + (_LL, _P, _P)
                         + (_I,) * 6 + (_F, _I, _P),
    "tt_int8_quantize_rows": (_P, _I, _P, _P) + (_I,) * 4 + (_P,),
    "tt_int8_epilogue": (_P,) * 6 + (_I, _P) + (_I,) * 5 + (_P,),
    "tt_conv_pos": (_P, _P, _I) + (_P,) * 5 + (_I,) * 5 + (_P,),
    "tt_decode_trunk": ((_I,) * 7 + (_F,) + (_P,) * 22 + (_I,) + (_P,) * 10
                        + (_F, _I, _F, _F) + (_P,) * 4),
    "tt_decode_partial_floats": (_I,) * 4,
    "tt_decode_set_trace": (_P,),
}

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output (ptxas register/shared-memory report)


def find_nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libtortoise_kernels_{h.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the kernels unless this exact build exists; returns the
    library path. Each source compiles in its own nvcc process (they run
    in parallel), then one link; concurrent builders write distinct
    temporaries and publish with an atomic rename."""
    global build_log
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs, procs = [], []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *compile_flags, "-I", str(SRC_DIR), "-c", "-o", str(obj),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_name(f"{tag}.tmp.so")
    link = None
    if all(p.returncode == 0 for p in procs):
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp), *map(str, objs)], capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
    for obj in objs:
        obj.unlink(missing_ok=True)
    build_log = "".join(logs)
    if link is None or link.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed:\n{build_log}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = {"tt_decode_partial_floats": _LL,
                              "tt_decode_set_trace": None}.get(name,
                                                               ctypes.c_int)
            _lib = lib
        return _lib


def check(code: int, name: str) -> None:
    """Raise for a nonzero cudaError_t returned by a C entry point."""
    if code != 0:
        import torch

        msg = ""
        try:
            rt = ctypes.CDLL("libcudart.so")
            rt.cudaGetErrorString.restype = ctypes.c_char_p
            msg = rt.cudaGetErrorString(code).decode()
        except OSError:
            pass
        raise RuntimeError(
            f"{name} failed with cudaError {code} {msg} on "
            f"{torch.cuda.get_device_name()}")


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
