"""GGML weight-file reader/writer.

File format (as consumed by the reference loaders, main.cpp:493-501 and
main.cpp:811-888):

    uint32 magic = 0x67676d6c
    repeated records until EOF:
        int32 n_dims
        int32 name_len
        int32 ttype            (0 = f32; only f32 appears in these files)
        int32 ne[n_dims]       (ggml axis order: ne[0] fastest-varying)
        char  name[name_len]
        raw   data             (ne product * dtype size, row-major w.r.t.
                                reversed ne — i.e. numpy shape ne[::-1])

The reader returns numpy arrays with shape ``ne[::-1]`` so a ggml tensor
declared ``ggml_new_tensor_2d(ctx, F32, 3072, 1024)`` arrives as a numpy
array of shape (1024, 3072) — the torch/Conv1D orientation the exporter
wrote.

A writer is provided for round-trip tests and for synthesizing random
checkpoints with the production tensor inventory (the published weight
files are not redistributable with this repo).

Prefers the native mmap-based reader (tortoise_tpu_torch.native) when the C++
extension has been built; falls back to pure Python.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, Tuple

import numpy as np

GGML_MAGIC = 0x67676D6C

_GGML_DTYPES = {
    0: np.dtype(np.float32),
    1: np.dtype(np.float16),
    16: np.dtype(np.int8),
    24: np.dtype(np.int32),  # GGML_TYPE_I32 in the vintage used by the ref
}
_DTYPE_TO_TTYPE = {np.dtype(np.float32): 0, np.dtype(np.float16): 1}


def read_ggml(path: str, mmap: bool = True) -> Dict[str, np.ndarray]:
    """Parse a GGML file into {tensor_name: ndarray(shape=ne[::-1])}."""
    try:
        from tortoise_tpu_torch.native import ggml_index  # fast path

        index = ggml_index(path)
    except Exception:
        index = None
    if index is not None:
        return _views_from_index(path, index, mmap)
    return _read_ggml_py(path, mmap)


def _views_from_index(path, index, mmap):
    out = {}
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    for name, ttype, shape, offset in index:
        dtype = _GGML_DTYPES[ttype]
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(
            buf, dtype=dtype, count=count, offset=offset
        ).reshape(shape)
        out[name] = arr if mmap else np.array(arr)
    return out


def _read_ggml_py(path: str, mmap: bool) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    n = buf.nbytes
    if n < 4:
        raise ValueError(f"{path}: truncated GGML file")
    (magic,) = struct.unpack_from("<I", buf, 0)
    if magic != GGML_MAGIC:
        raise ValueError(f"{path}: bad GGML magic 0x{magic:08x}")
    pos = 4
    while pos + 12 <= n:
        n_dims, name_len, ttype = struct.unpack_from("<iii", buf, pos)
        pos += 12
        if n_dims < 0 or n_dims > 4 or name_len < 0 or name_len > 4096:
            raise ValueError(f"{path}: corrupt record header at {pos - 12}")
        ne = struct.unpack_from(f"<{n_dims}i", buf, pos)
        pos += 4 * n_dims
        if any(d < 0 for d in ne):
            # symmetric with the native scanner: a negative dim flips
            # the payload size negative and walks the cursor backwards
            raise ValueError(f"{path}: corrupt record dims at {pos}")
        name = bytes(buf[pos : pos + name_len]).decode("utf-8")
        pos += name_len
        dtype = _GGML_DTYPES.get(ttype)
        if dtype is None:
            raise ValueError(f"{path}: tensor '{name}' has ttype {ttype}")
        count = 1
        for d in ne:
            count *= d
        nbytes = count * dtype.itemsize
        if pos + nbytes > n:
            raise ValueError(f"{path}: tensor '{name}' data truncated")
        arr = np.frombuffer(buf, dtype=dtype, count=count, offset=pos)
        arr = arr.reshape(tuple(reversed(ne)))
        out[name] = arr if mmap else np.array(arr)
        pos += nbytes
    return out


def write_ggml(
    path: str, tensors: Iterable[Tuple[str, np.ndarray]] | Dict[str, np.ndarray]
) -> None:
    """Write tensors in GGML record format (numpy shape -> reversed ne)."""
    if isinstance(tensors, dict):
        tensors = tensors.items()
    with open(path, "wb") as f:
        f.write(struct.pack("<I", GGML_MAGIC))
        for name, arr in tensors:
            arr = np.ascontiguousarray(arr)
            ttype = _DTYPE_TO_TTYPE.get(arr.dtype)
            if ttype is None:
                raise ValueError(f"unsupported dtype {arr.dtype} for '{name}'")
            ne = tuple(reversed(arr.shape)) or (1,)
            name_b = name.encode("utf-8")
            f.write(struct.pack("<iii", len(ne), len(name_b), ttype))
            f.write(struct.pack(f"<{len(ne)}i", *ne))
            f.write(name_b)
            f.write(arr.tobytes())
