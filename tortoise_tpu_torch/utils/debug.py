"""Debug intermediates: the reference's save_f32_tensor /
compare_to_saved_tensor_with_name dump-and-diff workflow
(main.cpp:384-450, 4917-5001); a copy of the JAX package's
``utils/debug.py`` that also takes tensors on the card.

Enable with TORTOISE_DUMP_DIR=/path (or construct a DumpRegistry): model
code calls ``dump(name, array)``; arrays land as .npy files. A later run
(or the reference's own ./logs dumps converted to .npy) can be diffed with
``compare_dumps``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def _to_host(array) -> np.ndarray:
    """numpy copy of an array or a tensor on any device (bf16 as f32)."""
    if hasattr(array, "detach"):  # a torch.Tensor, possibly on the card
        t = array.detach().cpu()
        if not t.dtype.is_floating_point or t.dtype.itemsize >= 4:
            return t.numpy()
        return t.float().numpy()
    return np.asarray(array)


class DumpRegistry:
    def __init__(self, directory: Optional[str] = None):
        self._directory = directory
        self.counter = 0
        if directory:
            os.makedirs(directory, exist_ok=True)

    @property
    def directory(self) -> Optional[str]:
        # re-read per call: setting TORTOISE_DUMP_DIR after import still
        # takes effect (the default registry is built at import)
        return self._directory or os.environ.get("TORTOISE_DUMP_DIR")

    @property
    def enabled(self) -> bool:
        return bool(self.directory)

    def dump(self, name: str, array) -> None:
        d = self.directory
        if not d:
            return
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{self.counter:04d}_{name}.npy")
        np.save(path, _to_host(array))
        self.counter += 1


_default = DumpRegistry()


def dump(name: str, array) -> None:
    _default.dump(name, array)


def compare_dumps(dir_a: str, dir_b: str, atol: float = 1e-2,
                  ) -> List[Tuple[str, float]]:
    """Diff two dump directories by tensor name (ignoring the NNNN_
    counter prefix when present). Returns [(name, max_abs_diff)] for
    mismatches beyond atol; a NaN in either tensor counts as a mismatch,
    a tensor only one side dumped reads inf, and repeated names are
    compared occurrence by occurrence."""

    def index(d: str) -> Dict[str, str]:
        out: Dict[str, str] = {}
        seen: Dict[str, int] = {}
        for f in sorted(os.listdir(d)):
            if f.endswith(".npy"):
                stem = f[: -len(".npy")]
                head, _, tail = stem.partition("_")
                # strip only a numeric counter prefix; keep bare names
                name = tail if tail and head.isdigit() else stem
                i = seen.get(name, 0)
                seen[name] = i + 1
                out[name if i == 0 else f"{name}@{i}"] = os.path.join(d, f)
        return out

    a, b = index(dir_a), index(dir_b)
    bad = []
    for name in sorted(set(a) ^ set(b)):
        bad.append((name + " (only one side)", float("inf")))
    for name in sorted(set(a) & set(b)):
        x, y = np.load(a[name]), np.load(b[name])
        if x.shape != y.shape:
            bad.append((name, float("inf")))
            continue
        if x.size == 0:
            continue
        diff = np.abs(x.astype(np.float64) - y.astype(np.float64))
        if np.isnan(diff).any():
            bad.append((name, float("nan")))
        elif float(np.max(diff)) > atol:
            bad.append((name, float(np.max(diff))))
    return bad
