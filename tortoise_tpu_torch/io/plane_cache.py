"""Disk cache for production-plane (int8-quantized) host weight trees; a
copy of the JAX package's ``io/plane_cache.py`` with the same on-disk
layout, so a plane written by either package loads in the other.

A warm restart otherwise pays three costs before its first utterance:
read the f32 checkpoint, quantize the matmul weights, and upload. After
one process quantizes on the host (``ar_stage.quantize_ar_host``,
``diffusion_stage.quantize_diffusion_weights`` on the numpy tree), the
int8 pairs and the f32 rest are saved one .npy per leaf, and later
processes memory-map them: no f32 read, no quantization, and the upload
reads the pages straight from the page cache.

Layout: one directory per tree; the leaf at tree path a/b/c lives in
a/b/c.npy; list and tuple nodes use '#<i>' path segments (the save_npz
scheme). Loaded trees give pairs as tuples and structural lists (the
vocoder's stages) as lists, which the manifest records. A MANIFEST.json
written last makes a partial cache invisible; writers build in a tmp
sibling and rename it into place.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional

import numpy as np

_MANIFEST = "MANIFEST.json"


def _flatten(prefix, node, out, lists):
    if isinstance(node, dict):
        for k, v in node.items():
            _flatten(f"{prefix}{k}/", v, out, lists)
    elif isinstance(node, (list, tuple)):
        if isinstance(node, list):
            lists.append(prefix[:-1] or "")
        for i, v in enumerate(node):
            _flatten(f"{prefix}#{i}/", v, out, lists)
    else:
        out[prefix[:-1]] = np.asarray(node)


def save_plane(tree: dict, path: str) -> None:
    """Write ``tree`` (host numpy tree of dict/list/tuple/ndarray) under
    directory ``path``, atomically (tmp dir + rename). ``path`` must be
    keyed by content: when a complete cache already exists it is kept and
    this write is discarded, since replacing it would pull leaves from
    under a reader that already read the manifest. Concurrent writers
    race benignly: one publish wins, the others discard theirs."""
    flat: dict = {}
    lists: list = []
    _flatten("", tree, flat, lists)
    tmp = f"{path}.{os.getpid()}.tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    for key, arr in flat.items():
        fp = os.path.join(tmp, key + ".npy")
        os.makedirs(os.path.dirname(fp) or tmp, exist_ok=True)
        np.save(fp, arr)
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump({"keys": sorted(flat), "lists": sorted(lists)}, f)
    if plane_exists(path):
        shutil.rmtree(tmp, ignore_errors=True)
        return
    try:
        if os.path.exists(path):
            # a directory without a manifest is a stale partial write
            # (no reader uses it): clear it, or the rename fails
            shutil.rmtree(path)
        os.replace(tmp, path)
    except OSError:
        # another writer published first; its cache is equivalent
        if not plane_exists(path):
            raise
        shutil.rmtree(tmp, ignore_errors=True)


def plane_exists(path: str) -> bool:
    return os.path.exists(os.path.join(path, _MANIFEST))


def load_plane(path: str, mmap: bool = True) -> Optional[dict]:
    """Rebuild the tree saved by save_plane, or None if ``path`` holds no
    complete cache. ``mmap=True`` maps every leaf copy-on-write: pages
    are read from disk on first touch (during the upload), and the
    arrays are writable, so ``torch.from_numpy`` wraps them without the
    host copy a read-only array needs (``params.tree_to_torch``); a write
    stays private to the process and never reaches the file."""
    mf = os.path.join(path, _MANIFEST)
    try:
        with open(mf) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return None
    keys = manifest["keys"]
    list_paths = set(manifest.get("lists", ()))
    out: dict = {}
    mode = "c" if mmap else None
    try:
        for key in keys:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.load(os.path.join(path, key + ".npy"),
                                      mmap_mode=mode)
    except OSError:
        # the cache vanished under us: a cold start, not a crash
        return None

    def fold(node, prefix):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            seq = [fold(node[f"#{i}"], f"{prefix}#{i}/")
                   for i in range(len(node))]
            return seq if prefix[:-1] in list_paths else tuple(seq)
        return {k: fold(v, f"{prefix}{k}/") for k, v in node.items()}

    return fold(out, "")
