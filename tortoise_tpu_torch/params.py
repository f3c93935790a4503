"""Parameter trees carried from the JAX package's numpy trees.

The checkpoint loaders (``tortoise_tpu_torch.io.checkpoint``: ``random_*_params``
and ``convert_*_checkpoint``) deliver nested dicts/lists of numpy arrays
with stacked (L, ...) layer blocks; int8 casts are ``(w_int8, scale)``
tuples. ``tree_to_torch`` maps such a tree onto tensors with the same
keys, nesting and layouts, so the port reads weights exactly where the
JAX package does.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def tree_to_torch(tree, device="cpu"):
    """Copy every array leaf of ``tree`` to a tensor on ``device``, with
    its dtype. dicts, lists and tuples keep their structure (an int8 pair
    stays a 2-tuple); tensors already on the device pass through."""
    if isinstance(tree, dict):
        return {k: tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_torch(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, np.ndarray) or np.isscalar(tree):
        arr = np.ascontiguousarray(tree)
        if not arr.flags.writeable:  # torch tensors may be written to
            arr = arr.copy()
        return torch.from_numpy(arr).to(device)
    return tree


def numel(shapes) -> int:
    """Elements of a tree of shapes (nested dicts of tuples)."""
    if isinstance(shapes, dict):
        return sum(numel(v) for v in shapes.values())
    return math.prod(shapes)


def _carve(buf, shapes, off, std, centre, prefix):
    out = {}
    for name, s in shapes.items():
        path = prefix + name
        if isinstance(s, dict):
            out[name], off = _carve(buf, s, off, std, centre, path + "/")
            continue
        n = math.prod(s)
        t = buf[off:off + n].view(s).mul_(std(path))
        c = centre(path)
        if c:
            t.add_(c)
        out[name], off = t, off + n
    return out, off


def seeded_trees(specs, seed: int, device) -> list:
    """Trees of f32 tensors on ``device`` from ``seed``: one generator,
    one flat N(0, 1) draw a tree (in the order of ``specs``), carved in
    the tree's order and scaled. ``specs``: (shapes, std, centre) each,
    ``std(path)`` and ``centre(path)`` giving a tensor's scale and shift
    from its path (its names from the root, joined by "/")."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    trees = []
    for shapes, std, centre in specs:
        buf = torch.randn(numel(shapes), generator=gen, device=device,
                          dtype=torch.float32)
        trees.append(_carve(buf, shapes, 0, std, centre, "")[0])
    return trees
