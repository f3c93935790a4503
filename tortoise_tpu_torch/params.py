"""Parameter trees carried from the JAX package's numpy trees.

The checkpoint loaders (``tortoise_tpu_torch.io.checkpoint``: ``random_*_params``
and ``convert_*_checkpoint``) deliver nested dicts/lists of numpy arrays
with stacked (L, ...) layer blocks; int8 casts are ``(w_int8, scale)``
tuples. ``tree_to_torch`` maps such a tree onto tensors with the same
keys, nesting and layouts, so the port reads weights exactly where the
JAX package does.
"""

from __future__ import annotations

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
