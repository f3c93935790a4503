"""Placements of the model trees over the mesh (counterpart of
``tortoise_tpu/parallel/sharding.py``).

Data parallelism: batch rows split over the "dp" axis (``place_batch``,
``gather_batch``). Tensor parallelism, Megatron style over "tp": the wide
dims of the attention and MLP products split column-parallel into the
heads or hidden channels and back row-parallel, with an all-reduce after
the row-parallel product (``models/*``). The spec trees below are the one
place that says which dimension of which weight splits: each leaf is a
``Shard(dim)`` or ``Replicate()`` placement on the "tp" axis, with the
keys and dims of the JAX package's specs (the float tree's layouts). The
layer-stacked leading axis is never split.

Two layout facts that GSPMD hid and that explicit slicing must get right:

- the AR fused qkv is part-major, ``[q | k | v]`` on its last dim: a
  contiguous split would hand rank 0 all of q and half of k, so
  ``attn_w`` / ``attn_b`` split each part's head range (``_PART_MAJOR``);
- an int8 pair ``(w_int8, scale)`` lays its weight out in another
  orientation (``_PAIR_LAYOUT``). Pairs are quantized from the FULL tree
  first, then sliced: a column split takes its scales along, a row split
  keeps them whole. Quantizing a rank's rows alone would give other
  per-column scales.

The row-parallel biases (``proj_b``, ``fc_proj_b``, ``attn_proj_b``,
``res_out_conv_b``) stay replicated and are added once, after the
all-reduce.
"""

from __future__ import annotations

from typing import Optional

import torch

try:
    from torch.distributed.tensor import Replicate, Shard
except ImportError:  # torch < 2.4 keeps them private
    from torch.distributed._tensor import Replicate, Shard

from tortoise_tpu_torch.parallel.mesh import axis_group

# qkv tensors whose last dim is [q | k | v], each part H*Dh wide
_PART_MAJOR = ("attn_w", "attn_b")
# how an int8 pair lays out the float weight it replaces:
#   "t": (..., out, in) -> (..., in, out) (a linear; the AR lm head (V, d))
#   "conv": (..., out, in, 3) -> (..., 3*in, out), tap-major rows
# any other pair keeps the weight's shape (the AR blocks' x @ w weights)
_PAIR_LAYOUT = {"lm_w": "t", "attn_qkv_w": "t", "attn_proj_w": "t",
                "res_in_conv_w": "t", "integrating_w": "t",
                "res_out_conv_w": "conv"}
_CONV_TAPS = 3


def replicated(mesh) -> tuple:
    """Placements of an array held whole by every rank."""
    return (Replicate(),) * mesh.ndim


def batch_spec(mesh, ndim: int, axis: int = 0, name: str = "dp") -> tuple:
    """Placements of an ndim-array with dimension ``axis`` split over the
    mesh axis ``name``."""
    return tuple(Shard(axis) if n == name else Replicate()
                 for n in mesh.mesh_dim_names)


def ar_param_specs(mesh) -> dict:
    """"tp" placements of the AR tree: column-parallel qkv/fc,
    row-parallel proj, replicated embeddings and norms, a vocab-split lm
    head (uneven when tp does not divide the vocab)."""
    col, row, vec, rep = Shard(2), Shard(1), Shard(1), Replicate()
    blocks = {
        "ln1_w": rep, "ln1_b": rep, "ln2_w": rep, "ln2_b": rep,
        "attn_w": col, "attn_b": vec,
        "proj_w": row, "proj_b": rep,
        "fc_w": col, "fc_b": vec,
        "fc_proj_w": row, "fc_proj_b": rep,
    }
    return {
        "text_emb": rep, "text_pos": rep, "mel_emb": rep, "mel_pos": rep,
        "blocks": blocks,
        "ln_f_w": rep, "ln_f_b": rep, "lm_ln_w": rep, "lm_ln_b": rep,
        "lm_w": Shard(0), "lm_b": Shard(0),
    }


def _diffusion_attn_specs(mesh) -> dict:
    """One stacked attention group. The qkv rows are per-head interleaved
    (h*3D + part*D + d), so a contiguous split of the 3C output dim is a
    split of whole heads when tp divides n_head; the rel-pos table (L,
    nb, H) splits on the same heads; proj is the row-parallel product."""
    rep = Replicate()
    return {
        "attn_norm_w": rep, "attn_norm_b": rep,
        "attn_qkv_w": Shard(1), "attn_qkv_b": Shard(1),
        "attn_proj_w": Shard(2), "attn_proj_b": rep,
        "attn_rel_w": Shard(2),
    }


def _diffusion_res_specs(mesh) -> dict:
    """FiLM resblock: in_conv column-parallel, out_conv row-parallel. The
    group norm between them reduces within groups of C/n_groups channels,
    so a group-aligned split keeps its statistics shard-local; its affine
    splits to match. The emb linear stays whole (each rank slices its
    channels of the FiLM scale and shift)."""
    rep = Replicate()
    return {
        "res_in_norm_w": rep, "res_in_norm_b": rep,
        "res_in_conv_w": Shard(1), "res_in_conv_b": Shard(1),
        "res_emb_w": rep, "res_emb_b": rep,
        "res_out_norm_w": Shard(1), "res_out_norm_b": Shard(1),
        "res_out_conv_w": Shard(2), "res_out_conv_b": rep,
    }


def diffusion_param_specs(mesh) -> dict:
    """"tp" placements of the diffusion tree: heads in every attention,
    hidden channels in the resblocks; the small convs and norms around
    them and the residual stream stay whole. Needs tp | n_head and
    tp | n_groups."""
    rep = Replicate()
    layer = {**_diffusion_res_specs(mesh), **_diffusion_attn_specs(mesh)}
    return {
        "cond_scale": rep, "cond_shift": rep,
        "latent_conv_w": rep, "latent_conv_b": rep,
        "latent_blocks": _diffusion_attn_specs(mesh),
        "code_norm_w": rep, "code_norm_b": rep,
        "time_w0": rep, "time_b0": rep, "time_w1": rep, "time_b1": rep,
        "integrator": layer,
        "inp_w": rep, "inp_b": rep,
        "integrating_w": rep, "integrating_b": rep,
        "layers": layer,
        "tail": _diffusion_res_specs(mesh),
        "out_norm_w": rep, "out_norm_b": rep,
        "out_w": rep, "out_b": rep,
        "uncond": rep,
    }


def vocoder_param_specs(mesh, n_stages: int = 3) -> dict:
    """"tp" placements of the vocoder tree: the kernel predictor's output
    channels (kernel_conv and bias_conv) split; ``models.vocoder`` gathers
    them before the per-block reshape. The trunk's narrow convs stay
    whole and ride the "dp" rows."""
    rep = Replicate()
    stage = {
        "convt_w": rep, "convt_b": rep,
        "kp_in_w": rep, "kp_in_b": rep,
        "kp_res": {"w1": rep, "b1": rep, "w3": rep, "b3": rep},
        "kp_kernel_w": Shard(0), "kp_kernel_b": Shard(0),
        "kp_bias_w": Shard(0), "kp_bias_b": Shard(0),
        "cb_w": rep, "cb_b": rep,
    }
    return {
        "pre_w": rep, "pre_b": rep,
        "stages": [stage] * n_stages,
        "post_w": rep, "post_b": rep,
    }


def _take(x, dim: int, tp):
    lo, hi = tp.split(x.shape[dim])
    return x.narrow(dim, lo, hi - lo).contiguous()


def _shard_leaf(key, x, placement, tp):
    """This rank's slice of one leaf (a tensor or an int8 pair) under a
    "tp" placement given in the float weight's layout."""
    if tp is None or not isinstance(placement, Shard):
        return x
    if not isinstance(x, tuple):
        if key in _PART_MAJOR:  # split each of q, k, v on its heads
            parts = x.unflatten(-1, (3, x.shape[-1] // 3))
            return _take(parts, -1, tp).flatten(-2)
        return _take(x, placement.dim, tp)
    wq, scale = x
    layout = _PAIR_LAYOUT.get(key, "same")
    ndim = wq.dim() + (layout == "conv")
    dim = placement.dim - ndim  # negative, in the float layout
    if layout == "same":
        if key in _PART_MAJOR:
            return (_shard_leaf(key, wq, placement, tp),
                    _shard_leaf(key, scale, placement, tp))
        col = dim == -1
        return _take(wq, dim, tp), (_take(scale, -1, tp) if col else scale)
    if layout == "t":
        col = dim == -2  # the float weight's out dim
        return (_take(wq, -1 if col else -2, tp),
                _take(scale, -1, tp) if col else scale)
    if dim == -3:  # conv out channels
        return _take(wq, -1, tp), _take(scale, -1, tp)
    taps = wq.unflatten(-2, (_CONV_TAPS, wq.shape[-2] // _CONV_TAPS))
    return _take(taps, -2, tp).flatten(-3, -2), scale


def shard_tree(tree, specs, mesh):
    """This rank's slices of a tree of tensors (and int8 pairs) under a
    matching tree of "tp" placements. Leaves the tree holds as None (an
    absent head pack) stay None; every other key needs a placement."""
    tp = axis_group(mesh, "tp")

    def walk(t, s, key):
        if isinstance(t, dict):
            missing = set(k for k, v in t.items() if v is not None) - set(s)
            if missing:
                raise KeyError(f"shard_tree: no placement for "
                               f"{sorted(missing)}")
            return {k: None if v is None else walk(v, s[k], k)
                    for k, v in t.items()}
        if isinstance(t, list):
            return [walk(a, b, key) for a, b in zip(t, s)]
        return _shard_leaf(key, t, s, tp)

    return walk(tree, specs, None)


def place_batch(arr, mesh, batch_axis: int = 0):
    """This rank's rows of a batched array (its part of the ``batch_axis``
    split over "dp"), as a tensor on its device; the whole array, with a
    warning, when the batch does not divide the dp size. ``mesh=None``
    returns the array unchanged."""
    if mesh is None:
        return arr
    from tortoise_tpu_torch.pipeline.common import dp_rows

    x = torch.as_tensor(arr)
    rows = dp_rows(mesh, x.shape[batch_axis], "place_batch")
    device = torch.device(mesh.device_type)
    return x.narrow(batch_axis, rows.start, rows.stop - rows.start) \
        .to(device)


def gather_batch(local, mesh, batch_axis: int = 0,
                 n_rows: Optional[int] = None):
    """The inverse of ``place_batch``: every rank's rows, concatenated in
    rank order on ``batch_axis``. ``n_rows``, the global batch size,
    tells the replicated fallback (``n_rows % dp != 0``: ``local`` is
    already every row and comes back unchanged) from a split; without it
    the rows are taken to be split. ``mesh=None`` (or dp = 1) returns
    ``local`` unchanged."""
    dp = axis_group(mesh, "dp")
    if dp is None or (n_rows is not None and n_rows % dp.size):
        return local
    return dp.all_gather(torch.as_tensor(local), batch_axis)


__all__ = ["Replicate", "Shard", "ar_param_specs", "batch_spec",
           "diffusion_param_specs", "gather_batch", "place_batch",
           "replicated", "shard_tree", "vocoder_param_specs"]
