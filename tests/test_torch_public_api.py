"""The last public names of the JAX package that the port lacked:
``ops.group_norm`` (the channel-major GroupNorm with a frame mask) held
against ``tortoise_tpu.ops.basic.group_norm``, and
``TortoiseModels.to_device`` (moves the host trees onto the device in
place; idempotent; the stages' memoized casts stay one per tree and
plane; synthesis after it gives the same audio bit for bit)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pseudo_golden_lib import tolerance_for
from tortoise_tpu.ops.basic import group_norm as jax_group_norm
from tortoise_tpu.pipeline.synthesize import TortoiseModels as JaxModels
from tortoise_tpu_torch import ops
from tortoise_tpu_torch.pipeline import common
from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels, synthesize

torch.set_num_threads(1)  # the tier-1 run's workers share the cores


def test_ops_exports_the_jax_names():
    import tortoise_tpu.ops as jax_ops

    names = ("layer_norm", "group_norm", "gelu", "silu", "leaky_relu",
             "pdot")
    for name in names:
        assert callable(getattr(jax_ops, name)), name
        assert getattr(ops, name) is getattr(ops.basic, name), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("affine", [False, True], ids=["bare", "affine"])
def test_group_norm_matches_jax(dtype, masked, affine):
    """(B, C, T) = (3, 16, 21) in 4 groups, with and without a ragged
    (B, 1, T) frame mask and the affine; f32 within 1e-5 and bf16 within
    the bf16 tolerance of the pseudo-golden fixture, of max |out|."""
    rng = np.random.default_rng(7)
    x = (rng.normal(0, 2, (3, 16, 21)) + 0.5).astype(np.float32)
    w = rng.normal(1, 0.2, (16,)).astype(np.float32) if affine else None
    b = rng.normal(0, 0.2, (16,)).astype(np.float32) if affine else None
    mask = None
    if masked:
        mask = np.arange(21)[None, None, :] < np.array([21, 13, 1])[
            :, None, None]
    want = np.asarray(jax_group_norm(
        jnp.asarray(x, dtype), 4,
        None if w is None else jnp.asarray(w),
        None if b is None else jnp.asarray(b), mask=(
            None if mask is None else jnp.asarray(mask))), np.float32)
    got = ops.group_norm(
        torch.from_numpy(x).to(getattr(torch, dtype)), 4,
        None if w is None else torch.from_numpy(w),
        None if b is None else torch.from_numpy(b), mask=(
            None if mask is None else torch.from_numpy(mask)))
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == x.shape
    got = got.float().numpy()
    tol = 1e-5 if dtype == "float32" else tolerance_for(
        "diff_denoise_bf16_flash")
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale
    if masked:  # the invalid frames are zero
        assert not got[1, :, 13:].any() and not got[2, :, 1:].any()


def test_to_device_takes_the_jax_parameters():
    jax_p = list(inspect.signature(JaxModels.to_device).parameters)
    port_p = list(inspect.signature(TortoiseModels.to_device).parameters)
    assert jax_p == ["self", "include_ar", "include_diffusion"]
    assert port_p == jax_p + ["device"]


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def test_to_device_moves_host_trees_in_place(monkeypatch):
    models = TortoiseModels.random(0, tiny=True)
    ar_host = models.ar_params
    assert models.to_device(include_ar=False, device="cpu") is models
    assert models.ar_params is ar_host  # the AR stage casts its own tree
    for tree in (models.diffusion_params, models.vocoder_params):
        leaves = list(_leaves(tree))
        assert leaves and all(isinstance(x, torch.Tensor)
                              and x.device.type == "cpu" for x in leaves)
    # the values are the host tree's, bit for bit
    host = TortoiseModels.random(0, tiny=True)
    for got, want in zip(_leaves(models.vocoder_params),
                         _leaves(host.vocoder_params)):
        np.testing.assert_array_equal(got.numpy(), want)
    # the default device is the card: without one, it raises
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        models.to_device()


class _CountingDict(dict):
    inserts = 0

    def __setitem__(self, key, value):
        type(self).inserts += 1
        super().__setitem__(key, value)


@pytest.mark.parametrize("plane", ["f32", "bf16-int8"])
def test_to_device_is_idempotent_and_keeps_one_cast_per_plane(
        monkeypatch, plane):
    """After to_device, two synthesize() calls make one cast per tree and
    plane; a second to_device keeps the same trees (so the same casts);
    the audio equals, bit for bit, that of the host trees."""
    kw = dict(tokens=[1, 5, 9, 0], voice=np.zeros(64, np.float32), seed=0,
              device="cpu")
    if plane == "bf16-int8":
        kw.update(compute_dtype=torch.bfloat16, int8_weights=True)
    want = synthesize(TortoiseModels.random(0, tiny=True), **kw).audio

    monkeypatch.setattr(common, "_cast_cache", _CountingDict())
    _CountingDict.inserts = 0
    models = TortoiseModels.random(0, tiny=True).to_device(device="cpu")
    trees = (models.ar_params, models.diffusion_params,
             models.vocoder_params)
    first = synthesize(models, **kw).audio
    assert _CountingDict.inserts == 3  # AR, diffusion and vocoder casts
    assert models.to_device(device="cpu") is models
    assert all(a is b for a, b in zip(trees, (
        models.ar_params, models.diffusion_params, models.vocoder_params)))
    second = synthesize(models, **kw).audio
    assert _CountingDict.inserts == 3
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)
