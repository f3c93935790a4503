"""The port's int8 plane cache (``tortoise_tpu_torch/io/plane_cache.py``)
and its host quantizers against the JAX package's: the same pairs bit for
bit, the same on-disk layout (planes cross between the packages both
ways), and a tiny synthesize() from a loaded plane equal to the same call
from the f32 tree. Tolerance: exact throughout."""

import numpy as np
import pytest
import torch

from tortoise_tpu.config import (
    tiny_ar_config,
    tiny_diffusion_config,
    tiny_vocoder_config,
)
from tortoise_tpu.io import plane_cache as JP
from tortoise_tpu.io.checkpoint import (
    random_ar_params,
    random_diffusion_params,
    random_vocoder_params,
)
from tortoise_tpu.pipeline import ar_stage as JAS
from tortoise_tpu.pipeline import diffusion_stage as JDS
from tortoise_tpu_torch.io import plane_cache as TP
from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline import ar_stage as TAS
from tortoise_tpu_torch.pipeline import common as TC
from tortoise_tpu_torch.pipeline import diffusion_stage as TDS
from tortoise_tpu_torch.pipeline import synthesize as T

torch.set_num_threads(1)  # several pytest workers share the cores


def assert_tree_equal(a, b, path=""):
    """Same keys, nesting (tuple vs list), dtypes and values."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), (path, type(b))
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}#{i}")
    else:
        x = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        y = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert x.dtype == y.dtype, (path, x.dtype, y.dtype)
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.fixture(scope="module")
def trees():
    return dict(
        ar=random_ar_params(tiny_ar_config(), 0, fast=True),
        diffusion=random_diffusion_params(tiny_diffusion_config(), 1,
                                          fast=True),
        vocoder=random_vocoder_params(tiny_vocoder_config(), 2, fast=True))


def jax_plane(trees):
    return {"ar": JAS.quantize_ar_host(trees["ar"]),
            "diffusion": JDS.quantize_diffusion_weights(trees["diffusion"]),
            "vocoder": trees["vocoder"]}


def port_plane(trees):
    return {"ar": TAS.quantize_ar_host(trees["ar"]),
            "diffusion": TDS.quantize_diffusion_weights(trees["diffusion"]),
            "vocoder": trees["vocoder"]}


def test_quantize_ar_host_matches_jax(trees):
    """The port's host AR pairs equal the JAX package's bit for bit (the
    port leaves the head pack to quantize_ar on the device), and the
    device quantizer on CPU tensors gives the same pairs."""
    want = JAS.quantize_ar_host(trees["ar"])
    got = TAS.quantize_ar_host(trees["ar"])
    assert "head_pack" not in got
    assert_tree_equal(got, {k: v for k, v in want.items()
                            if k != "head_pack"})
    assert isinstance(got["blocks"]["attn_w"], tuple)
    assert got["blocks"]["attn_w"][0].dtype == np.int8
    on_device = TAS.quantize_ar(tree_to_torch(trees["ar"]))
    for k in TAS._MATMUL_WEIGHTS:
        assert_tree_equal(on_device["blocks"][k], got["blocks"][k])
    assert_tree_equal(on_device["lm_w"], got["lm_w"])
    # the head pack built from the host pairs equals the JAX package's
    built = TAS.quantize_ar(tree_to_torch(got))["head_pack"]
    assert_tree_equal(built, want["head_pack"])


def test_host_diffusion_quantizer_matches_jax(trees):
    """numpy leaves quantize on the host into numpy pairs equal to the
    JAX package's; tensor leaves on their device give the same pairs."""
    want = JDS.quantize_diffusion_weights(trees["diffusion"])
    got = TDS.quantize_diffusion_weights(trees["diffusion"])
    assert isinstance(got["integrating_w"][0], np.ndarray)
    assert_tree_equal(got, want)
    assert_tree_equal(
        TDS.quantize_diffusion_weights(tree_to_torch(trees["diffusion"])),
        got)


def test_plane_round_trip(trees, tmp_path):
    """Same dtypes and values; pairs come back as tuples, the vocoder's
    stages as a list; the copy-on-write maps are writable, so
    tree_to_torch wraps them without a host copy."""
    plane = port_plane(trees)
    path = str(tmp_path / "plane")
    TP.save_plane(plane, path)
    assert TP.plane_exists(path)
    loaded = TP.load_plane(path)
    assert_tree_equal(loaded, plane)
    assert isinstance(loaded["vocoder"]["stages"], list)
    assert isinstance(loaded["diffusion"]["integrating_w"], tuple)
    leaf = loaded["ar"]["blocks"]["attn_w"][0]
    assert isinstance(leaf, np.memmap) and leaf.flags.writeable
    assert tree_to_torch(leaf).data_ptr() == leaf.ctypes.data
    eager = TP.load_plane(path, mmap=False)
    assert not isinstance(eager["ar"]["blocks"]["attn_w"][0], np.memmap)
    assert_tree_equal(eager, plane)


@pytest.mark.parametrize("writer", ["jax_writes", "port_writes"])
def test_planes_cross_packages(trees, tmp_path, writer):
    """A plane written by one package loads in the other, with the same
    tree; the JAX package's plane carries its head pack, which the port's
    quantize_ar passes through unchanged."""
    path = str(tmp_path / "plane")
    if writer == "jax_writes":
        plane = jax_plane(trees)
        JP.save_plane(plane, path)
        loaded = TP.load_plane(path)
        dev = TAS.quantize_ar(tree_to_torch(loaded["ar"]))
        assert_tree_equal(dev["head_pack"], plane["ar"]["head_pack"])
    else:
        plane = port_plane(trees)
        TP.save_plane(plane, path)
        loaded = JP.load_plane(path)
    assert_tree_equal(loaded, plane)


def test_missing_partial_and_second_writer(trees, tmp_path):
    """No directory or no manifest: None. A second writer of a complete
    plane discards its copy and leaves the first one as it was."""
    assert TP.load_plane(str(tmp_path / "nope")) is None
    assert not TP.plane_exists(str(tmp_path / "nope"))
    partial = tmp_path / "partial"
    (partial / "ar").mkdir(parents=True)
    np.save(partial / "ar" / "x.npy", np.zeros(3))
    assert TP.load_plane(str(partial)) is None
    # a writer replaces the manifest-less partial
    TP.save_plane({"x": np.ones(2, np.float32)}, str(partial))
    assert_tree_equal(TP.load_plane(str(partial)),
                      {"x": np.ones(2, np.float32)})
    TP.save_plane({"x": np.zeros(2, np.float32)}, str(partial))
    assert_tree_equal(TP.load_plane(str(partial)),
                      {"x": np.ones(2, np.float32)})
    assert sorted(p.name for p in tmp_path.iterdir()) == ["partial"]


def test_synthesize_from_loaded_plane(trees, tmp_path):
    """The tiny bf16 + int8 synthesize() on the CPU from a loaded plane
    equals the same call from the f32 tree (the casts pass the pairs
    through). Two loads in one process each get their own cast entries
    and the same result."""
    kw = dict(ar_cfg=tiny_ar_config(), diffusion_cfg=tiny_diffusion_config(),
              vocoder_cfg=tiny_vocoder_config())
    call = dict(tokens=[1, 5, 9, 4, 12, 0], voice=np.random.default_rng(0)
                .normal(0, 0.5, 64).astype(np.float32), seed=3,
                compute_dtype=torch.bfloat16, int8_weights=True,
                device="cpu")
    TC.clear_cast_cache()
    want = T.synthesize(T.TortoiseModels(
        ar_params=trees["ar"], diffusion_params=trees["diffusion"],
        vocoder_params=trees["vocoder"], **kw), **call)
    path = str(tmp_path / "plane")
    TP.save_plane(port_plane(trees), path)
    runs = []
    for _ in range(2):
        tree = TP.load_plane(path)
        runs.append(T.synthesize(T.TortoiseModels(
            ar_params=tree["ar"], diffusion_params=tree["diffusion"],
            vocoder_params=tree["vocoder"], **kw), **call))
        sources = [ent[0] for ent in TC._cast_cache.values()]
        for name in ("ar", "diffusion", "vocoder"):
            assert any(src is tree[name] for src in sources), name
    for got in runs:
        assert got.sequences == want.sequences
        np.testing.assert_array_equal(got.mel, want.mel)
        np.testing.assert_array_equal(got.audio, want.audio)
