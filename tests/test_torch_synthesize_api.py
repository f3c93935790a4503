"""Two parameters of the JAX package's synthesize API on the port:
``synthesize(materialize=False)`` and ``TortoiseModels.random(cache_dir=)``.

materialize=False leaves ``mel`` None and ``latents`` one None per
candidate, with the audio of the materialized call (exact), and agrees
with the JAX call on the tiny f32 plane within 1e-3 of its max (the
tolerance of tests/pseudo_golden_lib.py), the random streams replayed
from the JAX key chains. The random-weight caches carry the JAX package's
file names and load in either package (exact)."""

import os

import numpy as np
import pytest
import torch

from tortoise_tpu.config import (
    tiny_ar_config,
    tiny_diffusion_config,
    tiny_vocoder_config,
)
from tortoise_tpu.io import checkpoint as JCK
from tortoise_tpu.io.checkpoint import (
    random_ar_params,
    random_diffusion_params,
    random_vocoder_params,
)
from tortoise_tpu.pipeline import synthesize as J
from tortoise_tpu_torch.io import checkpoint as TCK
from tortoise_tpu_torch.pipeline import synthesize as T
from test_torch_batch import replay_jax_streams

torch.set_num_threads(1)  # several pytest workers share the cores

TOKENS = [1, 5, 9, 4, 12, 7, 0]


@pytest.fixture(scope="module")
def models_kw():
    return dict(
        ar_params=random_ar_params(tiny_ar_config(), 1),
        diffusion_params=random_diffusion_params(tiny_diffusion_config(), 2),
        vocoder_params=random_vocoder_params(tiny_vocoder_config(), 3),
        ar_cfg=tiny_ar_config(), diffusion_cfg=tiny_diffusion_config(),
        vocoder_cfg=tiny_vocoder_config())


@pytest.fixture(scope="module")
def voice():
    return np.random.default_rng(0).normal(0, 0.5, 64).astype(np.float32)


def test_materialize_false_skips_the_downloads(models_kw, voice):
    """Two candidates: mel None, latents [None, None], the same tokens
    and audio as the materialized call."""
    kw = dict(tokens=TOKENS, voice=voice, seed=2, batch_size=2,
              device="cpu")
    m = T.TortoiseModels(**models_kw)
    full = T.synthesize(m, **kw)
    lean = T.synthesize(m, materialize=False, **kw)
    assert full.mel is not None and len(full.latents) == 2
    assert lean.mel is None and lean.latents == [None, None]
    assert lean.sequences == full.sequences
    np.testing.assert_array_equal(lean.audio, full.audio)
    assert set(lean.timings) == set(full.timings)


def test_materialize_false_matches_jax(models_kw, voice, monkeypatch):
    """The tiny f32 plane with the JAX key chains replayed: the same
    tokens, audio within 1e-3 of the JAX call's max, and the same
    None-shaped mel and latents."""
    replay_jax_streams(monkeypatch)
    kw = dict(tokens=TOKENS, voice=voice, seed=4, batch_size=2,
              materialize=False)
    want = J.synthesize(J.TortoiseModels(**models_kw), **kw)
    got = T.synthesize(T.TortoiseModels(**models_kw), device="cpu", **kw)
    assert want.mel is None and got.mel is None
    assert got.latents == want.latents == [None, None]
    assert got.sequences == want.sequences
    assert got.audio.shape == want.audio.shape
    assert np.abs(got.audio - want.audio).max() <= \
        1e-3 * np.abs(want.audio).max()


def assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            assert_trees_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_trees_equal(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


def refuse_drawing(monkeypatch, module):
    """Make ``module``'s random_*_params raise: a tree must come from the
    cache."""
    def refuse(*a, **k):
        raise AssertionError("drew weights instead of loading the cache")
    for name in ("random_ar_params", "random_diffusion_params",
                 "random_vocoder_params"):
        monkeypatch.setattr(module, name, refuse)


@pytest.mark.parametrize("writer", ["port_writes", "jax_writes"])
def test_random_cache_crosses_packages(tmp_path, monkeypatch, writer):
    """The cache files carry the JAX package's names; the other package
    loads them without drawing, and the trees equal a fresh draw."""
    cache = str(tmp_path)
    first, second = (T, J) if writer == "port_writes" else (J, T)
    fresh = T.TortoiseModels.random(5, tiny=True)
    first.TortoiseModels.random(5, tiny=True, cache_dir=cache)
    assert sorted(os.listdir(cache)) == [
        "ar_tiny_5.npz", "diffusion_tiny_6.npz", "vocoder_tiny_7.npz"]
    refuse_drawing(monkeypatch, JCK if second is J else TCK)
    loaded = second.TortoiseModels.random(5, tiny=True, cache_dir=cache)
    for name in ("ar_params", "diffusion_params", "vocoder_params"):
        assert_trees_equal(getattr(loaded, name), getattr(fresh, name))


def test_random_cache_skips_overridden_trees(tmp_path):
    """A tree drawn under a config override is never written and never
    read from the cache: a 2-head table must not load as the default."""
    cache = str(tmp_path)
    default = T.TortoiseModels.random(0, tiny=True, cache_dir=cache)
    files = sorted(os.listdir(cache))
    over = T.TortoiseModels.random(0, tiny=True, cache_dir=cache,
                                   diffusion={"n_head": 2},
                                   vocoder={"use_pallas_lvc": True})
    assert sorted(os.listdir(cache)) == files
    assert over.diffusion_cfg.n_head == 2
    fresh = T.TortoiseModels.random(0, tiny=True, diffusion={"n_head": 2})
    assert_trees_equal(over.diffusion_params, fresh.diffusion_params)
    assert_trees_equal(over.ar_params, default.ar_params)
    tables = [p["layers"]["attn_rel_w"].shape for p in
              (default.diffusion_params, over.diffusion_params)]
    assert tables[0] != tables[1], tables
