"""The port's copies of the AR stage's pure-Python rules and its int8
weight casts against the JAX package's originals: equal results, bit for
bit (the port quantizes in torch on the tree's device, the JAX package
in numpy on the host, with the same f32 math)."""

import dataclasses

import numpy as np
import pytest

from tortoise_tpu.config import (
    ARConfig,
    tiny_ar_config,
    tiny_diffusion_config,
)
from tortoise_tpu.io.checkpoint import random_ar_params, random_diffusion_params
from tortoise_tpu.ops import basic as JB
from tortoise_tpu.pipeline import ar_stage as J
from tortoise_tpu.pipeline import diffusion_stage as JD
import torch

from tortoise_tpu_torch.params import tree_to_torch
from tortoise_tpu_torch.pipeline import ar_stage as T
from tortoise_tpu_torch.pipeline import diffusion_stage as TD


def tree_to_numpy(tree):
    """Host numpy copy of a tensor tree (same nesting)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return tree


def _sequences(cfg, seed):
    rng = np.random.default_rng(seed)
    out = []
    for n in (0, 1, 5, 40, cfg.pad_mel_length):
        seq = rng.integers(0, cfg.n_mel_vocab, n).tolist()
        if n > 3:
            seq[-2:] = [cfg.strip_token] * 2          # stripped tail
            seq[1:12] = [cfg.calm_token] * min(11, n - 3)  # calm run
        out.append(seq)
    return out


@pytest.mark.parametrize("cfg", [ARConfig(), tiny_ar_config()],
                         ids=["full", "tiny"])
def test_padding_and_trim_rules(cfg):
    seqs = [s[:cfg.pad_mel_length] for s in _sequences(cfg, 0)]
    padded = [T.apply_padding(s, cfg) for s in seqs]
    assert padded == [J.apply_padding(s, cfg) for s in seqs]
    assert T.trim_keep_lengths(padded, cfg) == \
        J.trim_keep_lengths(padded, cfg)
    lat = np.random.default_rng(1).normal(
        size=(len(seqs), cfg.pad_mel_length, 4)).astype(np.float32)
    for a, b in zip(T.trim_latents(lat, padded, cfg),
                    J.trim_latents(lat, padded, cfg)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        T.apply_padding([1] * (cfg.pad_mel_length + 1), cfg)


def test_buckets_and_cache_size():
    for n in (1, 31, 32, 33, 200, 404):
        assert T.pick_bucket(n) == J.pick_bucket(n)
        assert T.size_cache(ARConfig(), T.pick_bucket(n)) == \
            J.size_cache(ARConfig(), J.pick_bucket(n))
    with pytest.raises(ValueError):
        T.pick_bucket(405)
    assert T.size_cache(ARConfig(), 32).cache_len == 640


def test_sampler_params_normalization():
    for sp in (None, (1.0, 10, 0.1, 1.5), {"top_k": 7}):
        assert T.normalize_sampler(sp) == J.normalize_sampler(sp)
    with pytest.raises(ValueError):
        T.normalize_sampler({"top_q": 1})


def _assert_trees_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_trees_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_trees_equal(x, y)
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_ar_int8_cast_matches():
    cfg = tiny_ar_config()
    params = random_ar_params(cfg, seed=2)
    _assert_trees_equal(tree_to_numpy(T.quantize_ar(tree_to_torch(params))),
                        J.quantize_ar_host(params))
    dev = tree_to_numpy(T.cast_matmul_weights(params, None, int8=True))
    assert isinstance(dev["blocks"]["attn_w"], tuple)
    _assert_trees_equal(dev, J.quantize_ar_host(params))


def test_head_pack_pads_vocab_to_8320():
    """Production vocab 8194 -> Vp 8320, padded columns zero with a
    -1e30 bias (so they never win the in-kernel sampler)."""
    cfg = ARConfig()
    rng = np.random.default_rng(3)
    d, v = cfg.d_model, cfg.n_mel_vocab
    params = {"ln_f_w": rng.normal(size=d).astype(np.float32),
              "ln_f_b": rng.normal(size=d).astype(np.float32),
              "lm_ln_w": rng.normal(size=d).astype(np.float32),
              "lm_ln_b": rng.normal(size=d).astype(np.float32),
              "lm_b": rng.normal(size=v).astype(np.float32)}
    lm = rng.normal(0, 0.02, (v, d)).astype(np.float32)
    pair = JB.quantize_cols_host(lm.T)
    got = tree_to_numpy(T._build_head_pack(tree_to_torch(params),
                                           tree_to_torch(pair)))
    _assert_trees_equal(got, J._build_head_pack(params, pair))
    assert got["lm_wq"].shape == (d, 8320)
    assert (got["lm_b"][0, v:] == np.float32(-1e30)).all()
    assert (got["lm_wq"][:, v:] == 0).all()


def test_diffusion_int8_cast_matches():
    params = random_diffusion_params(tiny_diffusion_config(), seed=4)
    got = TD.quantize_diffusion_weights(tree_to_torch(params))
    _assert_trees_equal(tree_to_numpy(got),
                        JD.quantize_diffusion_weights(params))


def test_tree_to_torch_keeps_structure():
    cfg = dataclasses.replace(tiny_ar_config(), n_layer=1)
    params = J.quantize_ar_host(random_ar_params(cfg, seed=5))
    back = tree_to_numpy(tree_to_torch(params))
    _assert_trees_equal(back, params)
