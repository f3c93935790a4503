"""Kernel F (the port's ``flash_packed_i8``, the int8-score packed
attention) and its A/B entry point against the JAX function of
``scripts/ubench_attn_int8_ab.py``, on the CPU.

On the CPU the wrapper runs its plain PyTorch version; here it is held
against the Pallas kernel run in interpret mode (``hpp=2``) on the same
numpy inputs, with bf16 and f32 qkv, on an even length and on a ragged
one whose padding to 128 rows and masked keys the kernel must handle.
The JAX script is loaded read-only by path; every test that loads it is
in this file. The hand-written kernels are held against the plain
version on a card by tests/test_torch_cuda.py.

Tolerance: 1e-2 of the reference's max |out|. The two compute the same
int8 products; they part where round(127 p) falls on the other side of a
tie, since the Pallas kernel takes exp2 of log2(e)-scaled scores and the
port exp of the scores (max errors seen: 8e-4 bf16, 1.1e-3 f32).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu_torch.ops.cuda import flash_attention_int8 as FI
from tortoise_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
from tortoise_tpu_torch.ops.cuda.flash_attention import relpos_bias_vector

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-2
# (dtype, b, t, heads, head width, valid length of row 1 or None)
CASES = [("bf16", 2, 256, 4, 64, None), ("f32", 2, 256, 4, 64, None),
         ("bf16", 2, 200, 4, 32, 180), ("f32", 2, 200, 4, 32, 180)]
_CACHE_KEYS = ("jax_compilation_cache_dir",
               "jax_persistent_cache_min_compile_time_secs",
               "jax_persistent_cache_min_entry_size_bytes")


def _load(name, rel):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_ab(tmp_path_factory):
    """scripts/ubench_attn_int8_ab.py. Importing it turns on JAX's
    persistent compilation cache; the cache goes to a temporary directory
    and the settings are put back once it is loaded."""
    saved = {k: getattr(jax.config, k) for k in _CACHE_KEYS}
    env = os.environ.get("TORTOISE_XLA_CACHE")
    os.environ["TORTOISE_XLA_CACHE"] = str(tmp_path_factory.mktemp("xla"))
    try:
        return _load("ubench_attn_int8_ab", "scripts/ubench_attn_int8_ab.py")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        if env is None:
            os.environ.pop("TORTOISE_XLA_CACHE")
        else:
            os.environ["TORTOISE_XLA_CACHE"] = env


@pytest.fixture(scope="module")
def port_ab():
    return _load("torch_ubench_attn_int8_ab",
                 "scripts/torch_ubench_attn_int8_ab.py")


def _inputs(b, t, h, d, n_valid, seed=0):
    rng = np.random.default_rng(seed)
    qkv = rng.normal(0, 1, (b, t, 3 * h * d)).astype(np.float32)
    table = rng.normal(0, 0.1, (32, h)).astype(np.float32)
    valid = np.ones((b, t), bool)
    if n_valid is not None:
        valid[1, n_valid:] = False
    return qkv, table, valid


def _both(dtype, qkv):
    if dtype == "bf16":
        return jnp.asarray(qkv, jnp.bfloat16), torch.tensor(qkv).bfloat16()
    return jnp.asarray(qkv), torch.tensor(qkv)


def assert_close(got, want, rel):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dtype,b,t,h,d,n_valid", CASES)
def test_plain_matches_the_jax_int8_kernel(jax_ab, dtype, b, t, h, d,
                                           n_valid):
    qkv, table, valid = _inputs(b, t, h, d, n_valid)
    xj, xt = _both(dtype, qkv)
    want = jax_ab.flash_packed_i8(xj, h, jnp.asarray(valid),
                                  jnp.asarray(table), hpp=2, interpret=True)
    got = FI.flash_packed_i8_plain(xt, h, torch.tensor(valid),
                                   torch.tensor(table))
    assert got.dtype == xt.dtype and tuple(got.shape) == (b, t, h * d)
    assert_close(got.float().numpy(), np.asarray(want, np.float32), TOL)


def test_a_row_with_no_valid_key_matches_the_jax_kernel(jax_ab):
    """Every score of the row is -1e30, so p = 1 on every key (padded ones
    too) and the output is the mean of the dequantized values."""
    qkv, table, valid = _inputs(2, 200, 4, 32, 0, seed=3)
    want = jax_ab.flash_packed_i8(jnp.asarray(qkv), 4, jnp.asarray(valid),
                                  jnp.asarray(table), hpp=2, interpret=True)
    got = FI.flash_packed_i8_plain(torch.tensor(qkv), 4,
                                   torch.tensor(valid), torch.tensor(table))
    assert_close(got.numpy(), np.asarray(want), TOL)
    assert np.isfinite(got.numpy()).all()


def test_kv_scales_are_one_per_batch_row_and_head():
    rng = np.random.default_rng(5)
    k = rng.normal(0, 1, (2, 3, 256, 32)).astype(np.float32)
    v = rng.normal(0, 1, (2, 3, 256, 32)).astype(np.float32)
    k *= np.arange(1, 7, dtype=np.float32).reshape(2, 3, 1, 1)
    k[1, 2] = 0.0  # an all-zero head takes the 1e-20 floor
    ki, vi, sk, sv = FI.quantize_kv_plain(torch.tensor(k), torch.tensor(v))
    want_sk = np.maximum(np.abs(k).max(axis=(2, 3)) * np.float32(1 / 127),
                         np.float32(1e-20))
    assert sk.shape == (2, 3) and sv.shape == (2, 3)
    np.testing.assert_array_equal(sk.numpy(), want_sk)
    np.testing.assert_array_equal(
        ki.numpy(), np.round(k / want_sk[..., None, None]).astype(np.int8))
    assert ki.dtype == vi.dtype == torch.int8
    assert int(ki.abs().max()) == 127 and int(ki[1, 2].abs().max()) == 0
    assert (vi.abs().amax(dim=(2, 3)) == 127).all()


def test_q_scale_is_one_per_128_row_block():
    """A large block leaves the scales of the blocks beside it alone: the
    block height of 128 rows is part of the function."""
    rng = np.random.default_rng(6)
    q = rng.normal(0, 1, (1, 2, 384, 64)).astype(np.float32)
    q[0, 0, 128:256] *= 50.0
    q8, sq = FI.quantize_q_plain(torch.tensor(q))
    blocks = q.reshape(1, 2, 3, 128, 64)
    want = np.abs(blocks).max(axis=(3, 4)) * np.float32(1 / 127)
    assert sq.shape == (1, 2, 3)
    np.testing.assert_array_equal(sq.numpy(), want)
    assert float(sq[0, 0, 1]) > 20 * float(sq[0, 0, 0])
    np.testing.assert_array_equal(
        q8.numpy(), np.round(blocks / want[..., None, None]).astype(
            np.int8).reshape(q.shape))


def test_cpu_wrapper_returns_the_plain_result_and_launches_nothing():
    qkv, table, valid = _inputs(2, 200, 4, 32, 180, seed=2)
    args = (torch.tensor(qkv), 4, torch.tensor(valid), torch.tensor(table))
    reset_launch_counts()
    got = FI.flash_packed_i8(*args)
    assert torch.equal(got, FI.flash_packed_i8_plain(*args))
    counts = launch_counts()
    assert counts["flash_packed_i8"] == counts["int8_quantize_kv"] == 0


def test_wrapper_raises_without_a_mask():
    qkv, table, _ = _inputs(1, 128, 2, 64, None)
    with pytest.raises(ValueError, match="key mask"):
        FI.flash_packed_i8(torch.tensor(qkv), 2, None, torch.tensor(table))


@pytest.mark.parametrize("d", [16, 48, 256])
def test_wrapper_raises_on_a_head_width_it_does_not_take(d):
    qkv, table, valid = _inputs(1, 128, 2, d, None)
    with pytest.raises(ValueError, match="head width"):
        FI.flash_packed_i8(torch.tensor(qkv), 2, torch.tensor(valid),
                           torch.tensor(table))


def test_card_launch_checks_the_shared_memory_limit_before_building():
    """The bias window and key mask stream with each key tile, so a
    block's shared memory no longer bounds the length; the one limit left,
    exact int32 context sums (Tp * 127^2 < 2^31), is refused before any
    kernel is built."""
    assert FI.MAX_TP % FI.BQ == 0
    assert FI.MAX_TP * 127 * 127 < 2 ** 31
    assert (FI.MAX_TP + FI.BQ) * 127 * 127 >= 2 ** 31
    qkv = torch.zeros((1, 1, 3 * 64), dtype=torch.bfloat16).expand(
        1, FI.MAX_TP + 1, 3 * 64)
    with pytest.raises(ValueError, match="int32"):
        FI.launch_i8(qkv, 1, None, None)


def test_side_inputs_pad_the_mask_and_bias_to_128_rows():
    qkv, table, valid = _inputs(2, 200, 4, 32, 180)
    mask, bias = FI.i8_side_inputs(torch.tensor(qkv), 4, torch.tensor(valid),
                                   torch.tensor(table))
    assert tuple(mask.shape) == (2, 256) and tuple(bias.shape) == (4, 512)
    assert (mask[0, :200] == 0).all() and (mask[0, 200:] == -1e30).all()
    assert (mask[1, :180] == 0).all() and (mask[1, 180:] == -1e30).all()
    # bias[h, (j - i) + Tp]: column 0 is the aligning pad
    assert (bias[:, 0] == 0).all()
    assert torch.equal(bias[:, 1:], relpos_bias_vector(
        torch.tensor(table), 256, FI.BIAS_SCALE))


def test_ab_script_on_the_cpu_matches_the_jax_ab(jax_ab, port_ab, capsys,
                                                 monkeypatch):
    """The port's A/B (its plain versions of F and B on the CPU) against
    the JAX A/B's two kernels in interpret mode on the same numpy-seeded
    inputs at a small shape: each output within tolerance, so the F-vs-B
    errors agree; main() prints the error, no timing and zero launches."""
    b, t, h, d = 2, 256, 4, 64
    monkeypatch.setattr(port_ab, "T", t)  # the script's shape, made small
    monkeypatch.setattr(port_ab, "H", h)
    qkv, table, mask = port_ab.make_inputs(torch, b, t, h, d, "cpu")
    acc = port_ab.accuracy(qkv, h, mask, table)
    xj = jnp.asarray(qkv.float().numpy(), jnp.bfloat16)
    mj, tj = jnp.asarray(mask.numpy()), jnp.asarray(table.numpy())
    o_b = np.asarray(jax_ab.flash_attention_packed(
        xj, h, mj, bias_table=tj, hpp=2, interpret=True), np.float32)
    o_f = np.asarray(jax_ab.flash_packed_i8(xj, h, mj, tj, hpp=2,
                                            interpret=True), np.float32)
    assert_close(acc["f_out"].float().numpy(), o_f, TOL)
    assert_close(acc["b_out"].float().numpy(), o_b, 2e-2)
    jax_err = np.abs(o_b - o_f).max()
    assert abs(acc["max_abs_err"] - jax_err) <= 2e-2 * np.abs(o_b).max()
    assert port_ab.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert any(ln.startswith("CPU: skipping device timing") for ln in lines)
    res = json.loads(lines[-1])["ab"]
    assert res["calls"] == 1 and res["shape"] == [b, h, t, d]
    assert set(res["launches"].values()) == {0}
    assert res["max_abs_err"] == pytest.approx(acc["max_abs_err"])


def test_int8_variants_match_the_source():
    """scripts/torch_int8_variants.py builds each variant of kernel F by a
    text substitution: every one must match csrc/flash_attention_int8.cu
    exactly once, or the script raises on the card."""
    mod = _load("torch_int8_variants", "scripts/torch_int8_variants.py")
    src = open(os.path.join(ROOT, "tortoise_tpu_torch", "csrc",
                            "flash_attention_int8.cu")).read()
    assert mod.VARIANTS["as built"] == []
    for name, subs in mod.VARIANTS.items():
        text = src
        for old, new in subs:
            assert text.count(old) == 1, (name, old)
            text = text.replace(old, new)
        assert (text != src) == bool(subs), name
