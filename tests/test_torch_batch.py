"""The port's batched serving path — ``synthesize_batch`` and its stage
drivers — against the JAX package's on tiny random weights, with the
port's random streams replaced by the JAX package's key chains through
the port's seams (``common.make_generator`` and each stage's ``draw_*``),
so both packages draw the same uniforms and noise. Plus the memoized
weight casts and kernel A's route for the batch sizes the server uses.

Tolerances as in tests/test_torch_slice.py: token sequences identical on
both planes; f32 mel and audio within 1e-3 of the reference's max
magnitude (the JAX vocoder's batch path rounds audio to 16-bit PCM,
~1.5e-5); bf16 + int8 mel within 0.1 absolute and audio within 5e-2 of
its max over the 80 steps (bf16 rounding differs between XLA and
PyTorch in the AR latent pass and in every denoiser eval). The tiny
random AR model's next-token distributions are nearly flat, so on the
bf16 plane a ~1e-3 logit difference can reorder two candidates: the
seed is one whose three streams meet no such near-tie.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tortoise_tpu.config import (
    tiny_ar_config,
    tiny_diffusion_config,
    tiny_vocoder_config,
)
from tortoise_tpu.io.checkpoint import (
    random_ar_params,
    random_diffusion_params,
    random_vocoder_params,
)
from tortoise_tpu.pipeline import diffusion_stage as JDS
from tortoise_tpu.pipeline import synthesize as J
from tortoise_tpu_torch.models import ar as TAR
from tortoise_tpu_torch.pipeline import ar_stage as TS
from tortoise_tpu_torch.pipeline import common as TC
from tortoise_tpu_torch.pipeline import diffusion_stage as TDS
from tortoise_tpu_torch.pipeline import streaming as TST
from tortoise_tpu_torch.pipeline import synthesize as T
from tortoise_tpu_torch.pipeline import vocoder_stage as TVS

# the suite runs several pytest workers on the same cores; torch's
# OpenMP pool at its default width in each of them oversubscribes the CPU
# (the tiny models' ops then run ~10x slower), so one thread a process
torch.set_num_threads(1)

ROWS = [[1, 5, 9, 4, 0], [1, 3, 9, 4, 12, 7, 20, 0],
        [1, 11, 2, 6, 8, 30, 17, 9, 22, 4, 0]]


class JaxKey:
    """A jax.random key standing where the port keeps a torch.Generator."""

    def __init__(self, key):
        self.key = key


def replay_jax_streams(monkeypatch):
    """Make every random draw of the port replay the JAX package's key
    chains: ``PRNGKey(seed)`` per stage; the AR uniforms and the diffusion
    noise split the key before each draw (ar_stage.py:299-325,
    diffusion_stage.py:181-182, 237-238); the vocoder draws from its key
    directly; a stream window folds its index into the key."""
    def split_then(draw):
        def fn(gen, shape, device):
            gen.key, sub = jax.random.split(gen.key)
            return torch.as_tensor(np.asarray(draw(sub, shape)),
                                   device=device)
        return fn

    def vocoder_draw(gen, shape, device):
        return torch.as_tensor(np.asarray(jax.random.normal(gen.key, shape)),
                               device=device)

    monkeypatch.setattr(TC, "make_generator",
                        lambda seed, device: JaxKey(jax.random.PRNGKey(seed)))
    monkeypatch.setattr(TS, "draw_uniform", split_then(jax.random.uniform))
    monkeypatch.setattr(TDS, "draw_normal", split_then(jax.random.normal))
    monkeypatch.setattr(TVS, "draw_normal", vocoder_draw)
    monkeypatch.setattr(TST, "window_generator",
                        lambda gen, i: JaxKey(jax.random.fold_in(gen.key, i)))


def close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= tol * max(np.abs(want).max(), 1e-30), \
        (err, np.abs(want).max())


@pytest.fixture(scope="module")
def models_kw():
    return dict(
        ar_params=random_ar_params(tiny_ar_config(), 1),
        diffusion_params=random_diffusion_params(tiny_diffusion_config(), 2),
        vocoder_params=random_vocoder_params(tiny_vocoder_config(), 3),
        ar_cfg=tiny_ar_config(), diffusion_cfg=tiny_diffusion_config(),
        vocoder_cfg=tiny_vocoder_config())


@pytest.fixture(scope="module")
def voices():
    return np.random.default_rng(0).normal(0, 0.5, (3, 64)).astype(np.float32)


@pytest.mark.parametrize("path", ["device", "host_lists"])
@pytest.mark.parametrize("plane", ["f32", "bf16_int8"])
def test_synthesize_batch_matches_jax(models_kw, voices, tmp_path,
                                      monkeypatch, plane, path):
    """Three ragged rows with per-row voices (one given as a path), with
    and without ``progress`` (the JAX package then takes its host-list
    path; the port keeps one device-resident path and reports the same
    fractions)."""
    voices[0].tofile(tmp_path / "v0.bin")
    row_voices = [str(tmp_path / "v0.bin"), voices[1], voices[2]]
    kw, jcd, tcd = {}, None, None
    if plane == "bf16_int8":
        kw["int8_weights"] = True
        jcd, tcd = jnp.bfloat16, torch.bfloat16
    jseen, tseen = [], []
    jkw = tkw = {}
    if path == "host_lists":
        jkw, tkw = dict(progress=jseen.append), dict(progress=tseen.append)
    want = J.synthesize_batch(J.TortoiseModels(**models_kw),
                              tokens_list=ROWS, voices=row_voices, seed=2,
                              compute_dtype=jcd, **kw, **jkw)
    replay_jax_streams(monkeypatch)
    got = T.synthesize_batch(T.TortoiseModels(**models_kw),
                             tokens_list=ROWS, voices=row_voices, seed=2,
                             compute_dtype=tcd, device="cpu", **kw, **tkw)
    assert tseen == jseen
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.sequences == w.sequences
        assert g.tokens == w.tokens
        assert g.mel.shape == w.mel.shape
        assert g.audio.shape == w.audio.shape
        assert g.latents[0].shape == w.latents[0].shape
        if plane == "f32":
            close(g.mel, w.mel, 1e-3)
            close(g.audio, w.audio, 1e-3)
        else:
            assert np.abs(g.mel - w.mel).max() <= 0.1
            close(g.audio, w.audio, 5e-2)
    # every row carries its own copy of the batch's stage walls
    assert got[0].timings == got[1].timings
    assert got[0].timings is not got[1].timings
    assert {"autoregressive_s", "diffusion_s", "vocoder_s"} <= \
        set(got[0].timings)


def test_synthesize_batch_voice_forms_and_serving_mode(models_kw, voices):
    """A list of per-row latents and the same (B, d) array give the same
    batch; one shared (d,) voice equals that voice repeated per row;
    ``materialize=False`` leaves mel and latents None and keeps the
    audio."""
    m = T.TortoiseModels(**models_kw)
    kw = dict(tokens_list=ROWS, seed=2, device="cpu")
    as_list = T.synthesize_batch(m, voices=list(voices), **kw)
    as_array = T.synthesize_batch(m, voices=voices, **kw)
    shared = T.synthesize_batch(m, voices=voices[1], **kw)
    repeated = T.synthesize_batch(m, voices=[voices[1]] * 3, **kw)
    serving = T.synthesize_batch(m, voices=voices, materialize=False, **kw)
    for a, b, s in zip(as_list, as_array, serving):
        np.testing.assert_array_equal(a.audio, b.audio)
        np.testing.assert_array_equal(a.audio, s.audio)
        assert a.sequences == b.sequences == s.sequences
        assert s.mel is None and s.latents == [None]
    for a, b in zip(shared, repeated):
        np.testing.assert_array_equal(a.audio, b.audio)
    with pytest.raises(ValueError, match="voice"):
        T.synthesize_batch(m, voices=None, **kw)


def test_diffusion_batch_progress_matches_jax(models_kw):
    """``progress`` fires at the JAX package's cuts: 0, then after each
    ~n/10 steps and at n (here n = 23, which no stride lands on)."""
    cfg = dataclasses.replace(models_kw["diffusion_cfg"],
                              n_sample_timesteps=23)
    lats = [np.random.default_rng(i).normal(0, 0.5, (n, 64))
            .astype(np.float32) for i, n in enumerate((9, 14))]
    jseen, tseen = [], []
    JDS.diffusion_batch(models_kw["diffusion_params"], lats, cfg, seed=1,
                        progress=jseen.append)
    mels = TDS.diffusion_batch(models_kw["diffusion_params"], lats, cfg,
                               seed=1, progress=tseen.append)
    assert tseen == jseen
    assert tseen[0] == 0.0 and tseen[-1] == 1.0 and len(tseen) == 13
    assert [m.shape[1] for m in mels] == [39, 60]


def test_vocoder_batch_matches_jax(models_kw, monkeypatch):
    """Ragged mels vocoded in one masked batch with the JAX package's
    PRNGKey(seed) noise replayed: every row's f32 audio within 1e-3."""
    from tortoise_tpu.pipeline import vocoder_stage as JVS

    cfg = models_kw["vocoder_cfg"]
    mels = [np.random.default_rng(i).uniform(-1, 1, (cfg.n_mel, n))
            .astype(np.float32) for i, n in enumerate((20, 33, 7))]
    want = JVS.vocoder_batch(models_kw["vocoder_params"], mels, cfg, seed=4)
    replay_jax_streams(monkeypatch)
    got = TVS.vocoder_batch(models_kw["vocoder_params"], mels, cfg, seed=4,
                            device="cpu")
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        close(g, w, 1e-3)


def test_second_synthesize_reuses_the_cast_trees(models_kw, monkeypatch):
    """The AR int8 quantization, the diffusion int8 quantization and the
    vocoder upload each run once for two calls on the same models, and
    the cast functions hand back the same tree object."""
    TC.clear_cast_cache()
    calls = {"ar": 0, "diffusion": 0, "vocoder": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(TS, "quantize_ar", counting("ar", TS.quantize_ar))
    monkeypatch.setattr(TDS, "quantize_diffusion_weights",
                        counting("diffusion", TDS.quantize_diffusion_weights))
    monkeypatch.setattr(TVS, "tree_to_torch",
                        counting("vocoder", TVS.tree_to_torch))
    m = T.TortoiseModels(**models_kw)
    kw = dict(tokens=ROWS[0], voice=np.zeros(64, np.float32), seed=1,
              compute_dtype=torch.bfloat16, int8_weights=True, device="cpu")
    first = T.synthesize(m, **kw)
    second = T.synthesize(m, **kw)
    assert calls == {"ar": 1, "diffusion": 1, "vocoder": 1}
    np.testing.assert_array_equal(first.audio, second.audio)
    ar_tree = TS.cast_matmul_weights(m.ar_params, torch.bfloat16, True, "cpu")
    assert TS.cast_matmul_weights(m.ar_params, torch.bfloat16, True,
                                  "cpu") is ar_tree
    assert TDS._prepare_params(m.diffusion_params, True, "cpu") is \
        TDS._prepare_params(m.diffusion_params, True, "cpu")
    assert TVS.device_params(m.vocoder_params, "cpu") is \
        TVS.device_params(m.vocoder_params, "cpu")


def test_cast_cache_keys_and_eviction():
    """Another plane or device misses; the ninth distinct entry evicts the
    first (a bounded FIFO of 8)."""
    TC.clear_cast_cache()
    p = random_vocoder_params(tiny_vocoder_config(), 0)
    a = TS.cast_matmul_weights(random_ar_params(tiny_ar_config(), 0), None)
    assert TVS.device_params(p, "cpu") is TVS.device_params(p, "cpu")
    assert TVS.device_params(p, "meta") is not TVS.device_params(p, "cpu")
    assert TVS.device_params(p, "meta")["pre_w"].device.type == "meta"
    q = random_diffusion_params(tiny_diffusion_config(), 0)
    assert TDS._prepare_params(q, True, "cpu") is not \
        TDS._prepare_params(q, False, "cpu")
    assert isinstance(a["blocks"]["attn_w"], torch.Tensor)

    TC.clear_cast_cache()
    built = []
    trees = [{"w": np.full((1,), i, np.float32)} for i in range(9)]

    def cast(tree):
        built.append(int(tree["w"][0]))
        return dict(tree)

    outs = [TC.cached_cast(t, "k", cast, "cpu") for t in trees]
    assert built == list(range(9)) and len(TC._cast_cache) == 8
    assert TC.cached_cast(trees[8], "k", cast, "cpu") is outs[8]
    assert TC.cached_cast(trees[1], "k", cast, "cpu") is outs[1]
    assert TC.cached_cast(trees[0], "k", cast, "cpu") is not outs[0]
    assert built == list(range(9)) + [0]


@pytest.mark.parametrize("b", [1, 2, 4, 8, 16])
def test_batches_up_to_16_rows_take_kernel_a(b, monkeypatch):
    """Ragged rows in one text bucket at every server batch bucket run
    each decode step through decode_sample_step (kernel A with its
    sampler) on the bf16 + int8 plane; top_k > 128 takes decode_step and
    the plain sampler."""
    cfg = dataclasses.replace(tiny_ar_config(), max_decode_steps=4)
    params = random_ar_params(cfg, 5)
    rng = np.random.default_rng(b)
    rows = [[1] + rng.integers(3, 30, size=3 + i % 5).tolist() + [0]
            for i in range(b)]
    seen = {"fused": 0, "plain": 0}

    def spy(name, fn):
        def wrapped(*a, **k):
            seen[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(TAR, "decode_sample_step",
                        spy("fused", TAR.decode_sample_step))
    monkeypatch.setattr(TAR, "decode_step", spy("plain", TAR.decode_step))
    voices = rng.normal(0, 0.5, (b, 64)).astype(np.float32)
    kw = dict(cfg=cfg, compute_dtype=torch.bfloat16, int8_weights=True)
    lats, padded = TS.autoregressive_batch(params, rows, voices, **kw)
    assert len(lats) == len(padded) == b
    assert seen["fused"] > 0 and seen["plain"] == 0
    seen.update(fused=0, plain=0)
    TS.autoregressive_batch(params, rows, voices,
                            sampler_params={"top_k": 200}, **kw)
    assert seen["fused"] == 0 and seen["plain"] > 0


def test_sampler_overrides_match_jax():
    from tortoise_tpu.pipeline.ar_stage import sampler_overrides as jso

    for kw in ({}, {"temperature": 1.1}, {"top_k": 9, "top_p_drop": 0.1},
               {"repetition_penalty": 1.0, "top_k": 200}):
        assert TS.sampler_overrides(**kw) == jso(**kw)
        assert TS.normalize_sampler(TS.sampler_overrides(**kw)) == \
            TS.normalize_sampler(jso(**kw))
