"""The whole slice — text ids -> AR -> diffusion -> vocoder -> audio —
through the port's ``synthesize`` against the JAX package's, on tiny
random weights, on the reference (mt19937) sampler plane where both
packages draw the same random stream.

Tolerances: token sequences identical on both planes. f32 plane: mel
and audio within 1e-3 of the reference's max magnitude. bf16 + int8
plane (diffusion without the flash kernel): mel within 0.1 absolute on
its [-1, 1] range and audio within 5e-2 of its max — the per-eval bf16
rounding differences between XLA and PyTorch (see test_torch_models)
compound over the 80 denoising steps.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

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
from tortoise_tpu.pipeline import synthesize as J
from tortoise_tpu_torch.pipeline import synthesize as T

TOKENS = [3, 9, 4, 12, 7, 1, 20, 5]


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


@pytest.mark.parametrize("plane", ["f32", "bf16_int8"])
@pytest.mark.parametrize("seed", [5, 8])
def test_synthesize_matches_jax(models_kw, voice, plane, seed):
    kw = {}
    jcd = tcd = None
    if plane == "bf16_int8":
        kw["int8_weights"] = True
        jcd, tcd = jnp.bfloat16, torch.bfloat16
    want = J.synthesize(J.TortoiseModels(**models_kw), tokens=TOKENS,
                        voice=voice, seed=seed, sampler="reference",
                        compute_dtype=jcd, **kw)
    got = T.synthesize(T.TortoiseModels(**models_kw), tokens=TOKENS,
                       voice=voice, seed=seed, sampler="reference",
                       compute_dtype=tcd, device="cpu", **kw)
    assert got.sequences == want.sequences
    assert got.mel.shape == want.mel.shape
    assert got.audio.shape == want.audio.shape
    for a, b in zip(got.latents, want.latents):
        assert a.shape == b.shape
    if plane == "f32":
        for name in ("mel", "audio"):
            a, b = getattr(got, name), getattr(want, name)
            assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), name
    else:
        assert np.abs(got.mel - want.mel).max() <= 0.1
        assert np.abs(got.audio - want.audio).max() <= \
            5e-2 * np.abs(want.audio).max()


@pytest.mark.parametrize("args", [
    ["--sampler", "reference"],
    ["--bf16", "--int8-weights", "--batch-size", "3"],
])
def test_cli_runs_on_cpu(tmp_path, args):
    """The CLI's single-utterance path end to end on tiny weights: on the
    bf16 + int8 plane the on-device sampling loop runs kernel A's plain
    version with its in-kernel sampler for all three candidates."""
    from tortoise_tpu.io.wav import read_wav
    from tortoise_tpu_torch import cli
    from tortoise_tpu_torch.pipeline.vocoder_stage import audio_length

    out = str(tmp_path / "out.wav")
    res = cli.run(["--random-weights", "--tiny", "--seed", "2",
                   "--device", "cpu", "--output", out] + args)
    assert cli.main(["--random-weights", "--tiny", "--seed", "2",
                     "--device", "cpu", "--output", out] + args) == 0
    assert np.isfinite(res.audio).all() and np.isfinite(res.mel).all()
    assert res.audio.shape == (audio_length(res.mel.shape[-1],
                                            tiny_vocoder_config()),)
    want_b = 3 if "--batch-size" in args else 1
    assert len(res.sequences) == len(res.latents) == want_b
    assert os.path.exists(out)
    assert read_wav(out)[0].shape[0] == res.audio.shape[0]


@pytest.mark.parametrize("flag", ["--stream", "--messages-file=x.txt"])
def test_cli_rejects_unported_modes(flag):
    """What the streaming and batched modes do not take, as in the JAX
    CLI: both run the jax sampler at one candidate, so --sampler
    reference and --batch-size are refused with them, before any model
    is built."""
    from tortoise_tpu_torch import cli

    for extra in (["--sampler", "reference"], ["--batch-size", "2"]):
        with pytest.raises(SystemExit) as e:
            cli.main([flag, "--random-weights", "--tiny", "--device", "cpu"]
                     + extra)
        assert e.value.code != 0 and "jax-sampler" in str(e.value.code)


@pytest.mark.parametrize("extra", [["--stream"], ["--tokens", "1,4,0"]])
def test_cli_messages_file_conflicting_flags(tmp_path, extra):
    from tortoise_tpu_torch import cli

    path = tmp_path / "m.txt"
    path.write_text("one\n")
    with pytest.raises(SystemExit) as e:
        cli.main(["--messages-file", str(path), "--random-weights", "--tiny",
                  "--device", "cpu"] + extra)
    assert "conflicts" in str(e.value.code)


def test_cli_messages_file_runs_on_cpu(tmp_path):
    """--messages-file: one synthesize_batch over the file's lines (blank
    lines skipped), one WAV per line with a -<i> suffix, each row the
    same as synthesize_batch on the same models, tokens and seed."""
    from tortoise_tpu.io.wav import read_wav
    from tortoise_tpu_torch import cli
    from tortoise_tpu_torch.pipeline.vocoder_stage import audio_length

    path = tmp_path / "m.txt"
    path.write_text("hello there\n\nsecond line\nthird one here\n")
    out = str(tmp_path / "out.wav")
    argv = ["--messages-file", str(path), "--random-weights", "--tiny",
            "--seed", "3", "--device", "cpu", "--diffusion-steps", "4",
            "--bf16", "--int8-weights", "--top-k", "9", "--output", out]
    results = cli.run(argv)
    assert cli.main(argv) == 0
    assert len(results) == 3
    models = T.TortoiseModels.random(3, tiny=True)
    models.diffusion_cfg = dataclasses.replace(
        models.diffusion_cfg, n_sample_timesteps=4, use_flash=False)
    want = T.synthesize_batch(
        models, tokens_list=[r.tokens for r in results],
        voices=np.zeros(64, np.float32), seed=3, compute_dtype=torch.bfloat16,
        int8_weights=True, sampler_params={"top_k": 9}, device="cpu")
    for i, (r, w) in enumerate(zip(results, want)):
        assert r.sequences == w.sequences
        np.testing.assert_array_equal(r.audio, w.audio)
        assert r.audio.shape == (audio_length(r.mel.shape[-1],
                                              tiny_vocoder_config()),)
        assert read_wav(str(tmp_path / f"out-{i}.wav"))[0].shape == \
            r.audio.shape


def test_cli_stream_runs_on_cpu(tmp_path):
    """--stream with the window flags: the written WAV is the chunks in
    order, and the chunks are stream_synthesize's on the same models."""
    from tortoise_tpu.io.wav import read_wav
    from tortoise_tpu_torch import cli
    from tortoise_tpu_torch.pipeline import streaming

    out = str(tmp_path / "s.wav")
    geom = dict(window_frames=24, overlap_frames=8, first_window_frames=16,
                vocoder_margin=8)
    chunks = cli.run(["--stream", "--random-weights", "--tiny", "--seed",
                      "2", "--device", "cpu", "--diffusion-steps", "4",
                      "--tokens", ",".join(map(str, TOKENS)),
                      "--stream-window", "24", "--stream-overlap", "8",
                      "--stream-first-window", "16", "--vocoder-margin", "8",
                      "--output", out])
    assert len(chunks) > 1 and chunks[-1].final
    audio = streaming.collect_stream(chunks)
    np.testing.assert_array_equal(read_wav(out)[0], audio)
    models = T.TortoiseModels.random(2, tiny=True)
    models.diffusion_cfg = dataclasses.replace(
        models.diffusion_cfg, n_sample_timesteps=4, use_flash=False)
    want = streaming.collect_stream(streaming.stream_synthesize(
        models, tokens=TOKENS, voice=np.zeros(64, np.float32), seed=2,
        device="cpu", **geom))
    np.testing.assert_array_equal(audio, want)
