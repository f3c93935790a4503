"""The port's own host modules (config, io, text, rng, native) against the
JAX package's originals: same config fields, bit-equal random weights,
the same RNG streams, WAV bytes, GGML files and tokenizer output."""

import dataclasses
import os

import numpy as np
import pytest

import tortoise_tpu.config as JC
import tortoise_tpu.io.checkpoint as JCK
import tortoise_tpu.io.ggml as JG
import tortoise_tpu.io.voice as JV
import tortoise_tpu.io.wav as JW
import tortoise_tpu.rng as JR
import tortoise_tpu.text.tokenizer as JT
import tortoise_tpu_torch.config as TC
import tortoise_tpu_torch.io.checkpoint as TCK
import tortoise_tpu_torch.io.ggml as TG
import tortoise_tpu_torch.io.voice as TV
import tortoise_tpu_torch.io.wav as TW
import tortoise_tpu_torch.native as TN
import tortoise_tpu_torch.rng as TR
import tortoise_tpu_torch.text.tokenizer as TT
from tortoise_tpu.parity import DEFAULT_REFERENCE

# the reference checkout's tokenizer, where the JAX package's tests find it
TOKENIZER_JSON = os.path.join(DEFAULT_REFERENCE, "models", "tokenizer.json")
CONFIGS = ("ARConfig", "DiffusionConfig", "VocoderConfig")
TINY = ("tiny_ar_config", "tiny_diffusion_config", "tiny_vocoder_config")


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("name", CONFIGS + TINY)
def test_config_fields_match(name):
    """Default and tiny configs: the same field names, order and values,
    in distinct classes (the port never reuses the JAX package's)."""
    jc, tc = getattr(JC, name)(), getattr(TC, name)()
    assert type(jc) is not type(tc)
    assert type(jc).__name__ == type(tc).__name__
    assert list(_fields(tc)) == list(_fields(jc))
    assert _fields(tc) == _fields(jc)
    for prop in ("d_head", "total_upsample"):
        if hasattr(jc, prop):
            assert getattr(tc, prop) == getattr(jc, prop)


def test_config_constants_match():
    for name in ("TACOTRON_MEL_MAX", "TACOTRON_MEL_MIN", "MEL_PAD_VALUE",
                 "OUTPUT_SAMPLE_RATE", "MEL_LEN_NUMER", "MEL_LEN_DENOM"):
        assert getattr(TC, name) == getattr(JC, name), name
    for n in (1, 17, 500, 1001):
        assert TC.mel_length_for_latents(n) == JC.mel_length_for_latents(n)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, np.asarray(tree)


@pytest.mark.parametrize("kind,seed", [("ar", 0), ("ar", 3),
                                       ("diffusion", 1), ("vocoder", 2)])
def test_random_params_bit_equal(kind, seed):
    """random_*_params give bit-identical arrays from the same seed (the
    CPU parity tests feed both packages one tree)."""
    cfg_name = {"ar": "tiny_ar_config", "diffusion": "tiny_diffusion_config",
                "vocoder": "tiny_vocoder_config"}[kind]
    fn = f"random_{kind}_params"
    want = dict(_leaves(getattr(JCK, fn)(getattr(JC, cfg_name)(), seed)))
    got = dict(_leaves(getattr(TCK, fn)(getattr(TC, cfg_name)(), seed)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("force_python", [False, True])
@pytest.mark.parametrize("seed", [0, 12345])
def test_reference_rng_streams_match(force_python, seed):
    """ReferenceRng on the native and the Python backend: raw words,
    uniforms, normals and multinomial draws equal the JAX package's."""
    j = JR.ReferenceRng(seed, force_python=force_python)
    t = TR.ReferenceRng(seed, force_python=force_python)
    assert t.backend == j.backend
    np.testing.assert_array_equal(t.raw_u32(700), j.raw_u32(700))
    np.testing.assert_array_equal(t.uniform(300), j.uniform(300))
    np.testing.assert_array_equal(t.normal(301), j.normal(301))
    np.testing.assert_array_equal(t.normal_f32(64), j.normal_f32(64))
    probs = np.random.default_rng(seed).dirichlet(np.ones(40))
    assert [t.multinomial(probs) for _ in range(20)] == \
        [j.multinomial(probs) for _ in range(20)]


def test_mt19937_state_text_roundtrips_across_packages():
    j = JR.MT19937(42)
    j.raw(1000)
    t = TR.MT19937(0)
    t.load_state_text(j.state_text())
    np.testing.assert_array_equal(t.raw(100), j.raw(100))


def test_native_library_builds_into_the_build_directory():
    """The port's native library builds under tortoise_tpu_torch/_build/,
    never beside its sources, and serves every native entry point."""
    if not TN.available():
        pytest.skip("no g++ to build the native library")
    path = TN.build()
    assert os.path.dirname(path) == TN.BUILD_DIR
    assert os.path.basename(TN.BUILD_DIR) == "_build"
    assert not any(f.endswith(".so") for f in
                   os.listdir(os.path.dirname(TN.__file__)))


@pytest.mark.parametrize("n", [0, 1, 4801])
def test_wav_bytes_match(n, tmp_path):
    data = np.random.default_rng(n).uniform(-1, 1, n).astype(np.float32)
    assert TW.wav_bytes(data, 24000) == JW.wav_bytes(data, 24000)
    assert TW.streaming_wav_header(22050) == JW.streaming_wav_header(22050)
    path = str(tmp_path / "a.wav")
    TW.write_wav(path, data)
    got, rate = JW.read_wav(path)
    np.testing.assert_array_equal(got, data)
    assert rate == 24000


def test_wav_encode_refuses_past_4_gib_before_allocating():
    """The port's native encoder returns None for a payload whose RIFF
    sizes would overflow, before it allocates the output buffer."""
    if not TN.available():
        pytest.skip("no g++ to build the native library")
    big = np.broadcast_to(np.zeros(1, np.float32), (2 ** 30,))
    assert TN.wav_encode(big, 24000) is None


def test_ggml_files_cross_read(tmp_path):
    """A GGML file written by either package reads back the same through
    the other, native index and Python parser alike."""
    rng = np.random.default_rng(0)
    tensors = {"a.weight": rng.normal(size=(3, 5)).astype(np.float32),
               "b.bias": rng.normal(size=(7,)).astype(np.float16)}
    for writer, reader in ((JG, TG), (TG, JG)):
        path = str(tmp_path / f"{writer.__name__}.bin")
        writer.write_ggml(path, tensors)
        for got in (reader.read_ggml(path), reader._read_ggml_py(path, True)):
            assert got.keys() == tensors.keys()
            for k, v in tensors.items():
                np.testing.assert_array_equal(np.asarray(got[k]), v)


def test_voice_latent_matches(tmp_path):
    path = str(tmp_path / "v.bin")
    np.random.default_rng(1).normal(size=64).astype(np.float32).tofile(path)
    np.testing.assert_array_equal(TV.load_voice_latent(path, 64),
                                  JV.load_voice_latent(path, 64))


SMALL_VOCAB = {"[STOP]": 0, "[UNK]": 1, "[SPACE]": 2, "a": 3, "b": 4,
               "c": 5, "ab": 6, "abc": 7, "ca": 8, ".": 9, "!": 10,
               "bc": 11, "[START]": 12}
SMALL_MERGES = [("a", "b"), ("ab", "c"), ("c", "a"), ("b", "c")]
MESSAGES = ("abc cab. ba!", "aabbcc", "c a b [START] x abca", "")


@pytest.mark.parametrize("native", [False, True])
@pytest.mark.parametrize("method", ["greedy", "bpe"])
def test_tokenizer_matches_on_a_small_vocab(native, method):
    j = JT.Tokenizer(SMALL_VOCAB, SMALL_MERGES, native=native)
    t = TT.Tokenizer(SMALL_VOCAB, SMALL_MERGES, native=native)
    for msg in MESSAGES:
        assert t.encode_pipeline(msg, method) == \
            j.encode_pipeline(msg, method), msg
        ids = t.encode(msg.replace(" ", "[SPACE]"), method)
        assert ids == j.encode(msg.replace(" ", "[SPACE]"), method)
        assert t.decode(ids) == j.decode(ids)


@pytest.fixture(scope="module")
def tokenizers():
    if not os.path.exists(TOKENIZER_JSON):
        pytest.skip(f"{TOKENIZER_JSON} not present")
    return (JT.Tokenizer.from_file(TOKENIZER_JSON),
            TT.Tokenizer.from_file(TOKENIZER_JSON))


@pytest.mark.parametrize("method", ["greedy", "bpe"])
def test_tokenizer_matches_on_the_reference_vocab(tokenizers, method):
    j, t = tokenizers
    for msg in ("this is a test message.", "based... doctor freeman?",
                "diffusion model complete!", "Numbers 123 & symbols #@!"):
        assert t.encode_pipeline(msg, method) == \
            j.encode_pipeline(msg, method), msg
