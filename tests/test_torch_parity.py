"""The port's parity runner (``python -m tortoise_tpu_torch.parity``)
against the JAX package's (tests/test_golden_parity.py): the same dry run
without weights, the same exit codes, the same golden-table parser and
prompt, and the weight-gated golden stages on the port's own stages
(they skip while the GGML weights are absent)."""

import os

import numpy as np
import pytest

from tortoise_tpu import parity as J
from tortoise_tpu_torch import parity as T

REF = T.DEFAULT_REFERENCE
MODELS = f"{REF}/models"
ASSETS = f"{REF}/assets"

HAVE = {name: os.path.exists(f"{MODELS}/{f}") for name, f in (
    ("ar", "ggml-model.bin"), ("diff", "ggml-diffusion-model.bin"),
    ("voc", "ggml-vocoder-model.bin"))}


def test_dry_run_without_weights_skips_three(tmp_path, capsys):
    """No weight files: three SKIP lines and exit 0, on the default
    device (cuda): the device is resolved only for a stage that runs."""
    assert T.main(["--models", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert out.count("SKIP") == 3
    assert out.count("weights absent") == 3
    assert "parity: 0 pass, 0 fail, 3 skip" in out


def test_corrupt_weights_fail_with_exit_1(tmp_path, capsys):
    """A present but broken weight file is a FAIL and exit 1, as in the
    JAX runner."""
    (tmp_path / "ggml-vocoder-model.bin").write_bytes(b"not a ggml file!")
    rcs = [mod.main(["--models", str(tmp_path), "--stages", "voc"])
           for mod in (J, T)]
    out = capsys.readouterr().out
    assert rcs == [1, 1]
    assert out.count("vocoder          FAIL") == 2


def test_unknown_stage_and_missing_oracles(tmp_path, capsys):
    with pytest.raises(SystemExit):
        T.main(["--models", str(tmp_path), "--stages", "ar,mel"])
    assert T.main(["--models", str(tmp_path), "--oracles"]) == 2
    assert "oracle suites: none found" in capsys.readouterr().out


def _main_cpp(rows, brace="};"):
    body = ",\n".join("{" + ", ".join(map(str, r)) + "}" for r in rows)
    return ("int x = 0;\nstd::vector<std::vector<int>> target_sequences = "
            "{\n" + body + "\n" + brace + "\nint y = 1;\n")


@pytest.mark.parametrize("shape", ["4x500", "3x500", "4x499", "no_table"])
def test_golden_token_table_matches_jax(tmp_path, shape):
    """The port parses a synthetic main.cpp as the JAX parser does, and
    refuses the same malformed tables."""
    rows = np.random.default_rng(0).integers(0, 8194, (4, 500)).tolist()
    src = {"4x500": _main_cpp(rows), "3x500": _main_cpp(rows[:3]),
           "4x499": _main_cpp([r[:499] for r in rows]),
           "no_table": "int main() { return 0; }\n"}[shape]
    (tmp_path / "main.cpp").write_text(src)
    if shape != "4x500":
        for mod in (J, T):
            with pytest.raises(ValueError):
                mod.golden_token_table(str(tmp_path))
        return
    got = T.golden_token_table(str(tmp_path))
    assert got == J.golden_token_table(str(tmp_path)) == rows


def test_prompt_and_fixture_reader_match_jax(tmp_path):
    assert T.TEST_TOKENS == J.TEST_TOKENS
    x = np.random.default_rng(1).normal(size=37).astype(np.float32)
    x.tofile(tmp_path / "x.bin")
    np.testing.assert_array_equal(T.load_f32(str(tmp_path / "x.bin")),
                                  J.load_f32(str(tmp_path / "x.bin")))
    np.testing.assert_array_equal(T.load_f32(str(tmp_path / "x.bin"), 5),
                                  x[:5])


@pytest.mark.skipif(not HAVE["ar"], reason="AR weights not present")
def test_autoregressive_golden():
    r = T.run_autoregressive(MODELS, ASSETS, REF, device="cpu")
    assert r.status == "pass", r


@pytest.mark.skipif(not HAVE["diff"], reason="diffusion weights not present")
def test_diffusion_golden():
    r = T.run_diffusion(MODELS, ASSETS, device="cpu")
    assert r.status == "pass", r


@pytest.mark.skipif(not HAVE["voc"], reason="vocoder weights not present")
def test_vocoder_golden():
    r = T.run_vocoder(MODELS, ASSETS, device="cpu")
    assert r.status == "pass", r
