"""The port's last host entry points against the JAX package's: the
CLI's option set and the three flags that reach the pipeline
(``--no-progress``, ``--cache-dir``, ``--tokenizer-method``),
``python -m tortoise_tpu_torch.convert``, and ``utils/`` (progress bar,
dumps, trace). Exact throughout."""

import io
import json
import os

import numpy as np
import pytest
import torch

from tortoise_tpu import cli as JCLI
from tortoise_tpu import convert as JCONV
from tortoise_tpu import utils as JU
from tortoise_tpu.config import (
    VocoderConfig,
    tiny_ar_config,
    tiny_diffusion_config,
    tiny_vocoder_config,
)
from tortoise_tpu.io import checkpoint as JCK
from tortoise_tpu_torch import cli as TCLI
from tortoise_tpu_torch import convert as TCONV
from tortoise_tpu_torch import utils as TU
from tortoise_tpu_torch.io.ggml import write_ggml
from tortoise_tpu_torch.pipeline import streaming as TST
from tortoise_tpu_torch.pipeline import synthesize as T
from tortoise_tpu_torch.utils.progress import progress_bar

torch.set_num_threads(1)  # several pytest workers share the cores


def option_defaults(parser):
    return {s: a.default for a in parser._actions for s in a.option_strings
            if s not in ("-h", "--help")}


def test_parser_takes_every_jax_option():
    """Every option string of the JAX CLI, with its default, plus
    --device (cuda by default) and --family (tortoise by default)."""
    want = option_defaults(JCLI.build_parser())
    got = option_defaults(TCLI.build_parser())
    assert set(want) <= set(got), set(want) - set(got)
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) == {"--device", "--family"}
    assert got["--device"] == "cuda"
    assert got["--family"] == "tortoise"


class Reached(Exception):
    """Raised by a stubbed pipeline entry point with its arguments."""


@pytest.mark.parametrize("no_progress", [False, True])
@pytest.mark.parametrize("mode", ["one_shot", "messages_file", "stream"])
def test_flags_reach_their_callees(tmp_path, monkeypatch, mode,
                                   no_progress):
    """--cache-dir reaches from_ggml_dir; --tokenizer-method reaches
    synthesize, synthesize_batch and stream_synthesize; the progress bar
    reaches the first two unless --no-progress."""
    seen = {}

    def from_ggml_dir(models_dir, cache_dir=None, **cfgs):
        seen["models"], seen["cache_dir"] = models_dir, cache_dir
        return T.TortoiseModels.random(0, tiny=True)

    def stub(name):
        def fn(*a, **kw):
            seen[name] = kw
            raise Reached(name)
        return fn

    monkeypatch.setattr(T.TortoiseModels, "from_ggml_dir",
                        staticmethod(from_ggml_dir))
    monkeypatch.setattr(T, "synthesize", stub("synthesize"))
    monkeypatch.setattr(T, "synthesize_batch", stub("synthesize_batch"))
    monkeypatch.setattr(TST, "stream_synthesize", stub("stream_synthesize"))
    argv = ["--models", str(tmp_path), "--cache-dir", str(tmp_path / "c"),
            "--tokenizer-method", "bpe", "--device", "cpu", "--seed", "1"]
    if no_progress:
        argv.append("--no-progress")
    callee = {"one_shot": "synthesize", "messages_file": "synthesize_batch",
              "stream": "stream_synthesize"}[mode]
    if mode == "messages_file":
        (tmp_path / "m.txt").write_text("one\ntwo\n")
        argv += ["--messages-file", str(tmp_path / "m.txt")]
    else:
        argv += ["--tokens", "1,5,9,0"] + (["--stream"] if mode == "stream"
                                           else [])
    with pytest.raises(Reached, match=callee):
        TCLI.run(argv)
    assert seen["models"] == str(tmp_path)
    assert seen["cache_dir"] == str(tmp_path / "c")
    kw = seen[callee]
    assert kw["tokenizer_method"] == "bpe"
    if mode != "stream":
        assert kw["progress"] is (None if no_progress else progress_bar)


def npz_contents(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def assert_npz_equal(a, b):
    x, y = npz_contents(a), npz_contents(b)
    assert sorted(x) == sorted(y)
    for k in x:
        assert x[k].dtype == y[k].dtype, k
        np.testing.assert_array_equal(x[k], y[k], err_msg=k)


@pytest.mark.parametrize("stage", ["ar", "diffusion", "vocoder"])
def test_converters_match_jax(tmp_path, stage):
    """On tiny write_ggml files, the port's convert_*_checkpoint writes
    the npz the JAX package's writes, and a second call loads it."""
    from tortoise_tpu_torch.io import checkpoint as TCK

    cfg, inventory = {
        "ar": (tiny_ar_config(), JCK.ar_tensor_inventory),
        "diffusion": (tiny_diffusion_config(),
                      JCK.diffusion_tensor_inventory),
        "vocoder": (tiny_vocoder_config(), JCK.vocoder_tensor_inventory),
    }[stage]
    src = str(tmp_path / f"{stage}.bin")
    write_ggml(src, JCK.random_ggml_tensors(inventory(cfg), seed=4))
    name = f"convert_{stage}_checkpoint"
    t_npz, j_npz = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tree = getattr(TCK, name)(src, t_npz, cfg)
    getattr(JCK, name)(src, j_npz, cfg)
    assert_npz_equal(t_npz, j_npz)
    again = getattr(TCK, name)(src, t_npz, cfg)  # from the cache
    assert sorted(again) == sorted(tree)


def test_convert_cli_matches_jax(tmp_path, capsys):
    """python -m tortoise_tpu_torch.convert on a production-inventory
    vocoder file: the JAX CLI's npz, and exit 1 for the two absent
    files."""
    cfg = VocoderConfig()
    tensors = JCK.random_ggml_tensors(JCK.vocoder_tensor_inventory(cfg),
                                      seed=3)
    tensors["conv_post.1.weight"] = tensors["conv_post.1.weight"].reshape(
        cfg.ch, 7)  # stored 2-D like the real file (main.cpp:1786)
    models = tmp_path / "models"
    models.mkdir()
    write_ggml(str(models / "ggml-vocoder-model.bin"), tensors)
    rcs = [mod.main(["--models", str(models), "--out",
                     str(tmp_path / name)])
           for mod, name in ((TCONV, "t"), (JCONV, "j"))]
    out = capsys.readouterr()
    assert rcs == [1, 1]
    assert out.out.count("ggml-vocoder-model.bin -> vocoder.npz") == 2
    assert out.err.count("skip ggml-model.bin: not found") == 2
    assert sorted(os.listdir(tmp_path / "t")) == ["vocoder.npz"]
    assert_npz_equal(tmp_path / "t" / "vocoder.npz",
                     tmp_path / "j" / "vocoder.npz")


def _dump_pair(root, pkg, arrays):
    """Two dump directories made by ``pkg``'s DumpRegistry."""
    dirs = []
    for side, xs in zip("ab", arrays):
        d = str(root / f"{pkg.__name__.split('.')[0]}_{side}")
        reg = pkg.DumpRegistry(d)
        for name, x in xs:
            reg.dump(name, x)
        dirs.append(d)
    return dirs


@pytest.mark.parametrize("what", ["progress_bar", "compare_dumps"])
def test_utils_match_jax(tmp_path, what):
    """The same bytes from progress_bar and the same mismatches from
    compare_dumps (NaN, one-sided, reshaped and repeated names) on
    directories the two packages wrote."""
    if what == "progress_bar":
        for width in (50, 7):
            outs = []
            for fn in (JU.progress_bar, TU.progress_bar):
                buf = io.StringIO()
                for f in (-0.5, 0.0, 0.333, 0.5, 0.999, 1.0, 1.7):
                    fn(f, width=width, out=buf)
                outs.append(buf.getvalue())
            assert outs[0] == outs[1]
    else:
        x = np.arange(6, dtype=np.float32).reshape(2, 3)
        a = [("emb", x), ("attn", x), ("attn", x * 2), ("nan", x),
             ("shape", x), ("gone", x)]
        b = [("emb", x), ("attn", x), ("attn", x * 2 + 0.5),
             ("nan", np.where(x > 3, np.nan, x)), ("shape", x.T),
             ("new", x)]
        got = [pkg.compare_dumps(*_dump_pair(tmp_path, pkg, (a, b)))
               for pkg in (JU, TU)]
        assert repr(got[0]) == repr(got[1])
        assert [n for n, _ in got[1]] == [
            "gone (only one side)", "new (only one side)", "attn@1", "nan",
            "shape"]
        j_dir, t_dir = (_dump_pair(tmp_path, pkg, (a, b))[0]
                        for pkg in (JU, TU))
        assert TU.compare_dumps(j_dir, t_dir, atol=0.0) == []


def test_dump_takes_tensors(tmp_path):
    """dump() moves a tensor to the host (bf16 widened to f32) before
    np.save."""
    from tortoise_tpu_torch.utils.debug import DumpRegistry

    reg = DumpRegistry(str(tmp_path))
    x = torch.linspace(-2, 2, 12).reshape(3, 4)
    reg.dump("f32", x)
    reg.dump("bf16", x.to(torch.bfloat16))
    reg.dump("i64", torch.arange(5))
    np.testing.assert_array_equal(np.load(tmp_path / "0000_f32.npy"),
                                  x.numpy())
    got = np.load(tmp_path / "0001_bf16.npy")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, x.to(torch.bfloat16).float().numpy())
    np.testing.assert_array_equal(np.load(tmp_path / "0002_i64.npy"),
                                  np.arange(5))


def test_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    """trace(dir) on the CPU writes a trace with the block's ops; with no
    directory and no TORTOISE_TRACE_DIR it is a no-op."""
    monkeypatch.delenv("TORTOISE_TRACE_DIR", raising=False)
    with TU.trace() as prof:
        assert prof is None
    d = tmp_path / "traces"
    with TU.trace(str(d)) as prof:
        assert prof is not None
        torch.mm(torch.ones(8, 8), torch.ones(8, 8))
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(d / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    monkeypatch.setenv("TORTOISE_TRACE_DIR", str(d))
    with TU.trace():
        torch.ones(2) + 1
    assert len(os.listdir(d)) == 2
