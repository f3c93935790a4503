"""The port's benchmark, ``python -m tortoise_tpu_torch.bench``, against
the JAX package's ``bench.py``: ``checked_sync`` on the JAX bench's four
cases (its composed route reports ``sync_consistent`` False, where the
JAX bench says True), ``roofline_stats`` against the JAX counts scaled
by the two chips' peaks, one tiny run of ``main()`` on the CPU, its
refusal to run without a card unless asked for the CPU, and its imports
(neither JAX nor the JAX package)."""

import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import bench as jax_bench  # noqa: E402  the JAX package's bench.py

from test_torch_import import REFUSE, ROOT  # noqa: E402
from tortoise_tpu_torch import bench  # noqa: E402

torch.set_num_threads(1)  # the tier-1 run's workers share the cores


def _mk(ar=0.5, diff=1.0, voc=0.2, extra=None):
    t = {"autoregressive_s": ar, "diffusion_s": diff, "vocoder_s": voc}
    if extra:
        t.update(extra)
    return t


def _clean():
    """A clean first pass returns at once."""
    return [(_mk(), 1.7)], 1.6, dict(
        calls=1, meta={"sync_retries": 0, "sync_consistent": True},
        wall=1.7, stages={"autoregressive_s": 0.5})


def _inflated():
    """Stages that sum to their own wall, many times the async wall (an
    inflated stage), are retried."""
    return [(_mk(ar=11.1), 12.8), (_mk(), 1.7)], 1.6, dict(
        calls=2, meta={"sync_retries": 1, "sync_consistent": True},
        wall=1.7, stages={"autoregressive_s": 0.5})


def _rotating():
    """One stage contaminated in each pass: the composed per-substage
    minimum ships, flagged composed and NOT consistent (the JAX bench
    calls it consistent)."""
    keys = ["autoregressive_s", "diffusion_s", "vocoder_s"]
    seq = []
    for i in range(3):
        t = _mk(extra={"ar_decode_steps": 500})
        t[keys[i]] += 10.0
        seq.append((t, sum(v for k, v in t.items() if k.endswith("_s"))))
    return seq, 1.7, dict(
        calls=3, meta={"sync_retries": 2, "sync_consistent": False,
                       "sync_composed": True},
        wall=1.7, stages={"autoregressive_s": 0.5, "diffusion_s": 1.0,
                          "vocoder_s": 0.2, "ar_decode_steps": 500})


def _hopeless():
    """Every pass contaminated the same way: the least-bad pass ships,
    flagged inconsistent, not composed."""
    return [(_mk(ar=11.0), 12.2)], 1.6, dict(
        calls=3, meta={"sync_retries": 2, "sync_consistent": False},
        wall=12.2, stages={"autoregressive_s": 11.0})


@pytest.mark.parametrize("case", [_clean, _inflated, _rotating, _hopeless],
                         ids=lambda c: c.__name__.strip("_"))
def test_checked_sync_cases(case):
    seq, ref_wall, want = case()
    calls = {"n": 0}

    def run():
        t, w = seq[min(calls["n"], len(seq) - 1)]
        calls["n"] += 1
        return dict(t), w, f"p{calls['n']}"

    _, tim, wall, meta = bench.checked_sync(run, ref_wall=ref_wall)
    assert calls["n"] == want["calls"]
    assert meta == want["meta"]
    assert abs(wall - want["wall"]) < 1e-9
    for k, v in want["stages"].items():
        assert abs(tim[k] - v) < 1e-9, k


def test_composed_route_is_not_reported_consistent():
    """The same passes through both benches: the JAX bench ships the
    composed split as consistent; the port says it is composed and not
    consistent, with the same split and wall."""
    seq, ref_wall, _ = _rotating()

    def runner():
        it = iter(seq)

        def run():
            t, w = next(it)
            return dict(t), w, None
        return run

    _, jt, jw, jmeta = jax_bench.checked_sync(runner(), ref_wall=ref_wall)
    _, pt, pw, pmeta = bench.checked_sync(runner(), ref_wall=ref_wall)
    assert jmeta["sync_consistent"] is True and jmeta["sync_composed"]
    assert pmeta["sync_consistent"] is False and pmeta["sync_composed"]
    assert pt == jt and pw == jw


def _duck(cfg_mod, tiny, timings, frames):
    """models and result with only what roofline_stats reads, from one
    package's config module."""
    if tiny:
        cfgs = (cfg_mod.tiny_ar_config(), cfg_mod.tiny_diffusion_config(),
                cfg_mod.tiny_vocoder_config())
    else:
        cfgs = (cfg_mod.ARConfig(), cfg_mod.DiffusionConfig(),
                cfg_mod.VocoderConfig())
    models = types.SimpleNamespace(ar_cfg=cfgs[0], diffusion_cfg=cfgs[1],
                                   vocoder_cfg=cfgs[2])
    vcfg = cfgs[2]
    n_audio = (frames + vcfg.mel_pad_frames) * vcfg.total_upsample - 6
    result = types.SimpleNamespace(
        timings=dict(timings), tokens=list(range(20)),
        audio=np.zeros(n_audio, np.float32), mel=None)
    return models, result


@pytest.mark.parametrize("tiny", [False, True], ids=["full", "tiny"])
@pytest.mark.parametrize("plane", [(True, True), (True, False),
                                   (False, False)],
                         ids=["bf16-int8", "bf16", "f32"])
@pytest.mark.parametrize("split", [True, False], ids=["split", "nosplit"])
def test_roofline_stats_match_the_jax_counts(monkeypatch, tiny, plane,
                                             split):
    """The same counts as the JAX bench: the ms fields equal, each share
    the JAX share times (v5e peak / H100 peak), to 1e-9 relative (both
    benches' rounding turned off)."""
    import tortoise_tpu.config as jax_cfg

    import tortoise_tpu_torch.config as port_cfg

    use_bf16, int8 = plane
    timings = {"diffusion_s": 3.91, "autoregressive_s": 1.2}
    if split:
        timings.update(ar_decode_loop_s=0.7631, ar_decode_steps=500)
    frames = 32 if tiny else 1017
    for mod in (jax_bench, bench):
        monkeypatch.setattr(mod, "round", lambda x, n=None: x,
                            raising=False)
    want = jax_bench.roofline_stats(*_duck(jax_cfg, tiny, timings, frames),
                                    use_bf16, int8)
    got = bench.roofline_stats(*_duck(port_cfg, tiny, timings, frames),
                               use_bf16, int8)
    assert got.keys() == want.keys()
    assert got["diffusion_ms_per_cfg_step"] == \
        want["diffusion_ms_per_cfg_step"]
    assert got["ar_ms_per_step"] == want["ar_ms_per_step"]
    peak = ((jax_bench.BF16_FLOPS, bench.BF16_FLOPS) if use_bf16
            else (jax_bench.F32_FLOPS, bench.F32_FLOPS))
    mfu = want["diffusion_mfu_pct"] * peak[0] / peak[1]
    assert got["diffusion_mfu_pct"] == pytest.approx(mfu, rel=1e-9)
    assert got["diffusion_mfu_pct"] > 0
    if not split:
        assert got["ar_hbm_roofline_pct"] is None is want[
            "ar_hbm_roofline_pct"]
        return
    hbm = want["ar_hbm_roofline_pct"] * jax_bench.HBM_GBPS \
        / bench.HBM_BYTES_PER_S
    assert got["ar_hbm_roofline_pct"] == pytest.approx(hbm, rel=1e-9)


@pytest.mark.parametrize("stage_sync", [False, True],
                         ids=["async", "stage-synced"])
def test_only_the_stage_synced_pass_waits_for_the_device(monkeypatch,
                                                         stage_sync):
    """The bench's timed passes run synthesize(stage_sync=False), which
    must not wait for the device between the stages (else checked_sync's
    2x test compares a pass with itself); the stage-synced pass does."""
    from tortoise_tpu_torch.pipeline import common, diffusion_stage
    from tortoise_tpu_torch.pipeline import synthesize as syn

    calls = []
    # the stages' sub-stage spans wait through common.sync
    for mod in (common, diffusion_stage, syn):
        monkeypatch.setattr(mod, "sync", calls.append)
    models = syn.TortoiseModels.random(0, tiny=True)
    res = syn.synthesize(models, tokens=[1, 5, 9, 0],
                         voice=np.zeros(64, np.float32), seed=0,
                         stage_sync=stage_sync, materialize=False,
                         device="cpu")
    assert res.audio.size > 0
    assert bool(calls) is stage_sync, calls


def test_main_small_on_the_cpu(monkeypatch, tmp_path, capsys):
    """One BENCH_SMALL run of main() on the CPU: exit 0, and the last
    stdout line carries the headline fields, the streaming section and
    kernel launches, all zero (the kernels run only on a card)."""
    for k in list(os.environ):
        if k.startswith("BENCH_"):
            monkeypatch.delenv(k)
    monkeypatch.setenv("BENCH_SMALL", "1")
    monkeypatch.setenv("BENCH_DEVICE", "cpu")
    monkeypatch.setenv("BENCH_WEIGHTS_CACHE", str(tmp_path / "weights"))
    assert bench.main() == 0
    out = capsys.readouterr().out.strip().splitlines()
    line = json.loads(out[-1])
    assert line["metric"] == "rtf" and line["rtf"] == line["value"] > 0
    assert line["device"] == "cpu" and line["int8_weights"] is True
    assert {"autoregressive_s", "diffusion_s", "vocoder_s",
            "ar_decode_loop_s"} <= line["stages_s"].keys()
    assert line["ar_decode_steps"] == 8
    assert isinstance(line["sync_consistent"], bool)
    assert "vs_baseline" not in line and "kernel_check" not in line
    stream = line["streaming"]
    assert "error" not in stream and stream["chunks"] >= 1
    assert stream["audio_s"] == line["audio_s"]
    launches = line["kernel_launches"]
    assert set(launches) == {"core", "streaming"}
    assert all(n == 0 for counts in launches.values()
               for n in counts.values())
    assert line["plane_cache_hit"] is False  # this run wrote the plane
    plane = Path(bench.weights_dir(small=True)) / "plane_int8"
    assert plane.is_dir() and plane.parent.parent == tmp_path / "weights"


def test_weights_dir_is_keyed_by_content(monkeypatch, tmp_path):
    """The bench's plane and tree cache sit in a directory keyed by the
    sources that make them: build_models serves a second call from the
    plane the first wrote, and an edit to the quantizers' module gives a
    new directory, so a stale plane is never loaded."""
    import shutil

    pkg = Path(bench.__file__).parent
    fake = tmp_path / "pkg"
    for rel in bench._TREE_SOURCES:
        (fake / rel).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(pkg / rel, fake / rel)
    monkeypatch.setattr(bench, "__file__", str(fake / "bench.py"))
    monkeypatch.setenv("BENCH_WEIGHTS_CACHE", str(tmp_path / "w"))

    first = bench.weights_dir(small=True)
    assert bench.weights_dir(small=False) != first
    _, f32 = bench.build_models(True, True, int8=True, device="cpu")
    assert f32 is not None  # drawn and quantized, then saved
    models, f32 = bench.build_models(True, True, int8=True, device="cpu")
    assert f32 is None  # the plane served
    assert isinstance(models.ar_params["lm_w"], tuple)

    with open(fake / "pipeline" / "ar_stage.py", "a") as f:
        f.write("\n# an edit\n")
    assert bench.weights_dir(small=True) != first
    _, f32 = bench.build_models(True, True, int8=True, device="cpu")
    assert f32 is not None  # a new key: no stale plane

    monkeypatch.setenv("BENCH_WEIGHTS_CACHE", "")
    assert bench.weights_dir(small=True) is None


@pytest.mark.parametrize("fault", [None, "no_bias", "no_mask"])
def test_kernel_selfcheck_reference(monkeypatch, fault):
    """The self-check on the CPU, where the wrappers take their plain
    versions: its own reference agrees with them within its limits, and
    a kernel B that drops the bias or the key mask lands past its limit.
    No kernel launched, so ``ok`` is False here."""
    from tortoise_tpu_torch.ops.cuda import flash_attention as fa

    packed = fa.flash_attention_packed
    if fault == "no_bias":
        monkeypatch.setattr(fa, "flash_attention_packed",
                            lambda qkv, h, valid, bias_table: packed(
                                qkv, h, valid))
    elif fault == "no_mask":
        monkeypatch.setattr(fa, "flash_attention_packed",
                            lambda qkv, h, valid, bias_table: packed(
                                qkv, h, None, bias_table=bias_table))
    kc = bench.kernel_selfcheck("cpu")
    assert kc["ok"] is False
    assert all(n == 0 for n in kc["launches"].values())
    assert kc["causal_flash_maxdiff"] < 0.05
    assert kc["decode_trunk_logits_maxdiff"] < 0.5
    assert kc["decode_trunk_kv_maxdiff"] < 0.2
    if fault is None:
        assert kc["packed_flash_maxdiff"] < 0.05
    else:
        assert kc["packed_flash_maxdiff"] > 0.2


def test_main_without_a_card_raises(monkeypatch):
    """No card and no BENCH_DEVICE: main() raises before any work."""
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench.main()


def test_bench_imports_without_jax():
    """The bench module imports with JAX and the JAX package refused."""
    probe = REFUSE + """
import tortoise_tpu_torch.bench
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "tortoise_tpu"))
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip() == "ok"
