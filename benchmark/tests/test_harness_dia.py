"""The Dia family (``families/dia.py``, ``drivers/dia_synthesize.py``,
the ``dia_*`` metrics, ``counts/dia.py``) runs a tiny ``dia-single`` on
the CPU from a copy of the benchmark, and a port without the Dia modules
(the tree before them) fails the cell at once; the cell joined the
benchmark as new files and entries only."""

import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from benchmark import check, harness

SEED = 2 ** 31 + 29
DIA_MODULES = ("models/dia.py", "models/dac.py", "pipeline/dia_stage.py",
               "pipeline/dac_stage.py")
# sha256 (first 16 hex digits) of every file under benchmark/ before the
# Dia cell joined
BEFORE = {
    "calibrate.py": "b47b193354742fe0",
    "check.py": "9dae982f3911ebe7",
    "configs/f5-tts-v1-base-bf16.json": "3c8fedcfc62107b9",
    "configs/tortoise-v2-f32.json": "7c9cfbbde708993d",
    "configs/tortoise-v2-int8.json": "25b0d42df5d5e2ff",
    "counts/__init__.py": "4c647462821ec09c",
    "counts/attention.py": "44f947deda0a5131",
    "counts/f5.py": "e4b2951b3df85e6b",
    "counts/kernel_a.py": "2ae0a8bc5410a73f",
    "counts/model.py": "e71789faaae1f6ea",
    "drivers/f5_synthesize.py": "bc9437376dc9b2b1",
    "drivers/synthesize.py": "bca84430fcf95b88",
    "families/f5.py": "876fc3fb87986717",
    "families/tortoise.py": "f2b9067da0fc81e4",
    "harness.py": "2f8292930e1da8f1",
    "metrics/ar_device_ms_per_step.single.py": "4d7de3d3415bd62f",
    "metrics/ar_ms_per_step.single.py": "c722282073b2e135",
    "metrics/diffusion_device_ms_per_step.single.py": "d707d9c49bfc1c50",
    "metrics/diffusion_ms_per_step.single.py": "49cf5b52204a1768",
    "metrics/f5_attention_roofline_pct.single.py": "2289a01befc77040",
    "metrics/f5_device_ms_per_step.single.py": "072e8bf60e360963",
    "metrics/f5_graph_replay_pct.single.py": "edb37e3043e5deb3",
    "metrics/f5_mfu_pct.single.py": "c20098a1439c2443",
    "metrics/graph_replay_pct.single.py": "bc4a68abb491f2e9",
    "metrics/host_gap_pct.single.py": "3d0dc018933f544c",
    "metrics/idle_pct.single.py": "1b0faa47c058036b",
    "metrics/kernel_a_roofline_pct.single.py": "641fbcc327675f43",
    "metrics/kernel_b_roofline_pct.single.py": "884951317c6827f0",
    "metrics/kernel_bf_roofline_pct.single.py": "9d187d10ec17d0a4",
    "metrics/mfu_pct.single.py": "b7b946236c5ec3d8",
    "metrics/rtf.py": "1aa2e872598993e2",
    "metrics/setup_s.py": "bf829d40505285a8",
    "metrics/vocoder_device_ms_per_s.single.py": "68b6a03cde800b46",
    "metrics/vocos_device_ms_per_s.single.py": "6c499f852456230e",
    "peaks.py": "2f3d74f0eec21460",
    "program_spans.py": "9cc00927bc4aaea5",
    "readers.py": "fd4a2903b227bb31",
    "reference/__init__.py": "6b70210d932acf4d",
    "reference/ar.py": "84b67e04e0671925",
    "reference/diffusion.py": "cf0065d15fdac05b",
    "reference/f5.py": "159514bed74e5bdf",
    "reference/precision.py": "43f860ac48c4032b",
    "reference/schedule.py": "3903bc86f844009e",
    "reference/vocoder.py": "2fc5d3e57a7a9144",
    "run.py": "0b3f18c0b1ce10a2",
    "tests/conftest.py": "e3636cec6fbec5d2",
    "tests/data/tortoise_readings.json": "6f3e176a3ea077f3",
    "tests/test_harness_control.py": "fcf4fe216cec8f43",
    "tests/test_harness_counts.py": "db57b6fff0578178",
    "tests/test_harness_f5.py": "e66c2f089b8835b1",
    "tests/test_harness_family.py": "b8628bc8595da402",
    "tests/test_harness_faults.py": "5b33d01002c74cb3",
    "tests/test_harness_imports.py": "950df0534ae12818",
    "tests/test_harness_program_spans.py": "d7ead26cb3125b07",
    "tests/test_harness_reference.py": "8b36c4711810f2e5",
    "tests/test_harness_spec.py": "713c16541ce76a12",
    "tests/test_harness_trace.py": "81c8c9b9ac374b22",
    "tests/test_harness_traffic.py": "9cfcb7e716e08744",
    "trace.py": "51eaece064c3036a",
    "traffic.py": "8b448fc6e601b39e",
    "traffic/f32-single.json": "9f6a607a0a674433",
    "traffic/f5-single.json": "0184f0e1bbd417fe",
    "traffic/int8-single.json": "b1210cbf76df2d74",
    "weights.py": "62c9ee9be664b350",
}


def tiny_dia(spec):
    """(cell, config, mix) of ``dia-single`` at the port's tiny sizes:
    prompts of 8-24 frames at 40 frames a second, dialogues of 6-20
    bytes (2-7 frames a request)."""
    from tortoise_tpu_torch.models.dac import tiny_dac_config
    from tortoise_tpu_torch.models.dia import tiny_dia_config

    cell = harness.cell(spec, "dia-single")
    config = harness.config_of(spec, cell)
    config["dia"] = dataclasses.asdict(tiny_dia_config())
    config["dac"] = dataclasses.asdict(tiny_dac_config())
    mix = harness.mix_of(cell)
    mix["text"] = dict(mix["text"], min_len=6, max_len=20, sizes=4)
    mix.update(voices=dict(mix["voices"], count=4),
               ref_s={"min": 0.2, "max": 0.6}, frames_per_s=40, plan=12)
    mix["check"] = dict(mix["check"], requests=2)
    return cell, config, mix


def _copy(root):
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    return str(root / "benchmark")


def test_dia_cell_runs_from_a_copy(tmp_path):
    """Correct on the seed, the fp8 control outside a limit, ``rtf`` and
    ``setup_s`` read, a traced run reading ``dia_mfu_pct.single`` (the
    device's metrics read nothing on the CPU), request rows of the
    family's fields."""
    import benchmark.run as R

    here = _copy(tmp_path)
    spec = harness.load_spec(str(tmp_path))
    cell, config, mix = tiny_dia(spec)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    # a clock that ticks once a reading: a window of 5 ticks serves two
    # requests, however long each takes on this machine
    clock = iter(range(1, 10 ** 6))
    try:
        with mock.patch.object(harness, "now", lambda: float(next(clock))):
            out = R.run_cell(spec, cell, SEED, 5.0, False,
                             torch.device("cpu"), 0.0, config=config,
                             mix=mix, control=True, here=here)
            traced = R.run_cell(spec, cell, SEED + 1, 5.0, True,
                                torch.device("cpu"), 0.0, config=config,
                                mix=mix, here=here)
    finally:
        torch.set_num_threads(threads)
    assert out["correct"], out["check"]
    assert out["attempted"] == 2 and out["failed"] == 0
    assert set(out["metrics"]) == {"rtf", "setup_s"}
    assert set(out["check"]) == {"logit_err", "audio_err"}
    assert not check.verdict(out["control"], mix["check"]["limits"])
    assert all(len(row) == 6 for row in out["requests"])
    assert traced["correct"]
    assert "dia_mfu_pct.single" in traced["metrics"]
    assert set(traced["metrics"]) <= {m["name"] for m in spec["per_layer"]
                                      if "dia-single" in m["workloads"]}


def test_a_port_without_dia_fails_the_cell_at_once(tmp_path):
    """The benchmark as it stands over a port without the Dia modules:
    ``run.py`` exits 4 on the import error of ``families/dia.py``, within
    seconds (a card is faked, so the run gets as far as the family)."""
    _copy(tmp_path)
    port = tmp_path / "tortoise_tpu_torch"
    shutil.copytree(os.path.join(harness.ROOT, "tortoise_tpu_torch"), port,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    for m in DIA_MODULES:
        (port / m).unlink()
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "torch.cuda.set_device = lambda d: None\n"
            "import benchmark.run as R\n"
            "sys.exit(R.main(['--workload', 'dia-single', '--seed', "
            f"'{SEED}', '--seconds', '20', '--trace', '0']))")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 4, out.stderr[-2000:]
    assert "refused" in out.stderr
    assert "tortoise_tpu_torch.models.dia" in out.stderr or \
        "tortoise_tpu_torch.models.dac" in out.stderr
    assert out.stdout == ""
    assert time.monotonic() - t0 < 120


def _plan(seed):
    from benchmark.families import dia

    spec = harness.load_spec()
    cell = harness.cell(spec, "dia-single")

    class Run:
        pass

    run = Run()
    run.config = harness.config_of(spec, cell)
    run.mix = harness.mix_of(cell)
    run.plan = dia.make_plan(run.mix, seed, run.config)
    return run


def test_the_cell_plans_three_step_graph_keys():
    """The mix's requests reach three (text, cache) buckets, within the
    step-graph cache: texts of 119-316 bytes in buckets of 128, one
    cache bucket of 2048 positions, prompts
    of 285-662 frames, 396-1154 generated frames, at most 1832 positions;
    every block of 8 requests holds every clip and every text length
    once, the dialogue opens with [S1] and holds [S2] halfway."""
    from benchmark.families import dia
    from tortoise_tpu_torch.pipeline import graphs

    for seed in (SEED, SEED + 1):
        run = _plan(seed)
        shapes = [dia.shape(run, r) for r in run.plan.requests]
        keys = {dia.graph_key(run, r) for r in run.plan.requests}
        assert keys == {(128, 2048), (256, 2048), (384, 2048)}
        assert len(keys) <= graphs.MAX_GRAPHS
        assert min(s[0] for s in shapes) == 285
        assert max(s[0] for s in shapes) == 662
        assert {s[2] for s in shapes} == {396, 505, 614, 724, 827, 936,
                                          1045, 1154}
        assert max(s[0] + s[3] for s in shapes) == 1832
        for i in range(0, len(run.plan.requests), 8):
            block = run.plan.requests[i:i + 8]
            assert sorted(r.voice for r in block) == list(range(8))
            assert len({len(r.tokens) for r in block}) == 8
        for r in run.plan.requests[:8]:
            assert r.tokens[0] == 1 and r.tokens[len(r.tokens) // 2] == 2
            assert all(32 <= t < 127 for i, t in enumerate(r.tokens[1:-1])
                       if i + 1 != len(r.tokens) // 2)
        assert all(c.text[0] == 1 for c in run.plan.clips)


def test_dia_counts():
    """``counts/dia.py`` at the published widths: 1.611 B parameters;
    a decode step reads 1,264.8 M weights (0.755 ms at 3.35 TB/s) and
    does 5.06 GFLOP; 73,728 bytes of self K/V a cached frame and 294,912
    of cross K/V a text byte; the DAC ~138 GFLOP an audio second."""
    from benchmark.counts import dia as counts

    spec = harness.load_spec()
    config = harness.config_of(spec, harness.cell(spec, "dia-single"))
    c, dc = config["dia"], config["dac"]
    n = counts.params(c, dc)
    assert n["encoder"] + n["decoder"] + n["embeddings"] == 1_611_160_576
    assert n["encoder"] == pytest.approx(251.7e6, rel=1e-3)
    assert n["decoder"] == pytest.approx(1321.3e6, rel=1e-3)
    assert n["dac"] == 54_247_777
    assert counts.step_weights(c) == pytest.approx(1264.8e6, rel=1e-4)
    assert counts.step_bytes(c, 0, 0) / 3.35e12 == pytest.approx(
        0.755e-3, rel=1e-3)
    assert counts.step_flops(c) == pytest.approx(5.06e9, rel=1e-3)
    assert counts.kv_bytes_per_frame(c) == 73_728
    assert counts.cross_bytes_per_byte(c) == 294_912
    assert counts.dac_flops_per_frame(dc) * 44100 / 512 == pytest.approx(
        138.5e9, rel=1e-3)
    one = counts.loop_bound_s(c, 10, 100, 1)
    assert one == pytest.approx(counts.step_bytes(c, 11, 100) / 3.35e12)
    f = counts.request_flops(c, dc, 500, 300, 1000, 1016)
    assert f["dia_linear"] > 1016 * counts.step_flops(c)
    assert f["dac"] == 1000 * counts.dac_flops_per_frame(dc)


def test_counts_agree_with_the_port_shapes():
    """The counted parameters are the port's tree's, tensor for tensor
    class."""
    import math

    from benchmark.counts import dia as counts
    from tortoise_tpu_torch.models import dac as DM
    from tortoise_tpu_torch.models import dia as M

    def n(tree):
        return (sum(n(v) for v in tree.values()) if isinstance(tree, dict)
                else math.prod(tree))

    spec = harness.load_spec()
    config = harness.config_of(spec, harness.cell(spec, "dia-single"))
    shapes = M.param_shapes(M.DiaConfig())
    got = counts.params(config["dia"], config["dac"])
    assert got["encoder"] == n(shapes["encoder"]) - 256 * 1024
    assert got["dac"] == n(DM.param_shapes(DM.DacConfig()))


def test_files_that_were_there_are_unchanged():
    """Every file of ``benchmark/`` from before the Dia cell is byte for
    byte as it was, and BENCHMARK.json keeps every earlier entry as it
    was, the new ones last."""
    for rel, digest in BEFORE.items():
        with open(os.path.join(harness.HERE, rel), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest()[:16] == digest, rel
    spec = harness.load_spec()
    assert [c["name"] for c in spec["configs"]][-1] == "dia-1.6b-bf16"
    assert [w["name"] for w in spec["workloads"]][-1] == "dia-single"
    new = [m["name"] for m in spec["per_layer"]][-5:]
    assert new == ["dia_device_ms_per_step.single",
                   "dac_device_ms_per_s.single",
                   "dia_step_roofline_pct.single", "dia_mfu_pct.single",
                   "dia_graph_replay_pct.single"]
    assert all(m["workloads"] == ["dia-single"] for m in spec["per_layer"]
               if m["name"] in new)
    with open(os.path.join(harness.HERE, "configs",
                           "dia-1.6b-bf16.json")) as f:
        assert json.load(f)["family"] == "dia"
