"""The F5-TTS family (``families/f5.py``, ``drivers/f5_synthesize.py``,
the ``f5_*`` metrics) runs a tiny ``f5-single`` on the CPU from a copy
of the benchmark, and a port without the F5 modules (the tree before
them) fails the cell at once."""

import dataclasses
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
F5_MODULES = ("models/f5.py", "models/vocos.py", "pipeline/f5_stage.py",
              "pipeline/vocos_stage.py")


def tiny_f5(spec):
    """(cell, config, mix) of ``f5-single`` at the port's tiny sizes: clips
    of 0.02-0.06 s (30-90 frames at the tiny hop of 16), 6-20 ids."""
    from tortoise_tpu_torch.models.f5 import tiny_f5_config
    from tortoise_tpu_torch.models.vocos import tiny_vocos_config

    cell = harness.cell(spec, "f5-single")
    config = harness.config_of(spec, cell)
    config["dit"] = dataclasses.asdict(tiny_f5_config())
    config["vocos"] = dataclasses.asdict(tiny_vocos_config())
    mix = harness.mix_of(cell)
    mix["text"] = dict(mix["text"], min_len=6, max_len=20, id_high=40,
                       sizes=4)
    mix.update(voices=dict(mix["voices"], count=4),
               ref_s={"min": 0.02, "max": 0.06}, ref_chars_per_s=300,
               plan=12)
    mix["check"] = dict(mix["check"], requests=2)
    return cell, config, mix


def _copy(root):
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    return str(root / "benchmark")


def test_f5_cell_runs_from_a_copy(tmp_path):
    """Correct on the seed, the control outside a limit, ``rtf`` and
    ``setup_s`` read, a traced run reading ``f5_mfu_pct.single`` (the
    device's metrics read nothing on the CPU), request rows of the
    family's fields."""
    import benchmark.run as R

    here = _copy(tmp_path)
    spec = harness.load_spec(str(tmp_path))
    cell, config, mix = tiny_f5(spec)
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
    assert set(out["check"]) == {"vel_err", "mel_err", "audio_err"}
    assert not check.verdict(out["control"], mix["check"]["limits"])
    assert all(len(row) == 6 for row in out["requests"])
    assert traced["correct"]
    assert "f5_mfu_pct.single" in traced["metrics"]
    assert set(traced["metrics"]) <= {m["name"] for m in spec["per_layer"]
                                      if "f5-single" in m["workloads"]}


def test_a_port_without_f5_fails_the_cell_at_once(tmp_path):
    """The benchmark as it stands over a port without the F5 modules:
    ``run.py`` exits 4 on the import error of ``families/f5.py``, within
    seconds (a card is faked, so the run gets as far as the family)."""
    _copy(tmp_path)
    port = tmp_path / "tortoise_tpu_torch"
    shutil.copytree(os.path.join(harness.ROOT, "tortoise_tpu_torch"), port,
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    for m in F5_MODULES:
        (port / m).unlink()
    code = ("import sys, torch\n"
            "torch.cuda.is_available = lambda: True\n"
            "torch.cuda.device_count = lambda: 1\n"
            "torch.cuda.set_device = lambda d: None\n"
            "import benchmark.run as R\n"
            "sys.exit(R.main(['--workload', 'f5-single', '--seed', "
            f"'{SEED}', '--seconds', '20', '--trace', '0']))")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=str(tmp_path)))
    assert out.returncode == 4, out.stderr[-2000:]
    assert "refused" in out.stderr and "f5" in out.stderr
    assert out.stdout == ""
    assert time.monotonic() - t0 < 120


def test_the_cell_plans_six_step_graph_keys():
    """The mix's requests reach six padded lengths (256-frame buckets),
    within the step-graph cache, and T stays under ~22 s; on every seed
    each block of 8 requests holds every clip and every text length
    once."""
    from benchmark.families import f5
    from tortoise_tpu_torch.pipeline import f5_stage, graphs

    spec = harness.load_spec()
    cell = harness.cell(spec, "f5-single")
    config = harness.config_of(spec, cell)
    mix = harness.mix_of(cell)

    class Run:
        pass

    run = Run()
    run.plan = f5.make_plan(mix, SEED, config["vocos"])
    shapes = [f5.shape(run, r) for r in run.plan.requests]
    pads = {f5_stage.padded_frames(t) for t, _, _ in shapes}
    assert pads == {768, 1024, 1280, 1536, 1792, 2048}
    assert len(pads) <= graphs.MAX_GRAPHS
    assert max(t for t, _, _ in shapes) * 256 / 24000 < 22
    other = f5.make_plan(mix, SEED + 1, config["vocos"])
    assert ([c.mel.shape for c in other.clips]
            == [c.mel.shape for c in run.plan.clips])
    for plan in (run.plan, other):
        for i in range(0, len(plan.requests), 8):
            block = plan.requests[i:i + 8]
            assert sorted(r.voice for r in block) == list(range(8))
            assert (sorted(len(r.tokens) for r in block)
                    == sorted(len(r.tokens) for r in run.plan.requests[:8]))


def test_f5_counts():
    """``counts/f5.py`` at the published widths: an eval at T = 2,048 is
    ~2.3 TFLOP with attention a third (1,024: ~0.97, a fifth); the
    weights an eval reads are the DiT's parameters less the text
    encoder's (which runs once a request), 2 bytes each."""
    import math

    from benchmark.counts import f5 as counts
    from tortoise_tpu_torch.models.f5 import F5Config, param_shapes

    spec = harness.load_spec()
    c = harness.config_of(spec, harness.cell(spec, "f5-single"))["dit"]
    for t, total, share in ((2048, 2.3e12, 0.33), (1024, 0.97e12, 0.19)):
        f = counts.eval_flops(c, t)
        assert sum(f.values()) == pytest.approx(total, rel=0.02)
        assert f["dit_attention"] / sum(f.values()) == pytest.approx(
            share, abs=0.01)

    def n(tree):
        return (sum(n(v) for v in tree.values()) if isinstance(tree, dict)
                else math.prod(tree))

    shapes = param_shapes(F5Config(**c))
    assert counts.weight_bytes(c) == 2 * (n(shapes) - n(shapes["text"]))
    assert n(shapes) == pytest.approx(336e6, rel=0.01)
