"""A model family is a module of the harness (``benchmark/families/``):
Tortoise's cells read as they did before their family moved there, and a
family of another architecture joins the benchmark as new files and
entries alone.

The readings of ``test_tortoise_reads_as_before`` were recorded from the
harness as it was before the move, by

    python3 benchmark/tests/test_harness_family.py --write --root <checkout>

run against a checkout of that harness (``--root``), and are held here to
the last bit."""

import contextlib
import hashlib
import json
import os
import shutil
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "tortoise_readings.json")
CASES = [(c, s) for c in ("int8-single", "f32-single")
         for s in (20240601, 2 ** 31 + 11)]
# a closed-loop window of this many ticks of the fake clock serves two
# requests, however long each takes on this machine
TICKS = 5.0


def _digest(tree) -> str:
    """sha256 of every tensor's bytes in ``tree``, in tree order."""
    h = hashlib.sha256()

    def walk(t):
        if isinstance(t, dict):
            for k in t:
                h.update(k.encode())
                walk(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        else:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())

    walk(tree)
    return h.hexdigest()


def _plan_digest(plan) -> str:
    rows = [[r.tokens, r.voice, r.seed, r.greedy, r.due]
            for r in plan.requests]
    h = hashlib.sha256(json.dumps(rows).encode())
    h.update(str(plan.voices.shape).encode())
    h.update(np.ascontiguousarray(plan.voices).tobytes())
    return h.hexdigest()


def readings(tiny, cell: str, seed: int) -> dict:
    """One tiny run of ``cell`` on the CPU on one thread, with a clock
    that ticks once a reading: its plan and every weight tree drawn
    (digests), the requests checked, the check's numbers, the result's
    keys and its request rows less their times."""
    from benchmark import harness, traffic, weights
    import benchmark.run as R

    plans, trees = [], []
    make_plan, make = traffic.make_plan, weights.make

    def plan_of(*a, **k):
        plan = make_plan(*a, **k)
        plans.append(_plan_digest(plan))
        return plan

    def weights_of(*a, **k):
        w = make(*a, **k)
        trees.append({name: _digest(t) for name, t in w.items()})
        return w

    clock = iter(range(1, 10 ** 6))
    spec, c, config, mix = tiny(cell)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(traffic, "make_plan",
                                                  plan_of))
            stack.enter_context(mock.patch.object(weights, "make",
                                                  weights_of))
            stack.enter_context(mock.patch.object(
                harness, "now", lambda: float(next(clock))))
            out = R.run_cell(spec, c, seed, TICKS, False,
                             torch.device("cpu"), 0.0, config=config,
                             mix=mix)
    finally:
        torch.set_num_threads(threads)
    return {"plans": plans, "weights": trees,
            "correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"],
            "requests_checked": out["requests_checked"],
            "check": {k: v["value"] for k, v in out["check"].items()},
            "limits": {k: v["limit"] for k, v in out["check"].items()},
            "keys": sorted(out), "metrics": sorted(out["metrics"]),
            "requests": [row[:-1] for row in out["requests"]]}


@pytest.mark.parametrize("cell,seed", CASES)
def test_tortoise_reads_as_before(tiny_cell, cell, seed):
    """Same seed, same plan, weights, requests checked, check numbers (to
    the last bit) and result keys as the harness gave before Tortoise
    became a family module."""
    with open(DATA) as f:
        want = json.load(f)[f"{cell}/{seed}"]
    got = json.loads(json.dumps(readings(tiny_cell, cell, seed)))
    assert got == want


# A toy family of another architecture, added to a copy of the benchmark
# as files and entries only: a seeded plain-torch "TTS" on the CPU whose
# audio is tanh(emb[id] + voice) @ out, ``hop`` samples an id. The
# program (the driver's entry) computes it batched and scaled by the
# configuration's ``scale``; the reference, id by id and unscaled.
TOY_FAMILY = '''"""The toy family: weights, reference and numbers."""
import torch

from benchmark import check, traffic


def _weights(config, seed):
    gen = torch.Generator().manual_seed(int(seed))
    return {"emb": torch.randn(config["vocab"], config["width"],
                               generator=gen),
            "out": torch.randn(config["width"], config["hop"],
                               generator=gen)}


def build(run):
    run.plan = traffic.make_plan(run.mix, run.seed, run.config["width"])
    run.models = _weights(run.config, run.seed)


def free(run):
    run.models = None


def reference(config, seed, device, control=False):
    w = _weights(config, seed)
    if control:  # bfloat16 weights, a step below the stated float32
        w = {k: v.bfloat16().float() for k, v in w.items()}
    return w


def _audio(w, served):
    voice = torch.as_tensor(served.voice)
    return torch.cat([torch.tanh(w["emb"][i] + voice) @ w["out"]
                      for i in served.text])


def numbers(ref, served, names):
    return {"audio_err": check._rel(served.audio, _audio(ref, served))}


def control_numbers(ref, ctrl, served, names):
    return {"audio_err": check._rel(_audio(ctrl, served),
                                    _audio(ref, served))}


def request_row(record):
    if not record.ok:
        return [None]
    return [len(record.result.audio) / record.result.sample_rate]
'''

TOY_DRIVER = '''"""Entry ``toy``: the toy program, closed loop."""
import types

import torch

from benchmark import harness


def _call(run, req):
    w, voice = run.models, torch.as_tensor(run.plan.voices[req.voice])
    h = torch.tanh(w["emb"][torch.tensor(req.tokens)] + voice)
    audio = (h @ w["out"]).reshape(-1) * run.config["scale"]
    return types.SimpleNamespace(audio=audio.numpy(),
                                 sample_rate=run.config["sample_rate"])


def setup(run):
    _call(run, run.plan.requests[0])


def window(run, state, seconds):
    run.opened = harness.now()
    for req in run.plan.requests:
        if harness.now() - run.opened >= seconds:
            break
        rec = harness.Record(request=req, start=harness.now())
        rec.result = _call(run, req)
        rec.end = harness.now()
        run.records.append(rec)
    run.closed = harness.now()


def served(run, rec):
    req = rec.request
    return types.SimpleNamespace(text=req.tokens, greedy=req.greedy,
                                 voice=run.plan.voices[req.voice],
                                 audio=rec.result.audio)


def close(state):
    pass
'''

TOY_CONFIG = {"name": "toy", "family": "toy", "vocab": 32, "width": 8,
              "hop": 30, "sample_rate": 24000, "scale": 1.0}
TOY_MIX = {"entry": "toy",
           "text": {"min_len": 6, "max_len": 20, "wrap": [31, 0],
                    "id_low": 1, "id_high": 31, "sizes": 4},
           "voices": {"count": 2, "std": 0.5}, "greedy_every": 1,
           "plan": 16,
           "check": {"requests": 4, "numbers": ["audio_err"],
                     "limits": {"audio_err": 1e-4}}}


def _toy_checkout(root):
    """A copy of the benchmark at ``root`` with the toy family added as
    files and entries; returns the bytes of every file it had before."""
    from benchmark import harness

    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    b = root / "benchmark"
    (b / "families/toy.py").write_text(TOY_FAMILY)
    (b / "drivers/toy.py").write_text(TOY_DRIVER)
    (b / "configs/toy.json").write_text(json.dumps(TOY_CONFIG))
    (b / "traffic/toy.json").write_text(json.dumps(TOY_MIX))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy", "source": "this test",
                            "file": "benchmark/configs/toy.json",
                            "reduced": [], "why": "a family of its own"})
    spec["workloads"].append({"name": "toy-single", "config": "toy",
                              "traffic": "toy", "chips": 1,
                              "why": "the toy entry, closed loop"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return before


def test_a_family_added_as_files(tmp_path):
    """The toy cell runs through ``run.run_cell`` from the copy: correct,
    with ``rtf`` and ``setup_s`` read and its control failing; the same
    program with its output scaled by 1.01 is not correct; and no file
    that was there before changed."""
    from benchmark import check, harness
    import benchmark.run as R

    root = tmp_path / "checkout"
    before = _toy_checkout(root)
    here = str(root / "benchmark")
    spec = harness.load_spec(str(root))
    cell = harness.cell(spec, "toy-single")

    def run(**kw):
        return R.run_cell(spec, cell, 2 ** 31 + 3, 0.5, False,
                          torch.device("cpu"), time.monotonic(), here=here,
                          **kw)

    out = run(control=True)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 4 and out["failed"] == 0
    assert set(out["metrics"]) == {"rtf", "setup_s"}
    assert out["metrics"]["rtf"]["value"] > 0
    assert all(len(row) == 5 for row in out["requests"])
    assert not check.verdict(out["control"], TOY_MIX["check"]["limits"])

    config = harness.config_of(spec, cell, str(root))
    scaled = run(config=dict(config, scale=1.01))
    assert not scaled["correct"], scaled["check"]

    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, f"{p} was edited"
    old = json.loads(before[root / "BENCHMARK.json"])
    for key, entries in old.items():
        if isinstance(entries, list) and key != "paths":
            assert spec[key][:len(entries)] == entries, key
        else:
            assert spec[key] == entries, key


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="record the readings of "
                                 "test_tortoise_reads_as_before")
    ap.add_argument("--write", action="store_true", required=True)
    ap.add_argument("--root", required=True,
                    help="the checkout whose harness is read")
    ap.add_argument("--out", default=DATA)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(0, os.path.join(os.path.abspath(args.root),
                                    "benchmark", "tests"))
    from conftest import tiny

    out = {f"{c}/{s}": readings(tiny, c, s) for c, s in CASES}
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
