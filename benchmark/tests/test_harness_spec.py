"""BENCHMARK.json against the contract's shape, every cell resolving its
files by name, a cell and a metric added as new files and entries
alone, and the shared modules knowing no model family."""

import ast
import json
import os
import re
import shutil

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_shape():
    spec = harness.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m["workloads"]:
            # each listed cell reports the metric it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
        layers.setdefault(m["layer"], m["layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in spec["workloads"]:
        assert w["config"] in names and w["chips"] in (1, 4)
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert len(w["why"]) <= 200
    assert len(set(cells)) == len(cells)
    assert {w["config"] for w in spec["workloads"]} == set(names)
    for c in spec["configs"]:
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert len(c["source"]) <= 200
    for cell in cells:
        reported = harness.metrics_of(spec, cell, "end_to_end")
        assert "setup_s" in [m["name"] for m in reported]
        assert len(reported) >= 2
        assert harness.metrics_of(spec, cell, "per_layer")
    assert len(json.dumps(spec)) < 64 * 1024


def test_every_cell_resolves_its_files():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        config = harness.config_of(spec, w)
        assert config["name"] == w["config"]
        mix = harness.mix_of(w)
        drv = harness.driver(mix)
        for fn in ("setup", "window", "served", "close"):
            assert callable(getattr(drv, fn))
        assert set(mix["check"]["limits"]) == set(mix["check"]["numbers"])
        if config["family"] == "tortoise":
            assert set(mix["check"]["limits"]) >= {"ar_gap"}
        for key in ("end_to_end", "per_layer"):
            for m in harness.metrics_of(spec, w["name"], key):
                assert callable(harness.metric(m["name"]).read)


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    """A copy of the benchmark gains a configuration, a cell and a
    per-layer metric by new files and entries only, and the harness
    finds each by name."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark")
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    spec = json.loads((root / "BENCHMARK.json").read_text())

    cfg = json.loads((root / "benchmark/configs/tortoise-v2-int8.json")
                     .read_text())
    cfg["name"] = "tortoise-v2-bf16"
    cfg["plane"] = dict(cfg["plane"], int8_weights=False)
    (root / "benchmark/configs/tortoise-v2-bf16.json").write_text(
        json.dumps(cfg))
    mix = json.loads((root / "benchmark/traffic/int8-single.json")
                     .read_text())
    (root / "benchmark/traffic/bf16-single.json").write_text(json.dumps(mix))
    (root / "benchmark/metrics/requests_done.single.py").write_text(
        "def read(run):\n    return float(len(run.done)) or None\n")
    spec["configs"].append({"name": "tortoise-v2-bf16",
                            "source": spec["configs"][0]["source"],
                            "file": "benchmark/configs/tortoise-v2-bf16.json",
                            "reduced": [], "why": "the --bf16 plane"})
    spec["workloads"].append({"name": "bf16-single",
                              "config": "tortoise-v2-bf16",
                              "traffic": "bf16-single", "chips": 1,
                              "why": "the plain bf16 AR step graph"})
    spec["per_layer"].append({"name": "requests_done.single",
                              "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "device",
                              "moves": "rtf",
                              "workloads": ["bf16-single"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    spec = harness.load_spec(str(root))
    here = str(root / "benchmark")
    cell = harness.cell(spec, "bf16-single")
    assert harness.config_of(spec, cell, str(root))["plane"][
        "int8_weights"] is False
    mix = harness.mix_of(cell, here)
    assert harness.driver(mix, here).__file__.endswith("synthesize.py")
    names = [m["name"] for m in
             harness.metrics_of(spec, "bf16-single", "per_layer")]
    assert names == ["requests_done.single"]
    assert [m["name"] for m in harness.metrics_of(
        spec, "bf16-single", "end_to_end")] == ["rtf", "setup_s"]

    class Run:
        done = [1, 2]
    assert harness.metric("requests_done.single", here).read(Run()) == 2.0
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, f"{p} was edited"


# what every family module defines (``harness``'s docstring)
FAMILY = ("build", "free", "reference", "numbers", "control_numbers",
          "request_row")
# the modules every family shares
SHARED = ("harness.py", "run.py", "calibrate.py", "check.py")


def test_every_configuration_names_its_family():
    spec = harness.load_spec()
    for w in spec["workloads"]:
        config = harness.config_of(spec, w)
        assert NAME.match(config["family"])
        fam = harness.family(config)
        assert fam.__file__ == os.path.join(harness.HERE, "families",
                                            config["family"] + ".py")
        for fn in FAMILY:
            assert callable(getattr(fam, fn)), (config["family"], fn)


@pytest.mark.parametrize("name", SHARED)
def test_shared_modules_import_nothing_of_the_port(name):
    """The harness reaches a model only through its family module: the
    shared modules' source imports nothing of ``tortoise_tpu_torch``,
    at the top or inside a function."""
    with open(os.path.join(harness.HERE, name)) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops  # the parse saw its imports
    assert "tortoise_tpu_torch" not in tops


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "tortoise_tpu"])
def test_banned_names_compared_whole(name, monkeypatch):
    """A module whose name only begins with a banned one (the port's
    ``tortoise_tpu_torch``) is not banned; the name itself, or one of its
    submodules, is."""
    import sys
    import types

    for m in [m for m in sys.modules if m.split(".")[0] == name]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, name + "_torch", types.ModuleType("x"))
    assert name not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, name + ".sub", types.ModuleType("x"))
    assert name in harness.banned_modules()
