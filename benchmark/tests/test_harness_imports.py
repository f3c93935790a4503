"""What a run imports: the harness, every driver and metric and the
port they drive load neither JAX nor the JAX package (top-level module
names compared whole), and the reference loads nothing of the port."""

import json
import subprocess
import sys

from benchmark import harness

BANNED = {"jax", "jaxlib", "flax", "tortoise_tpu"}


def _tops(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "PYTHONPATH": harness.ROOT,
             "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    spec = harness.load_spec()
    code = ["from benchmark import harness, run, calibrate, check, trace",
            "import tortoise_tpu_torch.pipeline.synthesize",
            "import tortoise_tpu_torch.serve",
            "spec = harness.load_spec()"]
    for w in spec["workloads"]:
        code.append(f"harness.driver(harness.mix_of(harness.cell(spec, "
                    f"{w['name']!r})))")
    for m in spec["end_to_end"] + spec["per_layer"]:
        code.append(f"harness.metric({m['name']!r})")
    tops = _tops("\n".join(code))
    assert "tortoise_tpu_torch" in tops and "torch" in tops
    assert not tops & BANNED, tops & BANNED


def test_the_reference_loads_nothing_of_the_port():
    tops = _tops("import benchmark.reference.ar, benchmark.reference."
                 "diffusion, benchmark.reference.vocoder, benchmark.reference."
                 "schedule, benchmark.reference.precision")
    assert not tops & (BANNED | {"tortoise_tpu_torch"})
