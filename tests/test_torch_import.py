"""The PyTorch port never imports JAX (the machine with the card has
none), directly or through the JAX package's jax-importing modules."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import tortoise_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tortoise_tpu_torch.__path__,
                                               "tortoise_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib",
                                            "tortoise_tpu.pipeline",
                                            "tortoise_tpu.ops",
                                            "tortoise_tpu.models")))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 15, names
assert {"tortoise_tpu_torch.ops.cuda.lvc",
        "tortoise_tpu_torch.ops.cuda.flash_attention",
        "tortoise_tpu_torch.serve",
        "tortoise_tpu_torch.pipeline.streaming"} <= set(names), names
"""

SERVING_PROBE = """
import sys
import tortoise_tpu_torch.serve, tortoise_tpu_torch.pipeline.streaming
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith(("jax.", "jaxlib", "tortoise_tpu.")
                                           ) and not k.startswith(
                 ("tortoise_tpu.config", "tortoise_tpu.io",
                  "tortoise_tpu.text", "tortoise_tpu.rng",
                  "tortoise_tpu.native")))
assert not bad, bad
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_serving_modules_import_without_jax():
    """The server and the streaming path, imported alone, pull in no JAX
    and, of the JAX package, only its jax-free host modules."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SERVING_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_without_jax_and_needs_a_card():
    """chip_smoke.py imports nothing of JAX and, without a card, exits
    nonzero and prints no result line."""
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert "tortoise_tpu." not in src.replace("tortoise_tpu_torch", "")


def test_c_entry_points_match_their_ctypes_signatures():
    """Every C entry point in csrc/ has a ctypes signature with its
    argument count, and every signature names an entry point (a missing
    or short signature would pass pointers as 32-bit ints)."""
    import re

    from tortoise_tpu_torch.ops.cuda import build

    exported = {}
    for src in build.SRC_DIR.glob("*.cu"):
        for name, params in re.findall(
                r"TT_EXPORT\s+[\w ]+?\s(\w+)\(([^)]*)\)", src.read_text()):
            exported[name] = len(params.split(","))
    assert exported.keys() == build.SIGNATURES.keys()
    for name, n in exported.items():
        assert len(build.SIGNATURES[name]) == n, name
