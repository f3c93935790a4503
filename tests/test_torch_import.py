"""The PyTorch port stands alone: it imports neither JAX (the machine
with the card has none) nor any module of the JAX package, not even a
jax-free one."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import tortoise_tpu_torch
names = [m.name for m in pkgutil.walk_packages(tortoise_tpu_torch.__path__,
                                               "tortoise_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k in ("jax", "tortoise_tpu")
             or k.startswith(("jax.", "jaxlib", "tortoise_tpu.")))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 15, names
assert {"tortoise_tpu_torch.ops.cuda.lvc",
        "tortoise_tpu_torch.ops.cuda.flash_attention",
        "tortoise_tpu_torch.serve",
        "tortoise_tpu_torch.pipeline.streaming",
        "tortoise_tpu_torch.config", "tortoise_tpu_torch.io.checkpoint",
        "tortoise_tpu_torch.text.tokenizer", "tortoise_tpu_torch.rng.reference",
        "tortoise_tpu_torch.native", "tortoise_tpu_torch.io.plane_cache",
        "tortoise_tpu_torch.convert", "tortoise_tpu_torch.parity",
        "tortoise_tpu_torch.utils.debug", "tortoise_tpu_torch.utils.profiling",
        "tortoise_tpu_torch.utils.progress"} <= set(names), names
"""

SERVING_PROBE = """
import sys
import tortoise_tpu_torch.serve, tortoise_tpu_torch.pipeline.streaming
bad = sorted(k for k in sys.modules
             if k in ("jax", "tortoise_tpu")
             or k.startswith(("jax.", "jaxlib", "tortoise_tpu.")))
assert not bad, bad
"""

# A meta-path finder that refuses the JAX package and JAX itself, as a
# machine without them would.
REFUSE = """
import importlib, importlib.abc, pkgutil, sys

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("tortoise_tpu", "jax", "jaxlib"):
            raise ImportError(f"refused: {name}")
        return None

sys.meta_path.insert(0, Refuse())
"""

# Under it every port module imports and the tiny synthesize() runs on
# the CPU.
REFUSING_PROBE = REFUSE + """
import numpy as np
import tortoise_tpu_torch
for m in pkgutil.walk_packages(tortoise_tpu_torch.__path__,
                               "tortoise_tpu_torch."):
    importlib.import_module(m.name)
from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels, synthesize
models = TortoiseModels.random(0, tiny=True)
res = synthesize(models, tokens=[1, 5, 9, 0], voice=np.zeros(64, np.float32),
                 seed=0, device="cpu")
assert res.audio.ndim == 1 and res.audio.size > 0
assert np.isfinite(res.audio).all()
print("ok", res.audio.shape)
"""


def test_port_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_serving_modules_import_without_jax():
    """The server and the streaming path, imported alone, pull in no JAX
    and no module of the JAX package."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", SERVING_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_port_runs_with_the_jax_package_refused():
    """With imports of tortoise_tpu and jax refused, every port module
    imports and the tiny synthesize() runs on the CPU."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", REFUSING_PROBE], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok"), proc.stdout


def test_chip_smoke_imports_without_jax_and_needs_a_card():
    """chip_smoke.py runs with imports of JAX and the JAX package refused
    and, without a card, exits nonzero before it runs or builds anything
    and prints no kernels line."""
    path = os.path.join(ROOT, "chip_smoke.py")
    run = REFUSE + (f"import runpy\nsys.argv = [{path!r}]\n"
                    f"sys.exit(runpy.run_path({path!r})['main']())\n")
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", run], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "needs a CUDA card" in proc.stderr, proc.stderr
    assert "refused" not in proc.stderr and "Traceback" not in proc.stderr
    assert '"kernels"' not in proc.stdout
    with open(path) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert "tortoise_tpu." not in src.replace("tortoise_tpu_torch", "")


CARD_SCRIPTS = ["torch_kernel_times.py", "torch_int8_variants.py",
                "torch_f32_body_variants.py"]


@pytest.mark.parametrize("script", CARD_SCRIPTS)
def test_card_scripts_import_without_jax_and_need_a_card(script):
    """The card-only scripts (the kernel timer and the two variant
    timers) run with imports of JAX and the JAX package refused and,
    without a card, exit nonzero before they build anything."""
    path = os.path.join(ROOT, "scripts", script)
    run = REFUSE + (f"import runpy\nsys.argv = [{path!r}]\n"
                    f"runpy.run_path({path!r}, run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-c", run], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "needs a CUDA card" in proc.stderr, proc.stderr
    assert "refused" not in proc.stderr and "Traceback" not in proc.stderr
    with open(path) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src
    assert "tortoise_tpu." not in src.replace("tortoise_tpu_torch", "")


UBENCH = sorted(f for f in os.listdir(os.path.join(ROOT, "scripts"))
                if f.startswith("torch_ubench_") and f.endswith(".py"))


def _imported_modules(path):
    """Every module an import statement of ``path`` names, at any depth
    (the scripts import most of what they use inside functions)."""
    import ast

    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("script", UBENCH)
def test_ubench_scripts_import_neither_jax_nor_the_jax_package(script):
    """No import in scripts/torch_ubench_*.py names jax, jaxlib or the
    JAX package, and each imports under a finder that refuses them."""
    path = os.path.join(ROOT, "scripts", script)
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "tortoise_tpu")]
    assert not bad, (script, bad)
    probe = REFUSE + (
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('m', %r)\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        % path)
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


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
