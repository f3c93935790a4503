"""Every public function that the JAX package and the port both have in
``pipeline/*``, ``models/*`` and ``serve.py``, and every public method of
``TortoiseModels``, takes the JAX function's parameters in the JAX
order, with the port's own parameters (``device``, ``tp``, ``progress``,
...) after all of JAX's: so a positional JAX call binds the same
parameters in the port. One case per function.

Exceptions, by name, with their reason (each is held to its stated
difference, so the list cannot go stale):

- ``models.ar.transformer``: the port's trunk takes the (B, S)
  ``seq_valid`` row third, where the JAX trunk takes the additive (B, 1,
  S, S) ``bias`` (it builds the causal bias itself), and returns per-layer
  k and v lists in the packed layout; it is an internal of ``prefill``
  and ``latent_forward``.
- ``models.ar.flash_prefill_on``: the port derives JAX's ``have_valid``
  itself (its trunk always has the validity row) and takes this rank's
  head count instead; it takes ``qkv_f16`` in JAX's place.
"""

import importlib
import inspect

import pytest

MODULES = ("pipeline.ar_stage", "pipeline.common", "pipeline.diffusion_stage",
           "pipeline.schedule", "pipeline.streaming", "pipeline.synthesize",
           "pipeline.vocoder_stage", "models.ar", "models.diffusion",
           "models.vocoder", "serve")
EXCEPTIONS = ("models.ar.transformer", "models.ar.flash_prefill_on")


CLASSES = ("pipeline.synthesize.TortoiseModels",)


def _resolve(pkg, name):
    """``pkg.name``: a module's function or a class's method."""
    parts = name.split(".")
    for i in range(len(parts) - 1, 0, -1):
        try:
            obj = importlib.import_module(".".join([pkg, *parts[:i]]))
        except ImportError:
            continue
        for part in parts[i:]:
            obj = getattr(obj, part)
        return obj
    raise ImportError(name)


def _pair(name):
    return _resolve("tortoise_tpu", name), _resolve("tortoise_tpu_torch", name)


def _shared():
    names = []
    for mod in MODULES:
        jax_mod = importlib.import_module(f"tortoise_tpu.{mod}")
        port_mod = importlib.import_module(f"tortoise_tpu_torch.{mod}")
        for name, fn in sorted(vars(jax_mod).items()):
            if (not name.startswith("_") and inspect.isfunction(fn)
                    and fn.__module__ == jax_mod.__name__
                    and inspect.isfunction(getattr(port_mod, name, None))):
                names.append(f"{mod}.{name}")
    for cls in CLASSES:
        jax_cls, port_cls = _pair(cls)
        for name, member in sorted(vars(jax_cls).items()):
            method = inspect.isfunction(member) or isinstance(
                member, (classmethod, staticmethod))
            if method and not name.startswith("_") and \
                    name in vars(port_cls):
                names.append(f"{cls}.{name}")
    return names


SHARED = _shared()
CHECKED = [n for n in SHARED if n not in EXCEPTIONS]


def _params(fn):
    return list(inspect.signature(fn).parameters)


def test_the_shared_functions_are_found():
    assert len(SHARED) >= 40, SHARED
    assert set(EXCEPTIONS) <= set(SHARED)
    for name in ("pipeline.ar_stage.autoregressive_batch",
                 "pipeline.ar_stage.autoregressive",
                 "pipeline.diffusion_stage.diffusion_batch",
                 "pipeline.diffusion_stage.diffusion_batch_device",
                 "pipeline.diffusion_stage.diffusion",
                 "pipeline.vocoder_stage.vocoder_batch",
                 "pipeline.vocoder_stage.vocoder",
                 "pipeline.synthesize.synthesize_batch",
                 "pipeline.synthesize.TortoiseModels.to_device",
                 "pipeline.synthesize.TortoiseModels.random",
                 "pipeline.synthesize.TortoiseModels.from_ggml_dir"):
        assert name in CHECKED


@pytest.mark.parametrize("name", CHECKED)
def test_port_takes_the_jax_parameters_in_the_jax_order(name):
    jax_fn, port_fn = _pair(name)
    jp, pp = _params(jax_fn), _params(port_fn)
    assert [p for p in jp if p not in pp] == [], "missing in the port"
    assert pp[:len(jp)] == jp, "the port's own parameters come last"
    # so every positional JAX call binds the same names in the port
    kinds = (inspect.Parameter.POSITIONAL_ONLY,
             inspect.Parameter.POSITIONAL_OR_KEYWORD)
    jsig, psig = inspect.signature(jax_fn), inspect.signature(port_fn)
    n = sum(p.kind in kinds for p in jsig.parameters.values())
    args = [object() for _ in range(n)]
    assert dict(jsig.bind_partial(*args).arguments) == \
        dict(psig.bind_partial(*args).arguments)


@pytest.mark.parametrize("name", EXCEPTIONS)
def test_exceptions_differ_only_as_stated(name):
    jax_fn, port_fn = _pair(name)
    jp, pp = _params(jax_fn), _params(port_fn)
    if name == "models.ar.transformer":
        assert jp[:7] == ["params", "x", "bias", "cfg", "compute_dtype",
                          "qkv_f16", "seq_valid"]
        assert pp == ["params", "x", "seq_valid", "cfg", "compute_dtype",
                      "qkv_f16", "tp"]
    else:
        assert jp == ["cfg", "compute_dtype", "qkv_f16", "shape",
                      "have_valid"]
        assert pp == ["cfg", "compute_dtype", "qkv_f16", "shape", "n_head"]
