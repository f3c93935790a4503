"""The generic part of a run, driven by ``BENCHMARK.json`` and the files
it names; nothing here knows a cell, a configuration or a metric.

A cell (``workloads[i]``) names its configuration (``configs[j].file``)
and its traffic mix, ``benchmark/traffic/<cell>.json``, which names its
entry driver, ``benchmark/drivers/<entry>.py``. Each metric is read by
``benchmark/metrics/<metric>.py``. A later cell, mix, entry or metric is
added as files and entries alone.

A driver module has four functions:

- ``setup(run) -> state``: build the entry on ``run.models`` and warm
  every shape the plan's requests will use;
- ``window(run, state, seconds)``: serve the plan for ``seconds`` and
  fill ``run.records`` (each request's times and result), ``run.opened``
  and ``run.closed``;
- ``served(run, record) -> check.Served``: what the check compares;
- ``close(state)``: stop what ``setup`` started.

A metric module has ``read(run) -> float | None``: None when the run
holds nothing for it to read, and the metric is then left out.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys
import time
from typing import Any, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
BANNED = ("jax", "jaxlib", "flax", "tortoise_tpu")


def load_spec(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config_of(spec: dict, cell_: dict, root: str = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == cell_["config"]:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise SystemExit(f"no configuration named {cell_['config']!r}")


def mix_of(cell_: dict, here: str = HERE) -> dict:
    with open(os.path.join(here, "traffic", cell_["name"] + ".json")) as f:
        return json.load(f)


def _module(kind: str, name: str, here: str = HERE):
    path = os.path.join(here, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(mix: dict, here: str = HERE):
    return _module("drivers", mix["entry"], here)


def metric(name: str, here: str = HERE):
    return _module("metrics", name, here)


def metrics_of(spec: dict, cell_name: str, key: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports: those
    that list it, and those that list no cells."""
    return [m for m in spec[key]
            if cell_name in m.get("workloads", [cell_name])]


def banned_modules() -> List[str]:
    """The top-level names in ``sys.modules`` that the port's runs must
    never load (compared whole)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(BANNED))


@dataclasses.dataclass
class Record:
    """One request of the window."""
    request: Any                  # traffic.Request
    due: Optional[float] = None   # host clock when it was due (open loop)
    start: float = 0.0            # host clock when it was sent
    end: Optional[float] = None   # host clock when its result was in hand
    result: Any = None            # the entry's result, None if it failed
    error: Optional[str] = None
    batch: Optional[dict] = None  # the server batch it ran in

    @property
    def ok(self) -> bool:
        return self.result is not None and self.error is None


@dataclasses.dataclass
class Run:
    """A run's state, handed to the driver and to every metric reader."""
    cell: dict
    config: dict
    mix: dict
    seed: int
    device: Any
    plan: Any = None
    models: Any = None
    compute_dtype: Any = None
    int8: bool = False
    records: List[Record] = dataclasses.field(default_factory=list)
    opened: float = 0.0
    closed: float = 0.0
    setup_s: float = 0.0
    trace: Any = None             # trace.Trace of a traced run
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def done(self) -> List[Record]:
        return [r for r in self.records if r.ok]

    @property
    def traced_done(self) -> List[Record]:
        """The finished requests inside the traced part of the window."""
        n = self.extra.get("traced", len(self.records))
        return [r for r in self.records[:n] if r.ok]


def request_done(run: Run) -> None:
    """Drivers call this after each request they record: a traced run
    whose mix names ``trace.requests`` stops tracing once that many have
    finished (the profiler's own processing grows with the kernels it
    saw, and must fit the run's time)."""
    stop = run.extra.get("stop_trace")
    n = run.mix.get("trace", {}).get("requests")
    if stop and n and len(run.records) >= n:
        stop()


def port_configs(config: dict, device):
    """The port's config dataclasses for ``config`` on ``device``: the
    published sizes, and ``use_flash`` by the CLI's rule."""
    from tortoise_tpu_torch.cli import flash_on
    from tortoise_tpu_torch.config import (
        ARConfig,
        DiffusionConfig,
        VocoderConfig,
    )

    def fields(d):
        return {k: tuple(v) if isinstance(v, list) else v
                for k, v in d.items()}

    plane = config["plane"]
    return (ARConfig(**fields(config["ar"])),
            DiffusionConfig(**fields(config["diffusion"]),
                            use_flash=plane["use_flash"]
                            and flash_on(device)),
            VocoderConfig(**fields(config["vocoder"])))


def build(run: Run) -> None:
    """The plan, the weights on the device and the port's models."""
    import torch

    from benchmark import traffic, weights
    from tortoise_tpu_torch.pipeline.synthesize import TortoiseModels

    plane = run.config["plane"]
    if plane["tf32"] is not None and run.device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = plane["tf32"]
        torch.backends.cudnn.allow_tf32 = plane["tf32"]
    run.compute_dtype = (getattr(torch, plane["compute_dtype"])
                         if plane["compute_dtype"] else None)
    run.int8 = plane["int8_weights"]
    run.plan = traffic.make_plan(run.mix, run.seed,
                                 run.config["ar"]["d_model"])
    w = weights.make(run.config, run.seed, run.device)
    ar, diff, voc = port_configs(run.config, run.device)
    run.models = TortoiseModels(ar_params=w["ar"],
                                diffusion_params=w["diffusion"],
                                vocoder_params=w["vocoder"], ar_cfg=ar,
                                diffusion_cfg=diff, vocoder_cfg=voc)


# the plan's requests that a window can reach, at most
REACH = 64


def free(run: Run) -> None:
    """Drop the program's state: its models, casts and step graphs."""
    import gc

    import torch

    from tortoise_tpu_torch.pipeline.common import clear_cast_cache

    run.models = None
    clear_cast_cache()
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()


def now() -> float:
    return time.monotonic()


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
