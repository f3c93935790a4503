"""The generic part of a run, driven by ``BENCHMARK.json`` and the files
it names; nothing here knows a cell, a configuration, a model family or
a metric.

A cell (``workloads[i]``) names its configuration (``configs[j].file``)
and its traffic mix, ``benchmark/traffic/<traffic>.json``, which names
its entry driver, ``benchmark/drivers/<entry>.py``. The configuration
names its model family, ``benchmark/families/<family>.py``. Each metric
is read by ``benchmark/metrics/<metric>.py``. A later cell, mix, entry,
family or metric is added as files and entries alone.

A family module has six functions:

- ``build(run)``: the plan (``traffic.make_plan`` at the family's voice
  width), the weights drawn from ``run.seed`` and the program's models:
  it sets ``run.plan``, ``run.models`` and whatever else of ``Run`` its
  drivers read;
- ``free(run)``: drop the program's state before the reference runs;
- ``reference(config, seed, device, control=False)``: the plain
  reference, which draws its weights again from the seed; with
  ``control`` one precision step below the configuration's;
- ``numbers(ref, served, names)``: the check's numbers ``names`` of one
  served request (``check.worst`` takes the worst over the sample);
- ``control_numbers(ref, ctrl, served, names)``: the same numbers of the
  control ``ctrl`` in the program's place on the same request;
- ``request_row(record)``: the family's fields of a request's row in the
  result line (after its index, text length and greedy).

A family's served object has ``text`` and ``greedy`` (``check.sample``
reads them); an entry's result has ``audio`` (the samples) and
``sample_rate`` (``rtf`` reads them).

A driver module has four functions:

- ``setup(run) -> state``: build the entry on ``run.models`` and warm
  every shape the plan's requests will use;
- ``window(run, state, seconds)``: serve the plan for ``seconds`` and
  fill ``run.records`` (each request's times and result), ``run.opened``
  and ``run.closed``;
- ``served(run, record)``: the family's served object, which the check
  compares;
- ``close(state)``: stop what ``setup`` started.

A metric module has ``read(run) -> float | None``: None when the run
holds nothing for it to read, and the metric is then left out.

Modules are found under the benchmark's directory ``here``, ``HERE``
unless a caller (a test running a copy) names another.
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


def mix_of(cell_: dict, here: Optional[str] = None) -> dict:
    with open(os.path.join(here or HERE, "traffic",
                           cell_["traffic"] + ".json")) as f:
        return json.load(f)


def _module(kind: str, name: str, here: Optional[str] = None):
    path = os.path.join(here or HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    # registered before it runs, as an import would: a dataclass in it
    # looks its module up there
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def driver(mix: dict, here: Optional[str] = None):
    return _module("drivers", mix["entry"], here)


def family(config: dict, here: Optional[str] = None):
    return _module("families", config["family"], here)


def metric(name: str, here: Optional[str] = None):
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
    """A run's state, handed to the driver and to every metric reader.
    The family's ``build`` sets ``plan``, ``models`` and, for Tortoise's
    drivers, ``compute_dtype`` and ``int8``."""
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


# the plan's requests that a window can reach, at most
REACH = 64


def now() -> float:
    return time.monotonic()


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
