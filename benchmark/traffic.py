"""The one traffic generator: a cell's mix file -> its seeded request plan.

A mix file (``benchmark/traffic/<traffic>.json``, the cell's ``traffic``)
holds only parameters:

- ``entry``: the driver that serves the plan (``benchmark/drivers/``);
- ``text``: ``min_len`` and ``max_len`` of the wrapped text (``[start] +
  ids + [end]``, ids uniform in ``[id_low, id_high)``), and ``sizes``:
  the lengths are the ``sizes`` evenly spaced quantiles of the uniform
  draw between the two, each block of ``sizes`` requests holding every
  one of them once, in an order drawn from the seed;
- ``voices``: ``count`` N(0, ``std``) latents of the family's voice
  width, one drawn per request;
- ``greedy_every``: every n-th request (from the second; all of them at
  1) asks for the
  greedy sampler (``top_k`` 1); the rest keep the sampler's defaults;
- ``arrivals`` (open loop only): ``rate`` per second, Poisson, as the
  ``sizes`` evenly spaced quantiles of the exponential gap, each block
  holding every gap once in a seeded order;
- ``bursts`` (open loop only): a burst every ``every_s`` seconds, all
  its requests due at once, of the ``sizes`` in blocks, each block
  holding every size once in a seeded order;
- ``plan``: how many requests to draw (more than a window can take).

So every seed gives the same set of sizes, arrivals and sampler
settings, in another order, and the same seed gives the same plan.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class Request:
    index: int
    tokens: List[int]
    voice: int               # index into the plan's voices
    seed: int                # the request's own synthesis seed
    greedy: bool
    due: Optional[float]     # seconds after the window opens (open loop)

    @property
    def sampler(self) -> Optional[dict]:
        return {"top_k": 1} if self.greedy else None


@dataclasses.dataclass
class Plan:
    requests: List[Request]
    voices: np.ndarray       # (count, width) float32
    mix: dict


def load_mix(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _blocks(rng, values, n):
    """n values: blocks of every one of ``values`` once, each block in a
    seeded order."""
    out = []
    while len(out) < n:
        out.extend(np.asarray(values)[rng.permutation(len(values))].tolist())
    return out[:n]


def lengths(mix: dict) -> list:
    """The ``sizes`` text lengths of the mix: evenly spaced quantiles of
    the uniform length distribution, rounded."""
    t = mix["text"]
    k = t["sizes"]
    span = t["max_len"] - t["min_len"]
    return [int(round(t["min_len"] + (i + 0.5) / k * span)) for i in range(k)]


def gaps(mix: dict) -> list:
    """The ``sizes`` Poisson gaps of the mix: evenly spaced quantiles of
    the exponential distribution at ``rate``."""
    a = mix["arrivals"]
    k = a["sizes"]
    return [-math.log(1.0 - (i + 0.5) / k) / a["rate"] for i in range(k)]


def make_plan(mix: dict, seed: int, width: int) -> Plan:
    """The cell's requests from ``seed``, with voices ``width`` wide
    (module docstring)."""
    rng = np.random.default_rng(int(seed))
    t, v = mix["text"], mix["voices"]
    n = mix["plan"]
    voices = rng.normal(0.0, v["std"], (v["count"], width)).astype(
        np.float32)
    sizes = _blocks(rng, lengths(mix), n)
    due = None
    if "arrivals" in mix:
        due = np.cumsum([0.0] + _blocks(rng, gaps(mix), n - 1)).tolist()
    elif "bursts" in mix:
        b = mix["bursts"]
        due = []
        for k, size in enumerate(_blocks(rng, b["sizes"], n)):
            due += [k * b["every_s"]] * size
        due = due[:n]
    every = mix.get("greedy_every")
    start, end = t["wrap"]
    reqs = []
    for i in range(n):
        ids = rng.integers(t["id_low"], t["id_high"], size=sizes[i] - 2)
        reqs.append(Request(
            index=i, tokens=[start] + ids.tolist() + [end],
            voice=int(rng.integers(0, v["count"])),
            seed=int(rng.integers(0, 2 ** 31)),
            greedy=bool(every) and i % every == 1 % every,
            due=None if due is None else due[i]))
    return Plan(reqs, voices, mix)
