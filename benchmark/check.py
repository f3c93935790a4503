"""What decides ``correct``, for every family: a sample of the window's
finished requests drawn from the seed, each compared with the plain
reference by its family's ``numbers`` (``benchmark/families/<family>.py``),
the worst of each number over the sample held to the limit the cell's
mix names (``check.limits``).

A family's served object has ``text`` (the request's input ids) and
``greedy``, which ``sample`` reads; its numbers are floats, 0 where the
program and the reference agree."""

from __future__ import annotations

from typing import List

import numpy as np
import torch


def _rel(got, want) -> float:
    got = torch.as_tensor(np.asarray(got)).double()
    want = torch.as_tensor(np.asarray(want)).double().to(got.device)
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return float("inf")
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


def sample(served: list, seed: int, n: int) -> List[int]:
    """Indices of ``n`` of the window's finished requests drawn from
    ``seed``: the longest text, a greedy one where there is one, and the
    rest drawn."""
    rng = np.random.default_rng(int(seed) + 7)
    idx = list(range(len(served)))
    pick = [max(idx, key=lambda i: (len(served[i].text), -i))]
    greedy = [i for i in idx if served[i].greedy and i not in pick]
    if greedy and not served[pick[0]].greedy:
        pick.append(int(rng.choice(greedy)))
    rest = [i for i in idx if i not in pick]
    rng.shuffle(rest)
    return (pick + rest)[:min(n, len(idx))]


def worst(readings: List[dict]) -> dict:
    out: dict = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def verdict(nums: dict, limits: dict) -> bool:
    """Every number within its limit, every limit's number read, and no
    number without a limit."""
    return (set(nums) == set(limits)
            and all(limits[k] is not None and nums[k] <= limits[k]
                    for k in limits))
