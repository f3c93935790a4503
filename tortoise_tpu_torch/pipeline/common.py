"""Small helpers shared by the stage drivers."""

from __future__ import annotations

import threading

import torch


def round_up(n: int, m: int) -> int:
    """Round n up to a multiple of the bucket size m."""
    return ((n + m - 1) // m) * m


def resolve_device(device=None) -> torch.device:
    """The device a run asked for; None picks the first CUDA card when
    there is one, else the CPU. A CUDA request without a card raises —
    nothing falls back to the CPU quietly."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA card is "
                           "available")
    return device


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU): stage walls
    are taken at these points."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_generator(seed: int, device) -> torch.Generator:
    """The random stream of one stage (AR uniforms, diffusion or vocoder
    noise), seeded by ``seed`` on ``device``. Stages create their
    generators only through this function and draw only through their
    module's ``draw_*`` function, so a test can replay another package's
    key chain through both."""
    return torch.Generator(device=device).manual_seed(int(seed))


_cast_cache: dict = {}
_cast_lock = threading.Lock()
_CAST_CACHE_MAX = 8  # distinct (tree, device, plane) entries


def clear_cast_cache() -> None:
    """Drop every memoized cast tree (their device memory is freed once no
    other reference remains)."""
    with _cast_lock:
        _cast_cache.clear()


def _device_key(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def cached_cast(params, key, fn, device):
    """``fn(params)`` memoized per (id(params), device, key): a stage's
    weight cast (upload, bf16 cast, int8 quantization) runs once per
    model tree and plane instead of on every call. The entry holds the
    source tree, so its id cannot be recycled while the entry is alive.
    A bounded FIFO: past ``_CAST_CACHE_MAX`` entries the oldest goes, so
    a process that reloads models does not pin every superseded tree and
    its device copy. The lock makes the lookup and the insert one step
    for the server's worker and stream threads (a cast runs under it, so
    two threads never build the same tree twice)."""
    full_key = (id(params), _device_key(device), key)
    with _cast_lock:
        ent = _cast_cache.get(full_key)
        if ent is not None and ent[0] is params:
            return ent[1]
        out = fn(params)
        _cast_cache[full_key] = (params, out)
        while len(_cast_cache) > _CAST_CACHE_MAX:
            _cast_cache.pop(next(iter(_cast_cache)))  # dicts keep order
        return out
