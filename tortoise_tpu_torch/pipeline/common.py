"""Small helpers shared by the stage drivers."""

from __future__ import annotations

import contextlib
import threading
import warnings

import numpy as np
import torch

from tortoise_tpu_torch.pipeline import graphs
from tortoise_tpu_torch.utils.profiling import span


def round_up(n: int, m: int) -> int:
    """Round n up to a multiple of the bucket size m."""
    return ((n + m - 1) // m) * m


def resolve_device(device=None) -> torch.device:
    """The device a run asked for; None means the card (``cuda``). A CUDA
    device without a card raises: nothing falls back to the CPU, which a
    caller asks for by name (``device="cpu"``)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA card is "
                           "available; pass device=\"cpu\" to run on the CPU")
    return device


def sync(device) -> None:
    """Wait for the device's queued work (a no-op on the CPU): stage walls
    are taken at these points."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def substage(name: str, timings, key: str, device):
    """The span ``name`` on ``device``, yielded; with ``timings`` (a
    stage's ``substage_timings``) the device is waited for at its end and
    its host wall goes to ``timings[key]``."""
    with span(name, device) as sp:
        yield sp
        if timings is not None:
            sync(device)
    if timings is not None:
        timings[key] = sp.s


def download(*tensors: torch.Tensor) -> list:
    """The tensors as float32 host arrays, in one ``download`` span."""
    with span("download", tensors[0].device):
        return [t.float().cpu().numpy() for t in tensors]


def _on_device(tree, device: torch.device) -> bool:
    """Whether every array leaf of ``tree`` is a tensor on ``device``."""
    if isinstance(tree, dict):
        return all(_on_device(v, device) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_on_device(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.device == device
    return not isinstance(tree, np.ndarray)


def ensure_device(tree, device=None):
    """``tree`` with every numpy leaf a tensor on ``device`` (default the
    card). A tree already wholly there is returned as it is, the same
    object, so the casts memoized on it (``cached_cast``, keyed on its
    id) stay valid."""
    from tortoise_tpu_torch.params import tree_to_torch

    device = _device_key(resolve_device(device))
    if _on_device(tree, device):
        return tree
    return tree_to_torch(tree, device)


def mesh_size(mesh) -> int:
    """Ranks of a mesh (0 when mesh is None)."""
    return 0 if mesh is None else mesh.size()


def pure_dp(mesh, b: int) -> bool:
    """The JAX package's admission rule for its per-device kernel planes:
    every rank on the dp axis and b rows splitting evenly over it. Here
    it admits the AR dp plane (kernel A on each rank's rows)."""
    from tortoise_tpu_torch.parallel.mesh import axis_size

    n, dp = mesh_size(mesh), axis_size(mesh, "dp")
    return n > 1 and n == dp and b % dp == 0


def dp_rows(mesh, b: int, who: str = "place_batch") -> slice:
    """This rank's rows of a b-row batch: its part of the split over the
    mesh's "dp" axis, or every row (with the JAX package's warning) when
    b does not divide the dp size, or when there is no dp axis."""
    from tortoise_tpu_torch.parallel.mesh import axis_group

    dp = axis_group(mesh, "dp")
    if dp is None:
        return slice(0, b)
    if b % dp.size:
        warnings.warn(
            f"{who}: batch size {b} does not divide the dp axis "
            f"({dp.size}); falling back to REPLICATED placement — no data "
            "parallelism for this array. Use a batch that is a multiple of "
            "the dp size.", stacklevel=3)
        return slice(0, b)
    return slice(*dp.split(b))


def draw_rows(draw, generator, shape, device, rows: slice) -> torch.Tensor:
    """Rows ``rows`` of one GLOBAL draw ``draw(generator, shape, device)``
    (shape[0] the whole batch): every rank seeds the same stream and
    draws the whole tensor, so each row gets the numbers it gets in the
    single-device run. A rank drawing only its own rows would take the
    first rows' numbers."""
    return draw(generator, shape, device)[rows]


def shard_cast(params, key, full, specs, mesh, device):
    """``full`` (a stage's device tree cast from the host tree ``params``
    under cache key ``key``) sliced for this rank's place on the mesh's
    "tp" axis by the placement tree ``specs(mesh)``, memoized like the
    casts, per mesh shape and rank. Without a tp axis, ``full``."""
    from tortoise_tpu_torch.parallel.mesh import axis_size
    from tortoise_tpu_torch.parallel.sharding import shard_tree

    if axis_size(mesh, "tp") == 1:
        return full
    # a tree sliced for one (mesh shape, rank) is another tree on another
    where = (tuple(mesh.mesh.shape), mesh.mesh_dim_names, mesh.get_rank())
    return cached_cast(params, (key, "tp") + where,
                       lambda _: shard_tree(full, specs(mesh), mesh), device)


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
    """Drop every memoized cast tree and the step graphs that read them
    (their device memory is freed once no other reference remains)."""
    with _cast_lock:
        _cast_cache.clear()
    graphs.clear()


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
    its device copy; the step graphs that read an evicted tree go with
    it (``graphs.drop_tree``). The lock makes the lookup and the insert
    one step for the server's worker and stream threads (a cast runs
    under it, so two threads never build the same tree twice)."""
    full_key = (id(params), _device_key(device), key)
    with _cast_lock:
        ent = _cast_cache.get(full_key)
        if ent is not None and ent[0] is params:
            return ent[1]
        out = fn(params)
        _cast_cache[full_key] = (params, out)
        while len(_cast_cache) > _CAST_CACHE_MAX:
            # dicts keep order
            graphs.drop_tree(_cast_cache.pop(next(iter(_cast_cache)))[1])
        return out
