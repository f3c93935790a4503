"""Device mesh and the collectives over its axes (counterpart of
``tortoise_tpu/parallel/mesh.py``).

JAX runs one controller over many devices; PyTorch runs one process a
rank. So the port's mesh is a ``torch.distributed.device_mesh.DeviceMesh``
with dims ``("dp", "tp")`` over a process group that is already
initialized (by ``torchrun`` through ``init_from_env``, or by the caller).
Every rank receives the same host inputs and keeps its own slice: its
rows on ``dp``, its heads or channels on ``tp``. Collectives are explicit
(``AxisGroup``): an all-reduce after each row-parallel product, an
all-gather of split outputs, a MIN-reduction of the AR stop flags.
Placements are plain local tensors, not DTensors: the kernels, the int8
pairs and the group norm have no DTensor rules.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _factor(n: int) -> Tuple[int, int]:
    """Split n into (dp, tp) with tp the largest power of two <= sqrt(n)
    dividing n."""
    best = 1
    t = 1
    while t * t <= n:
        if n % t == 0:
            best = t
        t *= 2
    return n // best, best


def init_from_env(backend: Optional[str] = None,
                  device_type: Optional[str] = None) -> bool:
    """``init_process_group`` from the ``env://`` variables that
    ``torchrun`` sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), when
    no group exists yet. ``backend=None`` is NCCL on ``cuda`` (the
    default device type) and gloo on ``cpu``. Returns True when it
    initialized the group."""
    if dist.is_initialized():
        return False
    device_type = device_type or "cuda"
    dist.init_process_group(
        backend or ("nccl" if device_type == "cuda" else "gloo"),
        init_method="env://")
    return True


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp", "tp"),
              shape: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None,
              backend: Optional[str] = None):
    """A DeviceMesh over the ranks of the initialized process group. With
    shape=None, factorize ``n_devices`` (default: the world size) into
    (dp, tp). ``device_type=None`` means ``cuda`` and raises without a
    card; each rank then takes ``cuda:{LOCAL_RANK % device_count}``.
    ``backend`` names the backend the group must run (NCCL on ``cuda``,
    gloo on ``cpu`` by default; gloo on the card when named): a group
    that runs another one raises, nothing is switched."""
    device_type = device_type or "cuda"
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: device_type 'cuda' but no CUDA card "
                           "is available; pass device_type=\"cpu\" (gloo)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; initialize one "
                           "first (torchrun + init_from_env(), or "
                           "torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if world < n_devices:
        raise ValueError(
            f"make_mesh: need {n_devices} devices but only {world} ranks "
            f"are in the process group (backend {dist.get_backend()}). "
            f"Start {n_devices} ranks, e.g. torchrun --nproc-per-node "
            f"{n_devices}.")
    if n_devices != world:
        raise ValueError(
            f"make_mesh: the mesh spans every rank of the group; "
            f"{n_devices} of {world} ranks asked")
    if shape is None:
        shape = _factor(n_devices)
    shape = tuple(int(s) for s in shape)
    if int(torch.tensor(shape).prod()) != n_devices:
        raise ValueError(
            f"make_mesh: shape {shape} does not cover {n_devices} devices")
    want = backend or ("nccl" if device_type == "cuda" else "gloo")
    if dist.get_backend() != want:
        raise ValueError(f"make_mesh: the process group runs "
                         f"{dist.get_backend()}, {want} was asked for")
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type,
                      torch.arange(n_devices).reshape(shape),
                      mesh_dim_names=tuple(axis_names[:len(shape)]))


def axis_size(mesh, name: str) -> int:
    """Size of the mesh axis ``name`` (1 when the mesh has no such axis
    or there is no mesh)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_group(mesh, name: str) -> Optional["AxisGroup"]:
    """This rank's AxisGroup on the mesh axis ``name``; None when the axis
    has one rank (nothing to split or reduce)."""
    if axis_size(mesh, name) == 1:
        return None
    return AxisGroup(name, axis_size(mesh, name),
                     mesh.get_local_rank(name), mesh.get_group(name))


def local_count(n: int, tp: Optional["AxisGroup"], what: str) -> int:
    """This rank's share of n heads or groups under tp (all n without)."""
    if tp is None:
        return n
    if n % tp.size:
        raise ValueError(f"tp = {tp.size} does not divide {n} {what}")
    return n // tp.size


@dataclasses.dataclass(frozen=True)
class AxisGroup:
    """This rank's place on one mesh axis and the collectives over it.
    Tensors go in and come out on the caller's device. The gloo backend
    carries CUDA tensors through host memory only for some collectives,
    so under gloo every CUDA tensor is staged through the host here."""

    name: str
    size: int
    rank: int
    group: object  # torch.distributed.ProcessGroup

    def split(self, n: int) -> Tuple[int, int]:
        """[lo, hi) of this rank's part of n (``torch.tensor_split``'s
        parts: the first n % size parts one longer)."""
        sizes = self.sizes(n)
        lo = sum(sizes[:self.rank])
        return lo, lo + sizes[self.rank]

    def sizes(self, n: int) -> List[int]:
        q, r = divmod(n, self.size)
        return [q + (i < r) for i in range(self.size)]

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda and dist.get_backend(self.group) == "gloo":
            return x.cpu()
        return x.contiguous().clone()

    def all_reduce(self, x: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        """The reduction of x over the axis (a new tensor)."""
        y = self._staged(x)
        dist.all_reduce(y, op=op, group=self.group)
        return y.to(x.device)

    def all_gather(self, x: torch.Tensor, dim: int = 0,
                   sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
        """The ranks' x concatenated along ``dim`` in rank order. With
        ``sizes`` (each rank's extent on ``dim``) the parts may be
        uneven: they travel padded to the longest."""
        dim = dim % x.dim()
        sizes = list(sizes) if sizes is not None \
            else [x.shape[dim]] * self.size
        if sizes[self.rank] != x.shape[dim]:
            raise ValueError(f"all_gather: rank {self.rank} holds "
                             f"{x.shape[dim]} on dim {dim}, sizes {sizes}")
        width = max(sizes)
        y = self._staged(x)
        if y.shape[dim] < width:
            pad = list(y.shape)
            pad[dim] = width - y.shape[dim]
            y = torch.cat([y, y.new_zeros(pad)], dim=dim)
        parts = [torch.empty_like(y) for _ in range(self.size)]
        dist.all_gather(parts, y, group=self.group)
        out = torch.cat([p.narrow(dim, 0, n) for p, n in zip(parts, sizes)],
                        dim=dim)
        return out.to(x.device)
