"""Device-mesh runtime (counterpart of ``kornia_tpu/parallel/mesh.py``).

The JAX package's mesh is a grid of devices inside one program, and
``shard_map`` runs a body on each with ``psum`` between them. Here the grid
is of SPMD ranks, one process each, joined by a ``torch.distributed``
process group (``spmd.spawn`` starts them on one host): every rank runs
the same function on its own block and calls the mesh's collectives where
the reference ``psum``s.

Axes convention, as in the reference:
  * ``data``  — batch / frame / pair data parallelism, the map blocks of
                distributed BA, the token blocks of context parallelism;
  * ``model`` — model or map-block parallelism.

A mesh made with no process group is one rank, and its collectives are
identities, like the reference's 1x1 mesh on one chip. Every collective
counts its calls and bytes (``Mesh.counts``); with ``Mesh.timed`` set it
also synchronises the device before and after each call and adds the
seconds between to ``counts["seconds"]``.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

__all__ = ["P", "Mesh", "NamedSharding", "make_mesh", "data_sharding",
           "replicated", "shard_batch", "local_mesh", "use_mesh"]

Device = Union[str, torch.device]

_ACTIVE_MESH: Optional["Mesh"] = None


class P(tuple):
    """A partition spec: one mesh axis name (or None) per array
    dimension, as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *spec):
        return super().__new__(cls, spec)


class Mesh:
    """A grid of SPMD ranks with one process group per axis.

    shape: ordered axis name → size (``mesh.shape["data"]``); the ranks
    fill the grid in row-major order. device: this rank's device. groups:
    axis → the process group of this rank's slice along the axis (None
    for the whole world); no entry at all when there is no process group.
    """

    def __init__(self, shape: "OrderedDict[str, int]", device: torch.device,
                 groups: Optional[Dict[str, object]] = None,
                 coords: Optional[Dict[str, int]] = None):
        self.shape = OrderedDict(shape)
        self.axis_names: Tuple[str, ...] = tuple(self.shape)
        self.device = torch.device(device)
        self._groups = groups
        self._coords = coords or {a: 0 for a in self.axis_names}
        self.timed = False
        self.counts = {"all_reduce": 0, "all_reduce_bytes": 0,
                       "all_gather": 0, "all_gather_bytes": 0,
                       "seconds": 0.0}

    def group(self, axis: str):
        """The process group of this rank's slice along `axis` (None: the
        default, whole-world group)."""
        if self._groups is None:
            raise RuntimeError("this mesh has no process group")
        return self._groups[axis]

    def rank(self, axis: str) -> int:
        """This rank's coordinate along `axis`."""
        return self._coords[axis]

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0.0 if k == "seconds" else 0

    def _run(self, kind: str, nbytes: int, op) -> None:
        self.counts[kind] += 1
        self.counts[f"{kind}_bytes"] += nbytes
        if not self.timed:
            op()
            return
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        sync()
        t0 = time.perf_counter()
        op()
        sync()
        self.counts["seconds"] += time.perf_counter() - t0

    def all_reduce(self, x: torch.Tensor, axis: str = "data") -> torch.Tensor:
        """Sum of `x` over the ranks of `axis` (the reference's ``psum``),
        written into `x` and returned."""
        if self._groups is None:
            return x
        self._run("all_reduce", x.numel() * x.element_size(),
                  lambda: dist.all_reduce(x, group=self.group(axis)))
        return x

    def all_gather(self, x: torch.Tensor, axis: str = "data",
                   dim: int = 0) -> torch.Tensor:
        """The blocks of every rank along `axis`, concatenated on `dim` in
        rank order."""
        if self._groups is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        self._run("all_gather", x.numel() * x.element_size(),
                  lambda: dist.all_gather(parts, x, group=self.group(axis)))
        return torch.cat(parts, dim)

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, device={self.device}, "
                f"rank={self._coords})")


def _default_device() -> torch.device:
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda")


def make_mesh(
    shape: Optional[Tuple[int, ...]] = None,
    axis_names: Sequence[str] = ("data", "model"),
    devices: Optional[Sequence[Device]] = None,
) -> Mesh:
    """The mesh of the initialised process group (or of one rank, without
    one).

    Default: every rank on the ``data`` axis, ``model`` = 1. `devices`, one
    per rank in rank order, names each rank's device (ranks may share a
    card under gloo); by default this rank's current CUDA device. With a
    process group every rank must call this, in the same order: it makes
    the groups of each axis collectively.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not name its axes "
                         f"{tuple(axis_names)}")
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"mesh shape {shape} holds {n} ranks; the process "
                         f"group has {world}")
    if devices is not None and len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    device = (torch.device(devices[rank]) if devices is not None
              else _default_device())
    named = OrderedDict(zip(axis_names, shape))
    coords, rem = {}, rank
    for a, s in reversed(named.items()):
        coords[a] = rem % s
        rem //= s
    coords = {a: coords[a] for a in axis_names}
    if not dist.is_initialized():
        return Mesh(named, device, None, coords)
    groups = {}
    for i, a in enumerate(axis_names):
        if shape[i] == world:
            groups[a] = None
            continue
        # every slice along axis a, in one order on every rank
        stride = 1
        for s in shape[i + 1:]:
            stride *= s
        for base in range(world):
            if (base // stride) % shape[i]:
                continue  # not the first rank of its slice
            ranks = [base + k * stride for k in range(shape[i])]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[a] = g
    return Mesh(named, device, groups, coords)


def local_mesh() -> Mesh:
    """The process-wide default mesh (lazily built)."""
    global _ACTIVE_MESH
    if _ACTIVE_MESH is None:
        _ACTIVE_MESH = make_mesh()
    return _ACTIVE_MESH


@contextmanager
def use_mesh(mesh: Mesh):
    global _ACTIVE_MESH
    prev = _ACTIVE_MESH
    _ACTIVE_MESH = mesh
    try:
        yield mesh
    finally:
        _ACTIVE_MESH = prev


class NamedSharding:
    """How a global array lies on a mesh: dimension d is split over the
    mesh axis ``spec[d]`` (replicated where None or absent)."""

    def __init__(self, mesh: Mesh, spec: P):
        self.mesh = mesh
        self.spec = P(*spec)

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global `x`, on the mesh's device."""
        for d, axis in enumerate(self.spec):
            if axis is None:
                continue
            n = self.mesh.shape[axis]
            if x.shape[d] % n:
                raise ValueError(f"dimension {d} of length {x.shape[d]} "
                                 f"does not split over {n} ranks of "
                                 f"{axis!r}")
            b = x.shape[d] // n
            x = x.narrow(d, self.mesh.rank(axis) * b, b)
        return x.to(self.mesh.device)


def data_sharding(mesh: Mesh, ndim: int, axis: int = 0) -> NamedSharding:
    """Shard dim `axis` over the mesh's `data` axis, replicate the rest."""
    spec = [None] * ndim
    spec[axis] = "data"
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(x: torch.Tensor, mesh: Optional[Mesh] = None,
                axis: int = 0) -> torch.Tensor:
    """This rank's block of the batched `x` along `axis`, split over
    ``data`` (the reference returns the global array placed sharded)."""
    mesh = mesh or local_mesh()
    return data_sharding(mesh, x.dim(), axis).local(x)
