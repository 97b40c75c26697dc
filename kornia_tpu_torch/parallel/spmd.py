"""SPMD ranks on one host: the port's counterpart of JAX's virtual devices.

``spawn(fn, world_size, backend, device, *args)`` starts `world_size`
processes (the ``spawn`` start method: each imports afresh, so `fn` must be
a module-level function of an importable module), joins them in one
``torch.distributed`` process group, and calls ``fn(mesh, *args)`` in each
with the group's mesh (``mesh.make_mesh``) made the active one. Rank 0's
return value comes back to the caller.

- Rendezvous goes through a ``file://`` store in a fresh temporary
  directory, never a fixed TCP port, so that several worlds can start at
  once on one machine.
- The backend is explicit. ``"nccl"`` needs one card per rank and raises
  before launch when there are fewer (NCCL refuses two ranks on one card).
  ``"gloo"`` ranks may share a card: rank r uses ``cuda:(r % cards)``.
  Nothing switches backend on its own.
- A rank on a card calls ``torch.cuda.set_device``; a rank on the CPU runs
  one intra-op thread, as the ranks share the host's cores.
- A rank that raises ends the world: the others are stopped and the
  exception is raised in the caller, naming the rank.
"""

from __future__ import annotations

import glob
import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Union

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from .mesh import make_mesh, use_mesh

__all__ = ["spawn"]

Device = Union[str, torch.device]

_BACKENDS = ("nccl", "gloo")
# a collective that waits longer than this has lost a rank
_TIMEOUT = timedelta(minutes=10)


def _rank_devices(world_size: int, backend: str,
                 device: Device) -> List[torch.device]:
    """The device of each rank of a world: the CPU, or the cards in turn.
    Raises where the backend cannot run that world."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, not "
                         f"{backend!r}")
    dev = torch.device(device)
    if dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("nccl runs on CUDA devices only")
        return [torch.device("cpu")] * world_size
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError("no CUDA device for a CUDA world")
    if backend == "nccl" and world_size > cards:
        raise RuntimeError(
            f"nccl: {world_size} ranks need {world_size} cards, {cards} "
            "found (NCCL refuses two ranks on one card; use gloo to share "
            "one)")
    return [torch.device("cuda", r % cards) for r in range(world_size)]


def _rank_main(rank: int, world_size: int, backend: str,
               devices: List[torch.device], store_dir: str) -> None:
    with open(os.path.join(store_dir, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(store_dir, "store"),
        world_size=world_size, rank=rank, timeout=_TIMEOUT,
        device_id=device if backend == "nccl" else None)
    try:
        mesh = make_mesh(devices=devices)
        with use_mesh(mesh):
            out = fn(mesh, *args)
        if rank == 0:
            torch.save(out, os.path.join(store_dir, "result.pt"))
        dist.barrier()
    except BaseException:
        # the first rank to fail is the cause; the others fail after it,
        # in collectives it left
        with open(os.path.join(store_dir, f"error-{time.time_ns():020d}-"
                               f"{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str, device: Device,
          *args: Any) -> Any:
    """Run ``fn(mesh, *args)`` on `world_size` ranks; rank 0's result."""
    if world_size < 1:
        raise ValueError(f"world_size must be positive, not {world_size}")
    devices = _rank_devices(world_size, backend, device)
    with tempfile.TemporaryDirectory(prefix="spmd-") as store_dir:
        # the call goes through a file: through each child's start-up pipe
        # a large one would hold the next child's start until this child
        # has imported what unpickling it needs
        with open(os.path.join(store_dir, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        try:
            mp.start_processes(
                _rank_main, args=(world_size, backend, devices, store_dir),
                nprocs=world_size, join=True, start_method="spawn")
        except ProcessException as e:
            errors = sorted(glob.glob(os.path.join(store_dir, "error-*")))
            if not errors:
                raise RuntimeError(
                    f"spmd rank {e.error_index} of {world_size} died: "
                    f"{e}") from e
            rank = errors[0].rsplit("-", 1)[1]
            with open(errors[0]) as f:
                raise RuntimeError(f"spmd rank {rank} of {world_size} "
                                   f"failed:\n{f.read()}") from e
        return torch.load(os.path.join(store_dir, "result.pt"),
                          weights_only=False)
