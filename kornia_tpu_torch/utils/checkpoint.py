"""Checkpoints of state trees (counterpart of
``kornia_tpu/utils/checkpoint.py``, which writes through orbax).

A state is a tree of tensors, numbers, strings, dicts, lists, tuples and
dataclasses (``BAState``, ``Se3``, ...). It is written with ``torch.save``
as plain containers, a dataclass as a tagged dict of its fields, and read
back with ``torch.load(weights_only=True)``, which unpickles no code. A
checkpoint is written under a temporary name and renamed into place, so a
crash while writing leaves no checkpoint that a restart could pick up.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
from typing import Any, Mapping, Optional, Union

import torch

__all__ = ["save_checkpoint", "load_checkpoint"]

Device = Union[str, torch.device]

_TAG = "__dataclass__"
# dataclasses are rebuilt from these modules only
_OWN = __name__.split(".")[0] + "."


def _plain(tree: Any) -> Any:
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        cls = type(tree)
        return {_TAG: f"{cls.__module__}:{cls.__qualname__}",
                **{f.name: _plain(getattr(tree, f.name))
                   for f in dataclasses.fields(tree)}}
    if isinstance(tree, Mapping):
        if _TAG in tree:
            raise ValueError(f"a state dict may not hold the key {_TAG!r}")
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach()
    return tree


def save_checkpoint(path: str, state: Any) -> None:
    """Save a state tree (params, optimizer state, BA map, ...) to `path`."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        torch.save(_plain(state), tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _class(tag: str):
    module, qualname = tag.split(":")
    if not module.startswith(_OWN):
        raise ValueError(f"checkpoint names a class outside {_OWN[:-1]}: "
                         f"{tag}")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    if not dataclasses.is_dataclass(obj):
        raise ValueError(f"checkpoint names a class that is not a "
                         f"dataclass: {tag}")
    return obj


def _rebuild(tree: Any, device: torch.device) -> Any:
    if isinstance(tree, dict):
        if _TAG in tree:
            cls = _class(tree[_TAG])
            return cls(**{k: _rebuild(v, device) for k, v in tree.items()
                          if k != _TAG})
        return {k: _rebuild(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, device) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _restore(tree: Any, target: Any, where: str) -> Any:
    """`tree` in the structure of `target`, each tensor on its target's
    device with its target's dtype."""
    if dataclasses.is_dataclass(target) and not isinstance(target, type):
        cls = type(target)
        if not (isinstance(tree, dict)
                and tree.get(_TAG) == f"{cls.__module__}:{cls.__qualname__}"):
            raise ValueError(f"checkpoint at {where or 'the root'} is not a "
                             f"{cls.__qualname__}")
        return dataclasses.replace(target, **{
            f.name: _restore(tree[f.name], getattr(target, f.name),
                             f"{where}.{f.name}")
            for f in dataclasses.fields(target)})
    if isinstance(target, Mapping):
        if not isinstance(tree, dict) or set(tree) != set(target):
            raise ValueError(f"checkpoint at {where or 'the root'} has other "
                             f"keys than the target")
        return {k: _restore(tree[k], v, f"{where}[{k!r}]")
                for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(target):
            raise ValueError(f"checkpoint at {where or 'the root'} has "
                             f"another length than the target")
        return type(target)(_restore(a, b, f"{where}[{i}]")
                            for i, (a, b) in enumerate(zip(tree, target)))
    if isinstance(target, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != target.shape:
            raise ValueError(f"checkpoint at {where or 'the root'} is not a "
                             f"tensor of shape {tuple(target.shape)}")
        return tree.to(device=target.device, dtype=target.dtype)
    return tree


def load_checkpoint(path: str, target: Optional[Any] = None,
                    device: Device = "cuda") -> Any:
    """Restore a state tree saved by save_checkpoint. With `target` (a tree
    of the same structure, as the reference's typed restore) each tensor
    lands on its target's device with its target's dtype; without one,
    every tensor lands on `device`."""
    tree = torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)
    if target is not None:
        return _restore(tree, target, "")
    return _rebuild(tree, torch.device(device))
