"""Class wrappers over functional ops (counterpart of
``kornia_tpu/core/module.py``: ``fn_module``)."""

from __future__ import annotations

from typing import Callable

__all__ = ["fn_module"]


def fn_module(fn: Callable, name: str, doc: str | None = None):
    """A kornia-style callable class around functional ``fn``: the
    constructor takes the functional's trailing (configuration) arguments,
    ``__call__`` the leading (tensor) ones, and applies
    ``fn(*inputs, *cfg_args, **cfg_kwargs)``."""

    class _Mod:
        def __init__(self, *args, **kwargs):
            self._args = args
            self._kwargs = kwargs

        def __call__(self, *inputs, **call_kwargs):
            return fn(*inputs, *self._args,
                      **{**self._kwargs, **call_kwargs})

        def __repr__(self):
            cfg = ", ".join([*map(repr, self._args),
                             *(f"{k}={v!r}" for k, v in
                               self._kwargs.items())])
            return f"{name}({cfg})"

    _Mod.__name__ = _Mod.__qualname__ = name
    _Mod.__doc__ = doc or (
        f"Class API over ``{fn.__module__}.{fn.__name__}`` "
        f"(kornia-compatible module wrapper).")
    return _Mod
