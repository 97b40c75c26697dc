"""Shape and type checks (counterpart of ``kornia_tpu/core/check.py``):
they run on the host, before any work, and raise ``ValueError`` (or
``TypeError`` for a dtype). ``disable_checks`` turns them off."""

from __future__ import annotations

from typing import Any, Sequence

from ..config import kornia_tpu_config

__all__ = ["check", "check_shape", "check_same_shape", "check_same_dtype",
           "check_is_image", "check_is_gray", "check_is_color", "check_laf",
           "checks_enabled", "enable_checks", "disable_checks"]


def checks_enabled() -> bool:
    return kornia_tpu_config.checks_enabled


def enable_checks() -> None:
    kornia_tpu_config.checks_enabled = True


def disable_checks() -> None:
    kornia_tpu_config.checks_enabled = False


def check(condition: bool, msg: str = "condition failed") -> None:
    """Raise ``ValueError(msg)`` unless ``condition`` holds."""
    if not condition and checks_enabled():
        raise ValueError(msg)


def check_shape(x: Any, pattern: Sequence[str], name: str = "tensor") -> None:
    """Check a shape against a symbolic pattern: ``"*"`` (any run of
    leading dims, first position only), an integer literal like ``"3"``,
    or a symbol like ``"B"`` that binds consistently within the call."""
    if not checks_enabled():
        return
    shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x)
    pat = list(pattern)
    if pat and pat[0] == "*":
        pat = pat[1:]
        if len(shape) < len(pat):
            raise ValueError(
                f"{name}: shape {shape} does not match pattern {list(pattern)}")
        shape = shape[len(shape) - len(pat):]
    if len(shape) != len(pat):
        raise ValueError(
            f"{name}: shape {shape} does not match pattern {list(pattern)}")
    bindings: dict = {}
    for dim, sym in zip(shape, pat):
        if sym.isdigit():
            ok = dim == int(sym)
        else:
            ok = bindings.setdefault(sym, dim) == dim
        if not ok:
            raise ValueError(
                f"{name}: shape {shape} does not match pattern {list(pattern)}")


def check_same_shape(a: Any, b: Any, msg: str = "") -> None:
    if checks_enabled() and tuple(a.shape) != tuple(b.shape):
        raise ValueError(
            msg or f"shape mismatch: {tuple(a.shape)} vs {tuple(b.shape)}")


def check_same_dtype(a: Any, b: Any, msg: str = "") -> None:
    if checks_enabled() and a.dtype != b.dtype:
        raise ValueError(msg or f"dtype mismatch: {a.dtype} vs {b.dtype}")


def check_is_image(x: Any, name: str = "image") -> None:
    """(..., C, H, W) with a float dtype."""
    if not checks_enabled():
        return
    if x.ndim < 3:
        raise ValueError(
            f"{name}: expected at least 3 dims (..., C, H, W), got "
            f"{tuple(x.shape)}")
    if not x.is_floating_point():
        raise TypeError(f"{name}: expected float dtype, got {x.dtype}")


def check_is_gray(x: Any, name: str = "image") -> None:
    check_is_image(x, name)
    if checks_enabled() and x.shape[-3] != 1:
        raise ValueError(f"{name}: expected 1 channel, got {x.shape[-3]}")


def check_is_color(x: Any, name: str = "image") -> None:
    check_is_image(x, name)
    if checks_enabled() and x.shape[-3] != 3:
        raise ValueError(f"{name}: expected 3 channels, got {x.shape[-3]}")


def check_laf(laf: Any, name: str = "laf") -> None:
    """Local affine frame stack (B, N, 2, 3)."""
    check_shape(laf, ["B", "N", "2", "3"], name)
