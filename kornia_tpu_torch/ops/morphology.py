"""Grayscale morphology (counterpart of ``kornia_tpu/ops/morphology.py``).

A flat structuring element of ones (no `structuring_element`) is one
``max_pool2d`` over the constant-padded image; any other kernel is a
shift-and-accumulate over its taps, the taps outside the kernel masked with
∓inf. Which route a kernel takes is read from a host copy of its values,
made once per kernel tensor (and again only after the tensor is modified
in place), so a kernel on the card costs one device→host read, not one a
call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from ..core.check import check
from ..core.dtype import as_float

__all__ = [
    "dilation",
    "erosion",
    "opening",
    "closing",
    "gradient",
    "top_hat",
    "bottom_hat",
]

# kernel tensor → (its version when read, whether every value is 1)
_ALL_ONES = WeakIdKeyDictionary()


def _is_full_ones(kernel) -> bool:
    """Whether every value of the kernel is 1, from a host copy read once
    per kernel tensor and version."""
    if not isinstance(kernel, torch.Tensor):
        return bool(np.all(np.asarray(kernel) == 1.0))
    seen = _ALL_ONES.get(kernel)
    if seen is None or seen[0] != kernel._version:
        seen = (kernel._version, bool((kernel.detach().cpu() == 1.0).all()))
        _ALL_ONES[kernel] = seen
    return seen[1]


def _morph(image: torch.Tensor, kernel: torch.Tensor, op: str,
           structuring_element: Optional[torch.Tensor] = None,
           origin: Optional[Tuple[int, int]] = None,
           pad_value: float = 0.0, flat: bool = False) -> torch.Tensor:
    """Max (dilation) or min (erosion) over the kernel's window anchored at
    `origin`, the border padded with `pad_value`."""
    image = as_float(image)
    check(image.ndim == 4, f"expected (B,C,H,W), got {tuple(image.shape)}")
    kh, kw = kernel.shape[-2:]
    oy, ox = origin if origin is not None else (kh // 2, kw // 2)
    xp = F.pad(image, (ox, kw - 1 - ox, oy, kh - 1 - oy), value=pad_value)
    if flat:
        if op == "max":
            return F.max_pool2d(xp, (kh, kw), stride=1)
        return -F.max_pool2d(-xp, (kh, kw), stride=1)
    kernel = torch.as_tensor(kernel, device=image.device).to(image.dtype)
    se = (torch.zeros_like(kernel) if structuring_element is None else
          torch.as_tensor(structuring_element,
                          device=image.device).to(image.dtype))
    H, W = image.shape[-2:]
    neutral = -torch.inf if op == "max" else torch.inf
    out = torch.full_like(image, neutral)
    for dy in range(kh):
        for dx in range(kw):
            tap = xp[..., dy:dy + H, dx:dx + W]
            if op == "max":
                cand = torch.where(kernel[dy, dx] > 0, tap + se[dy, dx],
                                   -torch.inf)
                out = torch.maximum(out, cand)
            else:
                cand = torch.where(kernel[dy, dx] > 0, tap - se[dy, dx],
                                   torch.inf)
                out = torch.minimum(out, cand)
    return out


def dilation(image: torch.Tensor, kernel: torch.Tensor,
             structuring_element: Optional[torch.Tensor] = None,
             origin: Optional[Tuple[int, int]] = None,
             border_type: str = "geodesic", border_value: float = 0.0,
             max_val: float = 1e4) -> torch.Tensor:
    """Max over the mirrored kernel's window (plus the structuring
    element); the geodesic border counts as 0."""
    flat = structuring_element is None and _is_full_ones(kernel)
    k = torch.flip(torch.as_tensor(kernel), dims=(-2, -1))
    se = None if structuring_element is None else torch.flip(
        torch.as_tensor(structuring_element), dims=(-2, -1))
    bv = 0.0 if border_type == "geodesic" else border_value
    return _morph(image, k, "max", se, origin, bv, flat)


def erosion(image: torch.Tensor, kernel: torch.Tensor,
            structuring_element: Optional[torch.Tensor] = None,
            origin: Optional[Tuple[int, int]] = None,
            border_type: str = "geodesic", border_value: float = 0.0,
            max_val: float = 1e4) -> torch.Tensor:
    """Min over the kernel's window (minus the structuring element); the
    geodesic border counts as `max_val`."""
    flat = structuring_element is None and _is_full_ones(kernel)
    bv = max_val if border_type == "geodesic" else border_value
    return _morph(image, torch.as_tensor(kernel), "min", structuring_element,
                  origin, bv, flat)


def opening(image: torch.Tensor, kernel: torch.Tensor, **kw) -> torch.Tensor:
    return dilation(erosion(image, kernel, **kw), kernel, **kw)


def closing(image: torch.Tensor, kernel: torch.Tensor, **kw) -> torch.Tensor:
    return erosion(dilation(image, kernel, **kw), kernel, **kw)


def gradient(image: torch.Tensor, kernel: torch.Tensor, **kw) -> torch.Tensor:
    return dilation(image, kernel, **kw) - erosion(image, kernel, **kw)


def top_hat(image: torch.Tensor, kernel: torch.Tensor, **kw) -> torch.Tensor:
    return as_float(image) - opening(image, kernel, **kw)


def bottom_hat(image: torch.Tensor, kernel: torch.Tensor,
               **kw) -> torch.Tensor:
    return closing(image, kernel, **kw) - as_float(image)
