"""Image layout utilities (counterpart of ``kornia_tpu/image/utils.py``)."""

from __future__ import annotations

import functools
import math
from typing import Any, Callable, List, Optional

import torch
import torch.nn.functional as F

__all__ = ["image_list_to_tensor", "make_grid", "perform_keep_shape_image",
           "perform_keep_shape_video"]


def image_list_to_tensor(images: List[Any]) -> torch.Tensor:
    """List of (H, W, C) images → (B, C, H, W), on the first one's device
    (numpy images go to the CPU)."""
    if not images:
        raise ValueError("Input list of images is empty")
    stacked = torch.stack([torch.as_tensor(im) for im in images])
    if stacked.ndim != 4:
        raise ValueError(
            f"images must be (H, W, C), got {tuple(stacked.shape[1:])}")
    return stacked.movedim(-1, 1)


def make_grid(tensor: torch.Tensor, n_row: Optional[int] = None,
              padding: int = 2) -> torch.Tensor:
    """Tile a (B, C, H, W) batch into one (C, H', W') image, `padding`
    zeros between tiles."""
    tensor = torch.as_tensor(tensor)
    B, C, H, W = tensor.shape
    if n_row is None:
        n_row = int(math.ceil(math.sqrt(B)))
    n_col = (B + n_row - 1) // n_row
    pH, pW = H + padding, W + padding
    padded = F.pad(tensor, (0, padding, 0, padding))
    padded = torch.cat([padded, padded.new_zeros(
        (n_row * n_col - B, C, pH, pW))], 0)
    grid = padded.reshape(n_row, n_col, C, pH, pW).permute(2, 0, 3, 1, 4)
    grid = grid.reshape(C, n_row * pH, n_col * pW)
    return grid[:, : n_row * pH - padding, : n_col * pW - padding]


def _keep_shape(f: Callable, spatial_dims: int) -> Callable:
    @functools.wraps(f)
    def wrapper(input, *args, **kwargs):
        x = torch.as_tensor(input)
        in_shape = tuple(x.shape)
        lead = in_shape[: x.ndim - (spatial_dims + 1)]
        x = x.reshape((-1,) + in_shape[x.ndim - (spatial_dims + 1):]) \
            if x.ndim > spatial_dims + 1 else x[None]
        if x.ndim == spatial_dims + 1:
            x = x[None]
        out = f(x, *args, **kwargs)
        return out.reshape(lead + tuple(out.shape[1:])) if lead else out[0]
    return wrapper


def perform_keep_shape_image(f: Callable) -> Callable:
    """Decorator: accept (..., C, H, W), run `f` on (B, C, H, W), restore
    the leading shape."""
    return _keep_shape(f, 3)


def perform_keep_shape_video(f: Callable) -> Callable:
    """Same for (..., C, T, H, W) video."""
    return _keep_shape(f, 4)
