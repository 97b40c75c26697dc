"""Coordinate grids and the pixel ↔ [-1, 1] normalisers (counterpart of
``kornia_tpu/core/grid.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from .dtype import true_div

__all__ = ["linspace", "create_meshgrid", "create_meshgrid3d",
           "normalize_pixel_coordinates", "denormalize_pixel_coordinates",
           "normalize_pixel_coordinates3d", "denormalize_pixel_coordinates3d"]


def linspace(start: float, stop: float, num: int,
             device: Optional[torch.device] = None) -> torch.Tensor:
    """float32 ``jnp.linspace``: with s = i / (num - 1), start · (1 - s) +
    stop · s, the last point exactly `stop`: rounded as the JAX package
    rounds it (torch.linspace counts the upper half down from `stop`), for
    the ops that floor it."""
    if num == 1:
        return torch.full((1,), float(start), device=device)
    s = true_div(torch.arange(num - 1, dtype=torch.float32, device=device),
                 num - 1)
    out = float(start) * (1.0 - s) + float(stop) * s
    return torch.cat([out, torch.full((1,), float(stop), device=device)])


def create_meshgrid(height: int, width: int,
                    normalized_coordinates: bool = True,
                    dtype: torch.dtype = torch.float32,
                    device: Optional[torch.device] = None) -> torch.Tensor:
    """(1, H, W, 2) grid of (x, y) coordinates; normalized coordinates span
    [-1, 1] (grid_sample's align_corners=True convention)."""
    if normalized_coordinates:
        xs = torch.linspace(-1.0, 1.0, width, dtype=dtype, device=device)
        ys = torch.linspace(-1.0, 1.0, height, dtype=dtype, device=device)
    else:
        xs = torch.arange(width, dtype=dtype, device=device)
        ys = torch.arange(height, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], dim=-1)[None]


def create_meshgrid3d(depth: int, height: int, width: int,
                      normalized_coordinates: bool = True,
                      dtype: torch.dtype = torch.float32,
                      device: Optional[torch.device] = "cuda") -> torch.Tensor:
    """(1, D, H, W, 3) grid of (x, y, z) coordinates, normalized to [-1, 1]
    or in pixels."""
    def axis(n):
        if normalized_coordinates:
            return torch.linspace(-1.0, 1.0, n, dtype=dtype, device=device)
        return torch.arange(n, dtype=dtype, device=device)

    gz, gy, gx = torch.meshgrid(axis(depth), axis(height), axis(width),
                                indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1)[None]


def _extent(pixel: torch.Tensor, height: int, width: int,
            eps: float) -> torch.Tensor:
    """(W - 1, H - 1), each at least eps."""
    return torch.tensor([width - 1, height - 1], dtype=pixel.dtype,
                        device=pixel.device).clamp_min(eps)


def normalize_pixel_coordinates(pixel: torch.Tensor, height: int, width: int,
                                eps: float = 1e-8) -> torch.Tensor:
    """(..., 2) pixels in [0, W-1] x [0, H-1] → [-1, 1]²."""
    return 2.0 * pixel / _extent(pixel, height, width, eps) - 1.0


def denormalize_pixel_coordinates(coord: torch.Tensor, height: int,
                                  width: int,
                                  eps: float = 1e-8) -> torch.Tensor:
    return (coord + 1.0) * _extent(coord, height, width, eps) / 2.0



def _extent3d(pixel: torch.Tensor, depth: int, height: int, width: int,
              eps: float) -> torch.Tensor:
    """(W - 1, H - 1, D - 1), each at least eps."""
    return torch.tensor([width - 1, height - 1, depth - 1], dtype=pixel.dtype,
                        device=pixel.device).clamp_min(eps)


def normalize_pixel_coordinates3d(pixel: torch.Tensor, depth: int,
                                  height: int, width: int,
                                  eps: float = 1e-8) -> torch.Tensor:
    """(..., 3) voxel coordinates (x, y, z) → [-1, 1]³."""
    return 2.0 * pixel / _extent3d(pixel, depth, height, width, eps) - 1.0


def denormalize_pixel_coordinates3d(coord: torch.Tensor, depth: int,
                                    height: int, width: int,
                                    eps: float = 1e-8) -> torch.Tensor:
    return (coord + 1.0) * _extent3d(coord, depth, height, width, eps) / 2.0
