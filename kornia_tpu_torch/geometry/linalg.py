"""Geometric linear algebra (counterpart of
``kornia_tpu/geometry/linalg.py``: the part the two-view path and the
trajectory metrics reach)."""

import torch

from ..ops.warp import transform_points

__all__ = ["transform_points", "compose_transformations",
           "inverse_transformation", "relative_transformation"]


def compose_transformations(T1: torch.Tensor,
                            T2: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) @ (..., 4, 4)."""
    return T1 @ T2


def inverse_transformation(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 4, 4) rigid transforms."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    top = torch.cat([Rt, -(Rt @ T[..., :3, 3:4])], dim=-1)
    bottom = torch.zeros_like(T[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def relative_transformation(T1: torch.Tensor,
                            T2: torch.Tensor) -> torch.Tensor:
    """T_12 such that T2 = T1 @ T_12."""
    return compose_transformations(inverse_transformation(T1), T2)
