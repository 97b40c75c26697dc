"""Geometric linear algebra (counterpart of
``kornia_tpu/geometry/linalg.py``): rigid transforms, point-line
distances and batched norms."""

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


def point_line_distance(point: torch.Tensor, line: torch.Tensor,
                        eps: float = 1e-9) -> torch.Tensor:
    """Distance from 2-D points (homogeneous or not) to lines (a, b, c)."""
    numerator = (line[..., 0] * point[..., 0] + line[..., 1] * point[..., 1]
                 + line[..., 2]).abs()
    denominator = torch.sqrt(line[..., 0] ** 2 + line[..., 1] ** 2 + eps)
    return numerator / denominator


def squared_norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return (x * x).sum(-1, keepdim=keepdim)


def batched_dot_product(x: torch.Tensor, y: torch.Tensor,
                        keepdim: bool = False) -> torch.Tensor:
    return (x * y).sum(-1, keepdim=keepdim)


def euclidean_distance(x: torch.Tensor, y: torch.Tensor,
                       keepdim: bool = False,
                       eps: float = 1e-8) -> torch.Tensor:
    return torch.sqrt(((x - y) ** 2).sum(-1, keepdim=keepdim) + eps)


def batched_squared_norm(x: torch.Tensor,
                         keepdim: bool = False) -> torch.Tensor:
    """Squared L2 norm over the last axis."""
    return (x * x).sum(-1, keepdim=keepdim)


__all__ += ["point_line_distance", "squared_norm", "batched_dot_product",
            "euclidean_distance", "batched_squared_norm"]
