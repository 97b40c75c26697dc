"""Lines, planes and rays (counterpart of ``kornia_tpu/geometry/line.py``).
The fits take an eigenvector of a covariance, whose sign is free."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..core.dtype import as_float

__all__ = ["ParametrizedLine", "fit_line", "Hyperplane", "fit_plane", "Ray"]


def _unit(d: torch.Tensor) -> torch.Tensor:
    return d / torch.linalg.norm(d, dim=-1, keepdim=True).clamp(min=1e-9)


@dataclasses.dataclass(frozen=True)
class ParametrizedLine:
    """origin (..., D) + t · direction (..., D), the direction a unit."""

    origin: torch.Tensor
    direction: torch.Tensor

    @classmethod
    def through(cls, p0: torch.Tensor, p1: torch.Tensor) -> "ParametrizedLine":
        return cls(as_float(p0), _unit(p1 - p0))

    def point_at(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, dtype=self.origin.dtype,
                            device=self.origin.device)
        return self.origin + t[..., None] * self.direction

    def projection(self, point: torch.Tensor) -> torch.Tensor:
        t = ((point - self.origin) * self.direction).sum(-1, keepdim=True)
        return self.origin + t * self.direction

    def distance(self, point: torch.Tensor) -> torch.Tensor:
        return torch.linalg.norm(point - self.projection(point), dim=-1)

    def squared_distance(self, point: torch.Tensor) -> torch.Tensor:
        diff = point - self.projection(point)
        return (diff * diff).sum(-1)


def fit_line(points: torch.Tensor, weights: Optional[torch.Tensor] = None
             ) -> ParametrizedLine:
    """Total-least-squares line of (B, N, D) points: through the weighted
    centroid along the principal direction."""
    points = as_float(points)
    if weights is None:
        weights = torch.ones(points.shape[:-1], dtype=points.dtype,
                             device=points.device)
    w = weights[..., None]
    mean = (points * w).sum(-2, keepdim=True) / \
        w.sum(-2, keepdim=True).clamp(min=1e-9)
    centered = (points - mean) * w.clamp(min=0.0).sqrt()
    cov = torch.einsum("...ni,...nj->...ij", centered, centered)
    _, vecs = torch.linalg.eigh(cov)
    return ParametrizedLine(mean[..., 0, :], vecs[..., :, -1])


@dataclasses.dataclass(frozen=True)
class Hyperplane:
    """normal · x + offset = 0, the normal a unit."""

    normal: torch.Tensor
    offset: torch.Tensor

    @classmethod
    def from_vector(cls, normal: torch.Tensor, point: torch.Tensor
                    ) -> "Hyperplane":
        n = _unit(normal)
        return cls(n, -(n * point).sum(-1))

    def signed_distance(self, point: torch.Tensor) -> torch.Tensor:
        return (self.normal * point).sum(-1) + self.offset

    def projection(self, point: torch.Tensor) -> torch.Tensor:
        return point - self.signed_distance(point)[..., None] * self.normal


def fit_plane(points: torch.Tensor) -> Hyperplane:
    """Total-least-squares plane of (B, N, 3) points."""
    points = as_float(points)
    mean = points.mean(-2, keepdim=True)
    centered = points - mean
    cov = torch.einsum("...ni,...nj->...ij", centered, centered)
    _, vecs = torch.linalg.eigh(cov)
    return Hyperplane.from_vector(vecs[..., :, 0], mean[..., 0, :])


@dataclasses.dataclass(frozen=True)
class Ray:
    """origin + t · direction, t ≥ 0."""

    origin: torch.Tensor
    direction: torch.Tensor

    @classmethod
    def through(cls, p0: torch.Tensor, p1: torch.Tensor) -> "Ray":
        return cls(as_float(p0), _unit(p1 - p0))

    def point_at(self, t) -> torch.Tensor:
        t = torch.as_tensor(t, device=self.origin.device)
        return self.origin + t[..., None] * self.direction

    def intersect_plane(self, plane: Hyperplane) -> torch.Tensor:
        """The intersection point (far away where parallel)."""
        denom = (self.direction * plane.normal).sum(-1)
        denom = torch.where(denom.abs() > 1e-9, denom,
                            torch.full_like(denom, 1e-9))
        t = -((self.origin * plane.normal).sum(-1) + plane.offset) / denom
        return self.point_at(t)
