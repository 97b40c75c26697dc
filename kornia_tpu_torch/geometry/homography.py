"""Homography estimation (counterpart of
``kornia_tpu/geometry/homography.py``): Hartley normalisation, the
weighted point and line DLTs and their reweighted forms, transfer errors
and the oriented-constraint check of minimal samples.

Every DLT runs on Hartley-normalised coordinates in float32, as the
reference does: a minimal 4-point system takes its exact 1-dimensional
nullspace by Householder QR, larger ones the smallest eigenvector of the
Gram matrix (``core/linalg.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.check import check_shape
from ..core.dtype import as_float
from ..core.linalg import (f32_matmul_precision, inverse_3x3,
                           lstsq_nullspace, nullspace_qr)
from ..ops.warp import transform_points

__all__ = [
    "normalize_points",
    "find_homography_dlt",
    "find_homography_dlt_iterated",
    "find_homography_lines_dlt",
    "find_homography_lines_dlt_iterated",
    "symmetric_transfer_error",
    "oneway_transfer_error",
    "line_segment_transfer_error_one_way",
    "sample_is_valid_for_homography",
    "TupleTensor",
]

# the reference's alias of a pair of tensors (a line segment's endpoints)
TupleTensor = Tuple[torch.Tensor, torch.Tensor]


def normalize_points(points: torch.Tensor, eps: float = 1e-8
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero-mean, sqrt(2) mean-distance normalisation of (..., N, 2)
    points → (normalized points, (..., 3, 3) transform)."""
    mean = points.mean(dim=-2, keepdim=True)
    dists = torch.linalg.vector_norm(points - mean, dim=-1)
    scale = math.sqrt(2.0) / (dists.mean(dim=-1) + eps)  # (...,)
    T = torch.zeros((*points.shape[:-2], 3, 3), dtype=points.dtype,
                    device=points.device)
    T[..., 0, 0] = scale
    T[..., 1, 1] = scale
    T[..., 2, 2] = 1.0
    T[..., 0, 2] = -scale * mean[..., 0, 0]
    T[..., 1, 2] = -scale * mean[..., 0, 1]
    return (points - mean) * scale[..., None, None], T


def _solve_dlt(A: torch.Tensor, weights: Optional[torch.Tensor],
               T1: torch.Tensor, T2: torch.Tensor, n: int) -> torch.Tensor:
    """The homography of a (B, 2n, 9) DLT system in normalised
    coordinates, rows weighted by sqrt(w), denormalised and scaled to
    H[2, 2] = 1."""
    if weights is not None:
        w = torch.cat([weights, weights], dim=1)[..., None]
        A = A * torch.sqrt(w.clamp_min(0.0))
    h = nullspace_qr(A)[..., 0] if n == 4 else lstsq_nullspace(A)
    H = inverse_3x3(T2) @ h.reshape(-1, 3, 3) @ T1
    h22 = H[..., 2:3, 2:3]
    return H / (h22 + torch.where(h22 >= 0, 1e-8, -1e-8))


@f32_matmul_precision
def find_homography_dlt(points1: torch.Tensor, points2: torch.Tensor,
                        weights: Optional[torch.Tensor] = None,
                        solver: str = "svd") -> torch.Tensor:
    """Weighted DLT homography from N >= 4 correspondences (B, N, 2) x2 →
    (B, 3, 3), points1 → points2. `solver` is accepted for the reference's
    signature; the nullspace is always the conditioned one above."""
    check_shape(points1, ["B", "N", "2"], "points1")
    points1 = as_float(points1)
    points2 = as_float(points2)
    N = points1.shape[1]
    p1n, T1 = normalize_points(points1)
    p2n, T2 = normalize_points(points2)
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    ones = torch.ones_like(x1)
    zeros = torch.zeros_like(x1)
    # two equations per correspondence: (B, 2N, 9)
    ax = torch.stack([zeros, zeros, zeros, -x1, -y1, -ones,
                      y2 * x1, y2 * y1, y2], dim=-1)
    ay = torch.stack([x1, y1, ones, zeros, zeros, zeros,
                      -x2 * x1, -x2 * y1, -x2], dim=-1)
    return _solve_dlt(torch.cat([ax, ay], dim=1), weights, T1, T2, N)


def oneway_transfer_error(pts1: torch.Tensor, pts2: torch.Tensor,
                          H: torch.Tensor, squared: bool = True,
                          eps: float = 1e-8) -> torch.Tensor:
    """d(H·p1, p2)², or d without `squared`."""
    err = ((transform_points(H, pts1) - pts2) ** 2).sum(-1)
    return err if squared else torch.sqrt(err + eps)


def symmetric_transfer_error(pts1: torch.Tensor, pts2: torch.Tensor,
                             H: torch.Tensor, squared: bool = True,
                             eps: float = 1e-8) -> torch.Tensor:
    """d(H·p1, p2)² + d(H⁻¹·p2, p1)²."""
    err = (oneway_transfer_error(pts1, pts2, H, True, eps)
           + oneway_transfer_error(pts2, pts1, inverse_3x3(H), True, eps))
    return err if squared else torch.sqrt(err + eps)


@f32_matmul_precision
def find_homography_dlt_iterated(points1: torch.Tensor,
                                 points2: torch.Tensor,
                                 weights: torch.Tensor,
                                 soft_inl_th: float = 3.0,
                                 n_iter: int = 5) -> torch.Tensor:
    """The weighted DLT, then `n_iter` refits reweighted by
    exp(-err / (2·soft_inl_th²)) of the one-way transfer error."""
    H = find_homography_dlt(points1, points2, weights)
    for _ in range(n_iter):
        err = oneway_transfer_error(points1, points2, H, squared=True)
        H = find_homography_dlt(points1, points2,
                                torch.exp(-err / (2.0 * soft_inl_th ** 2)))
    return H


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


@f32_matmul_precision
def find_homography_lines_dlt(ls1: torch.Tensor, ls2: torch.Tensor,
                              weights: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Homography from line-segment correspondences (B, N, 2, 2): both
    transformed endpoints of a segment must lie on the destination
    segment's line."""
    ls1 = as_float(ls1)
    ls2 = as_float(ls2)
    N = ls1.shape[1]
    p1n, T1 = normalize_points(torch.cat([ls1[..., 0, :], ls1[..., 1, :]],
                                         dim=1))
    p2n, T2 = normalize_points(torch.cat([ls2[..., 0, :], ls2[..., 1, :]],
                                         dim=1))
    line2 = torch.linalg.cross(_homog(p2n[:, :N]), _homog(p2n[:, N:]))
    line2 = line2 / torch.linalg.vector_norm(
        line2[..., :2], dim=-1, keepdim=True).clamp_min(1e-8)
    a, b, c = line2.unbind(-1)

    def constraint(p):
        x, y = p[..., 0], p[..., 1]
        return torch.stack([a * x, a * y, a, b * x, b * y, b, c * x, c * y,
                            c], dim=-1)

    A = torch.cat([constraint(p1n[:, :N]), constraint(p1n[:, N:])], dim=1)
    return _solve_dlt(A, weights, T1, T2, N)


def line_segment_transfer_error_one_way(ls1: torch.Tensor, ls2: torch.Tensor,
                                        H: torch.Tensor,
                                        squared: bool = False
                                        ) -> torch.Tensor:
    """Mean distance of the transferred endpoints of ls1 from the lines of
    ls2."""
    ps1_in2 = transform_points(H, ls1[..., 0, :])
    pe1_in2 = transform_points(H, ls1[..., 1, :])
    line2 = torch.linalg.cross(_homog(ls2[..., 0, :]), _homog(ls2[..., 1, :]))
    n = torch.linalg.vector_norm(line2[..., :2], dim=-1).clamp_min(1e-8)
    d1 = ((line2[..., :2] * ps1_in2).sum(-1) + line2[..., 2]).abs() / n
    d2 = ((line2[..., :2] * pe1_in2).sum(-1) + line2[..., 2]).abs() / n
    err = 0.5 * (d1 + d2)
    return err ** 2 if squared else err


def find_homography_lines_dlt_iterated(ls1: torch.Tensor, ls2: torch.Tensor,
                                       weights: torch.Tensor,
                                       soft_inl_th: float = 4.0,
                                       n_iter: int = 5) -> torch.Tensor:
    """The weighted line DLT, then n_iter - 1 refits reweighted by the
    segment transfer error."""
    H = find_homography_lines_dlt(ls1, ls2, weights)
    for _ in range(n_iter - 1):
        err = line_segment_transfer_error_one_way(ls1, ls2, H, False)
        w = torch.exp(-err / (2.0 * soft_inl_th ** 2))
        H = find_homography_lines_dlt(ls1, ls2, w)
    return H


def sample_is_valid_for_homography(points1: torch.Tensor,
                                   points2: torch.Tensor) -> torch.Tensor:
    """Oriented-constraint check of 4-point samples (B, 4, 2) x2 → (B,):
    the signs of the four triple products agree in both images (a zero
    counts as its own sign, as ``jnp.sign`` gives it)."""
    check_shape(points1, ["B", "4", "2"], "points1")

    def orient(ph):
        l_12 = torch.linalg.cross(ph[:, 0], ph[:, 1])
        l_34 = torch.linalg.cross(ph[:, 2], ph[:, 3])
        return torch.stack([(l_34 * ph[:, 0]).sum(-1),
                            (l_34 * ph[:, 1]).sum(-1),
                            (l_12 * ph[:, 2]).sum(-1),
                            (l_12 * ph[:, 3]).sum(-1)], dim=-1)

    return (torch.sign(orient(_homog(points1)))
            == torch.sign(orient(_homog(points2)))).all(-1)
