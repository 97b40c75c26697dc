"""Coordinate and rotation conversions (counterpart of
``kornia_tpu/geometry/conversions.py``: the part the two-view path, the Lie
groups, PnP and the scene generator reach).

Quaternions are (w, x, y, z). The small-angle guards are the reference's:
a floor inside every ``sqrt`` and Taylor branches selected by
``torch.where``, so that values and forward-mode Jacobians stay finite at
zero, where the optimisers linearise.
"""

from __future__ import annotations

import torch

__all__ = [
    "normalize_points_with_intrinsics",
    "vector_to_skew_symmetric_matrix",
    "axis_angle_to_rotation_matrix",
    "angle_axis_to_rotation_matrix",
    "rotation_matrix_to_quaternion",
    "normalize_quaternion",
    "quaternion_to_rotation_matrix",
    "quaternion_to_angle_axis",
    "angle_axis_to_quaternion",
]

_EPS = 1e-8

# _fwd_ad_note: under torch.func.jacfwd (torch 2.x), a Python float combined
# with a 0-dim tensor gives a float64 tangent, and the next product with a
# float32 tangent fails. Functions that the optimisers differentiate per
# observation therefore keep per-element scalars as (..., 1) slices.


def normalize_points_with_intrinsics(points: torch.Tensor,
                                     K: torch.Tensor) -> torch.Tensor:
    """Pixel coordinates (..., N, 2) → normalized camera coordinates."""
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    x = (points[..., 0] - cx) / fx
    y = (points[..., 1] - cy) / fy
    return torch.stack([x, y], dim=-1)


def vector_to_skew_symmetric_matrix(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 3, 3), the hat operator."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zeros = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zeros, -z, y], dim=-1),
        torch.stack([z, zeros, -x], dim=-1),
        torch.stack([-y, x, zeros], dim=-1),
    ], dim=-2)


def axis_angle_to_rotation_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula (..., 3) → (..., 3, 3), Taylor branch below
    θ² < 1e-8."""
    theta2 = (axis_angle * axis_angle).sum(-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2.clamp_min(1e-20))
    K = vector_to_skew_symmetric_matrix(axis_angle)
    K2 = K @ K
    eye = torch.eye(3, dtype=axis_angle.dtype,
                    device=axis_angle.device).expand(K.shape)
    R_full = eye + (torch.sin(theta) / theta) * K \
        + ((1.0 - torch.cos(theta)) / theta2.clamp_min(1e-20)) * K2
    R_taylor = eye + (1.0 - theta2 / 6.0) * K + (0.5 - theta2 / 24.0) * K2
    return torch.where(theta2 < 1e-8, R_taylor, R_full)


angle_axis_to_rotation_matrix = axis_angle_to_rotation_matrix


def normalize_quaternion(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    if q.shape[-1] != 4:
        raise ValueError(f"quaternion must be (..., 4) wxyz, got "
                         f"{tuple(q.shape)}")
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(eps)


def rotation_matrix_to_quaternion(R: torch.Tensor,
                                  eps: float = _EPS) -> torch.Tensor:
    """(..., 3, 3) → (..., 4) wxyz: Shepperd's four candidates, the best
    conditioned one picked per element without branches."""
    if tuple(R.shape[-2:]) != (3, 3):
        raise ValueError(f"R must be (..., 3, 3), got {tuple(R.shape)}")
    # entries keep a trailing axis of 1 (see _fwd_ad_note)
    m = [[R[..., i, j:j + 1] for j in range(3)] for i in range(3)]
    (m00, m01, m02), (m10, m11, m12), (m20, m21, m22) = m
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(x.clamp_min(eps))

    qw_0 = safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.cat([qw_0, (m21 - m12) / (4 * qw_0 + eps),
                    (m02 - m20) / (4 * qw_0 + eps),
                    (m10 - m01) / (4 * qw_0 + eps)], dim=-1)
    qx_1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.cat([(m21 - m12) / (4 * qx_1 + eps), qx_1,
                    (m01 + m10) / (4 * qx_1 + eps),
                    (m02 + m20) / (4 * qx_1 + eps)], dim=-1)
    qy_2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.cat([(m02 - m20) / (4 * qy_2 + eps),
                    (m01 + m10) / (4 * qy_2 + eps), qy_2,
                    (m12 + m21) / (4 * qy_2 + eps)], dim=-1)
    qz_3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.cat([(m10 - m01) / (4 * qz_3 + eps),
                    (m02 + m20) / (4 * qz_3 + eps),
                    (m12 + m21) / (4 * qz_3 + eps), qz_3], dim=-1)
    c0 = tr > 0
    c1 = (m00 >= m11) & (m00 >= m22)
    c2 = m11 >= m22
    q = torch.where(c0, q0, torch.where(c1, q1, torch.where(c2, q2, q3)))
    return normalize_quaternion(q)


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz → (..., 3, 3)."""
    q = normalize_quaternion(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    tx, ty, tz = 2 * x, 2 * y, 2 * z
    twx, twy, twz = tx * w, ty * w, tz * w
    txx, txy, txz = tx * x, ty * x, tz * x
    tyy, tyz, tzz = ty * y, tz * y, tz * z
    return torch.stack([
        torch.stack([1 - (tyy + tzz), txy - twz, txz + twy], dim=-1),
        torch.stack([txy + twz, 1 - (txx + tzz), tyz - twx], dim=-1),
        torch.stack([txz - twy, tyz + twx, 1 - (txx + tyy)], dim=-1),
    ], dim=-2)


def quaternion_to_angle_axis(q: torch.Tensor,
                             eps: float = _EPS) -> torch.Tensor:
    """(..., 4) wxyz → (..., 3), on the w ≥ 0 hemisphere (angle ≤ π)."""
    q = torch.where(q[..., 0:1] < 0, -q, q)
    w = q[..., 0:1]  # a trailing axis of 1 (see _fwd_ad_note)
    xyz = q[..., 1:]
    sin_sq = (xyz * xyz).sum(-1, keepdim=True)
    sin_t = torch.sqrt(sin_sq.clamp_min(1e-20))
    angle = 2.0 * torch.atan2(sin_t, w)
    k_big = angle / sin_t.clamp_min(eps)
    k = torch.where(sin_sq > eps * eps, k_big, 2.0)
    return xyz * k


def angle_axis_to_quaternion(axis_angle: torch.Tensor,
                             eps: float = _EPS) -> torch.Tensor:
    """(..., 3) → (..., 4) wxyz, Taylor branch below θ² ≤ eps²."""
    theta2 = (axis_angle * axis_angle).sum(-1, keepdim=True)
    theta = torch.sqrt(theta2.clamp_min(1e-20))
    half = 0.5 * theta
    big = theta2 > eps * eps
    k = torch.where(big, torch.sin(half) / theta, 0.5 - theta2 / 48.0)
    w = torch.where(big, torch.cos(half), 1.0 - theta2 / 8.0)
    return torch.cat([w, axis_angle * k], dim=-1)
