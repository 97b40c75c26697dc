"""Coordinate and rotation conversions (counterpart of
``kornia_tpu/geometry/conversions.py``): angles, polar and homogeneous
coordinates, the rotation representations, homography and intrinsics
normalisation and the camera-convention converters.

Quaternions are (w, x, y, z). The small-angle guards are the reference's:
a floor inside every ``sqrt`` and Taylor branches selected by
``torch.where``, so that values and forward-mode Jacobians stay finite at
zero, where the optimisers linearise.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..core.check import check_shape
from ..core.dtype import as_float
from ..core.grid import (  # noqa: F401  (re-exported, as the reference does)
    denormalize_pixel_coordinates,
    denormalize_pixel_coordinates3d,
    normalize_pixel_coordinates,
    normalize_pixel_coordinates3d,
)
from ..ops.warp import denormalize_homography, normalize_homography  # noqa: F401

__all__ = [
    "rad2deg", "deg2rad", "pol2cart", "cart2pol",
    "convert_points_from_homogeneous", "convert_points_to_homogeneous",
    "convert_affinematrix_to_homography",
    "convert_affinematrix_to_homography3d",
    "rotation_matrix_to_angle_axis", "rotation_matrix_to_axis_angle",
    "quaternion_log_to_exp", "quaternion_exp_to_log",
    "euler_from_quaternion", "quaternion_from_euler",
    "normalize_pixel_coordinates", "denormalize_pixel_coordinates",
    "normalize_pixel_coordinates3d", "denormalize_pixel_coordinates3d",
    "normalize_homography", "denormalize_homography",
    "normalize_homography3d", "denormalize_points_with_intrinsics",
    "Rt_to_matrix4x4", "matrix4x4_to_Rt",
    "camtoworld_to_worldtocam_Rt", "worldtocam_to_camtoworld_Rt",
    "camtoworld_graphics_to_vision_4x4", "camtoworld_vision_to_graphics_4x4",
    "ARKitQTVecs_to_ColmapQTVecs", "angle_to_rotation_matrix",
    "camtoworld_graphics_to_vision_Rt", "camtoworld_vision_to_graphics_Rt",
    "normal_transform_pixel3d", "axis_angle_to_quaternion",
    "quaternion_to_axis_angle",
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


def rad2deg(x: torch.Tensor) -> torch.Tensor:
    return as_float(x) * (180.0 / math.pi)


def deg2rad(x: torch.Tensor) -> torch.Tensor:
    return as_float(x) * (math.pi / 180.0)


def pol2cart(rho: torch.Tensor, phi: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    return rho * torch.cos(phi), rho * torch.sin(phi)


def cart2pol(x: torch.Tensor, y: torch.Tensor, eps: float = _EPS
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.sqrt(x * x + y * y + eps), torch.atan2(y, x)


def convert_points_from_homogeneous(points: torch.Tensor,
                                    eps: float = _EPS) -> torch.Tensor:
    """(..., N, D+1) → (..., N, D), the divide guarded near w = 0."""
    z = points[..., -1:]
    scale = torch.where(z.abs() > eps,
                        1.0 / (z + torch.where(z >= 0, eps, -eps)),
                        torch.ones_like(z))
    return points[..., :-1] * scale


def convert_points_to_homogeneous(points: torch.Tensor) -> torch.Tensor:
    if points.ndim < 2:
        raise ValueError(f"points must be at least (N, D), got shape "
                         f"{tuple(points.shape)}")
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def _append_unit_row(A: torch.Tensor) -> torch.Tensor:
    """(..., n-1, n) → (..., n, n) with the last row (0, ..., 0, 1)."""
    pad = torch.zeros((*A.shape[:-2], 1, A.shape[-1]), dtype=A.dtype,
                      device=A.device)
    pad[..., 0, -1] = 1.0
    return torch.cat([A, pad], dim=-2)


def convert_affinematrix_to_homography(A: torch.Tensor) -> torch.Tensor:
    """(..., 2, 3) → (..., 3, 3)."""
    check_shape(A, ["*", "2", "3"], "A")
    return _append_unit_row(A)


def convert_affinematrix_to_homography3d(A: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) → (..., 4, 4)."""
    check_shape(A, ["*", "3", "4"], "A")
    return _append_unit_row(A)


def rotation_matrix_to_angle_axis(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → (..., 3) through the quaternion."""
    return quaternion_to_angle_axis(rotation_matrix_to_quaternion(R))


rotation_matrix_to_axis_angle = rotation_matrix_to_angle_axis
# both spellings are the reference's public surface
axis_angle_to_quaternion = angle_axis_to_quaternion
quaternion_to_axis_angle = quaternion_to_angle_axis


def quaternion_log_to_exp(q_log: torch.Tensor,
                          eps: float = _EPS) -> torch.Tensor:
    """(..., 3) log-quaternion → (..., 4) unit quaternion."""
    q_log = as_float(q_log)
    n = torch.linalg.vector_norm(q_log, dim=-1, keepdim=True)
    return torch.cat([torch.cos(n), q_log * torch.sin(n) / n.clamp_min(eps)],
                     dim=-1)


def quaternion_exp_to_log(q: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """(..., 4) unit quaternion → (..., 3)."""
    q = as_float(q)
    xyz = q[..., 1:]
    n = torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    return xyz * torch.atan2(n, q[..., :1]) / n.clamp_min(eps)


def euler_from_quaternion(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                          z: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """wxyz → (roll, pitch, yaw), XYZ Euler angles."""
    yy = y * y
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + yy))
    sinp = 2.0 * (w * y - z * x)
    pitch = torch.where(sinp.abs() >= 1.0, torch.sign(sinp) * (math.pi / 2.0),
                        torch.asin(sinp.clamp(-1, 1)))
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (yy + z * z))
    return roll, pitch, yaw


def quaternion_from_euler(roll: torch.Tensor, pitch: torch.Tensor,
                          yaw: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor]:
    """(roll, pitch, yaw) → the w, x, y, z components."""
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    return (cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
            cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy)


def normal_transform_pixel3d(depth: int, height: int, width: int,
                             dtype: torch.dtype = torch.float32,
                             device=None) -> torch.Tensor:
    """(1, 4, 4): voxel coordinates → [-1, 1]."""
    return torch.tensor(
        [[2.0 / max(width - 1, 1), 0.0, 0.0, -1.0],
         [0.0, 2.0 / max(height - 1, 1), 0.0, -1.0],
         [0.0, 0.0, 2.0 / max(depth - 1, 1), -1.0],
         [0.0, 0.0, 0.0, 1.0]], dtype=dtype, device=device)[None]


def normalize_homography3d(H: torch.Tensor, dsize_src: Tuple[int, int, int],
                           dsize_dst: Tuple[int, int, int]) -> torch.Tensor:
    """Voxel-space (..., 4, 4) homography → normalized coordinates."""
    src_tr = normal_transform_pixel3d(*dsize_src, H.dtype, H.device)
    dst_tr = normal_transform_pixel3d(*dsize_dst, H.dtype, H.device)
    return dst_tr @ H @ torch.linalg.inv(src_tr)


def denormalize_points_with_intrinsics(points: torch.Tensor,
                                       K: torch.Tensor) -> torch.Tensor:
    """Normalized camera coordinates (..., N, 2) → pixel coordinates."""
    fx = K[..., 0, 0][..., None]
    fy = K[..., 1, 1][..., None]
    cx = K[..., 0, 2][..., None]
    cy = K[..., 1, 2][..., None]
    return torch.stack([points[..., 0] * fx + cx, points[..., 1] * fy + cy],
                       dim=-1)


def Rt_to_matrix4x4(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3), (..., 3, 1) → (..., 4, 4)."""
    return _append_unit_row(torch.cat([R, t], dim=-1))


def matrix4x4_to_Rt(M: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return M[..., :3, :3], M[..., :3, 3:4]


def camtoworld_to_worldtocam_Rt(R: torch.Tensor, t: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t)


def worldtocam_to_camtoworld_Rt(R: torch.Tensor, t: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t)


def _graphics_flip(M: torch.Tensor) -> torch.Tensor:
    return torch.diag(torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=M.dtype,
                                   device=M.device))


def camtoworld_graphics_to_vision_4x4(M: torch.Tensor) -> torch.Tensor:
    """OpenGL (y up, z back) → vision (y down, z forward)."""
    return M @ _graphics_flip(M)


def camtoworld_vision_to_graphics_4x4(M: torch.Tensor) -> torch.Tensor:
    return M @ _graphics_flip(M)


def ARKitQTVecs_to_ColmapQTVecs(qvec: torch.Tensor, tvec: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ARKit camera-to-world (graphics) → COLMAP world-to-camera
    (vision)."""
    R = quaternion_to_rotation_matrix(qvec)
    t = tvec.reshape(*tvec.shape[:-1], 3, 1)
    M = camtoworld_graphics_to_vision_4x4(Rt_to_matrix4x4(R, t))
    R3, t3 = camtoworld_to_worldtocam_Rt(*matrix4x4_to_Rt(M))
    return rotation_matrix_to_quaternion(R3), t3[..., 0]


def angle_to_rotation_matrix(angle: torch.Tensor) -> torch.Tensor:
    """Angles in degrees (any shape) → (*, 2, 2) rotation matrices."""
    ang = deg2rad(as_float(angle))
    c, s = torch.cos(ang), torch.sin(ang)
    return torch.stack([c, s, -s, c], dim=-1).reshape(*ang.shape, 2, 2)


def camtoworld_graphics_to_vision_Rt(R: torch.Tensor, t: torch.Tensor
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flip the y and z axes of a camera-to-world pose: OpenGL → OpenCV."""
    check_shape(R, ["B", "3", "3"], "R")
    check_shape(t, ["B", "3", "1"], "t")
    return matrix4x4_to_Rt(
        camtoworld_graphics_to_vision_4x4(Rt_to_matrix4x4(R, t)))


def camtoworld_vision_to_graphics_Rt(R: torch.Tensor, t: torch.Tensor
                                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flip the y and z axes of a camera-to-world pose: OpenCV → OpenGL."""
    check_shape(R, ["B", "3", "3"], "R")
    check_shape(t, ["B", "3", "1"], "t")
    return matrix4x4_to_Rt(
        camtoworld_vision_to_graphics_4x4(Rt_to_matrix4x4(R, t)))
