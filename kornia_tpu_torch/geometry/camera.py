"""Camera models (counterpart of ``kornia_tpu/geometry/camera.py``):
pinhole, z = 1 and orthographic projections and their inverses, the
affine and Kannala-Brandt (fisheye) distortions, ``cam2pixel`` /
``pixel2cam``, the projection and distortion Jacobians, and the batched
``PinholeCamera`` and rectified ``StereoCamera`` as plain classes holding
tensors.

Distortions are pure functions of (points, params), so any of them
composes with any projection. The Kannala-Brandt inverse is Newton's
method with a fixed trip count (8), as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch
from torch.func import jacfwd, vmap

from ..core.dtype import as_float

__all__ = [
    "PinholeCamera",
    "project_points",
    "unproject_points",
    "project_points_z1",
    "unproject_points_z1",
    "project_points_orthographic",
    "unproject_points_orthographic",
    "distort_points_affine",
    "undistort_points_affine",
    "distort_points_kannala_brandt",
    "undistort_points_kannala_brandt",
    "cam2pixel",
    "pixel2cam",
    "StereoCamera",
    "dx_distort_points_affine",
    "dx_distort_points_kannala_brandt",
    "dx_project_points_z1",
    "dx_project_points_orthographic",
]


def _safe(z: torch.Tensor, eps: float) -> torch.Tensor:
    """z where |z| > eps, else eps (the reference's guarded divisor)."""
    return torch.where(z.abs() > eps, z, torch.full_like(z, eps))


# -----------------------------------------------------------------------------
# Projections
# -----------------------------------------------------------------------------

def project_points(points_3d: torch.Tensor,
                   camera_matrix: torch.Tensor) -> torch.Tensor:
    """(..., 3) camera points and (..., 3, 3) K → (..., 2) pixels."""
    points_3d = as_float(points_3d)
    xy = points_3d[..., :2] / _safe(points_3d[..., 2:3], 1e-8)
    u = xy[..., 0] * camera_matrix[..., 0, 0] + camera_matrix[..., 0, 2]
    v = xy[..., 1] * camera_matrix[..., 1, 1] + camera_matrix[..., 1, 2]
    return torch.stack([u, v], dim=-1)


def unproject_points(points_2d: torch.Tensor, depth: torch.Tensor,
                     camera_matrix: torch.Tensor,
                     normalize: bool = False) -> torch.Tensor:
    """(..., 2) pixels and their depth ((...) or (..., 1)) → (..., 3) camera
    points; with `normalize` the ray has unit length before the depth
    scales it."""
    points_2d = as_float(points_2d)
    depth = as_float(depth)
    x = (points_2d[..., 0] - camera_matrix[..., 0, 2]) \
        / camera_matrix[..., 0, 0]
    y = (points_2d[..., 1] - camera_matrix[..., 1, 2]) \
        / camera_matrix[..., 1, 1]
    xyz = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    if normalize:
        xyz = xyz / torch.linalg.vector_norm(xyz, dim=-1, keepdim=True)
    if depth.ndim == xyz.ndim - 1:
        depth = depth[..., None]
    return xyz * depth


def project_points_z1(points_3d: torch.Tensor) -> torch.Tensor:
    """The perspective divide onto the z = 1 plane."""
    return points_3d[..., :2] / _safe(points_3d[..., 2:3], 1e-8)


def unproject_points_z1(points_2d: torch.Tensor,
                        extension: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    if extension is None:
        extension = torch.ones_like(points_2d[..., :1])
    elif extension.ndim == points_2d.ndim - 1:
        extension = extension[..., None]
    return torch.cat([points_2d * extension, extension], dim=-1)


def project_points_orthographic(points_3d: torch.Tensor) -> torch.Tensor:
    return points_3d[..., :2]


def unproject_points_orthographic(points_2d: torch.Tensor,
                                  extension: torch.Tensor) -> torch.Tensor:
    if extension.ndim == points_2d.ndim - 1:
        extension = extension[..., None]
    return torch.cat([points_2d, extension], dim=-1)


# -----------------------------------------------------------------------------
# Distortion models
# -----------------------------------------------------------------------------

def distort_points_affine(points: torch.Tensor,
                          params: torch.Tensor) -> torch.Tensor:
    """params (..., 4) = (fx, fy, cx, cy)."""
    return torch.stack([points[..., 0] * params[..., 0] + params[..., 2],
                        points[..., 1] * params[..., 1] + params[..., 3]],
                       dim=-1)


def undistort_points_affine(points: torch.Tensor,
                            params: torch.Tensor) -> torch.Tensor:
    return torch.stack([(points[..., 0] - params[..., 2]) / params[..., 0],
                        (points[..., 1] - params[..., 3]) / params[..., 1]],
                       dim=-1)


def distort_points_kannala_brandt(points: torch.Tensor,
                                  params: torch.Tensor) -> torch.Tensor:
    """Fisheye distortion of z = 1 plane points; params (..., 8) =
    (fx, fy, cx, cy, k1, k2, k3, k4)."""
    points = as_float(points)
    fx, fy, cx, cy, k1, k2, k3, k4 = params.unbind(-1)
    x, y = points[..., 0], points[..., 1]
    r = torch.sqrt(x * x + y * y + 1e-12)
    theta = torch.atan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = theta_d / r
    return torch.stack([fx * scale * x + cx, fy * scale * y + cy], dim=-1)


def undistort_points_kannala_brandt(points: torch.Tensor,
                                    params: torch.Tensor,
                                    iters: int = 8) -> torch.Tensor:
    """Newton's inversion of the fisheye model, `iters` steps."""
    points = as_float(points)
    fx, fy, cx, cy, k1, k2, k3, k4 = params.unbind(-1)
    un = (points[..., 0] - cx) / fx
    vn = (points[..., 1] - cy) / fy
    theta_d = torch.sqrt(un * un + vn * vn + 1e-12)
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        poly = 1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4)))
        dpoly = (3.0 * k1 * t2 + 5.0 * k2 * t2 ** 2 + 7.0 * k3 * t2 ** 3
                 + 9.0 * k4 * t2 ** 4)
        theta = theta - (theta * poly - theta_d) / _safe(poly + dpoly, 1e-8)
    scale = torch.tan(theta) / theta_d.clamp_min(1e-12)
    return torch.stack([un * scale, vn * scale], dim=-1)


# -----------------------------------------------------------------------------
# PinholeCamera
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Batched pinhole camera: intrinsics (B, 4, 4), world→camera
    extrinsics (B, 4, 4), image heights and widths (B,)."""

    intrinsics: torch.Tensor
    extrinsics: torch.Tensor
    height: torch.Tensor
    width: torch.Tensor

    @classmethod
    def from_parameters(cls, fx, fy, cx, cy, height, width, tx=None,
                        ty=None, tz=None, batch_size: Optional[int] = None,
                        device: Union[str, torch.device] = "cuda"
                        ) -> "PinholeCamera":
        """From per-camera scalars or (B,) tensors: on the device of the
        first tensor among them, or on `device` when all are numbers."""
        given = [v.device for v in (fx, fy, cx, cy, height, width, tx, ty, tz)
                 if isinstance(v, torch.Tensor)]
        device = given[0] if given else device

        def col(v):
            return torch.as_tensor(v, dtype=torch.float32, device=device)

        fx = torch.atleast_1d(col(fx))
        B = fx.shape[0]
        K = torch.eye(4, dtype=torch.float32, device=device).repeat(B, 1, 1)
        for (i, j), v in (((0, 0), fx), ((1, 1), fy), ((0, 2), cx),
                          ((1, 2), cy)):
            K[:, i, j] = col(v).expand(B)
        E = torch.eye(4, dtype=torch.float32, device=device).repeat(B, 1, 1)
        for i, v in enumerate((tx, ty, tz)):
            if v is not None:
                E[:, i, 3] = col(v).expand(B)
        return cls(K, E, col(height).expand(B).clone(),
                   col(width).expand(B).clone())

    @property
    def batch_size(self) -> int:
        return self.intrinsics.shape[0]

    @property
    def fx(self):
        return self.intrinsics[..., 0, 0]

    @property
    def fy(self):
        return self.intrinsics[..., 1, 1]

    @property
    def cx(self):
        return self.intrinsics[..., 0, 2]

    @property
    def cy(self):
        return self.intrinsics[..., 1, 2]

    @property
    def tx(self):
        return self.extrinsics[..., 0, 3]

    @property
    def ty(self):
        return self.extrinsics[..., 1, 3]

    @property
    def tz(self):
        return self.extrinsics[..., 2, 3]

    @property
    def camera_matrix(self) -> torch.Tensor:
        return self.intrinsics[..., :3, :3]

    @property
    def rotation_matrix(self) -> torch.Tensor:
        return self.extrinsics[..., :3, :3]

    @property
    def translation_vector(self) -> torch.Tensor:
        return self.extrinsics[..., :3, 3:4]

    def intrinsics_inverse(self) -> torch.Tensor:
        out = torch.eye(4, dtype=self.intrinsics.dtype,
                        device=self.intrinsics.device).expand(
            self.intrinsics.shape).clone()
        out[..., 0, 0] = 1.0 / self.fx
        out[..., 1, 1] = 1.0 / self.fy
        out[..., 0, 2] = -self.cx / self.fx
        out[..., 1, 2] = -self.cy / self.fy
        return out

    def project(self, points_3d: torch.Tensor) -> torch.Tensor:
        """World points (..., N, 3) → pixels (..., N, 2)."""
        pc = torch.einsum("...ij,...nj->...ni", self.rotation_matrix,
                          points_3d) \
            + self.translation_vector[..., 0][..., None, :]
        return project_points(pc, self.camera_matrix[..., None, :, :])

    def unproject(self, points_2d: torch.Tensor,
                  depth: torch.Tensor) -> torch.Tensor:
        """Pixels (..., N, 2) and depths → world points (..., N, 3)."""
        pc = unproject_points(points_2d, depth,
                              self.camera_matrix[..., None, :, :])
        Rt = self.rotation_matrix.transpose(-1, -2)
        return torch.einsum("...ij,...nj->...ni", Rt,
                            pc - self.translation_vector[..., 0][..., None, :])

    def scale(self, factor) -> "PinholeCamera":
        f = torch.as_tensor(factor, dtype=self.intrinsics.dtype,
                            device=self.intrinsics.device)
        K = self.intrinsics.clone()
        for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)):
            K[..., i, j] = K[..., i, j] * f
        return PinholeCamera(K, self.extrinsics, self.height * f,
                             self.width * f)


def cam2pixel(cam_coords: torch.Tensor, dst_proj: torch.Tensor,
              eps: float = 1e-12) -> torch.Tensor:
    """(B, H, W, 3) camera points and (B, 4, 4) projections → (B, H, W, 2)
    pixels."""
    b, h, w = cam_coords.shape[:3]
    pts = cam_coords.reshape(b, -1, 3)
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    proj = torch.einsum("bij,bnj->bni", dst_proj, ph)
    uv = proj[..., :2] / _safe(proj[..., 2:3], eps)
    return uv.reshape(b, h, w, 2)


def pixel2cam(depth: torch.Tensor, intrinsics_inv: torch.Tensor,
              pixel_coords: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W) depth, (B, 4, 4) K⁻¹ and (B, H, W, 2) pixels →
    (B, H, W, 3) camera points."""
    b, _, h, w = depth.shape
    ones = torch.ones_like(pixel_coords[..., :1])
    ph = torch.cat([pixel_coords, ones, ones], dim=-1).reshape(b, -1, 4)
    cam = torch.einsum("bij,bnj->bni", intrinsics_inv, ph)[..., :3]
    return cam.reshape(b, h, w, 3) * depth[:, 0, :, :, None]


# -----------------------------------------------------------------------------
# Stereo
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StereoCamera:
    """Rectified stereo rig from the left and right rectified (B, 3, 4)
    camera matrices."""

    rectified_left_camera: torch.Tensor
    rectified_right_camera: torch.Tensor

    @property
    def fx(self):
        return self.rectified_left_camera[..., 0, 0]

    @property
    def fy(self):
        return self.rectified_left_camera[..., 1, 1]

    @property
    def cx_left(self):
        return self.rectified_left_camera[..., 0, 2]

    @property
    def cx_right(self):
        return self.rectified_right_camera[..., 0, 2]

    @property
    def cy(self):
        return self.rectified_left_camera[..., 1, 2]

    @property
    def tx(self):
        """The baseline, from the right camera's horizontal offset."""
        return -self.rectified_right_camera[..., 0, 3] / self.fx

    @property
    def Q(self) -> torch.Tensor:
        """(B, 4, 4) disparity-to-depth reprojection matrix."""
        left = self.rectified_left_camera
        Q = torch.zeros((left.shape[0], 4, 4), dtype=left.dtype,
                        device=left.device)
        Q[:, 0, 0] = 1.0
        Q[:, 0, 3] = -self.cx_left
        Q[:, 1, 1] = 1.0
        Q[:, 1, 3] = -self.cy
        Q[:, 2, 3] = self.fx
        Q[:, 3, 2] = 1.0 / self.tx
        Q[:, 3, 3] = (self.cx_left - self.cx_right) / self.tx
        return Q

    def reproject_disparity_to_3D(self, disparity: torch.Tensor
                                  ) -> torch.Tensor:
        """(B, 1, H, W) disparity → (B, H, W, 3) points."""
        B, _, H, W = disparity.shape
        dt, dev = disparity.dtype, disparity.device
        gy, gx = torch.meshgrid(torch.arange(H, dtype=dt, device=dev),
                                torch.arange(W, dtype=dt, device=dev),
                                indexing="ij")
        uvd1 = torch.stack([gx.expand(B, H, W), gy.expand(B, H, W),
                            disparity[:, 0],
                            torch.ones((B, H, W), dtype=dt, device=dev)],
                           dim=-1)
        pts = torch.einsum("bij,bhwj->bhwi", self.Q, uvd1)
        return pts[..., :3] / _safe(pts[..., 3:4], 1e-8)


# -----------------------------------------------------------------------------
# Jacobians
# -----------------------------------------------------------------------------

def dx_distort_points_affine(points: torch.Tensor,
                             params: torch.Tensor) -> torch.Tensor:
    """∂(u, v)/∂(x, y) = diag(fx, fy), (..., 2, 2)."""
    params = as_float(params)
    fx, fy = params[..., 0], params[..., 1]
    z = torch.zeros_like(fx)
    J = torch.stack([torch.stack([fx, z], -1), torch.stack([z, fy], -1)], -2)
    return J.expand(*points.shape[:-1], 2, 2)


def dx_distort_points_kannala_brandt(points: torch.Tensor,
                                     params: torch.Tensor) -> torch.Tensor:
    """The exact (..., 2, 2) fisheye Jacobian by forward-mode autodiff of
    the distortion, point by point."""
    pts = as_float(points)
    lead = pts.shape[:-1]
    flat = pts.reshape(-1, 2)
    prm = as_float(params).expand(*lead, params.shape[-1]).reshape(
        -1, params.shape[-1])
    J = vmap(jacfwd(distort_points_kannala_brandt))(flat, prm)
    return J.reshape(*lead, 2, 2)


def dx_project_points_z1(points_in_camera: torch.Tensor) -> torch.Tensor:
    """∂π/∂X = [[1/z, 0, -x/z²], [0, 1/z, -y/z²]]."""
    p = as_float(points_in_camera)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    inv_z = 1.0 / z
    z0 = torch.zeros_like(x)
    return torch.stack([torch.stack([inv_z, z0, -x * inv_z * inv_z], -1),
                        torch.stack([z0, inv_z, -y * inv_z * inv_z], -1)],
                       -2)


def dx_project_points_orthographic(points_in_camera: torch.Tensor
                                   ) -> torch.Tensor:
    """Constant 1, (..., 1)."""
    return torch.ones_like(as_float(points_in_camera)[..., 0:1])
