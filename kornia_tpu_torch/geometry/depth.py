"""Depth-map geometry (counterpart of ``kornia_tpu/geometry/depth.py``):
depth to camera points and surface normals, depth from disparity or a
plane, and view synthesis by warping with a depth map."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.check import check_shape
from ..core.dtype import as_float
from ..core.grid import create_meshgrid, normalize_pixel_coordinates
from ..ops.filters import spatial_gradient
from ..ops.warp import grid_sample
from .camera import cam2pixel, pixel2cam, project_points

__all__ = [
    "depth_to_3d",
    "depth_to_3d_v2",
    "depth_to_normals",
    "depth_from_disparity",
    "depth_from_plane_equation",
    "warp_frame_depth",
    "unproject_meshgrid",
    "DepthWarper",
    "depth_warp",
]


def unproject_meshgrid(height: int, width: int,
                       camera_matrix: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) rays through every pixel on the z = 1 plane."""
    grid = create_meshgrid(height, width, False, camera_matrix.dtype,
                           camera_matrix.device)[0]
    fx = camera_matrix[..., 0, 0][..., None, None]
    fy = camera_matrix[..., 1, 1][..., None, None]
    cx = camera_matrix[..., 0, 2][..., None, None]
    cy = camera_matrix[..., 1, 2][..., None, None]
    x = (grid[..., 0] - cx) / fx
    y = (grid[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _rays(H: int, W: int, camera_matrix: torch.Tensor,
          normalize_points: bool) -> torch.Tensor:
    rays = unproject_meshgrid(H, W, camera_matrix)
    if normalize_points:
        rays = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)
    return rays


def depth_to_3d(depth: torch.Tensor, camera_matrix: torch.Tensor,
                normalize_points: bool = False) -> torch.Tensor:
    """(B, 1, H, W) depth → (B, 3, H, W) camera points."""
    check_shape(depth, ["B", "1", "H", "W"], "depth")
    depth = as_float(depth)
    _, _, H, W = depth.shape
    rays = _rays(H, W, camera_matrix, normalize_points)
    if rays.ndim == 3:
        rays = rays[None]
    return (rays * depth[:, 0, :, :, None]).permute(0, 3, 1, 2)


def depth_to_3d_v2(depth: torch.Tensor, camera_matrix: torch.Tensor,
                   normalize_points: bool = False) -> torch.Tensor:
    """(..., H, W) depth → (..., H, W, 3)."""
    depth = as_float(depth)
    H, W = depth.shape[-2:]
    return _rays(H, W, camera_matrix, normalize_points) * depth[..., None]


def depth_to_normals(depth: torch.Tensor, camera_matrix: torch.Tensor,
                     normalize_points: bool = False) -> torch.Tensor:
    """(B, 3, H, W) unit normals: the cross product of the point cloud's
    Sobel gradients along x and y."""
    pts = depth_to_3d(depth, camera_matrix, normalize_points)
    g = spatial_gradient(pts)                     # (B, 3, 2, H, W)
    a = g[:, :, 0].permute(0, 2, 3, 1)
    b = g[:, :, 1].permute(0, 2, 3, 1)
    normals = torch.linalg.cross(a, b, dim=-1)
    n = torch.linalg.vector_norm(normals, dim=-1, keepdim=True)
    return (normals / n.clamp_min(1e-8)).permute(0, 3, 1, 2)


def depth_from_disparity(disparity: torch.Tensor, baseline,
                         focal) -> torch.Tensor:
    disparity = as_float(disparity)
    baseline = torch.as_tensor(baseline, dtype=disparity.dtype,
                               device=disparity.device)
    focal = torch.as_tensor(focal, dtype=disparity.dtype,
                            device=disparity.device)
    safe = torch.where(disparity.abs() > 1e-8, disparity,
                       torch.full_like(disparity, 1e-8))
    return baseline * focal / safe


def depth_from_plane_equation(plane_normals: torch.Tensor,
                              plane_offsets: torch.Tensor,
                              points_uv: torch.Tensor,
                              camera_matrix: torch.Tensor,
                              eps: float = 1e-8) -> torch.Tensor:
    """Depth of (B, N, 2) pixels on the planes n·X = d, normals (B, 3),
    offsets (B, 1)."""
    fx = camera_matrix[..., 0, 0][..., None]
    fy = camera_matrix[..., 1, 1][..., None]
    cx = camera_matrix[..., 0, 2][..., None]
    cy = camera_matrix[..., 1, 2][..., None]
    x = (points_uv[..., 0] - cx) / fx
    y = (points_uv[..., 1] - cy) / fy
    denom = (plane_normals[..., 0:1] * x + plane_normals[..., 1:2] * y
             + plane_normals[..., 2:3])
    return plane_offsets / torch.where(denom.abs() > eps, denom,
                                       torch.full_like(denom, eps))


def warp_frame_depth(image_src: torch.Tensor, depth_dst: torch.Tensor,
                     src_trans_dst: torch.Tensor,
                     camera_matrix: torch.Tensor,
                     normalize_points: bool = False) -> torch.Tensor:
    """Warp (B, C, H, W) `image_src` into the dst view from the dst depth
    and the (B, 4, 4) dst → src pose (bilinear, zeros outside)."""
    check_shape(image_src, ["B", "C", "H", "W"], "image_src")
    image_src = as_float(image_src)
    B, _, H, W = image_src.shape
    pts = depth_to_3d(depth_dst, camera_matrix, normalize_points)
    pts = pts.permute(0, 2, 3, 1).reshape(B, -1, 3)
    R = src_trans_dst[..., :3, :3]
    t = src_trans_dst[..., :3, 3]
    pts_src = torch.einsum("bij,bnj->bni", R, pts) + t[:, None, :]
    uv = project_points(pts_src, camera_matrix[..., None, :, :]).reshape(
        B, H, W, 2)
    grid = torch.stack([2.0 * uv[..., 0] / max(W - 1, 1) - 1.0,
                        2.0 * uv[..., 1] / max(H - 1, 1) - 1.0], dim=-1)
    return grid_sample(image_src, grid, "bilinear", "zeros", True)


class DepthWarper:
    """Warp a dst-frame patch into the src frame by the src depth. After
    :meth:`compute_projection_matrix` the instance is a callable
    ``warper(depth_src, patch_dst)``."""

    def __init__(self, pinhole_dst, height: int, width: int,
                 mode: str = "bilinear", padding_mode: str = "zeros",
                 align_corners: bool = True):
        self.height, self.width = height, width
        self.mode, self.padding_mode = mode, padding_mode
        self.align_corners = align_corners
        self.eps = 1e-6
        self._pinhole_dst = pinhole_dst
        self._pinhole_src = None
        self._dst_proj_src: Optional[torch.Tensor] = None

    def compute_projection_matrix(self, pinhole_src) -> "DepthWarper":
        """dst_proj_src = K_dst · E_dst · E_src⁻¹."""
        src_E = pinhole_src.extrinsics
        R = src_E[..., :3, :3]
        t = src_E[..., :3, 3:]
        Rinv = R.transpose(-1, -2)
        inv_extr = torch.eye(4, dtype=src_E.dtype, device=src_E.device
                             ).expand(src_E.shape).clone()
        inv_extr[..., :3, :3] = Rinv
        inv_extr[..., :3, 3:] = -Rinv @ t
        dst_trans_src = self._pinhole_dst.extrinsics @ inv_extr
        self._dst_proj_src = self._pinhole_dst.intrinsics @ dst_trans_src
        self._pinhole_src = pinhole_src
        return self

    def warp_grid(self, depth_src: torch.Tensor) -> torch.Tensor:
        """Normalised (B, H, W, 2) sampling grid."""
        if self._dst_proj_src is None or self._pinhole_src is None:
            raise ValueError("call compute_projection_matrix first")
        check_shape(depth_src, ["B", "1", "H", "W"], "depth_src")
        B, _, H, W = depth_src.shape
        pix = create_meshgrid(H, W, False, depth_src.dtype,
                              depth_src.device).expand(B, H, W, 2)
        cam_src = pixel2cam(depth_src,
                            self._pinhole_src.intrinsics_inverse(), pix)
        pix_src = cam2pixel(cam_src, self._dst_proj_src)
        return normalize_pixel_coordinates(pix_src, self.height, self.width)

    def __call__(self, depth_src: torch.Tensor,
                 patch_dst: torch.Tensor) -> torch.Tensor:
        return grid_sample(as_float(patch_dst), self.warp_grid(depth_src),
                           self.mode, self.padding_mode, self.align_corners)

    forward = __call__

    def compute_subpixel_step(self) -> torch.Tensor:
        """The inverse-depth step of a sub-pixel accurate depth sweep."""
        delta_d = 0.01
        P = self._dst_proj_src
        cx, cy = self.width / 2.0, self.height / 2.0
        pts = torch.tensor([[cx, cy, 1.0 - delta_d, 1.0],
                            [cx, cy, 1.0 + delta_d, 1.0]], dtype=P.dtype,
                           device=P.device).T[None]
        flow = P @ pts
        z = 1.0 / flow[:, 2]
        xy = torch.stack([flow[:, 0] * z, flow[:, 1] * z], dim=-1)
        dxdd = torch.linalg.vector_norm(xy[:, 1] - xy[:, 0], dim=-1) \
            / (2.0 * delta_d)
        return torch.min(0.5 / dxdd)


def depth_warp(pinhole_dst, pinhole_src, depth_src: torch.Tensor,
               patch_dst: torch.Tensor, height: int, width: int,
               align_corners: bool = True) -> torch.Tensor:
    """One-shot :class:`DepthWarper`."""
    warper = DepthWarper(pinhole_dst, height, width,
                         align_corners=align_corners)
    warper.compute_projection_matrix(pinhole_src)
    return warper(depth_src, patch_dst)
