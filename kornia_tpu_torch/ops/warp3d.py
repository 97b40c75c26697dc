"""Volumetric warping (counterpart of ``kornia_tpu/ops/warp3d.py``):
``grid_sample3d`` (trilinear or nearest, as eight or one flat gathers
written as the reference writes them), the affine and projective 3-D warps
and their matrices, and the 3-D crops. The 4x4 matrix algebra runs in true
f32 (TF32 off)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.check import check, check_shape
from ..core.dtype import as_float
from ..core.grid import create_meshgrid3d
from ..core.linalg import f32_matmul_precision

__all__ = [
    "grid_sample3d",
    "warp_affine3d",
    "warp_perspective3d",
    "get_projective_transform",
    "affine3d",
    "rotate3d",
    "crop_by_boxes3d",
    "center_crop3d",
    "crop3d",
    "warp_grid3d", "homography_warp3d", "get_perspective_transform3d",
    "get_shear_matrix3d", "get_affine_matrix3d", "crop_and_resize3d",
    "crop_by_transform_mat3d",
]


def grid_sample3d(volume: torch.Tensor, grid: torch.Tensor,
                  mode: str = "bilinear", padding_mode: str = "zeros",
                  align_corners: bool = True) -> torch.Tensor:
    """Sample (B, C, D, H, W) at a normalized grid (B, Do, Ho, Wo, 3) of
    (x, y, z): trilinear (8 gathers) or nearest; outside the volume zeros,
    or the border value for any other padding mode."""
    volume = as_float(volume)
    B, C, D, H, W = volume.shape
    Do, Ho, Wo = grid.shape[1:4]
    dtype = volume.dtype

    def unnorm(c, size):
        if align_corners:
            return (c + 1.0) * 0.5 * (size - 1)
        return ((c + 1.0) * size - 1.0) * 0.5

    gx = unnorm(grid[..., 0].to(dtype), W)
    gy = unnorm(grid[..., 1].to(dtype), H)
    gz = unnorm(grid[..., 2].to(dtype), D)
    flat = volume.reshape(B, C, D * H * W)

    def tap(iz, iy, ix):
        idx = ((iz.clamp(0, D - 1) * H + iy.clamp(0, H - 1)) * W
               + ix.clamp(0, W - 1))
        v = torch.gather(flat, 2, idx.reshape(B, 1, -1).expand(
            B, C, Do * Ho * Wo)).reshape(B, C, Do, Ho, Wo)
        if padding_mode == "zeros":
            valid = ((ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
                     & (iz >= 0) & (iz < D))
            v = v * valid[:, None].to(dtype)
        return v

    if mode == "nearest":
        return tap(torch.round(gz).long(), torch.round(gy).long(),
                   torch.round(gx).long())
    x0, y0, z0 = torch.floor(gx), torch.floor(gy), torch.floor(gz)
    wx, wy, wz = (gx - x0)[:, None], (gy - y0)[:, None], (gz - z0)[:, None]
    x0i, y0i, z0i = x0.long(), y0.long(), z0.long()
    out = torch.zeros((B, C, Do, Ho, Wo), dtype=dtype, device=volume.device)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                w = ((wz if dz else 1 - wz) * (wy if dy else 1 - wy)
                     * (wx if dx else 1 - wx))
                out = out + w * tap(z0i + dz, y0i + dy, x0i + dx)
    return out


def _bottom_row(B: int, dtype, device) -> torch.Tensor:
    return torch.tensor([[[0.0, 0.0, 0.0, 1.0]]], dtype=dtype,
                        device=device).expand(B, 1, 4)


@f32_matmul_precision
def get_projective_transform(center: torch.Tensor, angles: torch.Tensor,
                             scales: torch.Tensor) -> torch.Tensor:
    """(B, 3, 4) rotation about `center`, `angles` (B, 3) in degrees read
    as an axis-angle vector (not Euler angles), each column scaled by
    `scales` ((B, 1) isotropic or (B, 3))."""
    # imported here, as the reference does: the geometry package imports
    # this module
    from ..geometry.conversions import axis_angle_to_rotation_matrix
    center = as_float(center)
    R = axis_angle_to_rotation_matrix(torch.deg2rad(as_float(angles)))
    scales = torch.as_tensor(scales, dtype=R.dtype, device=R.device)
    if scales.ndim == 1:
        scales = scales[:, None]
    R = R @ (torch.eye(3, dtype=R.dtype, device=R.device)
             * scales[:, None, :])
    t = center[..., None] - R @ center[..., None]
    return torch.cat([R, t], dim=-1)


def affine3d(tensor: torch.Tensor, matrix: torch.Tensor,
             mode: str = "bilinear", padding_mode: str = "zeros",
             align_corners: bool = False) -> torch.Tensor:
    """A (B, 3, 4) affine applied to (B, C, D, H, W), size kept."""
    tensor = as_float(tensor)
    return warp_affine3d(tensor, matrix, tuple(tensor.shape[-3:]), mode,
                         padding_mode, align_corners)


def rotate3d(tensor: torch.Tensor, yaw: torch.Tensor, pitch: torch.Tensor,
             roll: torch.Tensor, center: Optional[torch.Tensor] = None,
             mode: str = "bilinear", padding_mode: str = "zeros",
             align_corners: bool = False) -> torch.Tensor:
    """Rotate (B, C, D, H, W) counter-clockwise about its centre by the
    axis-angle (yaw, pitch, roll) in degrees."""
    tensor = as_float(tensor)
    B = tensor.shape[0]
    D, H, W = tensor.shape[-3:]
    dt, dev = tensor.dtype, tensor.device
    if center is None:
        center = torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0, (D - 1) / 2.0],
                              dtype=dt, device=dev)
    center = torch.as_tensor(center, dtype=dt, device=dev).expand(B, 3)
    ypr = torch.stack([torch.as_tensor(a, dtype=dt, device=dev).expand(B)
                       for a in (yaw, pitch, roll)], dim=-1)
    M = get_projective_transform(center, ypr,
                                 torch.ones((B, 1), dtype=dt, device=dev))
    return affine3d(tensor, M, mode, padding_mode, align_corners)


def warp_affine3d(src: torch.Tensor, M: torch.Tensor,
                  dsize: Tuple[int, int, int], flags: str = "bilinear",
                  padding_mode: str = "zeros",
                  align_corners: bool = True) -> torch.Tensor:
    """(B, C, D, H, W) warped by (B, 3, 4) affines M: src → dst."""
    src = as_float(src)
    check_shape(M, ["B", "3", "4"], "M")
    M4 = torch.cat([M.to(src.dtype),
                    _bottom_row(src.shape[0], src.dtype, src.device)], dim=1)
    return warp_perspective3d(src, M4, dsize, flags, padding_mode,
                              align_corners)


def _norm_mat(d: int, h: int, w: int, dtype, device) -> torch.Tensor:
    """4x4: voxel coordinates → [-1, 1]³."""
    tr = torch.eye(4, dtype=dtype, device=device)
    tr[0, 0] = 2.0 / max(w - 1, 1)
    tr[1, 1] = 2.0 / max(h - 1, 1)
    tr[2, 2] = 2.0 / max(d - 1, 1)
    tr[:3, 3] = -1.0
    return tr


def _transform_grid3d(M: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4) applied to (B, N, 3) points, divided by w (guarded)."""
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    out = torch.einsum("bij,bnj->bni", M, ph)
    w_ = out[..., 3:4]
    return out[..., :3] / torch.where(w_.abs() > 1e-8, w_, 1e-8)


@f32_matmul_precision
def warp_perspective3d(src: torch.Tensor, M: torch.Tensor,
                       dsize: Tuple[int, int, int], flags: str = "bilinear",
                       padding_mode: str = "zeros",
                       align_corners: bool = True) -> torch.Tensor:
    """(B, C, D, H, W) warped by (B, 4, 4) projective transforms M: src →
    dst, to `dsize`; without `align_corners` the destination grid takes
    half-voxel centres, as ``F.affine_grid`` does."""
    src = as_float(src)
    B, C, D, H, W = src.shape
    Do, Ho, Wo = dsize
    f32, dev = torch.float32, src.device
    M_norm = (_norm_mat(Do, Ho, Wo, f32, dev)[None] @ M.to(f32)
              @ torch.linalg.inv(_norm_mat(D, H, W, f32, dev))[None])
    M_inv = torch.linalg.inv(M_norm).to(src.dtype)
    grid = create_meshgrid3d(Do, Ho, Wo, True, src.dtype, dev)
    if not align_corners:
        grid = grid * torch.tensor([(Wo - 1) / Wo, (Ho - 1) / Ho,
                                    (Do - 1) / Do], dtype=src.dtype,
                                   device=dev)
    pts = grid.reshape(1, -1, 3).expand(B, Do * Ho * Wo, 3)
    grid_w = _transform_grid3d(M_inv, pts).reshape(B, Do, Ho, Wo, 3)
    return grid_sample3d(src, grid_w, flags, padding_mode, align_corners)


@f32_matmul_precision
def crop_by_boxes3d(src: torch.Tensor, src_box: torch.Tensor,
                    dst_box: torch.Tensor,
                    dsize: Tuple[int, int, int]) -> torch.Tensor:
    """Crop by the least-squares affine taking the dst hexahedron (B, 8, 3)
    to the src one."""
    src_pts = as_float(src_box)
    dst_pts = as_float(dst_box)
    B = src_pts.shape[0]
    A = torch.cat([dst_pts, torch.ones((B, 8, 1), dtype=dst_pts.dtype,
                                       device=dst_pts.device)], dim=-1)
    AtA = torch.einsum("bni,bnj->bij", A, A)
    Atb = torch.einsum("bni,bnk->bik", A, src_pts)
    eye = torch.eye(4, dtype=torch.float32, device=A.device)
    Mls = torch.linalg.solve((AtA + 1e-8 * eye).to(torch.float32),
                             Atb.to(torch.float32))
    M44 = torch.cat([Mls.transpose(-1, -2),
                     _bottom_row(B, torch.float32, A.device)], dim=1)
    return warp_perspective3d(src, torch.linalg.inv(M44).to(src.dtype),
                              dsize)


def crop3d(src: torch.Tensor, start: Tuple[int, int, int],
           size: Tuple[int, int, int]) -> torch.Tensor:
    """The (D, H, W) window at `start` of `size`."""
    (z, y, x), (d, h, w) = start, size
    return src[:, :, z:z + d, y:y + h, x:x + w]


def center_crop3d(src: torch.Tensor,
                  size: Tuple[int, int, int]) -> torch.Tensor:
    D, H, W = src.shape[-3:]
    d, h, w = size
    return crop3d(src, ((D - d) // 2, (H - h) // 2, (W - w) // 2), size)


def warp_grid3d(grid: torch.Tensor, src_homo_dst: torch.Tensor
                ) -> torch.Tensor:
    """A (1|B, D, H, W, 3) grid transformed by (B, 4, 4) homographies."""
    B = src_homo_dst.shape[0]
    D, H, W = grid.shape[-4:-1]
    pts = grid.reshape(-1, D * H * W, 3).expand(B, D * H * W, 3).to(
        src_homo_dst.dtype)
    return _transform_grid3d(src_homo_dst, pts).reshape(B, D, H, W, 3)


def homography_warp3d(patch_src: torch.Tensor, src_homo_dst: torch.Tensor,
                      dsize: Tuple[int, int, int], mode: str = "bilinear",
                      padding_mode: str = "zeros",
                      align_corners: bool = False,
                      normalized_coordinates: bool = True) -> torch.Tensor:
    """Warp (B, C, D, H, W) by normalized-coordinate 3-D homographies."""
    patch_src = as_float(patch_src)
    D, H, W = dsize
    grid = create_meshgrid3d(D, H, W, normalized_coordinates,
                             patch_src.dtype, patch_src.device)
    warped = warp_grid3d(grid, src_homo_dst.to(patch_src.dtype))
    return grid_sample3d(patch_src, warped, mode, padding_mode,
                         align_corners)


def get_perspective_transform3d(src: torch.Tensor,
                                dst: torch.Tensor) -> torch.Tensor:
    """(B, 4, 4) projective transforms from corners 0, 1, 2, 5 and 7 of
    (B, 8, 3) box pairs (the reference's 15x15 system)."""
    src = as_float(src)
    dst = as_float(dst).to(src.dtype)
    check(tuple(src.shape[-2:]) == (8, 3) and src.shape == dst.shape,
          f"expected (B, 8, 3) pairs, got {tuple(src.shape)} / "
          f"{tuple(dst.shape)}")
    B = src.shape[0]
    idx = torch.tensor([0, 1, 2, 5, 7], device=src.device)
    s, d = src[:, idx], dst[:, idx]
    sh = torch.cat([s, torch.ones_like(s[..., :1])], dim=-1)
    zeros = torch.zeros_like(sh)

    def rows(axis):
        blocks = [zeros, zeros, zeros]
        blocks[axis] = sh
        return torch.cat(blocks + [-s * d[..., axis:axis + 1]], dim=-1)

    A = torch.cat([rows(0), rows(1), rows(2)], dim=1)
    b = torch.cat([d[..., 0], d[..., 1], d[..., 2]], dim=1)[..., None]
    X = torch.linalg.solve(A, b)[..., 0]
    return torch.cat([X, torch.ones((B, 1), dtype=src.dtype,
                                    device=src.device)], dim=-1).reshape(
        B, 4, 4)


def _shear_matrix3d_entries(sxy, sxz, syx, syz, szx, szy):
    ones = torch.ones_like(sxy)
    m00, m10, m20 = ones, sxy, sxz
    m01 = syx
    m11 = sxy * syx + ones
    m21 = sxz * syx + syz
    m02 = syx * szy + szx
    m12 = sxy * szx + szy * m11
    m22 = sxz * szx + szy * m21 + ones
    return m00, m10, m20, m01, m11, m21, m02, m12, m22


def get_shear_matrix3d(center: torch.Tensor, sxy=None, sxz=None, syx=None,
                       syz=None, szx=None, szy=None) -> torch.Tensor:
    """(B, 4, 4) ordered 3-D shear about `center` (angles in radians): the
    offsets from the positive tangents, the linear part from the negative
    ones, as the reference composes it."""
    center = as_float(center)
    B = center.shape[0]
    dt, dev = center.dtype, center.device
    tans = [torch.tan(torch.zeros(B, dtype=dt, device=dev) if v is None else
                      torch.as_tensor(v, dtype=dt, device=dev).expand(B))
            for v in (sxy, sxz, syx, syz, szx, szy)]
    x, y, zc = center[:, 0], center[:, 1], center[:, 2]
    m00, m10, m20, m01, m11, m21, m02, m12, m22 = \
        _shear_matrix3d_entries(*tans)
    m03 = m01 * y + m02 * zc
    m13 = m10 * x + m11 * y + m12 * zc - y
    m23 = m20 * x + m21 * y + m22 * zc - zc
    m00, m10, m20, m01, m11, m21, m02, m12, m22 = \
        _shear_matrix3d_entries(*[-t for t in tans])
    rows = torch.stack([m00, m01, m02, m03, m10, m11, m12, m13,
                        m20, m21, m22, m23], dim=-1).reshape(B, 3, 4)
    return torch.cat([rows, _bottom_row(B, dt, dev)], dim=1)


@f32_matmul_precision
def get_affine_matrix3d(translations: torch.Tensor, center: torch.Tensor,
                        scale: torch.Tensor, angles: torch.Tensor,
                        sxy=None, sxz=None, syx=None, syz=None,
                        szx=None, szy=None) -> torch.Tensor:
    """(B, 4, 4) from translation, centre, scale and axis-angle degrees
    (and the shears, if any)."""
    M = get_projective_transform(center, -as_float(angles), scale)
    M = torch.cat([M[..., :3], M[..., 3:] + as_float(translations)[..., None]],
                  dim=-1)
    M4 = torch.cat([M, _bottom_row(M.shape[0], M.dtype, M.device)], dim=1)
    if any(s is not None for s in (sxy, sxz, syx, syz, szx, szy)):
        M4 = M4 @ get_shear_matrix3d(center, sxy, sxz, syx, syz, szx, szy)
    return M4


def crop_and_resize3d(src: torch.Tensor, boxes: torch.Tensor,
                      size: Tuple[int, int, int],
                      interpolation: str = "bilinear",
                      align_corners: bool = False) -> torch.Tensor:
    """(B, 8, 3)-vertex sub-volumes resampled to `size`."""
    d, h, w = size
    dst = torch.tensor(
        [[0, 0, 0], [w - 1, 0, 0], [w - 1, h - 1, 0], [0, h - 1, 0],
         [0, 0, d - 1], [w - 1, 0, d - 1], [w - 1, h - 1, d - 1],
         [0, h - 1, d - 1]], dtype=torch.float32,
        device=boxes.device).expand(boxes.shape[0], 8, 3)
    return crop_by_boxes3d(src, boxes, dst, size)


def crop_by_transform_mat3d(src: torch.Tensor, transform: torch.Tensor,
                            out_size: Tuple[int, int, int],
                            mode: str = "bilinear",
                            padding_mode: str = "zeros",
                            align_corners: bool = True) -> torch.Tensor:
    """``warp_affine3d`` with a (B, 4, 4) crop transform."""
    return warp_affine3d(src, as_float(transform)[:, :3, :], out_size, mode,
                         padding_mode, align_corners)
