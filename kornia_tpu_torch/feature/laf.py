"""Local affine frames (counterpart of ``kornia_tpu/feature/laf.py``).

A LAF stack is (B, N, 2, 3): per keypoint an affine frame [A | c] that maps
the unit circle to an image ellipse, c the centre in pixels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..core.check import check_laf
from ..core.dtype import as_float
from ..core.linalg import det_2x2
from ..geometry.linalg import transform_points
from ..ops.kernels import patch_sample
from ..ops.pyramid import pyrdown
from ..ops.warp import grid_sample

__all__ = [
    "get_laf_scale",
    "set_laf_scale",
    "get_laf_center",
    "get_laf_orientation",
    "set_laf_orientation",
    "laf_from_center_scale_ori",
    "scale_laf",
    "make_upright",
    "ellipse_to_laf",
    "laf_to_boundary_points",
    "normalize_laf",
    "denormalize_laf",
    "laf_is_inside_image",
    "laf_from_three_points",
    "laf_to_three_points",
    "rotate_laf",
    "extract_patches_from_pyramid",
    "extract_patches_simple",
    "perspective_transform_lafs",
    "generate_patch_grid_from_normalized_laf",
]


def _rotation(rad: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2) [[c, s], [-s, c]] (image y-down convention)."""
    c, s = torch.cos(rad), torch.sin(rad)
    return torch.stack([torch.stack([c, s], -1), torch.stack([-s, c], -1)],
                       dim=-2)


def get_laf_scale(laf: torch.Tensor) -> torch.Tensor:
    """(B, N, 2, 3) → (B, N, 1, 1) sqrt|det A| (eps added to the signed det
    before the abs, as the reference does)."""
    check_laf(laf)
    d = (det_2x2(laf[..., :2, :2]) + 1e-10).abs()
    return torch.sqrt(d)[..., None, None]


def set_laf_scale(laf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Rescale the linear part to `scale` (B, N, 1, 1)."""
    A = laf[..., :2, :2] * (scale / get_laf_scale(laf))
    return torch.cat([A, laf[..., :2, 2:]], dim=-1)


def scale_laf(laf: torch.Tensor, scale_coef) -> torch.Tensor:
    """Multiply the linear part by a coefficient."""
    A = laf[..., :2, :2] * torch.as_tensor(scale_coef, dtype=laf.dtype,
                                           device=laf.device)
    return torch.cat([A, laf[..., :2, 2:]], dim=-1)


def get_laf_center(laf: torch.Tensor) -> torch.Tensor:
    check_laf(laf)
    return laf[..., :2, 2]


def get_laf_orientation(laf: torch.Tensor) -> torch.Tensor:
    """Degrees (B, N, 1): atan2(A01, A00)."""
    check_laf(laf)
    return torch.rad2deg(torch.atan2(laf[..., 0, 1], laf[..., 0, 0]))[..., None]


def rotate_laf(laf: torch.Tensor, angles_degrees: torch.Tensor) -> torch.Tensor:
    """Right-multiply the linear part by a rotation."""
    rot = _rotation(torch.deg2rad(as_float(angles_degrees))[..., 0])
    A = laf[..., :2, :2] @ rot
    return torch.cat([A, laf[..., :2, 2:]], dim=-1)


def set_laf_orientation(laf: torch.Tensor,
                        angles_degrees: torch.Tensor) -> torch.Tensor:
    return rotate_laf(laf, angles_degrees - get_laf_orientation(laf))


def laf_from_center_scale_ori(xy: torch.Tensor,
                              scale: Optional[torch.Tensor] = None,
                              ori: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """(B, N, 2) centres (+ scale (B, N, 1, 1), orientation in degrees
    (B, N, 1)) → (B, N, 2, 3)."""
    xy = as_float(xy)
    B, N = xy.shape[:2]
    if scale is None:
        scale = torch.ones((B, N, 1, 1), dtype=xy.dtype, device=xy.device)
    if ori is None:
        ori = torch.zeros((B, N, 1), dtype=xy.dtype, device=xy.device)
    A = _rotation(torch.deg2rad(ori[..., 0])) * scale
    return torch.cat([A, xy[..., None]], dim=-1)


def make_upright(laf: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Remove the rotation and keep the ellipse: the lower-triangular square
    root of A·Aᵀ, written the reference's way (l22 = det / |row 0|, which
    does not cancel for near-singular A as sqrt(C11 - l21²) does)."""
    check_laf(laf)
    det = get_laf_scale(laf)[..., 0, 0]  # (B, N)
    a00, a01 = laf[..., 0, 0], laf[..., 0, 1]
    a10, a11 = laf[..., 1, 0], laf[..., 1, 1]
    b2a2 = torch.sqrt(a01 * a01 + a00 * a00) + eps
    l11 = b2a2 / det
    l21 = (a11 * a01 + a10 * a00) / (b2a2 * det)
    l22 = det / b2a2
    L = torch.stack([torch.stack([l11, torch.zeros_like(l11)], -1),
                     torch.stack([l21, l22], -1)], dim=-2) * det[..., None,
                                                                 None]
    return torch.cat([L, laf[..., :2, 2:]], dim=-1)


def ellipse_to_laf(ells: torch.Tensor) -> torch.Tensor:
    """(B, N, 5) ellipses (x, y, a, b, c) of the conic [[a, b], [b, c]] →
    upright LAFs whose linear part is the conic's inverse square root."""
    ells = as_float(ells)
    a, b, c = ells[..., 2], ells[..., 3], ells[..., 4]
    M = torch.stack([torch.stack([a, b], -1), torch.stack([b, c], -1)],
                    dim=-2)
    vals, vecs = torch.linalg.eigh(M)
    d = 1.0 / torch.sqrt(torch.clamp_min(vals, 1e-9))
    inv_sqrt = vecs @ (d[..., None] * vecs.transpose(-1, -2))
    return make_upright(torch.cat([inv_sqrt, ells[..., :2, None]], dim=-1))


def laf_to_boundary_points(laf: torch.Tensor, n_pts: int = 50
                           ) -> torch.Tensor:
    """(B, N, n_pts, 2) points on each LAF's ellipse."""
    check_laf(laf)
    t = torch.linspace(0, 2 * math.pi, n_pts, dtype=laf.dtype,
                       device=laf.device)
    circle = torch.stack([torch.cos(t), torch.sin(t), torch.ones_like(t)],
                         dim=-1)
    return torch.einsum("bnij,pj->bnpi", laf, circle)


def _norm_coef(laf: torch.Tensor, images: torch.Tensor,
               invert: bool) -> torch.Tensor:
    H, W = images.shape[-2:]
    m = float(min(H, W))
    coef = [[m, m, W], [m, m, H]]
    if invert:
        coef = [[1.0 / v for v in row] for row in coef]
    return torch.tensor(coef, dtype=laf.dtype, device=laf.device)


def normalize_laf(laf: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    """Pixels → the image's unit: the linear part over min(H, W), the
    centre over (W, H)."""
    return laf * _norm_coef(laf, images, True)


def denormalize_laf(laf: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    return laf * _norm_coef(laf, images, False)


def laf_is_inside_image(laf: torch.Tensor, images: torch.Tensor,
                        border: int = 0) -> torch.Tensor:
    """(B, N) bool: 12 points of the ellipse all lie inside the image, at
    least `border` pixels from its edge."""
    H, W = images.shape[-2:]
    pts = laf_to_boundary_points(laf, 12)
    ok_x = (pts[..., 0] >= border) & (pts[..., 0] <= W - 1 - border)
    ok_y = (pts[..., 1] >= border) & (pts[..., 1] <= H - 1 - border)
    return torch.all(ok_x & ok_y, dim=-1)


def laf_from_three_points(threepts: torch.Tensor) -> torch.Tensor:
    """(B, N, 2, 3) columns [x-axis point, y-axis point, origin] → LAF."""
    c = threepts[..., :, 2]
    return torch.cat([threepts[..., :, :2] - c[..., None], c[..., None]],
                     dim=-1)


def laf_to_three_points(laf: torch.Tensor) -> torch.Tensor:
    c = laf[..., :, 2]
    return torch.cat([laf[..., :, :2] + c[..., None], c[..., None]], dim=-1)


def perspective_transform_lafs(trans: torch.Tensor,
                               lafs: torch.Tensor) -> torch.Tensor:
    """Map LAFs through (B, 3, 3) homographies, by their three points."""
    check_laf(lafs)
    B, N = lafs.shape[:2]
    pts = laf_to_three_points(lafs).transpose(-1, -2).reshape(B, N * 3, 2)
    warped = transform_points(trans, pts).reshape(B, N, 3, 2)
    return laf_from_three_points(warped.transpose(-1, -2))


def generate_patch_grid_from_normalized_laf(img: torch.Tensor,
                                            laf: torch.Tensor,
                                            PS: int = 32) -> torch.Tensor:
    """(B, N, PS, PS, 2) sampling grid in [-1, 1] for each pixel-unit LAF:
    ``affine_grid(align_corners=False)``'s base grid mapped through the LAF
    and renormalized with the align-corners-true formula, the reference's
    mixed convention."""
    H, W = img.shape[-2:]
    t = torch.linspace(-1.0, 1.0, PS, dtype=laf.dtype,
                       device=laf.device) * ((PS - 1) / PS)
    gy, gx = torch.meshgrid(t, t, indexing="ij")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)
    pix = torch.einsum("bnij,pqj->bnpqi", laf, grid)
    return torch.stack([2.0 * pix[..., 0] / max(W - 1, 1) - 1.0,
                        2.0 * pix[..., 1] / max(H - 1, 1) - 1.0], dim=-1)


def extract_patches_simple(img: torch.Tensor, laf: torch.Tensor,
                           PS: int = 32, normalize_lafs: bool = False
                           ) -> torch.Tensor:
    """(B, N, C, PS, PS) patches sampled from the full-resolution image
    with bilinear ``grid_sample`` ('border', align_corners=False), as the
    reference does. `normalize_lafs` is accepted and unused, as there."""
    img = as_float(img)
    B, N = laf.shape[:2]
    C = img.shape[1]
    grid = generate_patch_grid_from_normalized_laf(img, laf, PS)
    out = grid_sample(img, grid.reshape(B, N * PS, PS, 2), "bilinear",
                      "border", False)
    return out.reshape(B, C, N, PS, PS).permute(0, 2, 1, 3, 4)


def extract_patches_from_pyramid(img: torch.Tensor, laf: torch.Tensor,
                                 PS: int = 32,
                                 normalize_lafs_before: bool = True,
                                 pallas_fallback_budget: int = 64,
                                 patch_mode: Optional[str] = None
                                 ) -> torch.Tensor:
    """Scale-aware patch extraction: each LAF samples the pyramid level
    that matches its scale → (B, N, C, PS, PS).

    All levels are stacked along y into one atlas and every patch sample
    is one bilinear tap of it, through the ``patch_sample`` kernel. Unlike
    the reference's TPU kernel, which reads a 128x256 window per keypoint,
    the kernel has no window, so every keypoint is sampled exactly (the
    reference's CPU path, without its window budget). `patch_mode` is the
    reference's ``pallas_mode``: None, 'split' and 'highest' sample
    exactly, 'bf16' rounds as the TPU kernel's bf16 mode does, on both
    devices (the reference's CPU path ignores the mode). Level bookkeeping
    follows the reference: level = clamp(floor(log2(2·scale / PS))), and
    LAFs past the last level built get zero patches. `normalize_lafs_before`
    is accepted and unused, as in the reference; `pallas_fallback_budget`,
    the reference's count of oversized keypoints its TPU kernel resamples
    outside its window, has no effect here: no keypoint is windowed."""
    img = as_float(img)
    mode = patch_mode or "split"
    B, N = laf.shape[:2]
    C, H, W = img.shape[1:]
    dt, dev = laf.dtype, laf.device
    scale = get_laf_scale(laf)[..., 0, 0]  # (B, N) in pixels
    max_level = min(H, W) // PS
    levels = [img]
    for _ in range(max(1, max_level) - 1):
        nxt = pyrdown(levels[-1])
        if min(nxt.shape[-2:]) < PS:
            break
        levels.append(nxt)
    L = len(levels)
    lvl = torch.floor(torch.log2(torch.clamp_min(2.0 * scale / PS, 1e-6)))
    lvl = lvl.clamp(0, max(0, max_level - 1)).long()
    in_range = lvl <= (L - 1)
    lvl_c = torch.clamp_max(lvl, L - 1)

    hs = [lv.shape[-2] for lv in levels]
    ws = [lv.shape[-1] for lv in levels]
    offs = [0]
    for h_ in hs[:-1]:
        offs.append(offs[-1] + h_)
    atlas = torch.zeros((B, C, sum(hs), W), dtype=img.dtype, device=img.device)
    for li, limg in enumerate(levels):
        atlas[:, :, offs[li]:offs[li] + hs[li], :ws[li]] = limg

    h_t = torch.tensor(hs, dtype=dt, device=dev)
    w_t = torch.tensor(ws, dtype=dt, device=dev)
    off_t = torch.tensor(offs, dtype=dt, device=dev)
    sc_t = torch.minimum(h_t, w_t) / min(H, W)

    # the reference's mixed convention: affine_grid(align_corners=False)
    # spacing, renormalized align-corners-TRUE, sampled align_corners=False
    t = torch.linspace(-1.0, 1.0, PS, dtype=dt, device=dev) * ((PS - 1) / PS)
    gy, gx = torch.meshgrid(t, t, indexing="ij")
    grid3 = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (PS, PS, 3)
    A = laf[..., :2, :2] * sc_t[lvl_c][..., None, None]
    ctr = laf[..., :2, 2] * torch.stack([w_t[lvl_c] / W, h_t[lvl_c] / H], -1)
    laf_l = torch.cat([A, ctr[..., None]], dim=-1)
    pix = torch.einsum("bnij,pqj->bnpqi", laf_l, grid3)  # (B, N, PS, PS, 2)

    wl = w_t[lvl_c][..., None, None]
    hl = h_t[lvl_c][..., None, None]
    # effective source pixel p·size/(size-1) - 0.5, clamped INSIDE the
    # level rectangle so patches never bleed across atlas rows
    px = pix[..., 0] * wl / torch.clamp_min(wl - 1.0, 1.0) - 0.5
    py = pix[..., 1] * hl / torch.clamp_min(hl - 1.0, 1.0) - 0.5
    px = torch.minimum(torch.clamp_min(px, 0.0), wl - 1.0)
    py = torch.minimum(torch.clamp_min(py, 0.0), hl - 1.0) \
        + off_t[lvl_c][..., None, None]
    px = px.reshape(B, N, PS * PS).contiguous()
    py = py.reshape(B, N, PS * PS).contiguous()
    out = torch.stack([
        torch.stack([patch_sample(atlas[b, c], px[b], py[b], mode)
                     for c in range(C)], dim=1)
        for b in range(B)])  # (B, N, C, PS * PS)
    out = out.reshape(B, N, C, PS, PS)
    return torch.where(in_range[:, :, None, None, None], out, 0.0)

