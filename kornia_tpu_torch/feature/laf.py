"""Local affine frames (counterpart of ``kornia_tpu/feature/laf.py``, the
part the two-view path reaches).

A LAF stack is (B, N, 2, 3): per keypoint an affine frame [A | c] that maps
the unit circle to an image ellipse, c the centre in pixels.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.check import check_laf
from ..core.dtype import as_float
from ..core.linalg import det_2x2
from ..ops.kernels import patch_sample
from ..ops.pyramid import pyrdown

__all__ = [
    "get_laf_scale",
    "scale_laf",
    "get_laf_center",
    "get_laf_orientation",
    "set_laf_orientation",
    "rotate_laf",
    "laf_from_center_scale_ori",
    "extract_patches_from_pyramid",
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

