"""Keypoint orientation (counterpart of ``kornia_tpu/feature/orientation.py``):
the dominant gradient direction of a smoothed 36-bin histogram over the
patch, with parabolic peak refinement and the reference's sign and offset
conventions, or a learned angle detector (OriNet) in its place."""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..core.dtype import as_float
from ..ops.color import rgb_to_grayscale
from ..ops.filters import (get_gaussian_discrete_kernel1d,
                           get_gaussian_kernel2d, spatial_gradient)
from .laf import (extract_patches_from_pyramid, get_laf_orientation,
                  set_laf_orientation)

__all__ = ["patch_dominant_gradient_orientation", "LAFOrienter", "PassLAF"]


class PassLAF:
    """Identity stand-in for an orientation or affine-shape estimator."""

    def __call__(self, laf: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        return laf


def patch_dominant_gradient_orientation(patch: torch.Tensor,
                                        num_ang_bins: int = 36,
                                        eps: float = 1e-8) -> torch.Tensor:
    """(B, 1, PS, PS) → (B,) dominant orientation in radians."""
    patch = as_float(patch)
    B, C, PS, _ = patch.shape
    dt, dev = patch.dtype, patch.device
    grads = spatial_gradient(patch, "sobel")
    gx = grads[:, :, 0]
    gy = grads[:, :, 1]
    sigma = PS / 6.0
    gk = get_gaussian_kernel2d((PS, PS), (sigma, sigma), dt, dev)[0]
    mag = torch.sqrt(gx * gx + gy * gy + eps) * gk[None, None]
    ori = torch.atan2(gy, gx + eps) + 2.0 * math.pi
    o_big = num_ang_bins * (ori + math.pi) / (2.0 * math.pi)
    bo0f = torch.floor(o_big)
    wo1 = o_big - bo0f
    bo0 = torch.remainder(bo0f, num_ang_bins).long()
    bo1 = torch.remainder(bo0 + 1, num_ang_bins)
    # histogram as the reference forms it: one-hot weights, mean over pixels
    oh0 = F.one_hot(bo0[:, 0].reshape(B, -1), num_ang_bins).to(dt)
    oh1 = F.one_hot(bo1[:, 0].reshape(B, -1), num_ang_bins).to(dt)
    w1 = wo1[:, 0].reshape(B, -1, 1)
    m = mag[:, 0].reshape(B, -1, 1)
    hist = torch.mean(oh0 * (1.0 - w1) * m + oh1 * w1 * m, dim=1)
    # circular smoothing with the discrete Gaussian(5, 1.6)
    kernel = get_gaussian_discrete_kernel1d(5, 1.6, dt, dev)[0]
    hist_pad = torch.cat([hist[:, -2:], hist, hist[:, :2]], dim=1)
    smoothed = (hist_pad.unfold(1, 5, 1) * kernel).sum(-1)  # (B, bins)
    peak = torch.argmax(smoothed, dim=1)
    rows = torch.arange(B, device=dev)
    left = smoothed[rows, torch.remainder(peak - 1, num_ang_bins)]
    right = smoothed[rows, torch.remainder(peak + 1, num_ang_bins)]
    center = smoothed[rows, peak]
    denom = left + right - 2.0 * center
    offset = torch.where(denom.abs() > eps, 0.5 * (left - right) / denom, 0.0)
    return -((2.0 * math.pi * (peak.to(dt) + offset) / num_ang_bins)
             - math.pi)


class LAFOrienter:
    """Rotate LAFs by the estimated patch orientation, added to the
    current orientation. `angle_detector` maps (B·N, 1, PS, PS) patches to
    radians (OriNet); without it the gradient histogram orients."""

    def __init__(self, patch_size: int = 32, num_angular_bins: int = 36,
                 angle_detector: Optional[Callable] = None,
                 patch_mode: Optional[str] = None):
        self.patch_size = patch_size
        self.num_angular_bins = num_angular_bins
        self.angle_detector = angle_detector
        self.patch_mode = patch_mode

    def __call__(self, laf: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        B, N = laf.shape[:2]
        patches = extract_patches_from_pyramid(img, laf, self.patch_size,
                                               patch_mode=self.patch_mode)
        patches = patches.reshape(B * N, *patches.shape[2:])
        if patches.shape[1] == 3:
            patches = rgb_to_grayscale(patches)
        if self.angle_detector is None:
            angles = patch_dominant_gradient_orientation(
                patches, self.num_angular_bins)
        else:
            angles = self.angle_detector(patches)
        angles = angles.reshape(B, N)
        prev = get_laf_orientation(laf)[..., 0]
        return set_laf_orientation(laf,
                                   (torch.rad2deg(angles) + prev)[..., None])
