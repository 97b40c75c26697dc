"""Image-similarity losses (counterpart of ``kornia_tpu/losses/losses.py``,
``ssim``, ``ssim_loss``, ``psnr`` and ``psnr_loss``).

SSIM blurs five images with an 11-tap reflect Gaussian through
``gaussian_blur2d``, so on the card its forward and backward run the banded
blur kernel and its adjoint (``ops/kernels.py``).
"""

from __future__ import annotations

import torch

from ..core.dtype import as_float
from ..ops.filters import gaussian_blur2d

__all__ = ["ssim", "ssim_loss", "psnr", "psnr_loss"]


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         max_val: float = 1.0, eps: float = 1e-12) -> torch.Tensor:
    """Per-pixel SSIM map (B, C, H, W)."""
    img1 = as_float(img1)
    img2 = as_float(img2)
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2

    def blur(t):
        return gaussian_blur2d(t, window_size, 1.5, border_type="reflect")

    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    num = (2.0 * mu12 + C1) * (2.0 * s12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)
    return num / (den + eps)


def ssim_loss(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
              max_val: float = 1.0, reduction: str = "mean") -> torch.Tensor:
    return _reduce((1.0 - ssim(img1, img2, window_size, max_val)) / 2.0,
                   reduction)


def psnr(image: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    image = as_float(image)
    target = as_float(target)
    mse = ((image - target) ** 2).mean()
    return 10.0 * torch.log10(max_val ** 2 / mse.clamp_min(1e-12))


def psnr_loss(image: torch.Tensor, target: torch.Tensor,
              max_val: float = 1.0) -> torch.Tensor:
    return -psnr(image, target, max_val)
