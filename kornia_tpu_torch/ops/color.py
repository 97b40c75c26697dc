"""Colour conversions (counterpart of ``kornia_tpu/ops/color.py``, the grey
part the local-feature front end reaches). Inputs are ``(..., C, H, W)``
float tensors in [0, 1]."""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

from ..core.check import check
from ..core.dtype import as_float

__all__ = ["rgb_to_grayscale", "bgr_to_grayscale", "grayscale_to_rgb",
           "rgb_to_bgr", "bgr_to_rgb"]


def rgb_to_grayscale(image: torch.Tensor,
                     rgb_weights: Optional[Union[Sequence[float],
                                                 torch.Tensor]] = None
                     ) -> torch.Tensor:
    """(..., 3, H, W) → (..., 1, H, W): the weighted sum of R, G and B with
    the ITU-R 601 weights (0.299, 0.587, 0.114) unless `rgb_weights`."""
    image = as_float(image)
    check(image.ndim >= 3 and image.shape[-3] == 3,
          f"expected 3 channels, got {tuple(image.shape)}")
    w = torch.as_tensor([0.299, 0.587, 0.114] if rgb_weights is None
                        else rgb_weights, dtype=image.dtype,
                        device=image.device)
    r, g, b = image[..., 0:1, :, :], image[..., 1:2, :, :], \
        image[..., 2:3, :, :]
    return w[0] * r + w[1] * g + w[2] * b


def rgb_to_bgr(image: torch.Tensor) -> torch.Tensor:
    check(image.ndim >= 3 and image.shape[-3] == 3,
          f"expected 3 channels, got {tuple(image.shape)}")
    return torch.flip(image, dims=(-3,))


bgr_to_rgb = rgb_to_bgr


def bgr_to_grayscale(image: torch.Tensor) -> torch.Tensor:
    return rgb_to_grayscale(bgr_to_rgb(image))


def grayscale_to_rgb(image: torch.Tensor) -> torch.Tensor:
    check(image.ndim >= 3 and image.shape[-3] == 1,
          f"expected 1 channel, got {tuple(image.shape)}")
    return torch.cat([image] * 3, dim=-3)
