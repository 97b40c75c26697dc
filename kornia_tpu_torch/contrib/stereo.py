"""Block-matching stereo on a rectified pair (counterpart of
``kornia_tpu/contrib/stereo.py``).

The cost of disparity d at a left pixel is the channel mean of |left −
right shifted right by d| (zeros shifted in), box-filtered over a window.
All `max_disparity` cost maps of a direction are aggregated by one box
blur with the disparities in the batch: one banded blur launch on the card
per direction. The disparity is the soft-argmin (differentiable) or the
winner; the left-right check compares it with the right view's disparity
from the mirrored problem.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.dtype import as_float
from ..ops.filters import box_blur

__all__ = ["stereo_matching", "disparity_to_depth"]


def _cost_volume(ref: torch.Tensor, other: torch.Tensor, max_disparity: int,
                 window_size: int) -> torch.Tensor:
    """(B, D, H, W): the box-filtered channel-mean SAD of `ref` against
    `other` shifted right by each d."""
    D = max_disparity
    W = ref.shape[-1]
    # padded[..., s : s + W] is `other` shifted right by D - 1 - s
    padded = torch.nn.functional.pad(other, (D - 1, 0))
    shifted = padded.unfold(-1, W, 1).flip(-2)          # (B, C, H, D, W)
    sad = (ref[..., None, :] - shifted).abs().mean(dim=1)  # (B, H, D, W)
    return box_blur(sad.transpose(1, 2), window_size)


def stereo_matching(left: torch.Tensor, right: torch.Tensor,
                    max_disparity: int = 64, window_size: int = 9,
                    soft: bool = True, temperature: float = 50.0,
                    lr_check_th: Optional[float] = 1.5
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rectified (B, C, H, W) pair → (disparity (B, 1, H, W), valid
    (B, 1, H, W)). `soft` takes the soft-argmin at `temperature`, else the
    winner (the lowest disparity among equal costs); with `lr_check_th`,
    valid marks the pixels whose right-view disparity at the matched pixel
    agrees within the threshold."""
    left = as_float(left)
    right = as_float(right)
    W = left.shape[-1]

    def wta(cv):
        if soft:
            p = torch.softmax(-temperature * cv, dim=1)
            disps = torch.arange(max_disparity, dtype=cv.dtype,
                                 device=cv.device)
            return (p * disps[None, :, None, None]).sum(dim=1, keepdim=True)
        return torch.argmin(cv, dim=1, keepdim=True).to(cv.dtype)

    disp_left = wta(_cost_volume(left, right, max_disparity, window_size))
    if lr_check_th is None:
        return disp_left, torch.ones_like(disp_left, dtype=torch.bool)
    disp_right = wta(_cost_volume(right.flip(-1), left.flip(-1),
                                  max_disparity, window_size)).flip(-1)
    xs = torch.arange(W, dtype=disp_left.dtype, device=disp_left.device)
    x_right = torch.clamp(xs - disp_left, 0, W - 1)
    # torch.round rounds half to even, as jnp.round does
    dr_at = torch.gather(disp_right, -1, torch.round(x_right).long())
    return disp_left, (disp_left - dr_at).abs() < lr_check_th


def disparity_to_depth(disparity: torch.Tensor, focal: float,
                       baseline: float, eps: float = 1e-6) -> torch.Tensor:
    return focal * baseline / torch.clamp_min(disparity, eps)
