"""Corner and blob responses (counterpart of
``kornia_tpu/feature/responses.py``): Harris, Shi-Tomasi (GFTT), Hessian
determinant and difference of Gaussians.

The structure tensor blurs dx², dy² and dx·dy with a 7-tap Gaussian
(sigma 1, reflect border) through ``gaussian_blur2d``, so on the card each
of the three is one launch of the banded blur kernel
(``ops/kernels.py::fused_separable_blur2d``) over every image and level
folded into the batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.check import check
from ..core.dtype import as_float
from ..ops.filters import gaussian_blur2d, spatial_gradient

__all__ = [
    "harris_response",
    "gftt_response",
    "hessian_response",
    "dog_response",
    "dog_response_single",
]


def _sigma4(scores: torch.Tensor,
            sigmas: Optional[torch.Tensor]) -> torch.Tensor:
    """Scale normalisation: scores × sigma⁴, one sigma per image."""
    if sigmas is None:
        return scores
    return scores * torch.as_tensor(sigmas, dtype=scores.dtype,
                                    device=scores.device).reshape(
                                        -1, 1, 1, 1) ** 4


def _structure_tensor(input: torch.Tensor, grads_mode: str
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The blurred products of the first derivatives (dx², dy², dx·dy)."""
    grads = spatial_gradient(input, grads_mode)
    dx = grads[:, :, 0]
    dy = grads[:, :, 1]
    dx2 = gaussian_blur2d(dx * dx, 7, 1.0, border_type="reflect")
    dy2 = gaussian_blur2d(dy * dy, 7, 1.0, border_type="reflect")
    dxy = gaussian_blur2d(dx * dy, 7, 1.0, border_type="reflect")
    return dx2, dy2, dxy


def harris_response(input: torch.Tensor, k: float = 0.04,
                    grads_mode: str = "sobel",
                    sigmas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """det(M) - k·tr(M)² of the structure tensor M."""
    dx2, dy2, dxy = _structure_tensor(as_float(input), grads_mode)
    det = dx2 * dy2 - dxy * dxy
    trace = dx2 + dy2
    return _sigma4(det - k * trace * trace, sigmas)


def gftt_response(input: torch.Tensor, grads_mode: str = "sobel",
                  sigmas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The smaller eigenvalue of the structure tensor,
    0.5·(tr - sqrt(|tr² - 4·det|))."""
    dx2, dy2, dxy = _structure_tensor(as_float(input), grads_mode)
    trace = dx2 + dy2
    det = dx2 * dy2 - dxy * dxy
    e2 = 0.5 * (trace - torch.sqrt(torch.abs(trace * trace - 4.0 * det)))
    return _sigma4(e2, sigmas)


def hessian_response(input: torch.Tensor, grads_mode: str = "sobel",
                     sigmas: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Determinant of the Hessian, dxx·dyy - dxy²."""
    grads = spatial_gradient(as_float(input), grads_mode, order=2)
    dxx = grads[:, :, 0]
    dxy = grads[:, :, 1]
    dyy = grads[:, :, 2]
    return _sigma4(dxx * dyy - dxy * dxy, sigmas)


def dog_response(input: torch.Tensor) -> torch.Tensor:
    """Difference of adjacent Gaussian levels of a (B, L, C, H, W) stack."""
    check(input.ndim == 5, f"expected (B,L,C,H,W), got {tuple(input.shape)}")
    return input[:, 1:] - input[:, :-1]


def dog_response_single(input: torch.Tensor, sigma1: float = 1.0,
                        sigma2: float = 1.6) -> torch.Tensor:
    """DoG of one image: the sigma2 blur minus the sigma1 blur."""
    input = as_float(input)
    g1 = gaussian_blur2d(input, 2 * int(4 * sigma1) // 2 * 2 + 3, sigma1)
    g2 = gaussian_blur2d(input, 2 * int(4 * sigma2) // 2 * 2 + 3, sigma2)
    return g2 - g1
