"""Robust penalties and their IRLS weights (counterpart of
``kornia_tpu/losses/robust.py``).

The losses return rho(x²) of the difference of two images; the weights
w(r²) = rho'(r²) are the robust kernels of bundle adjustment and the pose
graph.
"""

from __future__ import annotations

import torch

from ..core.dtype import as_float

__all__ = [
    "charbonnier_loss",
    "cauchy_loss",
    "geman_mcclure_loss",
    "welsch_loss",
    "huber_weight",
    "cauchy_weight",
    "geman_mcclure_weight",
    "welsch_weight",
    "tukey_weight",
]


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def _sq_diff(img1, img2) -> torch.Tensor:
    return (as_float(img1) - as_float(img2)) ** 2


def charbonnier_loss(img1: torch.Tensor, img2: torch.Tensor,
                     reduction: str = "none") -> torch.Tensor:
    """rho(x) = sqrt(1 + x²) - 1."""
    return _reduce(torch.sqrt(1.0 + _sq_diff(img1, img2)) - 1.0, reduction)


def cauchy_loss(img1: torch.Tensor, img2: torch.Tensor,
                reduction: str = "none") -> torch.Tensor:
    """rho(x) = log(1 + x²)."""
    return _reduce(torch.log1p(_sq_diff(img1, img2)), reduction)


def geman_mcclure_loss(img1: torch.Tensor, img2: torch.Tensor,
                       reduction: str = "none") -> torch.Tensor:
    """rho(x) = 2 x² / (x² + 4)."""
    x2 = _sq_diff(img1, img2)
    return _reduce(2.0 * x2 / (x2 + 4.0), reduction)


def welsch_loss(img1: torch.Tensor, img2: torch.Tensor,
                reduction: str = "none") -> torch.Tensor:
    """rho(x) = 1 - exp(-x²/2)."""
    return _reduce(1.0 - torch.exp(-0.5 * _sq_diff(img1, img2)), reduction)


# IRLS weights w(r) = rho'(r²). `c` may be a Python float or a device scalar
# (the graduated scale of ba_sparse's GNC), so every form takes both.

def huber_weight(r2: torch.Tensor, delta=1.0) -> torch.Tensor:
    r = torch.sqrt(r2.clamp_min(1e-12))
    return torch.where(r <= delta, 1.0, delta / r)


def cauchy_weight(r2: torch.Tensor, c=1.0) -> torch.Tensor:
    return 1.0 / (1.0 + r2 / (c * c))


def geman_mcclure_weight(r2: torch.Tensor, c=1.0) -> torch.Tensor:
    return (c * c / (c * c + r2)) ** 2


def welsch_weight(r2: torch.Tensor, c=1.0) -> torch.Tensor:
    return torch.exp(-r2 / (c * c))


def tukey_weight(r2: torch.Tensor, c=4.685) -> torch.Tensor:
    w = 1.0 - r2 / (c * c)
    return torch.where(r2 <= c * c, w * w, 0.0)
