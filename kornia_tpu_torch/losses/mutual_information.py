"""Differentiable (normalized) mutual-information losses by kernel density
estimation (counterpart of ``kornia_tpu/losses/mutual_information.py``).

Masks weight the kernel responses instead of selecting samples, so shapes
stay fixed: a masked-out sample adds a zero term to the joint histogram.
The joint histogram is one product of two (bins, N) response matrices,
in true float32.
"""

from __future__ import annotations

import enum
import functools
import math

import torch

from ..core.dtype import as_float
from ..core.linalg import f32_matmul_precision

__all__ = [
    "MIKernel", "xu_kernel", "rectangular_kernel",
    "truncated_gaussian_kernel",
    "mutual_information_loss", "mutual_information_loss_2d",
    "mutual_information_loss_3d",
    "normalized_mutual_information_loss",
    "normalized_mutual_information_loss_2d",
    "normalized_mutual_information_loss_3d",
    "MILossFromRef", "MILossFromRef2D", "MILossFromRef3D",
    "NMILossFromRef", "NMILossFromRef2D", "NMILossFromRef3D",
]


def xu_kernel(x: torch.Tensor, window_radius: float = 1.0) -> torch.Tensor:
    """Xu et al.'s second-order polynomial Parzen kernel on [-wr, wr]."""
    xa = x.abs() * (1.0 / window_radius)
    poly1 = xa * (-1.8 * xa - 0.1) + 1.0
    poly2 = xa * (1.8 * xa - 3.7) + 1.9
    return torch.where(xa < 0.5, poly1,
                       torch.where(xa <= 1.0, poly2, torch.zeros_like(xa)))


def rectangular_kernel(x: torch.Tensor,
                       window_radius: float = 1.0) -> torch.Tensor:
    """Box kernel on [-wr, wr]."""
    return (x.abs() <= window_radius).to(x.dtype)


def truncated_gaussian_kernel(x: torch.Tensor,
                              window_radius: float = 1.0) -> torch.Tensor:
    """Gaussian of σ = wr, truncated to [-wr, wr]."""
    sigma = window_radius
    g = torch.exp(-0.5 * (x / sigma) ** 2) / (sigma * (2 * math.pi) ** 0.5)
    return torch.where(x.abs() <= window_radius, g, torch.zeros_like(g))


class MIKernel(enum.Enum):
    """The density kernels; ``functools.partial`` keeps the values from
    becoming methods."""

    xu = functools.partial(xu_kernel)
    rectangular = functools.partial(rectangular_kernel)
    truncated_gaussian = functools.partial(truncated_gaussian_kernel)


def _prep_mask(mask, n: int, like: torch.Tensor) -> torch.Tensor:
    """A mask common to the batch (at most one axis) as (n,) weights."""
    if mask is None:
        return torch.ones((n,), dtype=like.dtype, device=like.device)
    mask = torch.as_tensor(mask, device=like.device)
    if mask.ndim > 1:
        raise ValueError("mask must be a common (non-batched) mask")
    return mask.expand(n).to(like.dtype)


def _normalize_signal(data: torch.Tensor, w: torch.Tensor, num_bins: int,
                      eps: float) -> torch.Tensor:
    """The masked samples' range mapped to [0, num_bins]."""
    big = torch.finfo(data.dtype).max
    valid = w > 0
    mn = torch.where(valid, data, big).amin(-1, keepdim=True)
    mx = torch.where(valid, data, -big).amax(-1, keepdim=True)
    diff = mx - mn
    return torch.where(diff > eps, (data - mn) / diff * num_bins, 0.0)


def _entropies(joint: torch.Tensor, eps: float):
    p = joint.clamp_min(eps)
    p = p / p.sum((-1, -2), keepdim=True)
    px = p.sum(-2)
    py = p.sum(-1)
    return ((-px * torch.log(px)).sum(-1), (-py * torch.log(py)).sum(-1),
            (-p * torch.log(p)).sum((-1, -2)))


@f32_matmul_precision
def _mi_entropies(input, target, input_mask, target_mask,
                  kernel_function: MIKernel, num_bins: int,
                  window_radius: float):
    x = as_float(input)
    y = as_float(target).to(x.dtype)
    if x.shape != y.shape:
        raise ValueError(f"signals have incompatible shapes: "
                         f"{tuple(x.shape)} vs {tuple(y.shape)}")
    n = x.shape[-1]
    wx = _prep_mask(input_mask, n, x)
    wy = _prep_mask(target_mask, n, x)
    eps = float(torch.finfo(x.dtype).eps)
    xs = _normalize_signal(x, wx, num_bins, eps)
    ys = _normalize_signal(y, wy, num_bins, eps)
    if not isinstance(kernel_function, MIKernel):
        raise ValueError(f"kernel_function must be a MIKernel, got "
                         f"{kernel_function}")
    kern = functools.partial(kernel_function.value,
                             window_radius=window_radius)
    bins = torch.arange(num_bins, dtype=x.dtype, device=x.device)
    vx = kern(bins[:, None] - xs[..., None, :]) * (wx * wy)
    vy = kern(bins[:, None] - ys[..., None, :])
    return _entropies(vx @ vy.transpose(-1, -2), eps)


def mutual_information_loss(input: torch.Tensor, target: torch.Tensor,
                            input_mask=None, target_mask=None,
                            kernel_function: MIKernel = MIKernel.xu,
                            num_bins: int = 64,
                            window_radius: float = 1.0) -> torch.Tensor:
    """-MI(X, Y) of flat (..., N) signals."""
    h_x, h_y, h_xy = _mi_entropies(input, target, input_mask, target_mask,
                                   kernel_function, num_bins, window_radius)
    return -(h_x + h_y - h_xy)


def normalized_mutual_information_loss(
        input: torch.Tensor, target: torch.Tensor, input_mask=None,
        target_mask=None, kernel_function: MIKernel = MIKernel.xu,
        num_bins: int = 64, window_radius: float = 1.0) -> torch.Tensor:
    """-(H(X) + H(Y)) / H(X, Y)."""
    h_x, h_y, h_xy = _mi_entropies(input, target, input_mask, target_mask,
                                   kernel_function, num_bins, window_radius)
    return -(h_x + h_y) / h_xy


def _flat(x, ndim: int) -> torch.Tensor:
    """The trailing `ndim` axes flattened."""
    x = torch.as_tensor(x)
    return x.reshape(*x.shape[:-ndim], -1)


def _flat_mask(mask):
    return None if mask is None else torch.as_tensor(mask).reshape(-1)


def _flat_call(loss, ndim: int, input, target, input_mask, target_mask,
               kernel_function, num_bins, window_radius):
    return loss(_flat(input, ndim), _flat(target, ndim),
                _flat_mask(input_mask), _flat_mask(target_mask),
                kernel_function, num_bins, window_radius)


def mutual_information_loss_2d(input, target, input_mask=None,
                               target_mask=None,
                               kernel_function: MIKernel = MIKernel.xu,
                               num_bins: int = 64,
                               window_radius: float = 1.0) -> torch.Tensor:
    """-MI of (..., H, W) images."""
    return _flat_call(mutual_information_loss, 2, input, target, input_mask,
                      target_mask, kernel_function, num_bins, window_radius)


def mutual_information_loss_3d(input, target, input_mask=None,
                               target_mask=None,
                               kernel_function: MIKernel = MIKernel.xu,
                               num_bins: int = 64,
                               window_radius: float = 1.0) -> torch.Tensor:
    """-MI of (..., D, H, W) volumes."""
    return _flat_call(mutual_information_loss, 3, input, target, input_mask,
                      target_mask, kernel_function, num_bins, window_radius)


def normalized_mutual_information_loss_2d(
        input, target, input_mask=None, target_mask=None,
        kernel_function: MIKernel = MIKernel.xu, num_bins: int = 64,
        window_radius: float = 1.0) -> torch.Tensor:
    return _flat_call(normalized_mutual_information_loss, 2, input, target,
                      input_mask, target_mask, kernel_function, num_bins,
                      window_radius)


def normalized_mutual_information_loss_3d(
        input, target, input_mask=None, target_mask=None,
        kernel_function: MIKernel = MIKernel.xu, num_bins: int = 64,
        window_radius: float = 1.0) -> torch.Tensor:
    return _flat_call(normalized_mutual_information_loss, 3, input, target,
                      input_mask, target_mask, kernel_function, num_bins,
                      window_radius)


class _FromRefBase:
    """Holds a reference signal; a call scores another signal against
    it."""

    _loss = staticmethod(mutual_information_loss)
    _ndim_flatten = 0  # trailing axes flattened on the way in

    def __init__(self, reference_signal, mask=None,
                 kernel_function: MIKernel = MIKernel.xu,
                 num_bins: int = 64, window_radius: float = 1.0):
        ref = torch.as_tensor(reference_signal)
        if self._ndim_flatten:
            ref = _flat(ref, self._ndim_flatten)
            mask = _flat_mask(mask)
        self.reference = ref
        self.mask = mask
        self.kernel_function = kernel_function
        self.num_bins = num_bins
        self.window_radius = window_radius

    def __call__(self, other_signal, other_mask=None):
        other = torch.as_tensor(other_signal)
        if self._ndim_flatten:
            other = _flat(other, self._ndim_flatten)
            other_mask = _flat_mask(other_mask)
        return type(self)._loss(
            other, self.reference, other_mask, self.mask,
            self.kernel_function, self.num_bins, self.window_radius)

    forward = __call__


class MILossFromRef(_FromRefBase):
    """-MI against a stored flat reference."""


class NMILossFromRef(_FromRefBase):
    """-NMI against a stored flat reference."""

    _loss = staticmethod(normalized_mutual_information_loss)


class MILossFromRef2D(MILossFromRef):
    _ndim_flatten = 2


class MILossFromRef3D(MILossFromRef):
    _ndim_flatten = 3


class NMILossFromRef2D(NMILossFromRef):
    _ndim_flatten = 2


class NMILossFromRef3D(NMILossFromRef):
    _ndim_flatten = 3
