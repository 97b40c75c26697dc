"""Image pyramids (counterpart of ``kornia_tpu/ops/pyramid.py``):
``pyrdown``, ``pyrup``, the Gaussian and Laplacian pyramids,
``upscale_double`` and the SIFT ``ScalePyramid``.

Every octave's levels come from one ``multi_level_blur`` call: the
sequential blur chain as cumulative banded operators, all levels at once
(the kernel on the card, its plain version on the CPU). The reference
takes that path on a TPU only for octaves 32–768 pixels a side, a limit of
the TPU's VMEM; the port takes it for every octave. The blurs are differentiable on both
devices, so gradients flow through every level back to the input.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from ..core.dtype import as_float
from .filters import filter2d_separable, gaussian_blur2d, get_gaussian_kernel1d
from .kernels import multi_level_blur
from .warp import resize

__all__ = ["pyrdown", "pyrup", "build_pyramid", "build_laplacian_pyramid",
           "upscale_double", "ScalePyramid"]

_PYR_TAPS = [1.0, 4.0, 6.0, 4.0, 1.0]


def pyrdown(input: torch.Tensor, border_type: str = "reflect",
            align_corners: bool = False, factor: float = 2.0) -> torch.Tensor:
    """Blur with the 5-tap binomial kernel, then downsample by `factor`."""
    x = as_float(input)
    k = torch.tensor([_PYR_TAPS], dtype=x.dtype, device=x.device) / 16.0
    blurred = filter2d_separable(x, k, k, border_type)
    H, W = x.shape[-2:]
    return resize(blurred, (int(float(H) / factor), int(float(W) / factor)),
                  interpolation="bilinear", align_corners=align_corners)


def pyrup(input: torch.Tensor, border_type: str = "reflect",
          align_corners: bool = False) -> torch.Tensor:
    """Upsample by 2 (bilinear), then blur with the 5-tap binomial kernel."""
    x = as_float(input)
    H, W = x.shape[-2:]
    up = resize(x, (2 * H, 2 * W), interpolation="bilinear",
                align_corners=align_corners)
    k = torch.tensor([_PYR_TAPS], dtype=x.dtype, device=x.device) / 16.0
    return filter2d_separable(up, k, k, border_type)


def build_pyramid(input: torch.Tensor, max_level: int,
                  border_type: str = "reflect",
                  align_corners: bool = False) -> List[torch.Tensor]:
    """Gaussian pyramid as a list of `max_level` images, level 0 the
    input, each next level the `pyrdown` of the last."""
    pyramid = [as_float(input)]
    for _ in range(max_level - 1):
        pyramid.append(pyrdown(pyramid[-1], border_type, align_corners))
    return pyramid


def build_laplacian_pyramid(input: torch.Tensor, max_level: int,
                            border_type: str = "reflect",
                            align_corners: bool = False
                            ) -> List[torch.Tensor]:
    """Laplacian pyramid: each Gaussian level minus the ``pyrup`` of the
    next (resized to it), the last level the Gaussian residual."""
    gp = build_pyramid(input, max_level, border_type, align_corners)
    lp = []
    for i in range(max_level - 1):
        up = pyrup(gp[i + 1], border_type, align_corners)
        lp.append(gp[i] - resize(up, tuple(gp[i].shape[-2:]), "bilinear"))
    lp.append(gp[-1])
    return lp


def upscale_double(x: torch.Tensor) -> torch.Tensor:
    """Bilinear 2x upsampling with corner-aligned sampling positions."""
    return resize(as_float(x), (x.shape[-2] * 2, x.shape[-1] * 2),
                  interpolation="bilinear", align_corners=True)


class ScalePyramid:
    """SIFT-style scale pyramid: per octave a (B, L, C, h, w) level stack
    with sigma and pixel-distance bookkeeping, L = n_levels + 3. With
    `double_image` the first octave is the input upsampled 2x (pixel
    distance 0.5)."""

    def __init__(self, n_levels: int = 3, init_sigma: float = 1.6,
                 min_size: int = 15, double_image: bool = False):
        self.n_levels = n_levels
        self.init_sigma = init_sigma
        self.min_size = min_size
        self.double_image = double_image
        self.extra_levels = 3
        self.sigma_step = 2.0 ** (1.0 / n_levels)

    def n_octaves(self, h: int, w: int) -> int:
        size = min(h, w) * (2 if self.double_image else 1)
        n = 0
        while size >= self.min_size:
            n += 1
            size //= 2
        return max(n, 1)

    @staticmethod
    def get_kernel_size(sigma: float) -> int:
        return max(2 * int(math.ceil(4.0 * sigma)) + 1, 3)

    def get_first_level(self, input: torch.Tensor
                        ) -> Tuple[torch.Tensor, float, float]:
        if self.double_image:
            x, pixel_dist = upscale_double(input), 0.5
        else:
            x, pixel_dist = input, 1.0
        # bring the image to init_sigma, assuming a capture sigma of 0.5
        # input pixels
        cur_sigma = 0.5 / pixel_dist
        if self.init_sigma > cur_sigma:
            sigma = math.sqrt(self.init_sigma ** 2 - cur_sigma ** 2)
            x = gaussian_blur2d(x, self.get_kernel_size(sigma), sigma,
                                border_type="replicate")
            cur_sigma = self.init_sigma
        return x, cur_sigma, pixel_dist

    def _level_kernels(self, cur_sigma: float
                       ) -> Tuple[List[torch.Tensor], List[float]]:
        """Incremental 1-D kernels for levels 1..L-1 and the level sigmas.
        The kernels are host tensors: multi_level_blur keys its band tables
        on their taps, which it then reads without a device sync."""
        L = self.n_levels + self.extra_levels
        kernels, sigmas = [], []
        level_sigma = cur_sigma
        for _ in range(1, L):
            target = level_sigma * self.sigma_step
            sigma_diff = math.sqrt(max(target ** 2 - level_sigma ** 2, 1e-12))
            kernels.append(get_gaussian_kernel1d(
                self.get_kernel_size(sigma_diff), sigma_diff,
                device="cpu").reshape(-1))
            level_sigma = target
            sigmas.append(level_sigma)
        return kernels, sigmas

    def __call__(self, input: torch.Tensor
                 ) -> Tuple[List[torch.Tensor], List[torch.Tensor],
                            List[torch.Tensor]]:
        """→ (levels per octave (B, L, C, h, w), sigmas (B, L) per octave,
        pixel distances (B, L) per octave)."""
        x = as_float(input)
        B = x.shape[0]
        L = self.n_levels + self.extra_levels
        cur, cur_sigma, pixel_dist = self.get_first_level(x)
        octaves, sigmas_out, dists_out = [], [], []
        oct_count = self.n_octaves(x.shape[-2], x.shape[-1])
        for o in range(oct_count):
            kernels, lvl_sigmas = self._level_kernels(cur_sigma)
            sigmas = [cur_sigma * pixel_dist] + \
                [s * pixel_dist for s in lvl_sigmas]
            lv = multi_level_blur(cur, kernels, kernels,
                                  border_type="replicate")
            levels = [cur] + [lv[i] for i in range(L - 1)]
            octaves.append(torch.stack(levels, dim=1))  # (B, L, C, h, w)
            sigmas_out.append(torch.tensor(sigmas, dtype=x.dtype,
                                           device=x.device).expand(B, L))
            dists_out.append(torch.full((B, L), pixel_dist, dtype=x.dtype,
                                        device=x.device))
            if o == oct_count - 1:
                break
            # next octave: halve the level with sigma 2·init_sigma
            next_base = levels[self.n_levels]
            h, w = next_base.shape[-2:]
            cur = resize(next_base, (h // 2, w // 2), interpolation="bilinear")
            pixel_dist *= 2.0
        return octaves, sigmas_out, dists_out
