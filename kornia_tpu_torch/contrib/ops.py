"""Contributed operators (counterpart of ``kornia_tpu/contrib/ops.py``, the
part the scene renderer reaches): ``diamond_square``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch

from ..core.dtype import float32_on
from ..ops.warp import resize

__all__ = ["diamond_square"]

Device = Union[str, torch.device]


def diamond_square(
    output_size: Tuple[int, int, int, int],
    roughness: float = 0.7,
    random_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    normalize_range: Optional[Tuple[float, float]] = (0.0, 1.0),
    *,
    draws: Optional[Sequence[torch.Tensor]] = None,
    device: Device = "cuda",
) -> torch.Tensor:
    """Plasma fractal (B, C, H, W): a 2x2 uniform seed, upsampled
    (bilinear, corners aligned) level by level with uniform noise scaled by
    `roughness` per level, then resized to (H, W) and normalised per map.

    The uniform draws come from `generator` (None: a generator seeded with
    0, as the reference's default key), or are injected as `draws`: the
    (B, C, 2, 2) seed followed by one draw of each level's shape."""
    B, C, H, W = output_size
    levels = (max(1, math.ceil(math.log2(max(H, W) - 1)))
              if max(H, W) > 1 else 1)
    if draws is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    n = [0]

    def uniform(shape):
        if draws is not None:
            u = float32_on(draws[n[0]], device)
            if tuple(u.shape) != tuple(shape):
                raise ValueError(f"draw {n[0]} must be {tuple(shape)}, got "
                                 f"{tuple(u.shape)}")
        else:
            u = torch.rand(shape, generator=generator, device=device)
        n[0] += 1
        return u

    size = 2
    img = uniform((B, C, 2, 2)) * random_scale
    scale = random_scale
    for _ in range(levels):
        size = min(2 * size - 1, max(H, W))
        img = resize(img, (size, size), "bilinear", align_corners=True)
        scale = scale * roughness
        img = img + (uniform(img.shape) - 0.5) * scale
    img = resize(img, (H, W), "bilinear", align_corners=True)
    if normalize_range is not None:
        lo, hi = normalize_range
        mn = img.amin(dim=(-2, -1), keepdim=True)
        mx = img.amax(dim=(-2, -1), keepdim=True)
        img = (img - mn) / (mx - mn).clamp_min(1e-8) * (hi - lo) + lo
    return img
