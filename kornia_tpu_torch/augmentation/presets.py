"""Augmentation presets (counterpart of
``kornia_tpu/augmentation/presets.py``): StyleGAN2-ADA's adaptive
discriminator augmentation."""

from __future__ import annotations

from typing import Optional

import torch

from ..core.dtype import as_float
from .container import ImageSequential
from .geometric import RandomAffine, RandomHorizontalFlip
from .intensity import ColorJiggle, RandomBrightness, RandomErasing

__all__ = ["AdaptiveDiscriminatorAugmentation"]


class AdaptiveDiscriminatorAugmentation:
    """ADA: the augmentation probability `p` tunes itself from the
    discriminator-overfit heuristic r_t = E[sign(D(real))], stepping
    toward keeping r_t at `target`.

    In a GAN loop::

        ada = AdaptiveDiscriminatorAugmentation()
        imgs_aug = ada(imgs, generator)
        ada.update(d_real_logits)   # p adapts on the host, one read a step
    """

    def __init__(self, target: float = 0.6, adjustment_speed: float = 0.01,
                 p_max: float = 0.8):
        self.target = target
        self.adjustment_speed = adjustment_speed
        self.p_max = p_max
        self.p = 0.0

    def _pipeline(self) -> ImageSequential:
        p = self.p
        return ImageSequential(
            RandomHorizontalFlip(p=p),
            RandomAffine(degrees=10.0, translate=(0.1, 0.1), p=p),
            ColorJiggle(0.2, 0.2, 0.2, 0.05, p=p),
            RandomBrightness((0.9, 1.1), p=p),
            RandomErasing(p=0.5 * p),
        )

    def __call__(self, images: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        if self.p <= 0.0:
            return as_float(images)
        return self._pipeline()(images, generator)

    def update(self, d_real_logits: torch.Tensor) -> float:
        """Adapt p from the discriminator's outputs on real samples (one
        host read, as in the reference)."""
        r_t = float(torch.sign(d_real_logits).mean())
        if r_t > self.target:
            self.p = min(self.p + self.adjustment_speed, self.p_max)
        else:
            self.p = max(self.p - self.adjustment_speed, 0.0)
        return self.p
