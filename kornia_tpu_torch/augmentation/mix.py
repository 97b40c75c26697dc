"""Label-transforming mix augmentations (counterpart of
``kornia_tpu/augmentation/mix.py``): MixUp, CutMix, Mosaic, PatchMix,
Jigsaw and segmentation-class transplantation (2-D and 3-D). Donors are
the batch permuted; every selection is a ``torch.where`` on the device."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as TF

from ..core.dtype import as_float
from .base import AugmentationBase2D
from .intensity import _permutations

__all__ = ["RandomMixUpV2", "RandomCutMixV2", "RandomMosaic", "RandomJigsaw",
           "RandomTransplantation", "RandomPatchMix"]


def _perm(generator, batch: int) -> torch.Tensor:
    return _permutations(generator, 1, batch)[0]


def _mixed_labels(labels, perm, lam) -> torch.Tensor:
    return torch.stack([labels.to(torch.float32),
                        labels[perm.long()].to(torch.float32), lam], dim=-1)


class RandomMixUpV2(AugmentationBase2D):
    """x ← (1 - λ) x + λ x[perm]; labels returned as (y_a, y_b, λ)."""

    def __init__(self, lambda_val=(0.0, 1.0), **kw):
        super().__init__(**kw)
        self.lambda_val = lambda_val

    def sample_params(self, generator, batch, shape):
        return {"lam": self._uniform(generator, batch, *self.lambda_val),
                "perm": _perm(generator, batch)}

    def __call__(self, x, labels=None, generator=None, params=None):
        x = as_float(x)
        params = self._params_for(x, generator, params)
        lam = torch.where(params["apply_mask"], params["lam"], 0.0)
        lam4 = lam.reshape(-1, 1, 1, 1)
        out = (1.0 - lam4) * x + lam4 * x[params["perm"].long()]
        if labels is None:
            return out, params
        return out, _mixed_labels(labels, params["perm"], lam)


def _beta(generator, a: float, b: float, n: int) -> torch.Tensor:
    """Beta(a, b) draws as the ratio of two Gamma draws from `generator`
    (torch's Beta takes no generator)."""
    dev = generator.device

    def gamma(alpha):
        # Marsaglia-Tsang with the alpha < 1 boost; a fixed number of
        # proposals (accepted with probability above 0.95 each), so no
        # host read
        boost = alpha < 1.0
        al = alpha + 1.0 if boost else alpha
        d = al - 1.0 / 3.0
        c = 1.0 / (9.0 * d) ** 0.5
        out = torch.ones(n, device=dev)
        done = torch.zeros(n, dtype=torch.bool, device=dev)
        for _ in range(16):
            z = torch.randn(n, generator=generator, device=dev)
            u = torch.rand(n, generator=generator, device=dev)
            v = (1.0 + c * z) ** 3
            ok = (v > 0) & (torch.log(u.clamp_min(1e-30))
                            < 0.5 * z * z + d - d * v
                            + d * torch.log(v.clamp_min(1e-30)))
            take = ok & ~done
            out = torch.where(take, d * v, out)
            done = done | ok
        if boost:
            u = torch.rand(n, generator=generator, device=dev)
            out = out * u.clamp_min(1e-30) ** (1.0 / alpha)
        return out

    x, y = gamma(a), gamma(b)
    return x / (x + y)


class RandomCutMixV2(AugmentationBase2D):
    """Paste a random rectangle from the permuted batch."""

    def __init__(self, num_mix: int = 1, beta: float = 1.0, **kw):
        super().__init__(**kw)
        self.num_mix = num_mix
        self.beta = beta

    def sample_params(self, generator, batch, shape):
        H, W = shape[-2:]
        dev = generator.device
        lam = _beta(generator, self.beta, self.beta, batch)
        cut = torch.sqrt(1.0 - lam)
        return {"h": cut * H, "w": cut * W,
                "cy": torch.rand(batch, generator=generator, device=dev) * H,
                "cx": torch.rand(batch, generator=generator, device=dev) * W,
                "perm": _perm(generator, batch)}

    def __call__(self, x, labels=None, generator=None, params=None):
        x = as_float(x)
        params = self._params_for(x, generator, params)
        B, C, H, W = x.shape
        ys = torch.arange(H, dtype=x.dtype, device=x.device)[None, :, None]
        xs = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, :]
        y0 = (params["cy"] - params["h"] / 2).clamp(0, H)[:, None, None]
        y1 = (params["cy"] + params["h"] / 2).clamp(0, H)[:, None, None]
        x0 = (params["cx"] - params["w"] / 2).clamp(0, W)[:, None, None]
        x1 = (params["cx"] + params["w"] / 2).clamp(0, W)[:, None, None]
        box = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
        box = box & params["apply_mask"][:, None, None]
        out = torch.where(box[:, None], x[params["perm"].long()], x)
        lam_actual = 1.0 - box.to(x.dtype).mean(dim=(1, 2))
        if labels is None:
            return out, params
        return out, _mixed_labels(labels, params["perm"], lam_actual)


class RandomMosaic(AugmentationBase2D):
    """4-image mosaic; the output keeps the input size, the mosaic centre
    drawn inside the middle half."""

    def __init__(self, output_size: Optional[Tuple[int, int]] = None, **kw):
        super().__init__(**kw)
        self.output_size = output_size

    def sample_params(self, generator, batch, shape):
        H, W = shape[-2:]
        return {"cy": self._uniform(generator, batch, 0.25 * H, 0.75 * H),
                "cx": self._uniform(generator, batch, 0.25 * W, 0.75 * W),
                "perms": _permutations(generator, 3, batch)}

    def __call__(self, x, generator=None, params=None):
        x = as_float(x)
        params = self._params_for(x, generator, params)
        B, C, H, W = x.shape
        ys = torch.arange(H, dtype=x.dtype, device=x.device)[None, :, None]
        xs = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, :]
        top = (ys < params["cy"][:, None, None])[:, None]
        left = (xs < params["cx"][:, None, None])[:, None]
        perms = params["perms"].long()
        b, c, d = x[perms[0]], x[perms[1]], x[perms[2]]
        out = torch.where(top & left, x,
                          torch.where(top & ~left, b,
                                      torch.where(~top & left, c, d)))
        return torch.where(params["apply_mask"][:, None, None, None], out, x)


class RandomPatchMix(AugmentationBase2D):
    """Mix random grid patches between each sample and a permuted donor.
    Returns (images, lam), lam the share of each sample's own pixels
    kept."""

    def __init__(self, grid: Tuple[int, int] = (4, 4), mix_prob: float = 0.5,
                 **kw):
        super().__init__(**kw)
        self.grid = grid
        self.mix_prob = mix_prob

    def sample_params(self, generator, batch, shape):
        gy, gx = self.grid
        take = torch.rand((batch, gy, gx), generator=generator,
                          device=generator.device) < self.mix_prob
        return {"take_donor": take, "perm": _perm(generator, batch)}

    def __call__(self, x, generator=None, params=None):
        x = as_float(x)
        params = self._params_for(x, generator, params)
        B, C, H, W = x.shape
        gy, gx = self.grid
        mask = params["take_donor"].to(x.dtype)
        mask = mask.repeat_interleave(H // gy, dim=1).repeat_interleave(
            W // gx, dim=2)
        mask = TF.pad(mask, (0, W - (W // gx) * gx, 0, H - (H // gy) * gy))
        mask = mask * params["apply_mask"].to(x.dtype).reshape(-1, 1, 1)
        donor = x[params["perm"].long()]
        out = x * (1 - mask[:, None]) + donor * mask[:, None]
        return out, 1.0 - mask.mean(dim=(1, 2))


class RandomTransplantation(AugmentationBase2D):
    """Transplant the pixels of one segmentation class from a donor
    (permuted) sample into each image. Inputs: images and integer masks,
    channel-less (B, [D,] H, W) or with the images' channel axis."""

    def __init__(self, excluded_labels=(0,), **kw):
        super().__init__(**kw)
        self.excluded_labels = tuple(excluded_labels)

    def sample_params(self, generator, batch, shape):
        return {"perm": _perm(generator, batch),
                "label_u": torch.rand(batch, generator=generator,
                                      device=generator.device)}

    def __call__(self, images, masks, generator=None, params=None):
        images = as_float(images)
        params = self._params_for(images, generator, params)
        perm = params["perm"].long()
        donor_img = images[perm]
        donor_mask = masks[perm]
        # the donor label: the highest present label scaled by u
        max_label = donor_mask.reshape(donor_mask.shape[0], -1).amax(-1)
        label = torch.ceil(params["label_u"] * max_label.to(
            torch.float32).clamp_min(1.0)).to(masks.dtype)
        has_channel = masks.ndim == images.ndim
        m = donor_mask if has_channel else donor_mask[:, None]
        bshape = (-1,) + (1,) * (m.ndim - 1)
        sel = (m == label.reshape(bshape)) & \
            params["apply_mask"].reshape(bshape)
        out_img = torch.where(sel, donor_img, images)
        m_orig = masks if has_channel else masks[:, None]
        out_mask = torch.where(sel, m, m_orig)
        if not has_channel:
            out_mask = out_mask[:, 0]
        return out_img, out_mask


class RandomJigsaw(AugmentationBase2D):
    """Shuffle image tiles."""

    def __init__(self, grid: Tuple[int, int] = (4, 4), **kw):
        super().__init__(**kw)
        self.grid = grid

    def sample_params(self, generator, batch, shape):
        n = self.grid[0] * self.grid[1]
        k = 1 if self.same_on_batch else batch
        return {"perm": _permutations(generator, k, n).expand(batch, n)}

    def apply(self, x, params):
        B, C, H, W = x.shape
        gy, gx = self.grid
        th, tw = H // gy, W // gx
        tiles = x[:, :, :gy * th, :gx * tw].reshape(B, C, gy, th, gx, tw)
        tiles = tiles.permute(0, 2, 4, 1, 3, 5).reshape(B, gy * gx, C, th,
                                                        tw)
        shuffled = torch.take_along_dim(
            tiles, params["perm"].long()[:, :, None, None, None], dim=1)
        out = shuffled.reshape(B, gy, gx, C, th, tw).permute(0, 3, 1, 4, 2, 5)
        out = out.reshape(B, C, gy * th, gx * tw)
        if (gy * th, gx * tw) != (H, W):
            out = TF.pad(out, (0, W - gx * tw, 0, H - gy * th))
        return out


class MixAugmentationBaseV2(AugmentationBase2D):
    """Label-transforming mix-augmentation base."""


# the reference exports the class as PatchMix; RandomPatchMix is this
# package's original spelling: both are kept
PatchMix = RandomPatchMix


class RandomTransplantation3D(RandomTransplantation):
    """Volumetric transplantation: the same op on (B, C, D, H, W) images
    and (B, D, H, W) masks."""


__all__ += ["MixAugmentationBaseV2", "PatchMix", "RandomTransplantation3D"]
