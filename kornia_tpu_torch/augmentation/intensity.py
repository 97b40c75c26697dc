"""2D intensity augmentations (counterpart of
``kornia_tpu/augmentation/intensity.py``).

Each class draws its parameters on the input's device and applies them
to the whole batch. ``RandomGaussianBlur`` draws one sigma per sample, so
it runs two grouped convolutions, as the JAX package never sends
per-image kernels to its fused kernel either; ``RandomBoxBlur`` and
``RandomJPEG``'s chroma blur share 1-D taps and go through the fused blur
kernel on the card. ``RandomPlanckianJitter`` clips r and b to [0, 1], as
the JAX package does (kept; it differs from torch kornia).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.grid import linspace
from ..ops import color as C
from ..ops import enhance as E
from ..ops import filters as F
from .base import IntensityAugmentationBase2D, device_table

__all__ = [
    "ColorJiggle",
    "RandomDissolving",
    "ColorJitter",
    "RandomBrightness",
    "RandomContrast",
    "RandomSaturation",
    "RandomHue",
    "RandomGamma",
    "RandomGrayscale",
    "RandomGaussianBlur",
    "RandomGaussianNoise",
    "RandomMotionBlur",
    "RandomBoxBlur",
    "RandomMedianBlur",
    "RandomSolarize",
    "RandomPosterize",
    "RandomSharpness",
    "RandomEqualize",
    "RandomCLAHE",
    "RandomAutoContrast",
    "RandomInvert",
    "RandomChannelShuffle",
    "RandomChannelDropout",
    "RandomErasing",
    "RandomSaltAndPepper",
    "RandomRGBShift",
    "RandomPlanckianJitter",
    "RandomLinearIllumination",
    "RandomPlasmaBrightness",
    "RandomPlasmaShadow",
    "RandomJPEG",
    "Normalize",
    "Denormalize",
]


def _as_range(r, default):
    if r is None:
        return default
    if isinstance(r, (int, float)):
        return (float(r), float(r))
    return (float(r[0]), float(r[1]))


class RandomBrightness(IntensityAugmentationBase2D):
    def __init__(self, brightness=(0.8, 1.2), clip_output=True, **kw):
        super().__init__(**kw)
        self.rng = _as_range(brightness, (0.8, 1.2))
        self.clip_output = clip_output

    def sample_params(self, generator, batch, shape):
        return {"factor": self._uniform(generator, batch, *self.rng)}

    def apply(self, x, params):
        # a factor around 1, applied as the ADDITIVE adjust of factor - 1
        return E.adjust_brightness(x, params["factor"] - 1.0,
                                   self.clip_output)


class RandomContrast(IntensityAugmentationBase2D):
    def __init__(self, contrast=(0.8, 1.2), clip_output=True, **kw):
        super().__init__(**kw)
        self.rng = _as_range(contrast, (0.8, 1.2))
        self.clip_output = clip_output

    def sample_params(self, generator, batch, shape):
        return {"factor": self._uniform(generator, batch, *self.rng)}

    def apply(self, x, params):
        # the MULTIPLICATIVE adjust_contrast, as the reference's
        return E.adjust_contrast(x, params["factor"], self.clip_output)


class RandomSaturation(IntensityAugmentationBase2D):
    def __init__(self, saturation=(0.8, 1.2), **kw):
        super().__init__(**kw)
        self.rng = _as_range(saturation, (0.8, 1.2))

    def sample_params(self, generator, batch, shape):
        return {"factor": self._uniform(generator, batch, *self.rng)}

    def apply(self, x, params):
        return E.adjust_saturation(x, params["factor"])


class RandomHue(IntensityAugmentationBase2D):
    def __init__(self, hue=(-0.1, 0.1), **kw):
        super().__init__(**kw)
        self.rng = _as_range(hue, (-0.1, 0.1))

    def sample_params(self, generator, batch, shape):
        return {"factor": self._uniform(generator, batch, *self.rng)}

    def apply(self, x, params):
        return E.adjust_hue(x, params["factor"] * 2.0 * math.pi)


class RandomGamma(IntensityAugmentationBase2D):
    def __init__(self, gamma=(0.8, 1.2), gain=(1.0, 1.0), **kw):
        super().__init__(**kw)
        self.g_rng = _as_range(gamma, (0.8, 1.2))
        self.gain_rng = _as_range(gain, (1.0, 1.0))

    def sample_params(self, generator, batch, shape):
        return {"gamma": self._uniform(generator, batch, *self.g_rng),
                "gain": self._uniform(generator, batch, *self.gain_rng)}

    def apply(self, x, params):
        return E.adjust_gamma(x, params["gamma"], params["gain"])


class ColorJiggle(IntensityAugmentationBase2D):
    """Brightness, contrast, saturation and hue in a fixed order."""

    def __init__(self, brightness=0.2, contrast=0.2, saturation=0.2,
                 hue=0.1, **kw):
        super().__init__(**kw)
        b = brightness if isinstance(brightness, (tuple, list)) else (
            max(0.0, 1 - brightness), 1 + brightness)
        c = contrast if isinstance(contrast, (tuple, list)) else (
            max(0.0, 1 - contrast), 1 + contrast)
        s = saturation if isinstance(saturation, (tuple, list)) else (
            max(0.0, 1 - saturation), 1 + saturation)
        h = hue if isinstance(hue, (tuple, list)) else (-hue, hue)
        self.b, self.c, self.s, self.h = b, c, s, h

    def sample_params(self, generator, batch, shape):
        return {"brightness": self._uniform(generator, batch, *self.b),
                "contrast": self._uniform(generator, batch, *self.c),
                "saturation": self._uniform(generator, batch, *self.s),
                "hue": self._uniform(generator, batch, *self.h)}

    def apply(self, x, params):
        x = E.adjust_brightness(x, params["brightness"] - 1.0)
        x = E.adjust_contrast(x, params["contrast"])
        x = E.adjust_saturation(x, params["saturation"])
        return E.adjust_hue(x, params["hue"] * 2.0 * math.pi)


ColorJitter = ColorJiggle  # torchvision-compatible alias


class RandomGrayscale(IntensityAugmentationBase2D):
    def __init__(self, p: float = 0.1, **kw):
        super().__init__(p=p, **kw)

    def apply(self, x, params):
        return C.grayscale_to_rgb(C.rgb_to_grayscale(x))


class RandomGaussianBlur(IntensityAugmentationBase2D):
    """One sigma per sample: two grouped convolutions (per-image kernels
    never go to the fused blur kernel)."""

    def __init__(self, kernel_size=(3, 3), sigma=(0.1, 2.0), **kw):
        super().__init__(**kw)
        self.kernel_size = kernel_size if isinstance(kernel_size, tuple) else (
            kernel_size, kernel_size)
        self.sigma_rng = _as_range(sigma, (0.1, 2.0))

    def sample_params(self, generator, batch, shape):
        return {"sigma": self._uniform(generator, batch, *self.sigma_rng)}

    def apply(self, x, params):
        ky, kx = self.kernel_size
        gy = F.get_gaussian_kernel1d(ky, params["sigma"])  # (B, ky)
        gx = F.get_gaussian_kernel1d(kx, params["sigma"])
        out = F.filter2d(x, gy[..., :, None], border_type="reflect")
        return F.filter2d(out, gx[..., None, :], border_type="reflect")


class RandomGaussianNoise(IntensityAugmentationBase2D):
    def __init__(self, mean: float = 0.0, std: float = 1.0, **kw):
        super().__init__(**kw)
        self.mean = mean
        self.std = std

    def sample_params(self, generator, batch, shape):
        return {"noise": self.mean + self.std * torch.randn(
            tuple(shape), generator=generator, device=generator.device)}

    def apply(self, x, params):
        # the sampled noise is added unclipped, as in the reference
        return x + params["noise"]


class RandomMotionBlur(IntensityAugmentationBase2D):
    def __init__(self, kernel_size: int = 5, angle=(-45.0, 45.0),
                 direction=(-1.0, 1.0), **kw):
        super().__init__(**kw)
        self.kernel_size = kernel_size
        self.angle_rng = _as_range(angle, (-45.0, 45.0))
        self.dir_rng = _as_range(direction, (-1.0, 1.0))

    def sample_params(self, generator, batch, shape):
        return {"angle": self._uniform(generator, batch, *self.angle_rng),
                "direction": self._uniform(generator, batch, *self.dir_rng)}

    def apply(self, x, params):
        return F.motion_blur(x, self.kernel_size, params["angle"],
                             params["direction"])


class RandomBoxBlur(IntensityAugmentationBase2D):
    """Shared 1-D box taps: one fused blur launch on the card."""

    def __init__(self, kernel_size=(3, 3), **kw):
        super().__init__(**kw)
        self.kernel_size = kernel_size

    def apply(self, x, params):
        return F.box_blur(x, self.kernel_size)


class RandomMedianBlur(IntensityAugmentationBase2D):
    def __init__(self, kernel_size=(3, 3), **kw):
        super().__init__(**kw)
        self.kernel_size = kernel_size

    def apply(self, x, params):
        return F.median_blur(x, self.kernel_size)


class RandomSolarize(IntensityAugmentationBase2D):
    def __init__(self, thresholds=0.1, additions=0.1, **kw):
        super().__init__(**kw)
        t = thresholds if isinstance(thresholds, (tuple, list)) else (
            0.5 - thresholds, 0.5 + thresholds)
        a = additions if isinstance(additions, (tuple, list)) else (
            -additions, additions)
        self.t_rng, self.a_rng = t, a

    def sample_params(self, generator, batch, shape):
        return {"thresholds": self._uniform(generator, batch, *self.t_rng),
                "additions": self._uniform(generator, batch, *self.a_rng)}

    def apply(self, x, params):
        return E.solarize(x, params["thresholds"], params["additions"])


class RandomPosterize(IntensityAugmentationBase2D):
    def __init__(self, bits=3, **kw):
        super().__init__(**kw)
        self.bits_rng = bits if isinstance(bits, (tuple, list)) else (bits, 8)

    def sample_params(self, generator, batch, shape):
        lo, hi = self.bits_rng
        return {"bits": self._randint(generator, batch, lo, hi + 1)}

    def apply(self, x, params):
        return E.posterize(x, params["bits"])


class RandomSharpness(IntensityAugmentationBase2D):
    def __init__(self, sharpness=0.5, **kw):
        super().__init__(**kw)
        s = sharpness if isinstance(sharpness, (tuple, list)) else (
            0.0, sharpness)
        self.s_rng = s

    def sample_params(self, generator, batch, shape):
        return {"factor": self._uniform(generator, batch, *self.s_rng)}

    def apply(self, x, params):
        return E.sharpness(x, params["factor"])


class RandomEqualize(IntensityAugmentationBase2D):
    def apply(self, x, params):
        return E.equalize(x)


class RandomCLAHE(IntensityAugmentationBase2D):
    def __init__(self, clip_limit=(40.0, 40.0), grid_size=(8, 8), **kw):
        super().__init__(**kw)
        self.clip_rng = _as_range(clip_limit, (40.0, 40.0))
        self.grid_size = grid_size

    def apply(self, x, params):
        return E.equalize_clahe(x, self.clip_rng[1], self.grid_size)


class RandomAutoContrast(IntensityAugmentationBase2D):
    def __init__(self, clip_output: bool = True, **kw):
        super().__init__(**kw)
        self.clip_output = clip_output

    def apply(self, x, params):
        out = E.normalize_min_max(x)
        return out.clamp(0.0, 1.0) if self.clip_output else out


class RandomInvert(IntensityAugmentationBase2D):
    def __init__(self, max_val: float = 1.0, **kw):
        super().__init__(**kw)
        self.max_val = max_val

    def apply(self, x, params):
        return E.invert(x, self.max_val)


def _permutations(generator, n_perm: int, n: int) -> torch.Tensor:
    """n_perm uniform permutations of range(n), int32 (n_perm, n)."""
    keys = torch.rand((n_perm, n), generator=generator,
                      device=generator.device)
    return torch.argsort(keys, dim=-1).to(torch.int32)


class RandomChannelShuffle(IntensityAugmentationBase2D):
    def sample_params(self, generator, batch, shape):
        n = 1 if self.same_on_batch else batch
        perm = _permutations(generator, n, shape[1])
        return {"perm": perm.expand(batch, shape[1])}

    def apply(self, x, params):
        return torch.take_along_dim(
            x, params["perm"][:, :, None, None].long(), dim=1)


class RandomChannelDropout(IntensityAugmentationBase2D):
    def __init__(self, num_drop_channels: int = 1, fill_value: float = 0.0,
                 **kw):
        super().__init__(**kw)
        self.num_drop = num_drop_channels
        self.fill_value = fill_value

    def sample_params(self, generator, batch, shape):
        scores = torch.rand((batch, shape[1]), generator=generator,
                            device=generator.device)
        idx = torch.topk(scores, self.num_drop, dim=-1).indices
        drop = torch.zeros((batch, shape[1]), dtype=torch.bool,
                           device=scores.device)
        return {"drop": drop.scatter(1, idx, True)}

    def apply(self, x, params):
        m = params["drop"][:, :, None, None]
        return torch.where(m, self.fill_value, x)


class RandomErasing(IntensityAugmentationBase2D):
    """Rectangle erasing."""

    def __init__(self, scale=(0.02, 0.33), ratio=(0.3, 3.3), value=0.0,
                 **kw):
        super().__init__(**kw)
        self.scale = scale
        self.ratio = ratio
        self.value = value

    def sample_params(self, generator, batch, shape):
        H, W = shape[-2:]
        area = self._uniform(generator, batch, *self.scale) * H * W
        log_ratio = self._uniform(generator, batch, math.log(self.ratio[0]),
                                  math.log(self.ratio[1]))
        ratio = torch.exp(log_ratio)
        h = torch.sqrt(area * ratio).clamp(1, H)
        w = torch.sqrt(area / ratio).clamp(1, W)
        y0 = self._uniform(generator, batch, 0.0, 1.0) * (H - h)
        x0 = self._uniform(generator, batch, 0.0, 1.0) * (W - w)
        return {"y0": y0, "x0": x0, "h": h, "w": w}

    def apply(self, x, params):
        H, W = x.shape[-2:]
        ys = torch.arange(H, dtype=x.dtype, device=x.device)[None, :, None]
        xs = torch.arange(W, dtype=x.dtype, device=x.device)[None, None, :]
        y0 = params["y0"][:, None, None]
        x0 = params["x0"][:, None, None]
        h = params["h"][:, None, None]
        w = params["w"][:, None, None]
        inside = (ys >= y0) & (ys < y0 + h) & (xs >= x0) & (xs < x0 + w)
        return torch.where(inside[:, None], self.value, x)


class RandomSaltAndPepper(IntensityAugmentationBase2D):
    def __init__(self, amount=(0.01, 0.06), salt_vs_pepper=(0.4, 0.6),
                 **kw):
        super().__init__(**kw)
        self.amount = _as_range(amount, (0.01, 0.06))
        self.svp = _as_range(salt_vs_pepper, (0.4, 0.6))

    def sample_params(self, generator, batch, shape):
        B, _, H, W = shape
        amount = self._uniform(generator, batch, *self.amount)[:, None, None]
        svp = self._uniform(generator, batch, *self.svp)[:, None, None]
        u = torch.rand((B, H, W), generator=generator,
                       device=generator.device)
        salt = u < amount * svp
        pepper = (u >= amount * svp) & (u < amount)
        return {"salt": salt, "pepper": pepper}

    def apply(self, x, params):
        x = torch.where(params["salt"][:, None], 1.0, x)
        return torch.where(params["pepper"][:, None], 0.0, x)


class RandomRGBShift(IntensityAugmentationBase2D):
    def __init__(self, r_shift_limit=0.5, g_shift_limit=0.5,
                 b_shift_limit=0.5, **kw):
        super().__init__(**kw)
        self.limits = (r_shift_limit, g_shift_limit, b_shift_limit)

    def sample_params(self, generator, batch, shape):
        r, g, b = self.limits
        return {"r": self._uniform(generator, batch, -r, r),
                "g": self._uniform(generator, batch, -g, g),
                "b": self._uniform(generator, batch, -b, b)}

    def apply(self, x, params):
        return E.shift_rgb(x, params["r"], params["g"], params["b"])


# Planckian-locus r/b gain tables of the Planckian Jitter paper (Zini et al.
# 2022), the reference's published constants
_PLANCKIAN_BLACKBODY = np.array(
    [[1.6736, 0.0032], [1.4810, 0.3926], [1.3538, 0.5748], [1.2616, 0.7077],
     [1.1907, 0.8133], [1.1335, 0.9008], [1.0862, 0.9747], [1.0460, 1.0387],
     [1.0115, 1.0940], [0.9810, 1.1423], [0.9543, 1.1852], [0.9302, 1.2233],
     [0.9086, 1.2573], [0.8891, 1.2879], [0.8713, 1.3155], [0.8552, 1.3406],
     [0.8402, 1.3633], [0.8262, 1.3840], [0.8134, 1.4029], [0.8015, 1.4203],
     [0.7905, 1.4367], [0.7802, 1.4513], [0.7704, 1.4651], [0.7615, 1.4779],
     [0.7528, 1.4900]], np.float32)
_PLANCKIAN_CIED = np.array(
    [[1.3185, 0.5175], [1.2206, 0.6531], [1.1464, 0.7622], [1.0873, 0.8534],
     [1.0387, 0.9309], [0.9972, 0.9972], [0.9618, 1.0549], [0.9301, 1.1053],
     [0.9021, 1.1496], [0.8772, 1.1889], [0.8543, 1.2238], [0.8334, 1.2548],
     [0.8142, 1.2829], [0.7966, 1.3085], [0.7804, 1.3316], [0.7649, 1.3523],
     [0.7508, 1.3715], [0.7374, 1.3891], [0.7249, 1.4052], [0.7131, 1.4202],
     [0.7021, 1.4338], [0.6915, 1.4465], [0.6817, 1.4584]], np.float32)


class RandomPlanckianJitter(IntensityAugmentationBase2D):
    """White-balance jitter along the Planckian locus. mode: 'blackbody'
    (25 illuminants) or 'CIED' (23). The table moves to the input's
    device at first use (cached per device). r and b are clipped to
    [0, 1], as in the JAX package."""

    def __init__(self, mode: str = "blackbody", **kw):
        super().__init__(**kw)
        if mode not in ("blackbody", "CIED"):
            raise ValueError(f"mode must be blackbody or CIED, got {mode}")
        self.pl = (_PLANCKIAN_BLACKBODY if mode == "blackbody"
                   else _PLANCKIAN_CIED)

    def sample_params(self, generator, batch, shape):
        idx = self._randint(generator, batch, 0, self.pl.shape[0])
        pl = device_table(self, "pl", self.pl, generator.device)
        return {"gains": pl[idx.long()]}

    def apply(self, x, params):
        g = params["gains"]
        r = (x[:, 0:1] * g[:, 0].reshape(-1, 1, 1, 1)).clamp(0, 1)
        b = (x[:, 2:3] * g[:, 1].reshape(-1, 1, 1, 1)).clamp(0, 1)
        return torch.cat([r, x[:, 1:2], b], dim=1)


class RandomLinearIllumination(IntensityAugmentationBase2D):
    """Linear illumination gradient."""

    def __init__(self, gain=(0.01, 0.2), **kw):
        super().__init__(**kw)
        self.gain_rng = _as_range(gain, (0.01, 0.2))

    def sample_params(self, generator, batch, shape):
        return {"gain": self._uniform(generator, batch, *self.gain_rng),
                "angle": self._uniform(generator, batch, -math.pi,
                                       math.pi)}

    def apply(self, x, params):
        H, W = x.shape[-2:]
        ys = linspace(-1.0, 1.0, H, x.device)[None, :, None]
        xs = linspace(-1.0, 1.0, W, x.device)[None, None, :]
        a = params["angle"][:, None, None]
        ramp = xs * torch.cos(a) + ys * torch.sin(a)  # (B, H, W)
        gain = params["gain"][:, None, None]
        return (x + (gain * ramp)[:, None]).clamp(0.0, 1.0)


def _plasma(generator, shape, roughness) -> torch.Tensor:
    from ..contrib.ops import diamond_square
    B, _, H, W = shape
    rough = float(np.mean(np.asarray(roughness, np.float32)))
    return diamond_square((B, 1, H, W), rough, generator=generator,
                          device=generator.device)


class RandomPlasmaBrightness(IntensityAugmentationBase2D):
    """Fractal brightness field."""

    def __init__(self, roughness=(0.1, 0.7), intensity=(0.0, 0.4), **kw):
        super().__init__(**kw)
        self.roughness = _as_range(roughness, (0.1, 0.7))
        self.intensity = _as_range(intensity, (0.0, 0.4))

    def sample_params(self, generator, batch, shape):
        return {"field": _plasma(generator, shape, self.roughness),
                "intensity": self._uniform(generator, batch,
                                           *self.intensity)}

    def apply(self, x, params):
        i = params["intensity"][:, None, None, None]
        return (x + i * (2.0 * params["field"] - 1.0)).clamp(0.0, 1.0)


class RandomPlasmaShadow(IntensityAugmentationBase2D):
    def __init__(self, roughness=(0.1, 0.7), shade_intensity=(-1.0, 0.0),
                 shade_quantity=(0.0, 1.0), **kw):
        super().__init__(**kw)
        self.roughness = _as_range(roughness, (0.1, 0.7))
        self.intensity = _as_range(shade_intensity, (-1.0, 0.0))
        self.quantity = _as_range(shade_quantity, (0.0, 1.0))

    def sample_params(self, generator, batch, shape):
        return {"field": _plasma(generator, shape, self.roughness),
                "intensity": self._uniform(generator, batch,
                                           *self.intensity),
                "quantity": self._uniform(generator, batch, *self.quantity)}

    def apply(self, x, params):
        shade = params["field"] < params["quantity"][:, None, None, None]
        i = params["intensity"][:, None, None, None]
        return (x + shade * i).clamp(0.0, 1.0)


class RandomJPEG(IntensityAugmentationBase2D):
    """Differentiable JPEG degradation; its chroma blur is one fused blur
    launch on the card."""

    def __init__(self, jpeg_quality=(10.0, 90.0), **kw):
        super().__init__(**kw)
        self.quality_rng = _as_range(jpeg_quality, (10.0, 90.0))

    def sample_params(self, generator, batch, shape):
        return {"quality": self._uniform(generator, batch,
                                         *self.quality_rng)}

    def apply(self, x, params):
        from ..ops.jpeg import jpeg_codec_differentiable
        return jpeg_codec_differentiable(x, params["quality"])


class _MeanStd(IntensityAugmentationBase2D):
    """mean and std as given, and as float32 tensors on each device they
    are used on (cached: a forward uploads nothing)."""

    def __init__(self, mean, std, **kw):
        super().__init__(p=1.0, **kw)
        self.mean = mean
        self.std = std

    def _on(self, x):
        def one(v, name):
            if isinstance(v, torch.Tensor):
                return v.to(x.device, x.dtype)
            return device_table(self, name,
                                np.ravel(np.asarray(v, np.float32)), x.device)
        return one(self.mean, "mean"), one(self.std, "std")


class Normalize(_MeanStd):
    def apply(self, x, params):
        return E.normalize(x, *self._on(x))


class Denormalize(_MeanStd):
    def apply(self, x, params):
        return E.denormalize(x, *self._on(x))


class RandomDissolving(IntensityAugmentationBase2D):
    """One-step reverse-diffusion 'dissolve' through
    ``models/diffusion.py::StableDiffusionDissolving``. The step is drawn
    over [0, num_ddim_steps), as in the JAX package. H, W must be
    multiples of 8. Without a `model`, the default one is built at first
    use on the input's device (weights seeded 0)."""

    def __init__(self, step_range=None, model=None, **kw):
        from ..models.diffusion import DiffusionConfig
        kw.setdefault("same_on_batch", True)
        super().__init__(**kw)
        self._dslv = model
        n = (model.cfg if model is not None
             else DiffusionConfig()).num_ddim_steps
        self.step_range = step_range or (0, n - 1)

    def sample_params(self, generator, batch, shape):
        lo, hi = self.step_range
        step = torch.randint(int(lo), int(hi) + 1, (batch,),
                             generator=generator, device=generator.device,
                             dtype=torch.int32)
        return {"step": step}

    def apply(self, x, params):
        if self._dslv is None:
            from ..models.diffusion import StableDiffusionDissolving
            self._dslv = StableDiffusionDissolving(device=x.device)
        return self._dslv.dissolve(x, params["step"][0])


class RandomSnow(IntensityAugmentationBase2D):
    """Brighten dark L-channel regions (HLS threshold and gain)."""

    def __init__(self, snow_coefficient=(0.5, 0.5), brightness=(2.0, 2.0),
                 **kw):
        kw.setdefault("p", 1.0)
        super().__init__(**kw)
        self.snow_rng = _as_range(snow_coefficient, (0.5, 0.5))
        self.bright_rng = _as_range(brightness, (2.0, 2.0))

    def sample_params(self, generator, batch, shape):
        return {"snow_coefficient": self._uniform(generator, batch,
                                                  *self.snow_rng),
                "brightness": self._uniform(generator, batch,
                                            *self.bright_rng)}

    def apply(self, x, params):
        hls = C.rgb_to_hls(x)
        snow = params["snow_coefficient"][:, None, None]
        bright = params["brightness"][:, None, None, None]
        light = hls[:, 1]
        mask = (light < snow).to(x.dtype)[:, None]
        # on the lightness only
        mask = torch.nn.functional.pad(mask, (0, 0, 0, 0, 1, 1))
        new = (hls * mask * bright).clamp(0.0, 1.0)
        return C.hls_to_rgb(hls * (1.0 - mask) + new)


class RandomRain(IntensityAugmentationBase2D):
    """Rain streaks (value 200/255): every image scatters a fixed
    (max_drops, max_line_len) lattice of coordinates in one call, drops
    beyond the sampled count sent out of range and dropped."""

    def __init__(self, number_of_drops=(1000, 2000), drop_height=(5, 20),
                 drop_width=(-5, 5), **kw):
        super().__init__(**kw)
        self.n_rng = (int(number_of_drops[0]), int(number_of_drops[1]))
        self.h_rng = (int(drop_height[0]), int(drop_height[1]))
        self.w_rng = (int(drop_width[0]), int(drop_width[1]))

    def sample_params(self, generator, batch, shape):
        dev = generator.device

        def randint(lo, hi):
            return torch.randint(lo, hi + 1, (batch,), generator=generator,
                                 device=dev, dtype=torch.int32)
        return {"n": randint(*self.n_rng), "height": randint(*self.h_rng),
                "width": randint(*self.w_rng),
                "coords": torch.rand((batch, self.n_rng[1], 2),
                                     generator=generator, device=dev)}

    def apply(self, x, params):
        B, Cc, H, W = x.shape
        nmax = params["coords"].shape[1]
        lmax = max(self.h_rng[1], abs(self.w_rng[0]), abs(self.w_rng[1]), 1)
        h = params["height"].to(x.dtype)
        w = params["width"].to(x.dtype)
        cy = params["coords"][..., 0] * (H - h[:, None] - 1.0)
        cx = torch.where(
            (w > 0)[:, None],
            params["coords"][..., 1] * (W - w[:, None] - 1.0),
            params["coords"][..., 1] * (W + w[:, None] - 1.0) - w[:, None])
        t = linspace(0.0, 1.0, lmax, x.device)
        yy = (cy[..., None] + torch.floor(t * h[:, None, None])).to(
            torch.int32)
        xx = (cx[..., None] + torch.floor(t * w[:, None, None])).to(
            torch.int32)
        ok = (torch.arange(nmax, device=x.device)[None]
              < params["n"][:, None])[..., None]
        flat_idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        idx = torch.where(ok, flat_idx, H * W).long().reshape(B, 1, -1)
        # one spare column takes the masked drops
        flat = torch.cat([x.reshape(B, Cc, H * W),
                          x.new_zeros((B, Cc, 1))], dim=-1)
        out = flat.scatter(2, idx.expand(B, Cc, idx.shape[-1]),
                           200.0 / 255.0)
        return out[..., :H * W].reshape(B, Cc, H, W)


def _normalized_ramp(grad: torch.Tensor, params) -> torch.Tensor:
    mn = grad.amin(dim=(-2, -1), keepdim=True)
    mx = grad.amax(dim=(-2, -1), keepdim=True)
    grad = (grad - mn) / (mx - mn).clamp_min(1e-12)
    return (params["sign"] * params["gain"])[:, None, None] * grad


class RandomGaussianIllumination(IntensityAugmentationBase2D):
    """Additive 2D Gaussian illumination."""

    def __init__(self, gain=(0.01, 0.15), center=(0.1, 0.9),
                 sigma=(0.2, 1.0), sign=(-1.0, 1.0), **kw):
        super().__init__(**kw)
        self.gain_rng = _as_range(gain, (0.01, 0.15))
        self.center_rng = _as_range(center, (0.1, 0.9))
        self.sigma_rng = _as_range(sigma, (0.2, 1.0))
        self.sign_rng = _as_range(sign, (-1.0, 1.0))

    def sample_params(self, generator, batch, shape):
        u = lambda r: self._uniform(generator, batch, *r)  # noqa: E731
        out = {"gain": u(self.gain_rng), "cx": u(self.center_rng),
               "cy": u(self.center_rng), "sx": u(self.sigma_rng),
               "sy": u(self.sigma_rng)}
        out["sign"] = torch.where(u(self.sign_rng) >= 0, 1.0, -1.0)
        return out

    def apply(self, x, params):
        B, Cc, H, W = x.shape
        gx = F.gaussian(W, (params["sx"] * W)[:, None],
                        mean=torch.round(params["cx"] * W)[:, None],
                        device=x.device)
        gy = F.gaussian(H, (params["sy"] * H)[:, None],
                        mean=torch.round(params["cy"] * H)[:, None],
                        device=x.device)
        grad = _normalized_ramp(gy[:, :, None] * gx[:, None, :], params)
        return (x + grad[:, None]).clamp(0.0, 1.0)


class RandomLinearCornerIllumination(IntensityAugmentationBase2D):
    """Additive corner-anchored linear illumination."""

    def __init__(self, gain=(0.01, 0.2), sign=(-1.0, 1.0), **kw):
        super().__init__(**kw)
        self.gain_rng = _as_range(gain, (0.01, 0.2))
        self.sign_rng = _as_range(sign, (-1.0, 1.0))

    def sample_params(self, generator, batch, shape):
        gain = self._uniform(generator, batch, *self.gain_rng)
        sign = torch.where(self._uniform(generator, batch, *self.sign_rng)
                           >= 0, 1.0, -1.0)
        corner = torch.randint(0, 4, (batch,), generator=generator,
                               device=generator.device, dtype=torch.int32)
        return {"gain": gain, "sign": sign, "corner": corner}

    def apply(self, x, params):
        H, W = x.shape[-2:]
        yg = linspace(0.0, 1.0, H, x.device)[:, None].expand(H, W)
        xg = linspace(0.0, 1.0, W, x.device)[None, :].expand(H, W)
        base = torch.stack([xg + yg, -xg + yg, xg - yg, 1.0 - (xg + yg)])
        grad = _normalized_ramp(base[params["corner"].long()], params)
        return (x + grad[:, None]).clamp(0.0, 1.0)


class RandomPlasmaContrast(IntensityAugmentationBase2D):
    """Fractal contrast field: (x - 0.5) · 4 · plasma + 0.5."""

    def __init__(self, roughness=(0.1, 0.7), **kw):
        super().__init__(**kw)
        self.roughness = _as_range(roughness, (0.1, 0.7))

    def sample_params(self, generator, batch, shape):
        return {"field": _plasma(generator, shape, self.roughness)}

    def apply(self, x, params):
        return ((x - 0.5) * 4.0 * params["field"] + 0.5).clamp(0.0, 1.0)


# the reference's spellings (kornia/augmentation/__init__.py exports both)
RandomClahe = RandomCLAHE
RandomSaltAndPepperNoise = RandomSaltAndPepper

__all__ += [
    "RandomSnow", "RandomRain", "RandomGaussianIllumination",
    "RandomLinearCornerIllumination", "RandomPlasmaContrast",
    "RandomClahe", "RandomSaltAndPepperNoise",
]
