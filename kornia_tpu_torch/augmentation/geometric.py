"""2D geometric augmentations (counterpart of
``kornia_tpu/augmentation/geometric.py``).

Every op defines its (B, 3, 3) transform; warping, box and keypoint
transforms and inverses all go through that matrix. ``apply`` takes the
resample mode (``GeometricAugmentationBase2D``): the mask path asks for
nearest; ops that never resample by matrix (flips, elastic, TPS, fisheye)
ignore it, as the JAX package's do. ``RandomElasticTransform``'s 63-tap
Gaussian smoothing of its (B, 2, H, W) noise is one fused blur launch on
the card.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as TF

from ..core.dtype import as_float, host_tensor
from ..ops.warp import (
    get_affine_matrix2d,
    get_perspective_transform,
    get_rotation_matrix2d,
    get_translation_matrix2d,
    warp_perspective,
)
from .base import GeometricAugmentationBase2D

__all__ = [
    "Resize",
    "LongestMaxSize",
    "SmallestMaxSize",
    "RandomHorizontalFlip",
    "RandomVerticalFlip",
    "RandomRotation",
    "RandomRotation90",
    "RandomAffine",
    "RandomPerspective",
    "RandomShear",
    "RandomTranslate",
    "RandomCrop",
    "RandomResizedCrop",
    "CenterCrop",
    "RandomElasticTransform",
    "RandomThinPlateSpline",
    "RandomFisheye",
]


def _const_batch(rows, B: int, device) -> torch.Tensor:
    """A constant matrix (nested tuples), broadcast to (B, ...)."""
    t = host_tensor(rows, device)
    return t.expand(B, *t.shape)


def _scale_matrix(in_hw, out_hw, B: int, device) -> torch.Tensor:
    (H, W), (h, w) = in_hw, out_hw
    return _const_batch(((float(w - 1.0) / max(W - 1, 1), 0.0, 0.0),
                         (0.0, float(h - 1.0) / max(H - 1, 1), 0.0),
                         (0.0, 0.0, 1.0)), B, device)


def _centre(B: int, H: int, W: int, device) -> torch.Tensor:
    return _const_batch(((W - 1) / 2.0, (H - 1) / 2.0), B, device)


def _to_homography(A: torch.Tensor) -> torch.Tensor:
    from ..geometry.conversions import convert_affinematrix_to_homography
    return convert_affinematrix_to_homography(A)


class Resize(GeometricAugmentationBase2D):
    """Deterministic resize."""

    def __init__(self, size, interpolation: str = "bilinear",
                 antialias: bool = False, **kw):
        super().__init__(p=1.0, **kw)
        self.size = (size, size) if isinstance(size, int) else size
        self.interpolation = interpolation
        self.antialias = antialias

    def __call__(self, x, generator=None, params=None):
        from ..ops.warp import resize
        return resize(as_float(x), self.size, self.interpolation,
                      antialias=self.antialias)

    def out_size(self, in_hw):
        return (int(self.size[0]), int(self.size[1]))

    def matrix(self, params, shape):
        B = params["apply_mask"].shape[0]
        return _scale_matrix(shape[-2:], self.out_size(shape[-2:]), B,
                             params["apply_mask"].device)


class LongestMaxSize(GeometricAugmentationBase2D):
    """Resize so the longest side equals max_size."""

    def __init__(self, max_size: int, **kw):
        super().__init__(p=1.0, **kw)
        self.max_size = max_size

    def __call__(self, x, generator=None, params=None):
        from ..ops.warp import resize
        return resize(as_float(x), self.max_size, side="long")

    def out_size(self, in_hw):
        H, W = in_hw
        s = self.max_size / max(H, W)
        return (int(round(H * s)), int(round(W * s)))

    def matrix(self, params, shape):
        B = params["apply_mask"].shape[0]
        return _scale_matrix(shape[-2:], self.out_size(shape[-2:]), B,
                             params["apply_mask"].device)


class SmallestMaxSize(GeometricAugmentationBase2D):
    """Resize so the shortest side equals max_size."""

    def __init__(self, max_size: int, **kw):
        super().__init__(p=1.0, **kw)
        self.max_size = max_size

    def __call__(self, x, generator=None, params=None):
        from ..ops.warp import resize
        return resize(as_float(x), self.max_size, side="short")

    def out_size(self, in_hw):
        H, W = in_hw
        s = self.max_size / min(H, W)
        return (int(round(H * s)), int(round(W * s)))

    def matrix(self, params, shape):
        B = params["apply_mask"].shape[0]
        return _scale_matrix(shape[-2:], self.out_size(shape[-2:]), B,
                             params["apply_mask"].device)


class RandomHorizontalFlip(GeometricAugmentationBase2D):
    def matrix(self, params, shape):
        mask = params["apply_mask"]
        W = shape[-1]
        return _const_batch(((-1.0, 0.0, W - 1.0), (0.0, 1.0, 0.0),
                             (0.0, 0.0, 1.0)), mask.shape[0], mask.device)

    def apply(self, x, params, resample=None):
        return torch.flip(x, dims=(-1,))  # exact flip, no resampling


class RandomVerticalFlip(GeometricAugmentationBase2D):
    def matrix(self, params, shape):
        mask = params["apply_mask"]
        H = shape[-2]
        return _const_batch(((1.0, 0.0, 0.0), (0.0, -1.0, H - 1.0),
                             (0.0, 0.0, 1.0)), mask.shape[0], mask.device)

    def apply(self, x, params, resample=None):
        return torch.flip(x, dims=(-2,))


class RandomRotation(GeometricAugmentationBase2D):
    def __init__(self, degrees=15.0, resample="bilinear",
                 padding_mode="zeros", **kw):
        super().__init__(**kw)
        d = degrees if isinstance(degrees, (tuple, list)) else (-degrees,
                                                                degrees)
        self.degrees = d
        self.flags = {"resample": resample, "padding_mode": padding_mode}

    def sample_params(self, generator, batch, shape):
        return {"degrees": self._uniform(generator, batch, *self.degrees)}

    def matrix(self, params, shape):
        deg = params["degrees"]
        B = deg.shape[0]
        H, W = shape[-2:]
        A = get_rotation_matrix2d(_centre(B, H, W, deg.device), deg,
                                  torch.ones((B, 2), device=deg.device))
        return _to_homography(A)


class RandomRotation90(GeometricAugmentationBase2D):
    """Rotation by multiples of 90°."""

    def __init__(self, times=(0, 3), **kw):
        super().__init__(**kw)
        self.times = times

    def sample_params(self, generator, batch, shape):
        return {"k": self._randint(generator, batch, self.times[0],
                                   self.times[1] + 1)}

    def matrix(self, params, shape):
        k = params["k"]
        B = k.shape[0]
        H, W = shape[-2:]
        A = get_rotation_matrix2d(_centre(B, H, W, k.device),
                                  90.0 * k.to(torch.float32),
                                  torch.ones((B, 2), device=k.device))
        return _to_homography(A)

    def apply(self, x, params, resample=None):
        # exact rot90 per k, a select over the 4 variants (square images)
        H, W = x.shape[-2:]
        if H == W:
            opts = torch.stack([x] + [torch.rot90(x, r, (-2, -1))
                                      for r in (1, 2, 3)])
            k = torch.remainder(params["k"].long(), 4)
            return torch.take_along_dim(opts, k[None, :, None, None, None],
                                        dim=0)[0]
        return super().apply(x, params, resample)


class RandomAffine(GeometricAugmentationBase2D):
    def __init__(self, degrees=15.0, translate=None, scale=None, shear=None,
                 resample="bilinear", padding_mode="zeros", **kw):
        super().__init__(**kw)
        self.degrees = degrees if isinstance(degrees, (tuple, list)) else (
            -degrees, degrees)
        self.translate = translate
        self.scale_rng = scale
        self.shear = (shear if shear is None
                      or isinstance(shear, (tuple, list)) else (-shear, shear))
        self.flags = {"resample": resample, "padding_mode": padding_mode}

    def sample_params(self, generator, batch, shape):
        H, W = shape[-2:]
        dev = generator.device
        u = lambda lo, hi: self._uniform(generator, batch, lo, hi)  # noqa
        p = {"degrees": u(*self.degrees)}
        if self.translate is not None:
            tx, ty = self.translate
            p["tx"] = u(-tx * W, tx * W)
            p["ty"] = u(-ty * H, ty * H)
        else:
            p["tx"] = torch.zeros(batch, device=dev)
            p["ty"] = torch.zeros(batch, device=dev)
        p["scale"] = (u(*self.scale_rng[:2]) if self.scale_rng is not None
                      else torch.ones(batch, device=dev))
        p["shear_x"] = (torch.deg2rad(u(*self.shear))
                        if self.shear is not None
                        else torch.zeros(batch, device=dev))
        return p

    def matrix(self, params, shape):
        deg = params["degrees"]
        B = deg.shape[0]
        H, W = shape[-2:]
        t = torch.stack([params["tx"], params["ty"]], -1)
        s = torch.stack([params["scale"], params["scale"]], -1)
        return get_affine_matrix2d(t, _centre(B, H, W, deg.device), s, deg,
                                   sx=params["shear_x"])


class RandomShear(RandomAffine):
    def __init__(self, shear=(-10.0, 10.0), **kw):
        super().__init__(degrees=0.0, shear=shear, **kw)


class RandomTranslate(RandomAffine):
    def __init__(self, translate=(0.1, 0.1), **kw):
        super().__init__(degrees=0.0, translate=translate, **kw)


def _corners(H: int, W: int, device) -> torch.Tensor:
    return host_tensor(((0.0, 0.0), (W - 1.0, 0.0), (W - 1.0, H - 1.0),
                        (0.0, H - 1.0)), device)


class RandomPerspective(GeometricAugmentationBase2D):
    def __init__(self, distortion_scale: float = 0.5, resample="bilinear",
                 **kw):
        super().__init__(**kw)
        self.distortion_scale = distortion_scale
        self.flags = {"resample": resample}

    def sample_params(self, generator, batch, shape):
        H, W = shape[-2:]
        dev = generator.device
        d = self.distortion_scale
        # each corner jittered inward by up to d/2 of the size
        n = (4, 2) if self.same_on_batch else (batch, 4, 2)
        jit = torch.rand(n, generator=generator, device=dev) * d / 2.0
        jit = jit.expand(batch, 4, 2)
        corners = _corners(H, W, dev)
        signs = host_tensor(((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0),
                             (1.0, -1.0)), dev)
        size = host_tensor((float(W), float(H)), dev)
        dst = corners[None] + jit * signs[None] * size
        return {"src": corners.expand(batch, 4, 2), "dst": dst}

    def matrix(self, params, shape):
        return get_perspective_transform(params["src"], params["dst"])


class _AlwaysApplied(GeometricAugmentationBase2D):
    """Ops whose output has another size: they always apply (p = 1)."""

    def __call__(self, x, generator=None, params=None):
        x = as_float(x)
        return self.apply(x, self._params_for(x, generator, params))


class RandomCrop(_AlwaysApplied):
    """Crop to `size` at a random location; the output has the crop
    size."""

    def __init__(self, size: Tuple[int, int], resample="bilinear",
                 padding_mode="zeros", **kw):
        # the output's shape is the crop's, so the op always applies; a
        # caller's p is accepted and ignored, as in the reference's API
        kw.pop("p", None)
        super().__init__(p=1.0, **kw)
        self.size = size
        self.flags = {"resample": resample, "padding_mode": padding_mode}

    def sample_params(self, generator, batch, shape):
        H, W = shape[-2:]
        h, w = self.size
        y0 = self._uniform(generator, batch, 0.0, max(H - h, 0) + 1e-6)
        x0 = self._uniform(generator, batch, 0.0, max(W - w, 0) + 1e-6)
        return {"y0": torch.floor(y0), "x0": torch.floor(x0)}

    def out_size(self, in_hw):
        return (int(self.size[0]), int(self.size[1]))

    def matrix(self, params, shape):
        t = torch.stack([-params["x0"], -params["y0"]], -1)
        return get_translation_matrix2d(t)

    def apply(self, x, params, resample=None):
        M = self.matrix(params, tuple(x.shape))
        return warp_perspective(x, M, tuple(self.size),
                                mode=self._resample(resample),
                                align_corners=True)


class RandomResizedCrop(_AlwaysApplied):
    def __init__(self, size: Tuple[int, int], scale=(0.08, 1.0),
                 ratio=(3 / 4, 4 / 3), resample="bilinear", **kw):
        kw.pop("p", None)  # the output's shape is fixed: always applies
        super().__init__(p=1.0, **kw)
        self.size = size
        self.scale = scale
        self.ratio = ratio
        self.flags = {"resample": resample}

    def sample_params(self, generator, batch, shape):
        H, W = shape[-2:]
        area = self._uniform(generator, batch, *self.scale) * H * W
        logr = self._uniform(generator, batch, math.log(self.ratio[0]),
                             math.log(self.ratio[1]))
        ratio = torch.exp(logr)
        w = torch.sqrt(area * ratio).clamp(8.0, W)
        h = torch.sqrt(area / ratio).clamp(8.0, H)
        y0 = self._uniform(generator, batch, 0.0, 1.0) * (H - h)
        x0 = self._uniform(generator, batch, 0.0, 1.0) * (W - w)
        return {"y0": y0, "x0": x0, "h": h, "w": w}

    def out_size(self, in_hw):
        return (int(self.size[0]), int(self.size[1]))

    def matrix(self, params, shape):
        """Maps the crop box to the output rectangle."""
        h_out, w_out = self.size
        x0, y0 = params["x0"], params["y0"]
        x1 = x0 + params["w"] - 1
        y1 = y0 + params["h"] - 1
        src = torch.stack([torch.stack([x0, y0], -1),
                           torch.stack([x1, y0], -1),
                           torch.stack([x1, y1], -1),
                           torch.stack([x0, y1], -1)], dim=1)
        dst = _corners(h_out, w_out, x0.device).expand(x0.shape[0], 4, 2)
        return get_perspective_transform(src, dst)

    def apply(self, x, params, resample=None):
        M = self.matrix(params, tuple(x.shape))
        return warp_perspective(x, M, tuple(self.size),
                                mode=self._resample(resample),
                                align_corners=True)


class CenterCrop(GeometricAugmentationBase2D):
    def __init__(self, size, **kw):
        super().__init__(p=1.0, **kw)
        self.size = (size, size) if isinstance(size, int) else size

    def __call__(self, x, generator=None, params=None):
        from ..ops.warp import center_crop
        return center_crop(as_float(x), self.size)

    def out_size(self, in_hw):
        return (int(self.size[0]), int(self.size[1]))

    def matrix(self, params, shape):
        H, W = shape[-2:]
        h, w = self.size
        mask = params["apply_mask"]
        x0 = float(math.floor((W - w) / 2.0))
        y0 = float(math.floor((H - h) / 2.0))
        return _const_batch(((1.0, 0.0, -x0), (0.0, 1.0, -y0),
                             (0.0, 0.0, 1.0)), mask.shape[0], mask.device)


class RandomElasticTransform(GeometricAugmentationBase2D):
    """Elastic deformation by (B, 2, H, W) noise smoothed with a
    Gaussian (one fused blur launch on the card)."""

    def __init__(self, kernel_size=(63, 63), sigma=(32.0, 32.0),
                 alpha=(1.0, 1.0), **kw):
        super().__init__(**kw)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.alpha = alpha

    def sample_params(self, generator, batch, shape):
        B, _, H, W = shape
        return {"noise": torch.rand((B, 2, H, W), generator=generator,
                                    device=generator.device) * 2 - 1}

    def apply(self, x, params, resample=None):
        from ..ops.warp import elastic_transform2d
        return elastic_transform2d(x, params["noise"], self.kernel_size,
                                   self.sigma, self.alpha,
                                   align_corners=True)


class RandomThinPlateSpline(GeometricAugmentationBase2D):
    def __init__(self, scale: float = 0.2, **kw):
        super().__init__(**kw)
        self.scale = scale

    def sample_params(self, generator, batch, shape):
        dev = generator.device
        lin = torch.linspace(-1, 1, 3, device=dev)
        grid = torch.stack(torch.meshgrid(lin, lin, indexing="ij"),
                           -1).reshape(-1, 2)
        src = grid.expand(batch, 9, 2)
        noise = (torch.rand((batch, 9, 2), generator=generator, device=dev)
                 * 2 - 1) * self.scale
        return {"src": src, "dst": src + noise}

    def apply(self, x, params, resample=None):
        from ..ops.warp import get_tps_transform, warp_image_tps
        kw_, aw = get_tps_transform(params["dst"], params["src"])
        return warp_image_tps(x, params["dst"], kw_, aw, align_corners=True)


class RandomFisheye(GeometricAugmentationBase2D):
    """Radial fisheye distortion."""

    def __init__(self, center_x=(-0.3, 0.3), center_y=(-0.3, 0.3),
                 gamma=(0.9, 1.1), **kw):
        super().__init__(**kw)
        self.cx = center_x
        self.cy = center_y
        self.gamma = gamma

    def sample_params(self, generator, batch, shape):
        return {"cx": self._uniform(generator, batch, *self.cx),
                "cy": self._uniform(generator, batch, *self.cy),
                "gamma": self._uniform(generator, batch, *self.gamma)}

    def apply(self, x, params, resample=None):
        from ..core.grid import create_meshgrid
        from ..ops.warp import grid_sample
        B, _, H, W = x.shape
        grid = create_meshgrid(H, W, True, x.dtype,
                               x.device).expand(B, H, W, 2)
        c = torch.stack([params["cx"], params["cy"]], -1)[:, None, None, :]
        d = grid - c
        r = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        g = params["gamma"][:, None, None, None]
        warped = c + d * torch.pow(r.clamp_min(1e-6), g - 1.0)
        return grid_sample(x, warped, "bilinear", "zeros", True)


class PadTo(GeometricAugmentationBase2D):
    """Pad the sample to a fixed (height, width); always applies (p = 1)
    and inverts by cropping."""

    def __init__(self, size: Tuple[int, int], pad_mode: str = "constant",
                 pad_value: float = 0.0, keepdim: bool = False, **kw):
        kw["p"] = 1.0
        kw["p_batch"] = 1.0
        super().__init__(**kw)
        self.size = (int(size[0]), int(size[1]))
        self.pad_mode = pad_mode
        self.pad_value = float(pad_value)
        self._in_hw: Optional[Tuple[int, int]] = None

    def out_size(self, in_hw):
        return (max(self.size[0], in_hw[0]), max(self.size[1], in_hw[1]))

    def __call__(self, x, generator=None, params=None):
        x = as_float(x)
        H, W = x.shape[-2:]
        self._in_hw = (H, W)
        ph = max(self.size[0] - H, 0)
        pw = max(self.size[1] - W, 0)
        if self.pad_mode == "constant":
            return TF.pad(x, (0, pw, 0, ph), value=self.pad_value)
        mode = {"replicate": "replicate", "reflect": "reflect",
                "circular": "circular"}[self.pad_mode]
        lead = x.shape[:-2]
        flat = x.reshape(-1, 1, H, W)
        out = TF.pad(flat, (0, pw, 0, ph), mode=mode)
        return out.reshape(*lead, H + ph, W + pw)

    forward = __call__

    def inverse(self, x, params=None):
        if self._in_hw is None:
            return x
        H, W = self._in_hw
        return x[..., :H, :W]


__all__ += ["PadTo"]
