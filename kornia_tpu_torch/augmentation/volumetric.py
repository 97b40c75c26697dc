"""3D volumetric augmentations (counterpart of
``kornia_tpu/augmentation/volumetric.py``). Inputs are (B, C, D, H, W);
the warps go through ``ops/warp3d.py``, the motion blur through
``ops/filters.py::motion_blur3d``."""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.dtype import as_float, host_tensor
from ..ops.warp3d import (center_crop3d, crop3d,  # noqa: F401
                          get_projective_transform, warp_affine3d)
from .base import AugmentationBase2D, eye_batch

__all__ = [
    "RandomHorizontalFlip3D",
    "RandomVerticalFlip3D",
    "RandomDepthicalFlip3D",
    "RandomRotation3D",
    "RandomAffine3D",
    "RandomCrop3D",
    "CenterCrop3D",
    "RandomEqualize3D",
]


class _Base3D(AugmentationBase2D):
    """3D ops reuse the 2D machinery (mask gating, drawing)."""


def _flip_matrix4(shape, axis, device):
    """(B, 4, 4) reflection about the volume centre along `axis` (-1 = W,
    -2 = H, -3 = D); xyz order as get_projective_transform's."""
    D, H, W = shape[-3:]
    idx = {-1: 0, -2: 1, -3: 2}[axis]
    size = {-1: W, -2: H, -3: D}[axis]
    rows = [[1.0 if i == j else 0.0 for j in range(4)] for i in range(4)]
    rows[idx][idx] = -1.0
    rows[idx][3] = size - 1.0
    t = host_tensor(rows, device)
    return t.expand(shape[0], 4, 4)


class _Flip3D(_Base3D):
    axis = -1

    def apply(self, x, params):
        return torch.flip(x, dims=(self.axis,))

    def matrix4(self, params, shape):
        return _flip_matrix4(shape, self.axis, params["apply_mask"].device)


class RandomHorizontalFlip3D(_Flip3D):
    axis = -1


class RandomVerticalFlip3D(_Flip3D):
    axis = -2


class RandomDepthicalFlip3D(_Flip3D):
    axis = -3


def _degree_ranges(degrees):
    if isinstance(degrees, (int, float)):
        return [(-degrees, degrees)] * 3
    return [d if isinstance(d, (tuple, list)) else (-d, d) for d in degrees]


def _centre3(B: int, shape, device) -> torch.Tensor:
    D, H, W = shape[-3:]
    return host_tensor(((W - 1) / 2.0, (H - 1) / 2.0, (D - 1) / 2.0),
                       device).expand(B, 3)


def _with_bottom(M: torch.Tensor) -> torch.Tensor:
    bottom = torch.zeros_like(M[:, :1])
    bottom[:, 0, 3] = 1.0
    return torch.cat([M, bottom], dim=1)


class RandomRotation3D(_Base3D):
    """XYZ Euler rotation."""

    def __init__(self, degrees=15.0, **kw):
        super().__init__(**kw)
        self.degrees = _degree_ranges(degrees)

    def sample_params(self, generator, batch, shape):
        return {"angles": torch.stack(
            [self._uniform(generator, batch, *self.degrees[i])
             for i in range(3)], dim=-1)}

    def apply(self, x, params):
        M = self.matrix4(params, tuple(x.shape))[:, :3]
        # the reference's 3D geometric ops default to align_corners=False
        return warp_affine3d(x, M, tuple(x.shape[-3:]), align_corners=False)

    def matrix4(self, params, shape):
        ang = params["angles"]
        B = ang.shape[0]
        M = get_projective_transform(_centre3(B, shape, ang.device), ang,
                                     torch.ones(B, device=ang.device))
        return _with_bottom(M)


class RandomAffine3D(_Base3D):
    def __init__(self, degrees=15.0, translate=None, scale=None, **kw):
        super().__init__(**kw)
        self.degrees = _degree_ranges(degrees)
        self.translate = translate
        self.scale_rng = scale

    def sample_params(self, generator, batch, shape):
        angles = torch.stack([self._uniform(generator, batch,
                                            *self.degrees[i])
                              for i in range(3)], dim=-1)
        D, H, W = shape[-3:]
        dev = generator.device
        if self.translate is not None:
            # one draw scaled to each axis' range, as the JAX package
            # draws the three shifts from one key
            u = self._uniform(generator, batch, 0.0, 1.0)
            t = torch.stack([u * (2 * f * n) - f * n
                             for f, n in zip(self.translate, (W, H, D))], -1)
        else:
            t = torch.zeros((batch, 3), device=dev)
        scale = (self._uniform(generator, batch, *self.scale_rng)
                 if self.scale_rng is not None
                 else torch.ones(batch, device=dev))
        return {"angles": angles, "t": t, "scale": scale}

    def apply(self, x, params):
        M = self.matrix4(params, tuple(x.shape))[:, :3]
        return warp_affine3d(x, M, tuple(x.shape[-3:]), align_corners=False)

    def matrix4(self, params, shape):
        ang = params["angles"]
        B = ang.shape[0]
        M = get_projective_transform(_centre3(B, shape, ang.device), ang,
                                     params["scale"])
        M = torch.cat([M[:, :, :3], M[:, :, 3:] + params["t"][..., None]],
                      dim=-1)
        return _with_bottom(M)


class RandomCrop3D(_Base3D):
    def __init__(self, size: Tuple[int, int, int], **kw):
        super().__init__(p=1.0, **kw)
        self.size = size

    def sample_params(self, generator, batch, shape):
        D, H, W = shape[-3:]
        d, h, w = self.size
        n = 1 if self.same_on_batch else batch

        def origin(extent):
            return torch.randint(0, max(extent, 0) + 1, (n,),
                                 generator=generator, device=generator.device,
                                 dtype=torch.int32).expand(batch)
        return {"z0": origin(D - d), "y0": origin(H - h),
                "x0": origin(W - w)}

    def __call__(self, x, generator=None, params=None):
        x = as_float(x)
        params = self._params_for(x, generator, params)
        B, C = x.shape[:2]
        d, h, w = self.size
        dev = x.device

        def index(origin, n):
            return origin.long()[:, None] + torch.arange(n, device=dev)[None]
        z = index(params["z0"], d)[:, None, :, None, None]
        y = index(params["y0"], h)[:, None, None, :, None]
        xx = index(params["x0"], w)[:, None, None, None, :]
        b = torch.arange(B, device=dev)[:, None, None, None, None]
        c = torch.arange(C, device=dev)[None, :, None, None, None]
        return x[b, c, z, y, xx]

    def matrix4(self, params, shape):
        t = -torch.stack([params["x0"], params["y0"], params["z0"]],
                         -1).to(torch.float32)
        M = eye_batch(t.shape[0], t.device, 4).clone()
        M[:, :3, 3] = t
        return M


class CenterCrop3D(_Base3D):
    def __init__(self, size: Tuple[int, int, int], **kw):
        super().__init__(p=1.0, **kw)
        self.size = size

    def __call__(self, x, generator=None, params=None):
        return center_crop3d(as_float(x), self.size)


class RandomEqualize3D(_Base3D):
    def apply(self, x, params):
        from ..ops.enhance import equalize3d
        return equalize3d(x)


# --- the reference's 3D base-class names ------------------------------------

class AugmentationBase3D(_Base3D):
    """(B, C, D, H, W) augmentation base."""


class IntensityAugmentationBase3D(AugmentationBase3D):
    """Never changes geometry."""


class GeometricAugmentationBase3D(AugmentationBase3D):
    """Invertible through a (B, 4, 4) matrix."""

    def matrix4(self, params, shape):
        mask = params["apply_mask"]
        return eye_batch(mask.shape[0], mask.device, 4)


class RigidAffineAugmentationBase3D(GeometricAugmentationBase3D):
    """Rigid or affine 3D ops."""


class RandomMotionBlur3D(IntensityAugmentationBase3D):
    """Directional 3D motion blur; yaw, pitch, roll and direction drawn
    per sample, the kernel size fixed."""

    def __init__(self, kernel_size: int = 3, angle=35.0,
                 direction=(-1.0, 1.0), border_type: str = "constant", **kw):
        super().__init__(**kw)
        self.kernel_size = int(kernel_size) if not isinstance(
            kernel_size, (tuple, list)) else int(kernel_size[0])
        if isinstance(angle, (int, float)):
            self.angle = [(-float(angle), float(angle))] * 3
        elif isinstance(angle[0], (tuple, list)):
            self.angle = [tuple(a) for a in angle]
        elif len(angle) == 3:
            self.angle = [(-float(a), float(a)) for a in angle]
        else:
            self.angle = [tuple(angle)] * 3
        self.direction = (tuple(direction)
                          if isinstance(direction, (tuple, list))
                          else (-float(direction), float(direction)))
        self.border_type = border_type

    def sample_params(self, generator, batch, shape):
        angles = torch.stack([self._uniform(generator, batch, *self.angle[i])
                              for i in range(3)], dim=-1)
        return {"angle": angles,
                "direction": self._uniform(generator, batch,
                                           *self.direction)}

    def apply(self, x, params):
        from ..ops.filters import motion_blur3d
        return motion_blur3d(x, self.kernel_size, params["angle"],
                             params["direction"], self.border_type)


class RandomPerspective3D(GeometricAugmentationBase3D):
    """Random 3D perspective warp: the corners pulled toward the centre by
    distortion_scale / 2 · U[0, 1) of the centre's coordinates."""

    def __init__(self, distortion_scale: float = 0.5,
                 resample: str = "bilinear", align_corners: bool = False,
                 **kw):
        super().__init__(**kw)
        self.distortion_scale = float(distortion_scale)
        self.resample = resample
        self.align_corners = align_corners

    def sample_params(self, generator, batch, shape):
        _, _, D, H, W = shape
        dev = generator.device
        corners = ((0, 0, 0), (W - 1, 0, 0), (W - 1, H - 1, 0),
                   (0, H - 1, 0), (0, 0, D - 1), (W - 1, 0, D - 1),
                   (W - 1, H - 1, D - 1), (0, H - 1, D - 1))
        centre = ((W - 1) / 2.0, (H - 1) / 2.0, (D - 1) / 2.0)
        start = host_tensor(corners, dev)
        # unit direction toward the volume centre per corner (±1 each axis)
        towards = host_tensor(tuple(tuple(float((c > v) - (c < v))
                                          for v, c in zip(p, centre))
                                    for p in corners), dev)
        factor = self.distortion_scale / 2.0 * host_tensor(centre, dev)
        n = (1, 8, 3) if self.same_on_batch else (batch, 8, 3)
        rand = torch.rand(n, generator=generator, device=dev).expand(
            batch, 8, 3)
        end = start + factor * rand * towards
        return {"start_points": start.expand(batch, 8, 3),
                "end_points": end}

    def apply(self, x, params):
        from ..ops.warp3d import warp_perspective3d
        M = self.matrix4(params, tuple(x.shape))
        return warp_perspective3d(x, M, tuple(x.shape[-3:]), self.resample,
                                  align_corners=self.align_corners)

    def matrix4(self, params, shape):
        from ..ops.warp3d import get_perspective_transform3d
        return get_perspective_transform3d(params["start_points"],
                                           params["end_points"])


__all__ += [
    "AugmentationBase3D", "IntensityAugmentationBase3D",
    "GeometricAugmentationBase3D", "RigidAffineAugmentationBase3D",
    "RandomMotionBlur3D", "RandomPerspective3D",
]
