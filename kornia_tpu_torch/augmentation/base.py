"""Augmentation framework core (counterpart of
``kornia_tpu/augmentation/base.py``).

An augmentation draws its parameters from a ``torch.Generator`` on the
input's device (``generate_parameters``) and applies them to the whole
batch; the probability gate is a boolean ``apply_mask`` in the params
dict, and the op's output is selected per sample with ``torch.where``. So a
forward makes no host read: the draws, the gate and the op all stay on
the device. ``__call__(x, generator=None, params=None)`` replays injected
params exactly, which is how the port is held against the JAX package.

Geometric ops define their (B, 3, 3) matrix; the containers compose them
for boxes, keypoints and inverses. Where the JAX package swaps
``self.flags`` to nearest resampling for the length of a mask's call, the
port passes the resample mode to ``apply`` explicitly: the same result,
and no object state changes during a call.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.dtype import as_float, host_tensor

__all__ = ["AugmentationBase2D", "IntensityAugmentationBase2D",
           "GeometricAugmentationBase2D", "apply_batch_mask"]

Params = Dict[str, torch.Tensor]


def default_generator(device, seed: int = 0) -> torch.Generator:
    """The generator a call draws from when it is given none: seeded with
    the reference's key number (``PRNGKey(0)`` → 0) on `device`."""
    return torch.Generator(device=device).manual_seed(seed)


def device_table(owner: Any, name: Any, values, device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`values`, a table that `owner` holds on the host, on `device`:
    copied there at first use and kept on `owner`, one copy per device,
    copied again if the host values change (a public attribute such as
    ``Normalize.mean`` may be set). It is built outside inference mode, so
    a table first used there still serves a later backward. Callers index
    it or compute from it; they never hand the table itself out."""
    values = np.asarray(values)
    stamp = (values.dtype.str, values.shape, values.tobytes())
    tables = owner.__dict__.setdefault("_device_tables", {})
    key = (name, torch.device(device), dtype)
    if key not in tables or tables[key][0] != stamp:
        with torch.inference_mode(False):
            tables[key] = (stamp, host_tensor(values, device, dtype))
    return tables[key][1]


def eye_batch(B: int, device, n: int = 3,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, n, n) identities (a fill on the device, no host copy)."""
    return torch.eye(n, dtype=dtype, device=device).expand(B, n, n)


def apply_batch_mask(out: torch.Tensor, inp: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """Select augmented vs original per batch element."""
    m = mask.reshape(-1, *([1] * (inp.ndim - 1)))
    return torch.where(m, out, inp)


class AugmentationBase2D:
    """Base class: subclasses implement ``sample_params(generator, batch,
    shape)`` and ``apply(x, params)``; geometric ops also ``matrix(params,
    shape)``."""

    def __init__(self, p: float = 0.5, p_batch: float = 1.0,
                 same_on_batch: bool = False, keepdim: bool = False):
        self.p = p
        self.p_batch = p_batch
        self.same_on_batch = same_on_batch
        self.flags: Dict[str, Any] = {}

    # -- override points -----------------------------------------------------
    def sample_params(self, generator: torch.Generator, batch: int,
                      shape: Tuple[int, ...]) -> Params:
        return {}

    def apply(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        raise NotImplementedError

    def matrix(self, params: Params, shape: Tuple[int, ...]) -> torch.Tensor:
        """Identity unless geometric."""
        mask = params["apply_mask"]
        return eye_batch(mask.shape[0], mask.device)

    # -- machinery -----------------------------------------------------------
    def generate_parameters(self, generator: torch.Generator,
                            shape: Tuple[int, ...]) -> Params:
        B = shape[0]
        dev = generator.device
        n = () if self.same_on_batch else (B,)
        elem = torch.rand(n, generator=generator, device=dev) < self.p
        elem = elem.expand(B)
        batch_gate = torch.rand((), generator=generator,
                                device=dev) < self.p_batch
        params = self.sample_params(generator, B, shape)
        params["apply_mask"] = elem & batch_gate
        return params

    def _params_for(self, x: torch.Tensor,
                    generator: Optional[torch.Generator],
                    params: Optional[Params]) -> Params:
        if params is not None:
            return params
        if generator is None:
            generator = default_generator(x.device)
        return self.generate_parameters(generator, tuple(x.shape))

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[Params] = None) -> torch.Tensor:
        x = as_float(x)
        params = self._params_for(x, generator, params)
        out = self.apply(x, params)
        return apply_batch_mask(out, x, params["apply_mask"])

    def transform_matrix(self, x: torch.Tensor,
                         params: Params) -> torch.Tensor:
        M = self.matrix(params, tuple(x.shape))
        eye = eye_batch(M.shape[0], M.device, dtype=M.dtype)
        return torch.where(params["apply_mask"].reshape(-1, 1, 1), M, eye)

    # -- container extension points -----------------------------------------
    def out_size(self, in_hw: Tuple[int, int]) -> Tuple[int, int]:
        """Static output (H, W) for input (H, W); size-changing ops
        (crop, resize, pad) override."""
        return in_hw

    def apply_to_mask(self, m: torch.Tensor, params: Params,
                      in_hw: Tuple[int, int]) -> torch.Tensor:
        """Mask path: intensity ops leave masks unchanged."""
        return m

    def transform_coords(self, pts: torch.Tensor, params: Params,
                         in_hw: Tuple[int, int]) -> torch.Tensor:
        """(B, ..., 2) point action: identity for intensity ops."""
        return pts

    def inverse_coords(self, pts: torch.Tensor, params: Params,
                       in_hw: Tuple[int, int]) -> torch.Tensor:
        return pts

    def inverse_image(self, x: torch.Tensor, params: Params,
                      in_hw: Tuple[int, int], mode: str = "bilinear"
                      ) -> torch.Tensor:
        """Per-op inverse replay: intensity ops are non-invertible no-ops,
        as in the reference."""
        return x

    # -- uniform-sampling helper --------------------------------------------
    def _uniform(self, generator: torch.Generator, batch: int, lo, hi,
                 shape: Tuple[int, ...] = ()) -> torch.Tensor:
        """U[lo, hi) of (batch, *shape), one draw shared by the batch when
        same_on_batch. lo and hi may be numbers or 0-dim tensors."""
        n = shape if self.same_on_batch else (batch, *shape)
        u = torch.rand(n, generator=generator, device=generator.device)
        v = u * (hi - lo) + lo
        return v.expand(batch, *shape) if self.same_on_batch else v

    def _randint(self, generator: torch.Generator, batch: int, lo: int,
                 hi: int) -> torch.Tensor:
        """int32 (batch,) in [lo, hi), shared when same_on_batch."""
        n = () if self.same_on_batch else (batch,)
        v = torch.randint(int(lo), int(hi), n, generator=generator,
                          device=generator.device, dtype=torch.int32)
        return v.expand(batch)


class IntensityAugmentationBase2D(AugmentationBase2D):
    """Marker base: never changes geometry."""


class GeometricAugmentationBase2D(AugmentationBase2D):
    """Geometric ops are invertible through their 3x3 matrix. ``apply``
    takes the resample mode (None: the op's own flag), so that the mask
    path asks for nearest without changing the op."""

    def _resample(self, resample: Optional[str]) -> str:
        return resample or self.flags.get("resample", "bilinear")

    def apply(self, x: torch.Tensor, params: Params,
              resample: Optional[str] = None) -> torch.Tensor:
        from ..ops.warp import warp_perspective
        M = self.matrix(params, tuple(x.shape))
        H, W = x.shape[-2:]
        return warp_perspective(x, M, (H, W), mode=self._resample(resample),
                                padding_mode=self.flags.get("padding_mode",
                                                            "zeros"),
                                align_corners=True)

    def inverse(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        from ..core.linalg import inverse_3x3
        from ..ops.warp import warp_perspective
        M = self.transform_matrix(x, params)
        H, W = x.shape[-2:]
        return warp_perspective(x, inverse_3x3(M), (H, W),
                                align_corners=True)

    # -- container extension points -----------------------------------------
    def _gated_matrix(self, params: Params,
                      in_hw: Tuple[int, int]) -> torch.Tensor:
        B = params["apply_mask"].shape[0]
        M = self.matrix(params, (B, 1, *in_hw))
        eye = eye_batch(B, M.device, dtype=M.dtype)
        return torch.where(params["apply_mask"].reshape(-1, 1, 1), M, eye)

    def apply_to_mask(self, m: torch.Tensor, params: Params,
                      in_hw: Tuple[int, int]) -> torch.Tensor:
        """The op's own apply with nearest resampling: covers matrix warps
        and deformation fields (elastic, TPS), which a composed 3x3 cannot
        express."""
        out = self.apply(m, params, resample="nearest")
        if out.shape == m.shape:
            return apply_batch_mask(out, m, params["apply_mask"])
        return out  # size-changing ops apply unconditionally (p = 1)

    def transform_coords(self, pts: torch.Tensor, params: Params,
                         in_hw: Tuple[int, int]) -> torch.Tensor:
        from ..geometry.linalg import transform_points
        M = self._gated_matrix(params, in_hw)
        B = pts.shape[0]
        return transform_points(M, pts.reshape(B, -1, 2)).reshape(pts.shape)

    def inverse_coords(self, pts: torch.Tensor, params: Params,
                       in_hw: Tuple[int, int]) -> torch.Tensor:
        from ..core.linalg import inverse_3x3
        from ..geometry.linalg import transform_points
        M = inverse_3x3(self._gated_matrix(params, in_hw))
        B = pts.shape[0]
        return transform_points(M, pts.reshape(B, -1, 2)).reshape(pts.shape)

    def inverse_image(self, x: torch.Tensor, params: Params,
                      in_hw: Tuple[int, int], mode: str = "bilinear"
                      ) -> torch.Tensor:
        """Per-op inverse replay to the op's input frame (handles
        size-changing crops: dsize = in_hw)."""
        from ..core.linalg import inverse_3x3
        from ..ops.warp import warp_perspective
        M = inverse_3x3(self._gated_matrix(params, in_hw))
        return warp_perspective(x, M, tuple(in_hw), mode=mode,
                                align_corners=True)


class RigidAffineAugmentationBase2D(GeometricAugmentationBase2D):
    """Ops whose transform is a rigid or affine 3x3."""


__all__ += ["RigidAffineAugmentationBase2D"]
