"""Augmentation containers (counterpart of
``kornia_tpu/augmentation/container.py``): ``ImageSequential``,
``AugmentationSequential`` with its data keys (input, mask, bbox /
bbox_xyxy, keypoints, class), its inverse, and the two dispatchers.

A pipeline's parameters are a list of dicts of tensors, one an op, drawn
from one generator on the input's device and returned for replay
(``params=``) and for the exact inverse. Every data key replays the ops
one by one: size-changing crops re-frame the later ops, masks take
non-affine warps (elastic, TPS) from the op's own apply, and the inverse
walks the recorded params in reverse. A forward makes no host read.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.dtype import as_float
from ..core.linalg import inverse_3x3  # noqa: F401  (the JAX module's names)
from ..geometry.linalg import transform_points  # noqa: F401
from .base import (AugmentationBase2D, GeometricAugmentationBase2D,
                   default_generator, eye_batch)

__all__ = ["ImageSequential", "AugmentationSequential", "DataKey",
           "ManyToManyAugmentationDispather", "ManyToOneAugmentationDispather"]


class DataKey:
    INPUT = "input"
    MASK = "mask"
    BBOX = "bbox"
    BBOX_XYXY = "bbox_xyxy"
    KEYPOINTS = "keypoints"
    CLASS = "class"


class ImageSequential:
    """Sequential image-only pipeline."""

    def __init__(self, *augs: AugmentationBase2D):
        self.augs = list(augs)

    def generate_parameters(self, generator: torch.Generator,
                            shape) -> List[Dict]:
        return [aug.generate_parameters(generator, tuple(shape))
                for aug in self.augs]

    def _params_for(self, x, generator, params):
        if params is not None:
            return params
        if generator is None:
            generator = default_generator(x.device)
        return self.generate_parameters(generator, tuple(x.shape))

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[List[Dict]] = None) -> torch.Tensor:
        x = as_float(x)
        params = self._params_for(x, generator, params)
        for aug, p in zip(self.augs, params):
            x = aug(x, params=p)
        return x


class AugmentationSequential(ImageSequential):
    """Multi-datakey pipeline with per-op replay and exact inverse.

    call: ``aug(image, mask, bbox, keypoints, data_keys=[...],
    generator=g)``. Boxes are (B, N, 4) xyxy, (B, N, 4, 2) corner quads,
    or ``geometry.boxes.Boxes``; keypoints are (B, N, 2) or ``Keypoints``.
    Container inputs come back as the same container type."""

    def __init__(self, *augs: AugmentationBase2D,
                 data_keys: Sequence[str] = ("input",),
                 same_on_batch: bool = False):
        super().__init__(*augs)
        self.data_keys = list(data_keys)
        self._params: Optional[List[Dict]] = None
        self._in_hw: Optional[Tuple[int, int]] = None

    # -- size bookkeeping ---------------------------------------------------
    def size_chain(self, in_hw: Tuple[int, int]) -> List[Tuple[int, int]]:
        """Static (H, W) before each op (and the final): n_ops + 1."""
        sizes = [tuple(in_hw)]
        for aug in self.augs:
            sizes.append(tuple(aug.out_size(sizes[-1])))
        return sizes

    # -- matrix composition (affine ops only) -------------------------------
    def transform_matrix(self, shape, params: List[Dict]) -> torch.Tensor:
        mask = params[0]["apply_mask"] if params else None
        device = mask.device if mask is not None else None
        M = eye_batch(shape[0], device)
        for aug, p, hw in zip(self.augs, params, self.size_chain(shape[-2:])):
            if isinstance(aug, GeometricAugmentationBase2D):
                M = aug._gated_matrix(p, hw) @ M
        return M

    # -- per-datakey application --------------------------------------------
    def _apply_image(self, x, params):
        for aug, p in zip(self.augs, params):
            x = aug(x, params=p)
        return x

    def _apply_mask(self, m, params, in_hw):
        for aug, p, hw in zip(self.augs, params, self.size_chain(in_hw)):
            m = aug.apply_to_mask(m, p, hw)
        return m

    def _apply_coords(self, pts, params, in_hw):
        for aug, p, hw in zip(self.augs, params, self.size_chain(in_hw)):
            pts = aug.transform_coords(pts, p, hw)
        return pts

    def _inverse_coords(self, pts, params, in_hw):
        sizes = self.size_chain(in_hw)
        for aug, p, hw in zip(reversed(self.augs), reversed(params),
                              reversed(sizes[:-1])):
            pts = aug.inverse_coords(pts, p, hw)
        return pts

    def _apply_bbox(self, bbox, params, in_hw):
        """xyxy boxes travel as corner quads through every op and are made
        axis-aligned again at the end."""
        if bbox.shape[-1] == 4 and bbox.ndim == 3:
            out = self._apply_coords(_xyxy_to_corners(bbox), params, in_hw)
            return _corners_to_xyxy(out)
        return self._apply_coords(bbox, params, in_hw)

    def _inverse_bbox(self, bbox, params, in_hw):
        if bbox.shape[-1] == 4 and bbox.ndim == 3:
            out = self._inverse_coords(_xyxy_to_corners(bbox), params, in_hw)
            return _corners_to_xyxy(out)
        return self._inverse_coords(bbox, params, in_hw)

    def _coords(self, inp, k, params, in_hw, inverse: bool):
        """A box or keypoint input through the ops (or back)."""
        from ..geometry.boxes import Boxes, Keypoints
        move = self._inverse_coords if inverse else self._apply_coords
        if isinstance(inp, Boxes):
            quad = _xyxy_to_corners(inp.to_tensor("xyxy"))
            return Boxes(_corners_to_xyxy(move(quad, params, in_hw)),
                         inp.valid)
        if isinstance(inp, Keypoints):
            return Keypoints(move(inp.data, params, in_hw), inp.valid)
        if k == "keypoints":
            return move(as_float(inp), params, in_hw)
        box = self._inverse_bbox if inverse else self._apply_bbox
        return box(as_float(inp), params, in_hw)

    def __call__(self, *inputs, data_keys: Optional[Sequence[str]] = None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[List[Dict]] = None):
        keys_ = list(data_keys) if data_keys is not None else self.data_keys
        assert len(inputs) == len(keys_), \
            f"got {len(inputs)} inputs for data_keys {keys_}"
        image = as_float(inputs[keys_.index("input")])
        in_hw = tuple(image.shape[-2:])
        params = self._params_for(image, generator, params)
        self._params = params
        self._in_hw = in_hw
        outs = []
        for inp, k in zip(inputs, keys_):
            if k == "input":
                outs.append(self._apply_image(as_float(inp), params))
            elif k == "mask":
                outs.append(self._apply_mask(as_float(inp), params, in_hw))
            elif k in ("bbox", "bbox_xyxy", "keypoints"):
                outs.append(self._coords(inp, k, params, in_hw, False))
            elif k == "class":
                outs.append(inp)
            else:
                raise ValueError(f"unknown data key {k}")
        return outs[0] if len(outs) == 1 else tuple(outs)

    # -- inverse -------------------------------------------------------------
    def inverse(self, *inputs, data_keys: Optional[Sequence[str]] = None,
                params: Optional[List[Dict]] = None,
                in_hw: Optional[Tuple[int, int]] = None):
        """Replay the recorded params in reverse, op by op: each geometric
        op un-warps to its own input frame, so size-changing crops and
        per-op interpolation invert exactly."""
        keys_ = list(data_keys) if data_keys is not None else self.data_keys
        params = params if params is not None else self._params
        assert params is not None, "call forward first or pass params"
        in_hw = tuple(in_hw) if in_hw is not None else self._in_hw
        assert in_hw is not None, "pass in_hw= (original H, W)"
        sizes = self.size_chain(in_hw)
        outs = []
        for inp, k in zip(inputs, keys_):
            if k in ("input", "mask"):
                x = as_float(inp)
                mode = "nearest" if k == "mask" else "bilinear"
                for aug, p, hw in zip(reversed(self.augs), reversed(params),
                                      reversed(sizes[:-1])):
                    x = aug.inverse_image(x, p, hw, mode=mode)
                outs.append(x)
            elif k in ("bbox", "bbox_xyxy", "keypoints"):
                outs.append(self._coords(inp, k, params, in_hw, True))
            else:
                outs.append(inp)
        return outs[0] if len(outs) == 1 else tuple(outs)


def _xyxy_to_corners(bbox: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = bbox.unbind(-1)
    return torch.stack([torch.stack([x0, y0], -1), torch.stack([x1, y0], -1),
                        torch.stack([x1, y1], -1), torch.stack([x0, y1], -1)],
                       dim=-2)


def _corners_to_xyxy(corners: torch.Tensor) -> torch.Tensor:
    return torch.stack([corners[..., 0].amin(-1), corners[..., 1].amin(-1),
                        corners[..., 0].amax(-1), corners[..., 1].amax(-1)],
                       -1)


class ManyToManyAugmentationDispather:
    """Dispatch N pipelines to N inputs, each drawing from the one
    generator in turn."""

    def __init__(self, *augs: AugmentationSequential):
        self.augs = list(augs)

    def __call__(self, *inputs, generator: Optional[torch.Generator] = None):
        outs = []
        for aug, inp in zip(self.augs, inputs):
            img = inp[0] if isinstance(inp, (tuple, list)) else inp
            if generator is None:
                generator = default_generator(img.device)
            outs.append(aug(*inp, generator=generator))
        return tuple(outs)


class ManyToOneAugmentationDispather:
    """Apply pipelines with SHARED parameters to many inputs: each
    pipeline draws from a generator in the same state."""

    def __init__(self, *augs: AugmentationSequential):
        self.augs = list(augs)

    def __call__(self, *inputs, generator: Optional[torch.Generator] = None):
        outs = []
        state = None
        for aug, inp in zip(self.augs, inputs):
            img = inp[0] if isinstance(inp, (tuple, list)) else inp
            if generator is None:
                generator = default_generator(img.device)
            if state is None:
                state = generator.get_state()
            generator.set_state(state)
            params = aug.generate_parameters(generator, tuple(img.shape))
            if isinstance(inp, (tuple, list)):
                outs.append(aug(*inp, params=params))
            else:
                outs.append(aug(inp, params=params))
        return tuple(outs)
