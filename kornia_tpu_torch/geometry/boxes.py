"""Box and keypoint containers (counterpart of
``kornia_tpu/geometry/boxes.py``): dataclasses over padded fixed-N tensors
with validity masks."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from ..core.dtype import as_float
from ..ops.warp import transform_points
from .bbox import _xyxy_corners, bbox_to_mask, transform_bbox

__all__ = ["Boxes", "Keypoints", "VideoBoxes"]


@dataclasses.dataclass(frozen=True)
class Boxes:
    """(B, N, 4) xyxy boxes and (B, N) validity."""

    data: torch.Tensor
    valid: torch.Tensor

    @classmethod
    def from_tensor(cls, boxes: torch.Tensor, mode: str = "xyxy") -> "Boxes":
        boxes = as_float(boxes)
        if boxes.ndim == 2:
            boxes = boxes[None]
        if mode == "xywh":
            x, y, w, h = boxes.unbind(-1)
            boxes = torch.stack([x, y, x + w, y + h], -1)
        elif mode == "vertices":
            boxes = torch.stack(
                [boxes[..., 0].amin(-1), boxes[..., 1].amin(-1),
                 boxes[..., 0].amax(-1), boxes[..., 1].amax(-1)], -1)
        valid = torch.ones(boxes.shape[:-1], dtype=torch.bool,
                           device=boxes.device)
        return cls(boxes, valid)

    def to_tensor(self, mode: str = "xyxy") -> torch.Tensor:
        b = self.data
        if mode == "xywh":
            return torch.stack([b[..., 0], b[..., 1], b[..., 2] - b[..., 0],
                                b[..., 3] - b[..., 1]], -1)
        if mode == "vertices":
            return _xyxy_corners(b)
        return b

    def transform_boxes(self, M: torch.Tensor) -> "Boxes":
        """The axis-aligned envelope of each box's corners under M."""
        return Boxes(transform_bbox(M, self.data, "xyxy"), self.valid)

    def compute_area(self) -> torch.Tensor:
        b = self.data
        area = (b[..., 2] - b[..., 0]).clamp(min=0) * \
            (b[..., 3] - b[..., 1]).clamp(min=0)
        return area * self.valid

    def filter_boxes_by_area(self, min_area: float = 0.0,
                             max_area: Optional[float] = None) -> "Boxes":
        area = self.compute_area()
        ok = area >= min_area
        if max_area is not None:
            ok = ok & (area <= max_area)
        return Boxes(self.data, self.valid & ok)

    def clamp(self, height: int, width: int) -> "Boxes":
        b = self.data
        x = b[..., 0::2].clamp(0, width - 1)
        y = b[..., 1::2].clamp(0, height - 1)
        out = torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)
        return Boxes(out, self.valid)

    def to_mask(self, height: int, width: int) -> torch.Tensor:
        """(B, N, H, W) masks, 0 for invalid boxes."""
        B, N = self.data.shape[:2]
        quads = self.to_tensor("vertices").reshape(B * N, 4, 2)
        m = bbox_to_mask(quads, width, height).reshape(B, N, height, width)
        return m * self.valid[..., None, None]

    def pad(self, n: int) -> "Boxes":
        return Boxes(F.pad(self.data, (0, 0, 0, n)),
                     F.pad(self.valid, (0, n)))


@dataclasses.dataclass(frozen=True)
class Keypoints:
    """(B, N, 2) points and (B, N) validity."""

    data: torch.Tensor
    valid: torch.Tensor

    @classmethod
    def from_tensor(cls, pts: torch.Tensor) -> "Keypoints":
        pts = as_float(pts)
        if pts.ndim == 2:
            pts = pts[None]
        return cls(pts, torch.ones(pts.shape[:-1], dtype=torch.bool,
                                   device=pts.device))

    def to_tensor(self) -> torch.Tensor:
        return self.data

    def transform_keypoints(self, M: torch.Tensor) -> "Keypoints":
        return Keypoints(transform_points(M, self.data), self.valid)

    def clamp(self, height: int, width: int) -> "Keypoints":
        x = self.data[..., 0].clamp(0, width - 1)
        y = self.data[..., 1].clamp(0, height - 1)
        return Keypoints(torch.stack([x, y], -1), self.valid)

    def mark_outside(self, height: int, width: int) -> "Keypoints":
        x, y = self.data[..., 0], self.data[..., 1]
        inside = (x >= 0) & (x < width) & (y >= 0) & (y < height)
        return Keypoints(self.data, self.valid & inside)

    def pad(self, n: int) -> "Keypoints":
        return Keypoints(F.pad(self.data, (0, 0, 0, n)),
                         F.pad(self.valid, (0, n)))


@dataclasses.dataclass(frozen=True)
class VideoBoxes:
    """(B, T, N, 4) xyxy boxes over time and (B, T, N) validity."""

    data: torch.Tensor
    valid: torch.Tensor

    @classmethod
    def from_tensor(cls, boxes: torch.Tensor) -> "VideoBoxes":
        boxes = as_float(boxes)
        return cls(boxes, torch.ones(boxes.shape[:-1], dtype=torch.bool,
                                     device=boxes.device))

    def to_frame_boxes(self) -> Boxes:
        """Time folded into the batch dim."""
        B, T, N, _ = self.data.shape
        return Boxes(self.data.reshape(B * T, N, 4),
                     self.valid.reshape(B * T, N))

    def transform_boxes(self, M: torch.Tensor) -> "VideoBoxes":
        """Per-clip (B, 3, 3) or per-frame (B, T, 3, 3) homographies."""
        if M.ndim == 3:
            M = M[:, None].expand(*self.data.shape[:2], 3, 3)
        B, T, N, _ = self.data.shape
        flat = transform_bbox(M.reshape(B * T, 3, 3),
                              self.data.reshape(B * T, N, 4), "xyxy")
        return VideoBoxes(flat.reshape(B, T, N, 4), self.valid)
