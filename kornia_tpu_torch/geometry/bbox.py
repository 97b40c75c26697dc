"""Functional bounding-box ops (counterpart of
``kornia_tpu/geometry/bbox.py``)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.check import check, check_shape
from ..core.dtype import as_float
from ..ops.warp import transform_points

__all__ = ["bbox_generator", "bbox_generator3d", "infer_bbox_shape",
           "infer_bbox_shape3d", "bbox_to_mask", "bbox_to_mask3d",
           "transform_bbox", "nms", "validate_bbox", "validate_bbox3d"]


def bbox_generator(x_start: torch.Tensor, y_start: torch.Tensor,
                   width: torch.Tensor, height: torch.Tensor
                   ) -> torch.Tensor:
    """(B,) coordinates → (B, 4, 2) corner quads TL, TR, BR, BL."""
    x, y, w, h = (as_float(v) for v in (x_start, y_start, width, height))
    tl = torch.stack([x, y], -1)
    tr = torch.stack([x + w - 1, y], -1)
    br = torch.stack([x + w - 1, y + h - 1], -1)
    bl = torch.stack([x, y + h - 1], -1)
    return torch.stack([tl, tr, br, bl], dim=-2)


def bbox_generator3d(x_start, y_start, z_start, width, height, depth
                     ) -> torch.Tensor:
    """(B,) → (B, 8, 3) hexahedron vertices."""
    x, y, z, w, h, d = (as_float(v) for v in
                        (x_start, y_start, z_start, width, height, depth))
    verts = []
    for dz in (0, 1):
        zz = z + dz * (d - 1)
        verts += [torch.stack([x, y, zz], -1),
                  torch.stack([x + w - 1, y, zz], -1),
                  torch.stack([x + w - 1, y + h - 1, zz], -1),
                  torch.stack([x, y + h - 1, zz], -1)]
    return torch.stack(verts, dim=-2)


def infer_bbox_shape(boxes: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Corner quads (..., 4, 2) → (heights, widths)."""
    check_shape(boxes, ["*", "4", "2"], "boxes")
    widths = boxes[..., 1, 0] - boxes[..., 0, 0] + 1
    heights = boxes[..., 3, 1] - boxes[..., 0, 1] + 1
    return heights, widths


def infer_bbox_shape3d(boxes: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    check_shape(boxes, ["*", "8", "3"], "boxes")
    widths = boxes[..., 1, 0] - boxes[..., 0, 0] + 1
    heights = boxes[..., 3, 1] - boxes[..., 0, 1] + 1
    depths = boxes[..., 4, 2] - boxes[..., 0, 2] + 1
    return depths, heights, widths


def bbox_to_mask(boxes: torch.Tensor, width: int, height: int
                 ) -> torch.Tensor:
    """Corner quads (B, 4, 2) → (B, H, W) masks (1 inside, 0 outside)."""
    boxes = as_float(boxes)
    x0 = boxes[..., 0, 0][..., None, None]
    y0 = boxes[..., 0, 1][..., None, None]
    x1 = boxes[..., 1, 0][..., None, None]
    y1 = boxes[..., 3, 1][..., None, None]
    xs = torch.arange(width, dtype=boxes.dtype, device=boxes.device)
    ys = torch.arange(height, dtype=boxes.dtype, device=boxes.device)
    xs, ys = xs[None, None, :], ys[None, :, None]
    inside = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    return inside.to(boxes.dtype)


def bbox_to_mask3d(boxes: torch.Tensor, size: Tuple[int, int, int]
                   ) -> torch.Tensor:
    """(B, 8, 3) → (B, 1, D, H, W)."""
    boxes = as_float(boxes)
    D, H, W = size
    x0, y0, z0 = (boxes[..., 0, i][..., None, None, None] for i in range(3))
    x1 = boxes[..., 1, 0][..., None, None, None]
    y1 = boxes[..., 3, 1][..., None, None, None]
    z1 = boxes[..., 4, 2][..., None, None, None]
    kw = dict(dtype=boxes.dtype, device=boxes.device)
    xs = torch.arange(W, **kw)[None, None, None, :]
    ys = torch.arange(H, **kw)[None, None, :, None]
    zs = torch.arange(D, **kw)[None, :, None, None]
    inside = ((xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
              & (zs >= z0) & (zs <= z1))
    return inside[:, None].to(boxes.dtype)


def _xyxy_corners(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy → (..., 4, 2) corners TL, TR, BR, BL."""
    x0, y0, x1, y1 = b.unbind(-1)
    return torch.stack([torch.stack([x0, y0], -1), torch.stack([x1, y0], -1),
                        torch.stack([x1, y1], -1), torch.stack([x0, y1], -1)],
                       dim=-2)


def transform_bbox(trans_mat: torch.Tensor, boxes: torch.Tensor,
                   mode: str = "xyxy", restore_coordinates: bool = True
                   ) -> torch.Tensor:
    """(B, 3, 3) applied to xyxy or xywh boxes: the axis-aligned envelope
    of the four warped corners."""
    boxes = as_float(boxes)
    if mode == "xywh":
        x, y, w, h = boxes.unbind(-1)
        boxes_xyxy = torch.stack([x, y, x + w, y + h], -1)
    else:
        boxes_xyxy = boxes
    corners = _xyxy_corners(boxes_xyxy)
    M = trans_mat[:, None] if corners.ndim == 4 else trans_mat
    warped = transform_points(M, corners)
    out = torch.stack([warped[..., 0].amin(-1), warped[..., 1].amin(-1),
                       warped[..., 0].amax(-1), warped[..., 1].amax(-1)], -1)
    if mode == "xywh":
        out = torch.stack([out[..., 0], out[..., 1], out[..., 2] - out[..., 0],
                           out[..., 3] - out[..., 1]], -1)
    return out


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_output: Optional[int] = None) -> torch.Tensor:
    """IoU NMS over xyxy boxes (N, 4): indices (N,) in descending score
    order (ties in input order), -1 where suppressed; cut to `max_output`.
    N steps of tensor ops, no host read."""
    boxes = as_float(boxes)
    N = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    b = boxes[order]
    area = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    lt = torch.maximum(b[:, None, :2], b[None, :, :2])
    rb = torch.minimum(b[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / torch.clamp(area[:, None] + area[None, :] - inter, min=1e-8)
    # i survives iff no higher-scored kept box overlaps it
    earlier = torch.ones(N, N, dtype=torch.bool, device=boxes.device).tril(-1)
    overlap = (iou > iou_threshold) & earlier
    keep = torch.ones(N, dtype=torch.bool, device=boxes.device)
    for i in range(N):
        keep[i] = ~(overlap[i] & keep).any()
    kept_sorted = torch.where(keep, order, -1)
    if max_output is not None:
        kept_sorted = kept_sorted[:max_output]
    return kept_sorted


def validate_bbox(boxes: torch.Tensor) -> bool:
    """Check (B, 4, 2) boxes; returns True."""
    check(boxes.ndim == 3 and tuple(boxes.shape[1:]) == (4, 2),
          f"boxes must be (B, 4, 2), got {tuple(boxes.shape)}")
    return True


def validate_bbox3d(boxes: torch.Tensor) -> bool:
    """Check (B, 8, 3) hexahedrons; returns True."""
    check(boxes.ndim == 3 and tuple(boxes.shape[1:]) == (8, 3),
          f"boxes must be (B, 8, 3), got {tuple(boxes.shape)}")
    return True
