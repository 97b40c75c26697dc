"""Rasterised drawing (counterpart of ``kornia_tpu/image/draw.py``): each
primitive is a mask from a distance or half-plane test over the whole
grid, so a batch draws in a fixed number of tensor ops."""

from __future__ import annotations

import torch

from ..core.dtype import as_float

__all__ = ["draw_point2d", "draw_line", "draw_rectangle",
           "draw_convex_polygon"]


def _color(color, C: int, like: torch.Tensor) -> torch.Tensor:
    c = torch.as_tensor(color, dtype=like.dtype, device=like.device)
    return c.reshape(-1)[:C].reshape(C, 1, 1)


def _grid(H: int, W: int, like: torch.Tensor):
    kw = dict(dtype=like.dtype, device=like.device)
    return torch.meshgrid(torch.arange(H, **kw), torch.arange(W, **kw),
                          indexing="ij")


def draw_point2d(image: torch.Tensor, points: torch.Tensor, color
                 ) -> torch.Tensor:
    """Set the pixels at integer (x, y) points. image (C, H, W), points
    (N, 2), clamped to the image."""
    image = as_float(image)
    C, H, W = image.shape
    x = points[..., 0].to(torch.int64).clamp(0, W - 1)
    y = points[..., 1].to(torch.int64).clamp(0, H - 1)
    col = torch.as_tensor(color, dtype=image.dtype,
                          device=image.device).reshape(-1)[:C]
    out = image.clone()
    out[:, y, x] = col.reshape(C, *([1] * x.ndim))
    return out


def draw_line(image: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor, color
              ) -> torch.Tensor:
    """A 1 px line (pixels within 0.5 of the segment), not anti-aliased.
    image (C, H, W), p1 / p2 (2,)."""
    image = as_float(image)
    C, H, W = image.shape
    p1 = as_float(p1).to(image.device)
    p2 = as_float(p2).to(image.device)
    ys, xs = _grid(H, W, image)
    d = p2 - p1
    len2 = (d * d).sum().clamp(min=1e-8)
    t = ((xs - p1[0]) * d[0] + (ys - p1[1]) * d[1]) / len2
    t = t.clamp(0.0, 1.0)
    projx = p1[0] + t * d[0]
    projy = p1[1] + t * d[1]
    dist = ((xs - projx) ** 2 + (ys - projy) ** 2).sqrt()
    mask = (dist <= 0.5).to(image.dtype)[None]
    return image * (1 - mask) + _color(color, C, image) * mask


def draw_rectangle(image: torch.Tensor, rectangle: torch.Tensor, color,
                   fill: bool = False) -> torch.Tensor:
    """Rectangles (B, N, 4) xyxy onto (B, C, H, W): their 1 px borders, or
    their insides with `fill`. Builds a (B, N, H, W) mask."""
    image = as_float(image)
    B, C, H, W = image.shape
    rect = as_float(rectangle).to(image.device)
    kw = dict(dtype=image.dtype, device=image.device)
    ys = torch.arange(H, **kw)[None, None, :, None]
    xs = torch.arange(W, **kw)[None, None, None, :]
    x0, y0, x1, y1 = (rect[..., i][..., None, None] for i in range(4))
    inside = (xs >= x0) & (xs <= x1) & (ys >= y0) & (ys <= y1)
    if fill:
        mask = inside
    else:
        border = (((xs - x0).abs() < 1) | ((xs - x1).abs() < 1)
                  | ((ys - y0).abs() < 1) | ((ys - y1).abs() < 1))
        mask = inside & border
    mask = mask.any(dim=1)[:, None].to(image.dtype)  # over the N boxes
    col = torch.as_tensor(color, **kw).reshape(1, -1, 1, 1)
    return image * (1 - mask) + col * mask


def draw_convex_polygon(image: torch.Tensor, polygons: torch.Tensor, color
                        ) -> torch.Tensor:
    """Fill convex polygons (B, N, 2), vertices in the order that keeps the
    inside on the left of each edge, onto (B, C, H, W)."""
    image = as_float(image)
    B, C, H, W = image.shape
    poly = as_float(polygons).to(image.device)
    N = poly.shape[1]
    ys, xs = _grid(H, W, image)
    inside = torch.ones((B, H, W), dtype=torch.bool, device=image.device)
    for i in range(N):
        a = poly[:, i]
        b = poly[:, (i + 1) % N]
        cx = (b[:, 0] - a[:, 0])[:, None, None]
        cy = (b[:, 1] - a[:, 1])[:, None, None]
        px = xs[None] - a[:, 0][:, None, None]
        py = ys[None] - a[:, 1][:, None, None]
        inside = inside & (cx * py - cy * px >= 0)
    mask = inside[:, None].to(image.dtype)
    col = torch.as_tensor(color, dtype=image.dtype,
                          device=image.device).reshape(1, -1, 1, 1)
    return image * (1 - mask) + col * mask
