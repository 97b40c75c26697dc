"""Dense warping (counterpart of ``kornia_tpu/ops/warp.py``, the part the
ported paths reach): ``grid_sample``, ``remap``, bilinear ``resize`` and
``warp_perspective``.

``grid_sample`` follows ``torch.nn.functional.grid_sample``'s semantics but
is written as the reference writes it — four gathers over the flattened
image and the same lerp order — so that resized pyramid levels agree with
the reference to the last bits, not only to the tolerance of a different
summation order.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..core.check import check, check_shape
from ..core.dtype import as_float
from ..core.grid import create_meshgrid
from ..core.linalg import inverse_3x3

__all__ = [
    "grid_sample",
    "remap",
    "normal_transform_pixel",
    "normalize_homography",
    "transform_points",
    "warp_grid",
    "warp_perspective",
    "resize",
]


def _unnormalize(coord: torch.Tensor, size: int,
                 align_corners: bool) -> torch.Tensor:
    """[-1, 1] → pixel coordinates (grid_sample convention)."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def grid_sample(image: torch.Tensor, grid: torch.Tensor,
                mode: str = "bilinear", padding_mode: str = "zeros",
                align_corners: bool = False) -> torch.Tensor:
    """Sample (B, C, H, W) at a normalized grid (B, Ho, Wo, 2) of (x, y).
    Bilinear, with zeros or border padding (nearest, bicubic and
    reflection wait for a later slice)."""
    image = as_float(image)
    check(image.ndim == 4,
          f"grid_sample expects (B,C,H,W), got {tuple(image.shape)}")
    check(grid.ndim == 4 and grid.shape[-1] == 2,
          f"grid must be (B,Ho,Wo,2), got {tuple(grid.shape)}")
    if mode != "bilinear" or padding_mode not in ("zeros", "border"):
        raise NotImplementedError(
            f"grid_sample mode={mode!r} padding={padding_mode!r} is not "
            f"ported yet")
    B, C, H, W = image.shape
    Ho, Wo = grid.shape[1:3]
    dtype = image.dtype
    gx = _unnormalize(grid[..., 0].to(dtype), W, align_corners)
    gy = _unnormalize(grid[..., 1].to(dtype), H, align_corners)
    img_flat = image.reshape(B, C, H * W)

    def tap(iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
        ixc = ix.clamp(0, W - 1)
        iyc = iy.clamp(0, H - 1)
        idx = (iyc * W + ixc).reshape(B, 1, -1).expand(B, C, Ho * Wo)
        v = torch.gather(img_flat, 2, idx).reshape(B, C, Ho, Wo)
        if padding_mode == "zeros":
            valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            v = v * valid[:, None].to(dtype)
        return v

    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx = (gx - x0)[:, None]
    wy = (gy - y0)[:, None]
    x0i = x0.long()
    y0i = y0.long()
    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def remap(image: torch.Tensor, map_x: torch.Tensor, map_y: torch.Tensor,
          mode: str = "bilinear", padding_mode: str = "zeros",
          align_corners: bool = True,
          normalized_coordinates: bool = False) -> torch.Tensor:
    """Sample (B, C, H, W) at per-pixel maps of x and y ((h, w) or
    (B|1, h, w)), in pixels unless `normalized_coordinates`."""
    image = as_float(image)
    if map_x.ndim == 2:
        map_x, map_y = map_x[None], map_y[None]
    H, W = image.shape[-2:]
    if not normalized_coordinates:
        map_x = 2.0 * map_x / max(W - 1, 1) - 1.0
        map_y = 2.0 * map_y / max(H - 1, 1) - 1.0
    grid = torch.stack([map_x, map_y], dim=-1)
    if grid.shape[0] != image.shape[0]:
        grid = grid.expand(image.shape[0], *grid.shape[1:])
    return grid_sample(image, grid, mode, padding_mode, align_corners)


def normal_transform_pixel(height: int, width: int,
                           dtype: torch.dtype = torch.float32,
                           device=None) -> torch.Tensor:
    """(1, 3, 3): pixel coordinates → [-1, 1]."""
    return torch.tensor(
        [[2.0 / max(width - 1, 1), 0.0, -1.0],
         [0.0, 2.0 / max(height - 1, 1), -1.0],
         [0.0, 0.0, 1.0]], dtype=dtype, device=device)[None]


def normalize_homography(H_pix: torch.Tensor, dsize_src: Tuple[int, int],
                         dsize_dst: Tuple[int, int]) -> torch.Tensor:
    """Pixel-space homography → normalized-coordinate homography."""
    check_shape(H_pix, ["*", "3", "3"], "homography")
    src_norm = normal_transform_pixel(*dsize_src, H_pix.dtype, H_pix.device)
    dst_norm = normal_transform_pixel(*dsize_dst, H_pix.dtype, H_pix.device)
    return dst_norm @ H_pix @ inverse_3x3(src_norm)


def transform_points(trans: torch.Tensor,
                     points: torch.Tensor) -> torch.Tensor:
    """Apply (..., D+1, D+1) homogeneous transforms to (..., N, D) points."""
    d = points.shape[-1]
    ph = torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)
    out = torch.einsum("...ij,...nj->...ni", trans, ph)
    w = out[..., d:]
    return out[..., :d] / (w + torch.where(w >= 0, 1e-8, -1e-8))


def warp_grid(M_norm: torch.Tensor, dsize: Tuple[int, int],
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Sampling grid (B, h, w, 2) of a normalized homography (src ← dst)."""
    h, w = dsize
    grid = create_meshgrid(h, w, True, dtype, M_norm.device)
    B = M_norm.shape[0]
    pts = grid.reshape(1, -1, 2).expand(B, h * w, 2)
    return transform_points(M_norm, pts).reshape(B, h, w, 2)


def warp_perspective(image: torch.Tensor, M: torch.Tensor,
                     dsize: Tuple[int, int], mode: str = "bilinear",
                     padding_mode: str = "zeros",
                     align_corners: bool = True,
                     fill_value: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Warp by (B, 3, 3) homographies M: src → dst. With `fill_value`
    (one value per channel), pixels that sample outside the source take
    it: a warped constant-1 mask blends it in, as the reference does."""
    image = as_float(image)
    check_shape(image, ["B", "C", "H", "W"], "image")
    check_shape(M, ["B", "3", "3"], "M")
    if M.shape[0] == 1 and image.shape[0] > 1:
        M = M.expand(image.shape[0], 3, 3)
    M_norm = normalize_homography(M.to(image.dtype), tuple(image.shape[-2:]),
                                  dsize)
    grid = warp_grid(inverse_3x3(M_norm), dsize, image.dtype)
    if fill_value is not None:
        out = grid_sample(image, grid, mode, "zeros", align_corners)
        mask = grid_sample(torch.ones_like(image[:, :1]), grid, mode, "zeros",
                           align_corners)
        fill = torch.as_tensor(fill_value, dtype=image.dtype,
                               device=image.device).reshape(1, -1, 1, 1)
        return out + (1.0 - mask) * fill
    return grid_sample(image, grid, mode, padding_mode, align_corners)


def _size_of_side(H: int, W: int, size: int, side: str) -> Tuple[int, int]:
    """An int target size for one side (short, long, vert or horz), the
    other side scaled to keep the aspect ratio."""
    if side == "short":
        if H < W:
            return size, max(1, int(round(W * size / H)))
        return max(1, int(round(H * size / W))), size
    if side == "long":
        if H > W:
            return size, max(1, int(round(W * size / H)))
        return max(1, int(round(H * size / W))), size
    if side == "vert":
        return size, W
    return H, size


def resize(image: torch.Tensor, size: Union[int, Tuple[int, int]],
           interpolation: str = "bilinear",
           align_corners: Optional[bool] = None, side: str = "short",
           antialias: bool = False) -> torch.Tensor:
    """Bilinear resize with the reference's half-pixel sampling positions
    (align_corners=False) or corner-aligned ones. An int `size` is the
    target of `side` ("short", "long", "vert" or "horz"), the aspect ratio
    kept. Other interpolations and antialiasing raise NotImplementedError
    (they wait for a later slice)."""
    if interpolation != "bilinear" or antialias:
        raise NotImplementedError(
            f"resize interpolation={interpolation!r} antialias={antialias} "
            f"is not ported yet")
    image = as_float(image)
    H, W = image.shape[-2:]
    h, w = _size_of_side(H, W, size, side) if isinstance(size, int) else size
    if h <= 0 or w <= 0:
        raise ValueError(f"resize target must be positive, got {(h, w)}")
    if (h, w) == (H, W):
        return image
    B = image.shape[0]
    if align_corners:
        grid = create_meshgrid(h, w, True, image.dtype, image.device)
    else:
        dt, dev = image.dtype, image.device
        xs = (torch.arange(w, dtype=dt, device=dev) + 0.5) * (W / w) - 0.5
        ys = (torch.arange(h, dtype=dt, device=dev) + 0.5) * (H / h) - 0.5
        gx = 2.0 * xs / max(W - 1, 1) - 1.0
        gy = 2.0 * ys / max(H - 1, 1) - 1.0
        gyy, gxx = torch.meshgrid(gy, gx, indexing="ij")
        grid = torch.stack([gxx, gyy], dim=-1)[None]
    return grid_sample(image, grid.expand(B, h, w, 2), "bilinear", "border",
                       align_corners=True)
