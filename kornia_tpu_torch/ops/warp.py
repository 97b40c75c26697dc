"""Dense warping (counterpart of ``kornia_tpu/ops/warp.py``):
``grid_sample`` and everything built on it — the homography and affine
warps and their matrices, crops, flips, resizes, elastic and thin-plate
spline warps.

``grid_sample`` follows ``torch.nn.functional.grid_sample``'s semantics but
is written as the reference writes it — flat gathers over the (H·W) image
(4 bilinear, 16 bicubic, 1 nearest) and the same lerp order — so that the
two libraries agree to the last bits, not only to the tolerance of another
summation order; its bicubic border handling is the reference's, not
PyTorch's. The antialiased and nearest ``resize`` follow ``jax.image``'s
resampling (a weight matrix per axis; the floor of half-pixel centres),
which differs from ``F.interpolate``'s.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..core.check import check, check_shape
from ..core.dtype import as_float, host_tensor, true_div
from ..core.grid import create_meshgrid
from ..core.linalg import f32_matmul_precision, inverse_3x3, solve_refined

__all__ = [
    "grid_sample",
    "remap",
    "normal_transform_pixel",
    "normalize_homography",
    "denormalize_homography",
    "transform_points",
    "warp_grid",
    "warp_perspective",
    "warp_affine",
    "homography_warp",
    "HomographyWarper",
    "BaseWarper",
    "get_perspective_transform",
    "get_rotation_matrix2d",
    "get_shear_matrix2d",
    "get_affine_matrix2d",
    "get_translation_matrix2d",
    "invert_affine_transform",
    "crop_and_resize",
    "crop_by_boxes",
    "crop_by_indices",
    "crop_by_transform_mat",
    "center_crop",
    "resize",
    "resize_to_be_divisible",
    "rescale",
    "affine",
    "rotate",
    "translate",
    "scale",
    "shear",
    "elastic_transform2d",
    "get_tps_transform",
    "warp_points_tps",
    "warp_image_tps",
    "hflip",
    "vflip",
    "rot180",
    "upscale_double",
]

Device = Optional[Union[str, torch.device]]


def _unnormalize(coord: torch.Tensor, size: int,
                 align_corners: bool) -> torch.Tensor:
    """[-1, 1] → pixel coordinates (grid_sample convention)."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _reflect(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Reflect coordinates into [lo, hi] (grid_sample's 'reflection')."""
    span = hi - lo
    x = torch.remainder((x - lo).abs(), 2.0 * span)
    return hi - (x - span).abs()


def _reflect_coord(c: torch.Tensor, size: int,
                   align_corners: bool) -> torch.Tensor:
    if align_corners:
        return _reflect(c, 0.0, size - 1)
    return _reflect(c, -0.5, size - 0.5).clamp(0, size - 1)


def _cubic_weights(t: torch.Tensor, a: float = -0.75):
    """Keys cubic convolution weights (a = -0.75, PyTorch's) of the four
    taps at distances (1 + t, t, 1 - t, 2 - t) from the sample."""

    def w1(x):  # |x| <= 1
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0

    def w2(x):  # 1 < |x| < 2
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a

    return w2(1.0 + t), w1(t), w1(1.0 - t), w2(2.0 - t)


def grid_sample(image: torch.Tensor, grid: torch.Tensor,
                mode: str = "bilinear", padding_mode: str = "zeros",
                align_corners: bool = False) -> torch.Tensor:
    """Sample (B, C, H, W) at a normalized grid (B, Ho, Wo, 2) of (x, y).
    `mode` nearest (round half to even), bilinear or bicubic (Keys, a =
    -0.75); `padding_mode` zeros, border or reflection. Bilinear and
    nearest reflect the continuous coordinate; bicubic keeps it for the
    weights and reflects (then rounds) each integer tap."""
    image = as_float(image)
    check(image.ndim == 4,
          f"grid_sample expects (B,C,H,W), got {tuple(image.shape)}")
    check(grid.ndim == 4 and grid.shape[-1] == 2,
          f"grid must be (B,Ho,Wo,2), got {tuple(grid.shape)}")
    if mode not in ("nearest", "bilinear", "bicubic"):
        raise ValueError(f"unknown interpolation mode: {mode}")
    if padding_mode not in ("zeros", "border", "reflection"):
        raise ValueError(f"unknown padding mode: {padding_mode}")
    B, C, H, W = image.shape
    Ho, Wo = grid.shape[1:3]
    dtype = image.dtype
    gx = _unnormalize(grid[..., 0].to(dtype), W, align_corners)
    gy = _unnormalize(grid[..., 1].to(dtype), H, align_corners)
    reflect_taps = padding_mode == "reflection" and mode == "bicubic"
    if padding_mode == "reflection" and not reflect_taps:
        gx = _reflect_coord(gx, W, align_corners)
        gy = _reflect_coord(gy, H, align_corners)
    img_flat = image.reshape(B, C, H * W)

    def tap(iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
        if reflect_taps:
            ix = torch.round(_reflect_coord(ix.to(dtype), W,
                                            align_corners)).long()
            iy = torch.round(_reflect_coord(iy.to(dtype), H,
                                            align_corners)).long()
        ixc = ix.clamp(0, W - 1)
        iyc = iy.clamp(0, H - 1)
        idx = (iyc * W + ixc).reshape(B, 1, -1).expand(B, C, Ho * Wo)
        v = torch.gather(img_flat, 2, idx).reshape(B, C, Ho, Wo)
        if padding_mode == "zeros":
            valid = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
            v = v * valid[:, None].to(dtype)
        return v

    if mode == "nearest":
        return tap(torch.round(gy).long(), torch.round(gx).long())
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    x0i = x0.long()
    y0i = y0.long()
    if mode == "bilinear":
        wx = (gx - x0)[:, None]
        wy = (gy - y0)[:, None]
        v00 = tap(y0i, x0i)
        v01 = tap(y0i, x0i + 1)
        v10 = tap(y0i + 1, x0i)
        v11 = tap(y0i + 1, x0i + 1)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        return top * (1 - wy) + bot * wy
    wx = _cubic_weights((gx - x0)[:, None])
    wy = _cubic_weights((gy - y0)[:, None])
    out = torch.zeros((B, C, Ho, Wo), dtype=dtype, device=image.device)
    for j in range(4):
        row = torch.zeros_like(out)
        for i in range(4):
            row = row + wx[i] * tap(y0i + j - 1, x0i + i - 1)
        out = out + wy[j] * row
    return out


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
    return host_tensor(((2.0 / max(width - 1, 1), 0.0, -1.0),
                        (0.0, 2.0 / max(height - 1, 1), -1.0),
                        (0.0, 0.0, 1.0)), device or "cpu", dtype)[None]


def normalize_homography(H_pix: torch.Tensor, dsize_src: Tuple[int, int],
                         dsize_dst: Tuple[int, int]) -> torch.Tensor:
    """Pixel-space homography → normalized-coordinate homography."""
    check_shape(H_pix, ["*", "3", "3"], "homography")
    src_norm = normal_transform_pixel(*dsize_src, H_pix.dtype, H_pix.device)
    dst_norm = normal_transform_pixel(*dsize_dst, H_pix.dtype, H_pix.device)
    return dst_norm @ H_pix @ inverse_3x3(src_norm)


def denormalize_homography(H_norm: torch.Tensor,
                           dsize_src: Tuple[int, int],
                           dsize_dst: Tuple[int, int]) -> torch.Tensor:
    """Normalized-coordinate homography → pixel-space homography."""
    src_norm = normal_transform_pixel(*dsize_src, H_norm.dtype,
                                      H_norm.device)
    dst_norm = normal_transform_pixel(*dsize_dst, H_norm.dtype,
                                      H_norm.device)
    return inverse_3x3(dst_norm) @ H_norm @ src_norm


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


def _affine_to_homography(A: torch.Tensor) -> torch.Tensor:
    """(B, 2, 3) → (B, 3, 3)."""
    bottom = host_tensor(((0.0, 0.0, 1.0),), A.device, A.dtype)
    return torch.cat([A, bottom.expand(A.shape[0], 1, 3)], dim=1)


def warp_affine(image: torch.Tensor, M: torch.Tensor, dsize: Tuple[int, int],
                mode: str = "bilinear", padding_mode: str = "zeros",
                align_corners: bool = True,
                fill_value: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Warp by (B, 2, 3) affine matrices M: src → dst."""
    check_shape(M, ["B", "2", "3"], "M")
    return warp_perspective(image, _affine_to_homography(M.to(torch.float32)),
                            dsize, mode, padding_mode, align_corners,
                            fill_value)


def homography_warp(image: torch.Tensor, H_norm: torch.Tensor,
                    dsize: Tuple[int, int], mode: str = "bilinear",
                    padding_mode: str = "zeros", align_corners: bool = False,
                    normalized_homography: bool = True) -> torch.Tensor:
    """Warp with a normalized-coordinate homography (dst ← src), or with a
    pixel one through ``warp_perspective``."""
    if not normalized_homography:
        return warp_perspective(image, H_norm, dsize, mode, padding_mode,
                                True)
    grid = warp_grid(inverse_3x3(H_norm.to(torch.float32)), dsize)
    return grid_sample(image, grid, mode, padding_mode, align_corners)


class BaseWarper:
    """Warper interface."""

    def __init__(self, height: int, width: int):
        self.height = height
        self.width = width

    def __call__(self, patch_src, src_homo_dst):
        raise NotImplementedError

    forward = __call__


class HomographyWarper:
    """Homography warper with its destination grid made once; each call
    transforms the grid and samples."""

    def __init__(self, height: int, width: int, mode: str = "bilinear",
                 padding_mode: str = "zeros",
                 normalized_coordinates: bool = True,
                 device: Device = "cuda"):
        self.height = height
        self.width = width
        self.mode = mode
        self.padding_mode = padding_mode
        self.normalized_coordinates = normalized_coordinates
        self.grid = create_meshgrid(height, width, normalized_coordinates,
                                    device=device)
        self._warped_grid: Optional[torch.Tensor] = None

    def precompute_warp_grid(self, src_homo_dst: torch.Tensor) -> None:
        self._warped_grid = self.warp_grid(src_homo_dst)

    def warp_grid(self, src_homo_dst: torch.Tensor) -> torch.Tensor:
        B = src_homo_dst.shape[0]
        pts = self.grid.reshape(1, -1, 2).expand(
            B, self.height * self.width, 2)
        return transform_points(src_homo_dst, pts).reshape(
            B, self.height, self.width, 2)

    def __call__(self, patch_src: torch.Tensor,
                 src_homo_dst: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        if src_homo_dst is not None:
            grid = self.warp_grid(src_homo_dst)
        else:
            if self._warped_grid is None:
                raise ValueError(
                    "call precompute_warp_grid or pass src_homo_dst")
            grid = self._warped_grid
        return grid_sample(patch_src, grid, self.mode, self.padding_mode,
                           align_corners=True)


# -----------------------------------------------------------------------------
# Transform matrices
# -----------------------------------------------------------------------------

def get_perspective_transform(src: torch.Tensor,
                              dst: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) homographies taking 4 src points to 4 dst points: the
    8x8 DLT system, solved in f32 with equilibration and one refinement."""
    check_shape(src, ["B", "4", "2"], "src")
    check_shape(dst, ["B", "4", "2"], "dst")
    src = as_float(src)
    dst = as_float(dst)
    B = src.shape[0]
    x, y = src[..., 0], src[..., 1]
    u, v = dst[..., 0], dst[..., 1]
    zeros = torch.zeros_like(x)
    ones = torch.ones_like(x)
    ax = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y], -1)
    ay = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y], -1)
    A = torch.cat([ax, ay], dim=1)
    b = torch.cat([u, v], dim=1)[..., None]
    h = solve_refined(A, b)[..., 0]
    return torch.cat([h, torch.ones((B, 1), dtype=h.dtype, device=h.device)],
                     dim=-1).reshape(B, 3, 3)


def get_rotation_matrix2d(center: torch.Tensor, angle: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """(B, 2, 3): rotation by `angle` degrees (counter-clockwise) and
    scaling by (sx, sy) about `center`: A = R(θ)·diag(sx, sy), t = c − A·c."""
    center = as_float(center)
    angle = as_float(angle)
    scale = as_float(scale)
    rad = torch.deg2rad(angle)
    c, s = torch.cos(rad), torch.sin(rad)
    sx, sy = scale[..., 0], scale[..., 1]
    a00, a01, a10, a11 = c * sx, s * sy, -s * sx, c * sy
    cx, cy = center[..., 0], center[..., 1]
    tx = cx - (a00 * cx + a01 * cy)
    ty = cy - (a10 * cx + a11 * cy)
    a00, a01, tx, a10, a11, ty = torch.broadcast_tensors(a00, a01, tx, a10,
                                                         a11, ty)
    return torch.stack([torch.stack([a00, a01, tx], -1),
                        torch.stack([a10, a11, ty], -1)], -2)


def get_translation_matrix2d(translation: torch.Tensor) -> torch.Tensor:
    """(B, 2) → (B, 3, 3)."""
    translation = as_float(translation)
    B = translation.shape[0]
    eye = torch.eye(3, dtype=translation.dtype,
                    device=translation.device).repeat(B, 1, 1)
    eye[:, :2, 2] = translation
    return eye


def get_shear_matrix2d(center: torch.Tensor, sx: Optional[torch.Tensor] = None,
                       sy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 3, 3) shear by the angles (radians) sx, sy about `center`:
    T(c) · S · T(-c)."""
    center = as_float(center)
    B = center.shape[0]
    zeros = torch.zeros(B, dtype=center.dtype, device=center.device)
    tanx = torch.tan(zeros if sx is None else as_float(sx))
    tany = torch.tan(zeros if sy is None else as_float(sy))
    ones = torch.ones_like(tanx)
    S = torch.stack([torch.stack([ones, tanx, zeros], -1),
                     torch.stack([tany, tanx * tany + ones, zeros], -1),
                     torch.stack([zeros, zeros, ones], -1)], -2)
    return get_translation_matrix2d(center) @ S @ \
        get_translation_matrix2d(-center)


def get_affine_matrix2d(translations: torch.Tensor, center: torch.Tensor,
                        scale: torch.Tensor, angle: torch.Tensor,
                        sx: Optional[torch.Tensor] = None,
                        sy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, 3, 3) = T · R_center · S (· Shear)."""
    H = _affine_to_homography(get_rotation_matrix2d(center, angle, scale))
    H = get_translation_matrix2d(translations) @ H
    if sx is not None or sy is not None:
        H = H @ get_shear_matrix2d(center, sx, sy)
    return H


def invert_affine_transform(M: torch.Tensor) -> torch.Tensor:
    """(B, 2, 3) inverse affine."""
    return inverse_3x3(_affine_to_homography(as_float(M)))[:, :2, :]


# -----------------------------------------------------------------------------
# Crops
# -----------------------------------------------------------------------------

def crop_by_boxes(image: torch.Tensor, src_box: torch.Tensor,
                  dst_box: torch.Tensor, mode: str = "bilinear",
                  align_corners: bool = True) -> torch.Tensor:
    """Crop by the perspective transform between two quads; the output
    size is read from dst_box's third corner (one host read)."""
    M = get_perspective_transform(src_box, dst_box)
    h = int(round(float(dst_box[0, 2, 1]))) + 1
    w = int(round(float(dst_box[0, 2, 0]))) + 1
    return warp_perspective(image, M, (h, w), mode,
                            align_corners=align_corners)


def crop_and_resize(image: torch.Tensor, boxes: torch.Tensor,
                    size: Tuple[int, int], mode: str = "bilinear",
                    align_corners: bool = True) -> torch.Tensor:
    """boxes (B, 4, 2): corner quads (x, y), TL, TR, BR, BL, each warped to
    an output of `size`."""
    h, w = size
    dst = torch.tensor([[0.0, 0.0], [w - 1.0, 0.0], [w - 1.0, h - 1.0],
                        [0.0, h - 1.0]], dtype=torch.float32,
                       device=boxes.device).expand(boxes.shape[0], 4, 2)
    M = get_perspective_transform(as_float(boxes), dst)
    return warp_perspective(image, M, size, mode,
                            align_corners=align_corners)


def crop_by_indices(image: torch.Tensor, top: int, left: int,
                    size: Tuple[int, int]) -> torch.Tensor:
    return image[..., top:top + size[0], left:left + size[1]]


def center_crop(image: torch.Tensor, size: Tuple[int, int],
                mode: str = "bilinear",
                align_corners: bool = True) -> torch.Tensor:
    """The centred window of `size`; larger than the image, the centred
    box resampled by ``crop_and_resize``."""
    H, W = image.shape[-2:]
    h, w = size
    top, left = (H - h) // 2, (W - w) // 2
    if top >= 0 and left >= 0:
        return crop_by_indices(image, top, left, size)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    x0, x1 = cx - (w - 1) / 2.0, cx + (w - 1) / 2.0
    y0, y1 = cy - (h - 1) / 2.0, cy + (h - 1) / 2.0
    box = torch.tensor([[[x0, y0], [x1, y0], [x1, y1], [x0, y1]]],
                       dtype=torch.float32, device=image.device)
    return crop_and_resize(image, box.expand(image.shape[0], 4, 2), size,
                           mode, align_corners)


def crop_by_transform_mat(image: torch.Tensor, transform: torch.Tensor,
                          out_size: Tuple[int, int], mode: str = "bilinear",
                          padding_mode: str = "zeros",
                          align_corners: bool = True) -> torch.Tensor:
    """``warp_affine`` with a (B|1, 3, 3) crop transform."""
    image = as_float(image)
    M = as_float(transform).expand(image.shape[0], 3, 3).to(image.dtype)
    return warp_affine(image, M[:, :2, :], out_size, mode, padding_mode,
                       align_corners)


# -----------------------------------------------------------------------------
# Resize
# -----------------------------------------------------------------------------

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


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return (1 - x.abs()).clamp_min(0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic with a = -0.5 (``jax.image``'s cubic kernel)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, 0.0, out)


def _resample_weights(m: int, n: int, kernel, device) -> torch.Tensor:
    """(m, n) weights from m input to n output samples, as
    ``jax.image.scale_and_translate`` computes them with antialiasing: the
    kernel widened by 1/scale when shrinking, columns normalized, zero
    where the sample falls outside the input."""
    f32 = torch.float32
    inv_scale = 1.0 / torch.tensor(n / m, dtype=f32, device=device)
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample_f = (torch.arange(n, dtype=f32, device=device) + 0.5) \
        * inv_scale - 0.5
    x = (sample_f[None, :]
         - torch.arange(m, dtype=f32, device=device)[:, None]).abs() \
        / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(f32).eps),
                    w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= m - 0.5)
    return torch.where(inside[None, :], w, 0.0)


@f32_matmul_precision
def _resize_antialias(image: torch.Tensor, h: int, w: int,
                      kernel) -> torch.Tensor:
    """Each axis whose size changes resampled by its weight matrix (two
    products at most), in true f32."""
    H, W = image.shape[-2:]
    out = image
    if h != H:
        out = torch.einsum("...hw,hi->...iw", out,
                           _resample_weights(H, h, kernel, image.device))
    if w != W:
        out = torch.einsum("...hw,wj->...hj", out,
                           _resample_weights(W, w, kernel, image.device))
    return out


def _resize_nearest(image: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Output pixel i takes input floor((i + 0.5) · m / n) (f32), per axis
    whose size changes (``jax.image``'s nearest)."""
    for dim, n in ((-2, h), (-1, w)):
        m = image.shape[dim]
        if m == n:
            continue
        idx = torch.floor(true_div((torch.arange(
            n, dtype=torch.float32, device=image.device) + 0.5) * m,
            n)).long()
        image = image.index_select(image.ndim + dim, idx)
    return image


def resize(image: torch.Tensor, size: Union[int, Tuple[int, int]],
           interpolation: str = "bilinear",
           align_corners: Optional[bool] = None, side: str = "short",
           antialias: bool = False) -> torch.Tensor:
    """Resize (B, C, H, W) to `size`; an int `size` is the target of `side`
    ("short", "long", "vert" or "horz"), the aspect ratio kept.

    - nearest: ``jax.image``'s index rule (floor of the scaled half-pixel
      centre);
    - with `antialias`, where a side shrinks: ``jax.image``'s antialiased
      resampling (triangle kernel for bilinear, Keys a = -0.5 for bicubic,
      widened by the shrink factor), one weight matrix per axis;
    - else bilinear or bicubic ``grid_sample`` at half-pixel sampling
      positions (align_corners False) or corner-aligned ones, border
      padding. "area" and "linear" are bilinear."""
    kinds = {"bilinear": "bilinear", "nearest": "nearest",
             "bicubic": "bicubic", "area": "bilinear", "linear": "bilinear"}
    if interpolation not in kinds:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    method = kinds[interpolation]
    image = as_float(image)
    H, W = image.shape[-2:]
    h, w = _size_of_side(H, W, size, side) if isinstance(size, int) else size
    if h <= 0 or w <= 0:
        raise ValueError(f"resize target must be positive, got {(h, w)}")
    if (h, w) == (H, W):
        return image
    if method == "nearest":
        return _resize_nearest(image, h, w)
    if antialias and (h < H or w < W):
        return _resize_antialias(
            image, h, w, _keys_cubic if method == "bicubic" else _triangle)
    B = image.shape[0]
    if align_corners:
        grid = create_meshgrid(h, w, True, image.dtype, image.device)
    else:
        dt, dev = image.dtype, image.device
        xs = (torch.arange(w, dtype=dt, device=dev) + 0.5) * (W / w) - 0.5
        ys = (torch.arange(h, dtype=dt, device=dev) + 0.5) * (H / h) - 0.5
        gx = true_div(2.0 * xs, max(W - 1, 1)) - 1.0
        gy = true_div(2.0 * ys, max(H - 1, 1)) - 1.0
        gyy, gxx = torch.meshgrid(gy, gx, indexing="ij")
        grid = torch.stack([gxx, gyy], dim=-1)[None]
    return grid_sample(image, grid.expand(B, h, w, 2), method, "border",
                       align_corners=True)


def rescale(image: torch.Tensor, factor: Union[float, Tuple[float, float]],
            interpolation: str = "bilinear",
            antialias: bool = False) -> torch.Tensor:
    fy, fx = (factor, factor) if isinstance(factor, (int, float)) else factor
    H, W = image.shape[-2:]
    return resize(image, (int(H * fy), int(W * fx)), interpolation,
                  antialias=antialias)


def upscale_double(image: torch.Tensor) -> torch.Tensor:
    H, W = image.shape[-2:]
    return resize(image, (2 * H, 2 * W), "bilinear", align_corners=True)


def resize_to_be_divisible(image: torch.Tensor, divisible_factor: int,
                           interpolation: str = "bilinear",
                           align_corners: Optional[bool] = None,
                           side: str = "short",
                           antialias: bool = False) -> torch.Tensor:
    """Resize so that H and W are the nearest multiples of
    `divisible_factor`."""
    H, W = image.shape[-2:]
    h = round(H / divisible_factor) * divisible_factor
    w = round(W / divisible_factor) * divisible_factor
    return resize(image, (h, w), interpolation, align_corners, side,
                  antialias)


# -----------------------------------------------------------------------------
# Affine ops on images
# -----------------------------------------------------------------------------

def affine(image: torch.Tensor, M: torch.Tensor, mode: str = "bilinear",
           padding_mode: str = "zeros",
           align_corners: bool = True) -> torch.Tensor:
    H, W = image.shape[-2:]
    return warp_affine(image, M, (H, W), mode, padding_mode, align_corners)


def _center_of(image: torch.Tensor) -> torch.Tensor:
    H, W = image.shape[-2:]
    return host_tensor(((W - 1) / 2.0, (H - 1) / 2.0),
                       image.device).expand(image.shape[0], 2)


def rotate(image: torch.Tensor, angle: torch.Tensor,
           center: Optional[torch.Tensor] = None, mode: str = "bilinear",
           padding_mode: str = "zeros",
           align_corners: bool = True) -> torch.Tensor:
    """Rotate by `angle` degrees (counter-clockwise) about `center` (the
    image centre by default)."""
    image = as_float(image)
    angle = torch.atleast_1d(as_float(angle)).to(image.device)
    if center is None:
        center = _center_of(image)
    scale = torch.ones((image.shape[0], 2), dtype=image.dtype,
                       device=image.device)
    M = get_rotation_matrix2d(center, angle, scale)
    return affine(image, M, mode, padding_mode, align_corners)


def translate(image: torch.Tensor, translation: torch.Tensor,
              mode: str = "bilinear", padding_mode: str = "zeros",
              align_corners: bool = True) -> torch.Tensor:
    image = as_float(image)
    M = get_translation_matrix2d(as_float(translation))[:, :2, :]
    return affine(image, M, mode, padding_mode, align_corners)


def scale(image: torch.Tensor, scale_factor: torch.Tensor,
          center: Optional[torch.Tensor] = None, mode: str = "bilinear",
          padding_mode: str = "zeros",
          align_corners: bool = True) -> torch.Tensor:
    image = as_float(image)
    scale_factor = as_float(scale_factor)
    if scale_factor.ndim == 1:
        scale_factor = torch.stack([scale_factor, scale_factor], dim=-1)
    if center is None:
        center = _center_of(image)
    angle = torch.zeros(image.shape[0], dtype=image.dtype,
                        device=image.device)
    M = get_rotation_matrix2d(center, angle, scale_factor)
    return affine(image, M, mode, padding_mode, align_corners)


def shear(image: torch.Tensor, shear_factor: torch.Tensor,
          mode: str = "bilinear", padding_mode: str = "zeros",
          align_corners: bool = True) -> torch.Tensor:
    image = as_float(image)
    shear_factor = as_float(shear_factor)
    M = get_shear_matrix2d(_center_of(image), shear_factor[..., 0],
                           shear_factor[..., 1])
    return affine(image, M[:, :2, :], mode, padding_mode, align_corners)


def hflip(image: torch.Tensor) -> torch.Tensor:
    return torch.flip(image, dims=(-1,))


def vflip(image: torch.Tensor) -> torch.Tensor:
    return torch.flip(image, dims=(-2,))


def rot180(image: torch.Tensor) -> torch.Tensor:
    return torch.flip(image, dims=(-2, -1))


# -----------------------------------------------------------------------------
# Elastic and thin-plate-spline warps
# -----------------------------------------------------------------------------

def elastic_transform2d(image: torch.Tensor, noise: torch.Tensor,
                        kernel_size: Tuple[int, int] = (63, 63),
                        sigma: Tuple[float, float] = (32.0, 32.0),
                        alpha: Tuple[float, float] = (1.0, 1.0),
                        align_corners: bool = False, mode: str = "bilinear",
                        padding_mode: str = "zeros") -> torch.Tensor:
    """Warp by noise (B, 2, H, W) smoothed with a Gaussian under a zero
    border (one fused blur launch on the card), scaled by `alpha`, added to
    the identity grid and clamped to [-1, 1]."""
    from .filters import gaussian_blur2d
    image = as_float(image)
    B, C, H, W = image.shape
    disp = gaussian_blur2d(noise, kernel_size, sigma, border_type="constant")
    grid = create_meshgrid(H, W, True, image.dtype, image.device)
    warped = torch.stack([grid[..., 0] + alpha[0] * disp[:, 0],
                          grid[..., 1] + alpha[1] * disp[:, 1]], dim=-1)
    return grid_sample(image, warped.clamp(-1.0, 1.0), mode, padding_mode,
                       align_corners)


def _tps_rbf(d2: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """U(r) = r² log r = 0.5 r² log(r² + eps)."""
    return 0.5 * d2 * torch.log(d2 + eps)


def get_tps_transform(points_src: torch.Tensor, points_dst: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin-plate-spline (kernel weights (B, N, 2), affine weights (B, 3,
    2)) mapping the dst control points to the src ones; the kernel matrix
    pairs src against dst, as the reference builds it."""
    points_src = as_float(points_src)
    points_dst = as_float(points_dst)
    B, N, _ = points_src.shape
    dt, dev = points_src.dtype, points_src.device
    d2 = ((points_src[:, :, None, :] - points_dst[:, None, :, :]) ** 2).sum(-1)
    P = torch.cat([torch.ones((B, N, 1), dtype=dt, device=dev), points_src],
                  dim=-1)
    L = torch.cat([torch.cat([_tps_rbf(d2), P], dim=-1),
                   torch.cat([P.transpose(-1, -2),
                              torch.zeros((B, 3, 3), dtype=dt, device=dev)],
                             dim=-1)], dim=-2)
    Y = torch.cat([points_dst, torch.zeros((B, 3, 2), dtype=dt, device=dev)],
                  dim=-2)
    params = solve_refined(L, Y)
    return params[:, :N, :], params[:, N:, :]


def warp_points_tps(points: torch.Tensor, control_points: torch.Tensor,
                    kernel_weights: torch.Tensor,
                    affine_weights: torch.Tensor) -> torch.Tensor:
    """Apply a thin-plate spline to (B, N, 2) points."""
    d2 = ((points[:, :, None, :] - control_points[:, None, :, :]) ** 2).sum(-1)
    return (affine_weights[:, None, 0, :]
            + torch.einsum("bnd,bdk->bnk", points, affine_weights[:, 1:, :])
            + torch.einsum("bnm,bmk->bnk", _tps_rbf(d2), kernel_weights))


def warp_image_tps(image: torch.Tensor, kernel_centers: torch.Tensor,
                   kernel_weights: torch.Tensor, affine_weights: torch.Tensor,
                   align_corners: bool = False) -> torch.Tensor:
    """Warp (B, C, H, W) by a thin-plate spline given in normalized
    coordinates (dst → src)."""
    image = as_float(image)
    B, C, H, W = image.shape
    grid = create_meshgrid(H, W, True, image.dtype, image.device)
    pts = grid.reshape(1, -1, 2).expand(B, H * W, 2)
    src_pts = warp_points_tps(pts, kernel_centers, kernel_weights,
                              affine_weights)
    return grid_sample(image, src_pts.reshape(B, H, W, 2), "bilinear",
                       "zeros", align_corners)
