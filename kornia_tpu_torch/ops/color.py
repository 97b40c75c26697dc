"""Colour-space conversions (counterpart of ``kornia_tpu/ops/color.py``).

Inputs are ``(..., C, H, W)`` float tensors in [0, 1] unless stated. Every
conversion is an elementwise map written as the reference writes it, in the
same order of operations, so that the two libraries agree to rounding.
Conventions: HSV and HLS hue in radians [0, 2π); Lab and Luv under D65;
Y'CbCr is BT.601 full range. The reference's ``jnp.mod`` is Python's
modulo, ``torch.remainder`` here (not ``torch.fmod``).
"""

from __future__ import annotations

import enum
import math
from typing import Optional, Sequence, Tuple, Union

import torch

from ..core.check import check
from ..core.dtype import as_float

__all__ = [
    "rgb_to_grayscale", "bgr_to_grayscale", "grayscale_to_rgb",
    "rgb_to_bgr", "bgr_to_rgb",
    "rgb_to_rgba", "bgr_to_rgba", "rgba_to_rgb", "rgba_to_bgr",
    "rgb_to_linear_rgb", "linear_rgb_to_rgb",
    "rgb_to_hsv", "hsv_to_rgb",
    "rgb_to_hls", "hls_to_rgb",
    "rgb_to_xyz", "xyz_to_rgb",
    "rgb_to_lab", "lab_to_rgb",
    "rgb_to_luv", "luv_to_rgb",
    "rgb_to_ycbcr", "ycbcr_to_rgb",
    "rgb_to_yuv", "yuv_to_rgb",
    "rgb_to_yuv420", "yuv420_to_rgb", "rgb_to_yuv422", "yuv422_to_rgb",
    "rgb_to_raw", "raw_to_rgb", "raw_to_rgb_2x2_downscaled", "CFA",
    "rgb_to_y", "rgb_to_rgb255", "rgb255_to_rgb",
    "normals_to_rgb255", "rgb255_to_normals",
    "sepia", "sepia_from_rgb",
    "apply_colormap",
]

_TWO_PI = 2.0 * math.pi


def _split3(x: torch.Tensor):
    check(x.ndim >= 3 and x.shape[-3] == 3,
          f"expected (..., 3, H, W) color image, got {tuple(x.shape)}")
    return x[..., 0:1, :, :], x[..., 1:2, :, :], x[..., 2:3, :, :]


def rgb_to_grayscale(image: torch.Tensor,
                     rgb_weights: Optional[Union[Sequence[float],
                                                 torch.Tensor]] = None
                     ) -> torch.Tensor:
    """(..., 3, H, W) → (..., 1, H, W): the weighted sum of R, G and B with
    the ITU-R 601 weights (0.299, 0.587, 0.114) unless `rgb_weights`."""
    image = as_float(image)
    r, g, b = _split3(image)
    if rgb_weights is None:  # Python numbers: no copy to the device
        return 0.299 * r + 0.587 * g + 0.114 * b
    w = torch.as_tensor(rgb_weights, dtype=image.dtype, device=image.device)
    return w[0] * r + w[1] * g + w[2] * b


def rgb_to_bgr(image: torch.Tensor) -> torch.Tensor:
    check(image.ndim >= 3 and image.shape[-3] == 3,
          f"expected 3 channels, got {tuple(image.shape)}")
    return torch.flip(image, dims=(-3,))


bgr_to_rgb = rgb_to_bgr


def bgr_to_grayscale(image: torch.Tensor) -> torch.Tensor:
    return rgb_to_grayscale(bgr_to_rgb(image))


def grayscale_to_rgb(image: torch.Tensor) -> torch.Tensor:
    check(image.ndim >= 3 and image.shape[-3] == 1,
          f"expected 1 channel, got {tuple(image.shape)}")
    return torch.cat([image] * 3, dim=-3)


def rgb_to_rgba(image: torch.Tensor, alpha_val: float = 1.0) -> torch.Tensor:
    check(image.ndim >= 3 and image.shape[-3] == 3,
          f"expected 3 channels, got {tuple(image.shape)}")
    return torch.cat([image, torch.full_like(image[..., :1, :, :],
                                             alpha_val)], dim=-3)


def bgr_to_rgba(image: torch.Tensor, alpha_val: float = 1.0) -> torch.Tensor:
    return rgb_to_rgba(bgr_to_rgb(image), alpha_val)


def rgba_to_rgb(image: torch.Tensor) -> torch.Tensor:
    check(image.ndim >= 3 and image.shape[-3] == 4,
          f"expected 4 channels, got {tuple(image.shape)}")
    return image[..., :3, :, :]


def rgba_to_bgr(image: torch.Tensor) -> torch.Tensor:
    return rgb_to_bgr(rgba_to_rgb(image))


def rgb_to_linear_rgb(image: torch.Tensor) -> torch.Tensor:
    """sRGB gamma → linear (piecewise)."""
    image = as_float(image)
    return torch.where(image > 0.04045,
                       torch.pow((image + 0.055) / 1.055, 2.4),
                       image / 12.92)


def linear_rgb_to_rgb(image: torch.Tensor) -> torch.Tensor:
    image = as_float(image)
    safe = image.clamp_min(1e-12)
    return torch.where(image > 0.0031308,
                       1.055 * torch.pow(safe, 1 / 2.4) - 0.055,
                       12.92 * image)


def _hue(r, g, b, maxc, deltac):
    """Hue in radians [0, 2π) from the channels, their max and range."""
    dd = torch.where(deltac == 0, 1.0, deltac)
    rc = (maxc - r) / dd
    gc = (maxc - g) / dd
    bc = (maxc - b) / dd
    h = torch.where(maxc == r, bc - gc,
                    torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(deltac == 0, 0.0, h)
    return torch.remainder(h / 6.0, 1.0) * _TWO_PI


def rgb_to_hsv(image: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Hue in radians [0, 2π), saturation and value in [0, 1]."""
    image = as_float(image)
    r, g, b = _split3(image)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    deltac = maxc - minc
    s = deltac / (maxc + eps)
    return torch.cat([_hue(r, g, b, maxc, deltac), s, maxc], dim=-3)


def hsv_to_rgb(image: torch.Tensor) -> torch.Tensor:
    """The branch-free continuous form (no floor or select), as the
    reference computes it."""
    image = as_float(image)
    h, s, v = _split3(image)
    h6 = h * (6.0 / _TWO_PI)

    def channel(n):
        k = torch.remainder(n + h6, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.cat([channel(5.0), channel(3.0), channel(1.0)], dim=-3)


def rgb_to_hls(image: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Hue in radians, lightness and saturation."""
    image = as_float(image)
    r, g, b = _split3(image)
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    l = (maxc + minc) / 2.0
    deltac = maxc - minc
    s = torch.where(deltac == 0, 0.0,
                    torch.where(l < 0.5, deltac / (maxc + minc + eps),
                                deltac / (2.0 - maxc - minc + eps)))
    return torch.cat([_hue(r, g, b, maxc, deltac), l, s], dim=-3)


def hls_to_rgb(image: torch.Tensor) -> torch.Tensor:
    image = as_float(image)
    h, l, s = _split3(image)
    h = h / _TWO_PI * 12.0

    def f(n):
        k = torch.remainder(n + h, 12.0)
        a = s * torch.minimum(l, 1.0 - l)
        return l - a * torch.clamp(torch.minimum(k - 3.0, 9.0 - k), -1.0, 1.0)

    return torch.cat([f(0.0), f(8.0), f(4.0)], dim=-3)


_RGB2XYZ = [[0.412453, 0.357580, 0.180423],
            [0.212671, 0.715160, 0.072169],
            [0.019334, 0.119193, 0.950227]]
_XYZ2RGB = [[3.2404813432005266, -1.5371515162713185, -0.4985363261688878],
            [-0.9692549499965682, 1.8759900014898907, 0.0415559265582928],
            [0.0556466391351772, -0.2040413383665112, 1.0573110696453443]]
_SEPIA = [[0.393, 0.769, 0.189], [0.349, 0.686, 0.168],
          [0.272, 0.534, 0.131]]


def _mat3_mix(image: torch.Tensor, m) -> torch.Tensor:
    """Each output channel as the reference sums it: m[i,0]·a + m[i,1]·b +
    m[i,2]·c, elementwise (no matrix product, so no TF32), the weights as
    Python numbers (no copy to the device)."""
    a, b, c = _split3(image)
    return torch.cat([m[i][0] * a + m[i][1] * b + m[i][2] * c
                      for i in range(3)], dim=-3)


def rgb_to_xyz(image: torch.Tensor) -> torch.Tensor:
    return _mat3_mix(as_float(image), _RGB2XYZ)


def xyz_to_rgb(image: torch.Tensor) -> torch.Tensor:
    return _mat3_mix(as_float(image), _XYZ2RGB)


_D65 = (0.95047, 1.0, 1.08883)


def rgb_to_lab(image: torch.Tensor) -> torch.Tensor:
    """CIE Lab under D65: clamped cube root above the threshold, 116 f(y)
    − 16 for every y."""
    image = as_float(image)
    x, y, z = _split3(rgb_to_xyz(rgb_to_linear_rgb(image)))
    x, y, z = x / _D65[0], y / _D65[1], z / _D65[2]
    thresh = 0.008856

    def f(t):
        return torch.where(t > thresh, t.clamp_min(thresh).pow(1 / 3),
                           7.787 * t + 4.0 / 29.0)

    fx, fy, fz = f(x), f(y), f(z)
    return torch.cat([116.0 * fy - 16.0, 500.0 * (fx - fy),
                      200.0 * (fy - fz)], dim=-3)


def lab_to_rgb(image: torch.Tensor, clip: bool = True) -> torch.Tensor:
    image = as_float(image)
    L, a, b = _split3(image)
    fy = (L + 16.0) / 116.0
    fx = fy + a / 500.0
    fz = fy - b / 200.0

    def finv(t):
        t3 = t ** 3
        return torch.where(t3 > 0.008856, t3, (t - 4.0 / 29.0) / 7.787)

    xyz = torch.cat([finv(fx) * _D65[0], finv(fy) * _D65[1],
                     finv(fz) * _D65[2]], dim=-3)
    rgb = linear_rgb_to_rgb(xyz_to_rgb(xyz))
    return rgb.clamp(0.0, 1.0) if clip else rgb


def _white_uv():
    xn, yn, zn = _D65
    dn = xn + 15.0 * yn + 3.0 * zn
    return 4.0 * xn / dn, 9.0 * yn / dn


def rgb_to_luv(image: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """CIE Luv under D65."""
    image = as_float(image)
    x, y, z = _split3(rgb_to_xyz(rgb_to_linear_rgb(image)))
    L = torch.where(y > 0.008856,
                    116.0 * y.clamp_min(eps).pow(1 / 3) - 16.0, 903.3 * y)
    d = x + 15.0 * y + 3.0 * z + eps
    un, vn = _white_uv()
    u = 13.0 * L * (4.0 * x / d - un)
    v = 13.0 * L * (9.0 * y / d - vn)
    return torch.cat([L, u, v], dim=-3)


def luv_to_rgb(image: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    image = as_float(image)
    L, u, v = _split3(image)
    un, vn = _white_uv()
    y = torch.where(L > 7.999625, ((L + 16.0) / 116.0) ** 3,
                    L / 903.3) * _D65[1]
    Ls = torch.where(L == 0, eps, L)
    u_p = u / (13.0 * Ls) + un
    v_p = v / (13.0 * Ls) + vn
    v_ps = torch.where(v_p == 0, eps, v_p)
    x = y * 9.0 * u_p / (4.0 * v_ps)
    z = y * (12.0 - 3.0 * u_p - 20.0 * v_p) / (4.0 * v_ps)
    return linear_rgb_to_rgb(xyz_to_rgb(torch.cat([x, y, z], dim=-3)))


def rgb_to_ycbcr(image: torch.Tensor) -> torch.Tensor:
    """BT.601 full range, Cb and Cr centred at 0.5."""
    image = as_float(image)
    r, g, b = _split3(image)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = (b - y) * 0.564 + 0.5
    cr = (r - y) * 0.713 + 0.5
    return torch.cat([y, cb, cr], dim=-3)


def ycbcr_to_rgb(image: torch.Tensor) -> torch.Tensor:
    image = as_float(image)
    y, cb, cr = _split3(image)
    cb = cb - 0.5
    cr = cr - 0.5
    r = y + 1.403 * cr
    g = y - 0.714 * cr - 0.344 * cb
    b = y + 1.773 * cb
    return torch.cat([r, g, b], dim=-3).clamp(0.0, 1.0)


def rgb_to_yuv(image: torch.Tensor) -> torch.Tensor:
    image = as_float(image)
    r, g, b = _split3(image)
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = -0.147 * r - 0.289 * g + 0.436 * b
    v = 0.615 * r - 0.515 * g - 0.100 * b
    return torch.cat([y, u, v], dim=-3)


def yuv_to_rgb(image: torch.Tensor) -> torch.Tensor:
    image = as_float(image)
    y, u, v = _split3(image)
    r = y + 1.14 * v
    g = y - 0.396 * u - 0.581 * v
    b = y + 2.029 * u
    return torch.cat([r, g, b], dim=-3)


def rgb_to_yuv420(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (Y (..., 1, H, W), UV (..., 2, H/2, W/2)), chroma averaged over
    2x2 cells."""
    yuv = rgb_to_yuv(image)
    uv = yuv[..., 1:3, :, :]
    H, W = uv.shape[-2:]
    uv = uv.reshape(*uv.shape[:-3], 2, H // 2, 2, W // 2, 2).mean(
        dim=(-3, -1))
    return yuv[..., 0:1, :, :], uv


def yuv420_to_rgb(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    uv_full = uv.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
    return yuv_to_rgb(torch.cat([y, uv_full], dim=-3))


def rgb_to_yuv422(image: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """→ (Y (..., 1, H, W), UV (..., 2, H, W/2)), chroma averaged over
    horizontal pairs."""
    yuv = rgb_to_yuv(image)
    uv = yuv[..., 1:3, :, :]
    H, W = uv.shape[-2:]
    uv = uv.reshape(*uv.shape[:-3], 2, H, W // 2, 2).mean(dim=-1)
    return yuv[..., 0:1, :, :], uv


def yuv422_to_rgb(y: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    return yuv_to_rgb(torch.cat([y, uv.repeat_interleave(2, dim=-1)],
                                dim=-3))


class CFA(enum.Enum):
    """Bayer colour-filter-array layouts, OpenCV naming (``BG``: pixel (1, 1)
    is blue)."""

    BG = 0
    GB = 1
    RG = 2
    GR = 3


# position of (R, Gr, Gb, B) in each 2x2 Bayer cell
_CFA = {"BG": ((0, 0), (0, 1), (1, 0), (1, 1)),
        "GB": ((0, 1), (0, 0), (1, 1), (1, 0)),
        "RG": ((1, 1), (1, 0), (0, 1), (0, 0)),
        "GR": ((1, 0), (1, 1), (0, 0), (0, 1))}


def _cfa_key(cfa) -> str:
    return cfa.name if isinstance(cfa, CFA) else str(cfa)


def _cfa_masks(H: int, W: int, cfa, device):
    """Boolean (H, W) masks of the red and blue sites."""
    ry = (torch.arange(H, device=device) % 2)[:, None]
    rx = (torch.arange(W, device=device) % 2)[None, :]
    r_p, _, _, b_p = _CFA[_cfa_key(cfa)]
    return ((ry == r_p[0]) & (rx == r_p[1]),
            (ry == b_p[0]) & (rx == b_p[1]))


def rgb_to_raw(image: torch.Tensor, cfa: str = "BG") -> torch.Tensor:
    """Mosaic an RGB image into a one-channel Bayer pattern."""
    image = as_float(image)
    r, g, b = _split3(image)
    sel_r, sel_b = _cfa_masks(*image.shape[-2:], cfa, image.device)
    return torch.where(sel_r, r, torch.where(sel_b, b, g))


def raw_to_rgb(image: torch.Tensor, cfa: str = "BG") -> torch.Tensor:
    """Bilinear demosaic of a (B, 1, H, W) Bayer image: each channel's
    sites correlated with a 3x3 kernel under reflect padding, divided by
    the same correlation of the site mask."""
    from .filters import filter2d
    image = as_float(image)
    check(image.shape[-3] == 1,
          f"expected 1 channel raw, got {tuple(image.shape)}")
    sel_r, sel_b = _cfa_masks(*image.shape[-2:], cfa, image.device)
    m_r = sel_r.to(image.dtype)
    m_b = sel_b.to(image.dtype)
    m_g = 1.0 - m_r - m_b
    kern_rb = torch.tensor([[[0.25, 0.5, 0.25], [0.5, 1.0, 0.5],
                             [0.25, 0.5, 0.25]]], dtype=image.dtype,
                           device=image.device)
    kern_g = torch.tensor([[[0.0, 0.25, 0.0], [0.25, 1.0, 0.25],
                            [0.0, 0.25, 0.0]]], dtype=image.dtype,
                          device=image.device)

    def interp(mask, kern):
        num = filter2d(image * mask, kern, border_type="reflect")
        den = filter2d(mask.expand(image.shape), kern, border_type="reflect")
        return num / den.clamp_min(1e-8)

    return torch.cat([interp(m_r, kern_rb), interp(m_g, kern_g),
                      interp(m_b, kern_rb)], dim=-3)


def raw_to_rgb_2x2_downscaled(image: torch.Tensor, cfa="BG") -> torch.Tensor:
    """Half-resolution demosaic: each 2x2 Bayer cell becomes one RGB pixel,
    its greens averaged."""
    image = as_float(image)
    check(image.shape[-3] == 1,
          f"expected 1 channel raw, got {tuple(image.shape)}")
    H, W = image.shape[-2:]
    check(H % 2 == 0 and W % 2 == 0, f"H/W must be even, got {(H, W)}")
    r_p, gr_p, gb_p, b_p = _CFA[_cfa_key(cfa)]
    cells = image.reshape(*image.shape[:-2], H // 2, 2, W // 2, 2)
    cells = cells.movedim(-3, -2)  # (..., 1, H/2, W/2, 2, 2)
    r = cells[..., r_p[0], r_p[1]]
    g = 0.5 * (cells[..., gr_p[0], gr_p[1]] + cells[..., gb_p[0], gb_p[1]])
    b = cells[..., b_p[0], b_p[1]]
    return torch.cat([r, g, b], dim=-3)


def rgb_to_y(image: torch.Tensor) -> torch.Tensor:
    """RGB → luma Y (..., 1, H, W)."""
    r, g, b = _split3(as_float(image))
    return 0.299 * r + 0.587 * g + 0.114 * b


def rgb_to_rgb255(image: torch.Tensor) -> torch.Tensor:
    """[0, 1] RGB → [0, 255], clipped."""
    return (as_float(image) * 255.0).clamp(0.0, 255.0)


def rgb255_to_rgb(image: torch.Tensor) -> torch.Tensor:
    return as_float(image) / 255.0


def normals_to_rgb255(image: torch.Tensor) -> torch.Tensor:
    """Unit surface normals → [0, 255] RGB."""
    return (0.5 * (as_float(image) + 1.0)).clamp(0.0, 1.0) * 255.0


def rgb255_to_normals(image: torch.Tensor, eps: float = 1e-12
                      ) -> torch.Tensor:
    """[0, 255] RGB → unit surface normals."""
    n = (as_float(image) / 255.0) * 2.0 - 1.0
    norm = torch.linalg.vector_norm(n, dim=-3, keepdim=True)
    return n / norm.clamp_min(eps)


def sepia(image: torch.Tensor, rescale: bool = True,
          eps: float = 1e-6) -> torch.Tensor:
    """Sepia tone; `rescale` divides each channel by its maximum over the
    image."""
    out = _mat3_mix(as_float(image), _SEPIA)
    if rescale:
        out = out / (out.amax(dim=(-2, -1), keepdim=True) + eps)
    return out


sepia_from_rgb = sepia


def apply_colormap(gray: torch.Tensor, colormap: torch.Tensor
                   ) -> torch.Tensor:
    """Map (..., 1, H, W) in [0, 1] through an (N, 3) colour table with
    linear interpolation → (..., 3, H, W)."""
    gray = as_float(gray)
    n = colormap.shape[0]
    t = gray[..., 0, :, :].clamp(0.0, 1.0) * (n - 1)
    i0 = torch.floor(t).to(torch.int64)
    i1 = (i0 + 1).clamp_max(n - 1)
    w = (t - i0)[..., None]
    colormap = colormap.to(gray.device)
    c = colormap[i0] * (1 - w) + colormap[i1] * w  # (..., H, W, 3)
    return c.movedim(-1, -3)
