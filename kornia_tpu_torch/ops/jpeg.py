"""Differentiable JPEG codec (counterpart of ``kornia_tpu/ops/jpeg.py``;
Reich et al. 2024, "Differentiable JPEG").

The reference's semantics step for step: the polynomial floor and round
surrogates (their cubic terms are part of the forward value), soft
exponential clipping, the (QT · scale + 50) / 100 table law, 4:2:0 chroma
subsampling by a 3-tap Gaussian (sigma 0.5, one fused blur launch on the
card) and 2x2 averaging, bilinear chroma upsampling on decode, and
replicate padding to a multiple of 16. The 8x8 DCT is two products with
the orthonormal DCT-II matrix, in true f32 (TF32 off). The quantization
tables and the DCT matrix are the port's own copies.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.dtype import as_float, host_tensor
from ..core.linalg import f32_matmul_precision

__all__ = ["jpeg_codec_differentiable"]

# the standard JPEG quantization tables (luma, chroma)
_QT_Y = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)
_QT_C = np.full((8, 8), 99, np.float32)
_QT_C[:4, :4] = [[17, 18, 24, 47], [18, 21, 26, 66], [24, 26, 56, 99],
                 [47, 66, 99, 99]]


def _dct_matrix(n: int = 8) -> np.ndarray:
    """The orthonormal DCT-II matrix (rows: frequencies)."""
    k = np.arange(n)
    M = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None]
                                  / (2 * n))
    M[0] *= 1.0 / np.sqrt(2.0)
    return M.astype(np.float32)


_DCT = _dct_matrix()


def _blockify(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W) → (B, blocks, 8, 8), blocks in row-major order."""
    B, H, W = x.shape
    return x.reshape(B, H // 8, 8, W // 8, 8).permute(0, 1, 3, 2, 4).reshape(
        B, -1, 8, 8)


def _unblockify(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    B = x.shape[0]
    return x.reshape(B, H // 8, W // 8, 8, 8).permute(0, 1, 3, 2, 4).reshape(
        B, H, W)


def _poly_round(x: torch.Tensor) -> torch.Tensor:
    """round(x) + (x - round(x))³ (round half to even)."""
    xr = torch.round(x)
    return xr + (x - xr) ** 3


def _poly_floor(x: torch.Tensor) -> torch.Tensor:
    """floor(x) + (x - 0.5 - floor(x))³."""
    xf = torch.floor(x)
    return xf + (x - 0.5 - xf) ** 3


def _soft_clip(x: torch.Tensor, min_val: float, max_val: float,
               scale: float = 0.02) -> torch.Tensor:
    """Soft exponential clipping to [min_val, max_val]."""
    x = torch.where(x > max_val,
                    -scale * (torch.exp((-x + max_val).clamp_max(0.0)) - 1.0)
                    + max_val, x)
    return torch.where(x < min_val,
                       scale * (torch.exp((x - min_val).clamp_max(0.0)) - 1.0)
                       + min_val, x)


def _scaled_qtable(qt: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """(B, 8, 8) quantization tables at qualities q (B,):
    poly_floor(soft_clip((QT · scale + 50) / 100, 1, 255)), scale the
    poly_floor of 5000 / q below 50, else of 200 - 2q."""
    scale = _poly_floor(torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q))
    scaled = qt[None] * scale[:, None, None]
    return _poly_floor(_soft_clip((scaled + 50.0) / 100.0, 1.0, 255.0))


def _down2_antialias(x: torch.Tensor) -> torch.Tensor:
    """Half scale with antialiasing: a 3x3 Gaussian (sigma 0.5, reflect),
    then 2x2 averages."""
    from .filters import gaussian_blur2d
    B, H, W = x.shape
    blurred = gaussian_blur2d(x[:, None], 3, (0.5, 0.5), "reflect")[:, 0]
    return blurred.reshape(B, H // 2, 2, W // 2, 2).mean(dim=(2, 4))


def _up2_bilinear(x: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsampling (half-pixel centres, edges clamped): output
    2k = 0.25 in[k-1] + 0.75 in[k], 2k+1 = 0.75 in[k] + 0.25 in[k+1]."""
    def one_axis(a):
        size = a.shape[-1]
        k = torch.arange(size, device=a.device)
        lo = (k - 1).clamp(0, size - 1)
        hi = (k + 1).clamp(0, size - 1)
        even = 0.25 * a[..., lo] + 0.75 * a[..., k]
        odd = 0.75 * a[..., k] + 0.25 * a[..., hi]
        return torch.stack([even, odd], -1).reshape(*a.shape[:-1], 2 * size)

    x = one_axis(x.movedim(1, -1)).movedim(-1, 1)
    return one_axis(x)


@f32_matmul_precision
def jpeg_codec_differentiable(image_rgb: torch.Tensor,
                              jpeg_quality: torch.Tensor) -> torch.Tensor:
    """Encode and decode (B, 3, H, W) in [0, 1] at qualities (B,) (or one
    for all); any H, W (replicate-padded to /16, cropped back).
    Differentiable in the image and the quality."""
    from .color import rgb_to_ycbcr, ycbcr_to_rgb
    x = as_float(image_rgb)
    B, C, H0, W0 = x.shape
    h_pad, w_pad = (-H0) % 16, (-W0) % 16
    if h_pad or w_pad:
        x = F.pad(x, (0, w_pad, 0, h_pad), mode="replicate")
    H, W = H0 + h_pad, W0 + w_pad
    dev = x.device
    q = torch.as_tensor(jpeg_quality, device=dev).to(x.dtype).expand(B)
    dct = host_tensor(_DCT, dev)
    qt_y = _scaled_qtable(host_tensor(_QT_Y, dev), q)[:, None]
    qt_c = _scaled_qtable(host_tensor(_QT_C, dev), q)[:, None]

    ycbcr = rgb_to_ycbcr(x) * 255.0
    cb_s = _down2_antialias(ycbcr[:, 1])
    cr_s = _down2_antialias(ycbcr[:, 2])

    def encode_decode(plane, qt):
        blocks = _blockify(plane - 128.0)
        coeffs = torch.einsum("ij,bnjk,lk->bnil", dct, blocks, dct)
        deq = _poly_round(coeffs / qt) * qt
        return torch.einsum("ji,bnjk,kl->bnil", dct, deq, dct) + 128.0

    y_r = _unblockify(encode_decode(ycbcr[:, 0], qt_y), H, W)
    cb_r = _unblockify(encode_decode(cb_s, qt_c), H // 2, W // 2)
    cr_r = _unblockify(encode_decode(cr_s, qt_c), H // 2, W // 2)
    out = ycbcr_to_rgb(torch.stack([y_r, _up2_bilinear(cb_r),
                                    _up2_bilinear(cr_r)], dim=1) / 255.0)
    # the reference soft-clips the [0, 1] output against (0, 255): only the
    # lower bound acts
    return _soft_clip(out, 0.0, 255.0)[..., :H0, :W0]
