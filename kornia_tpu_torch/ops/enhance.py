"""Intensity and enhancement ops (counterpart of
``kornia_tpu/ops/enhance.py``): the ``adjust_*`` family, equalization
(global, volumetric and CLAHE), histograms, the integral image, ZCA
whitening, thresholds and normalization.

The integer algorithms (``equalize``, CLAHE's exact mode, ``posterize``,
the thresholds) are the reference's step for step: histograms are counted
with ``torch.bincount`` on integer bins, exact on the card, and the LUTs
use integer floor division, so results agree bit for bit. The matrix
products (ZCA, ``linear_transform``) run in true f32 (TF32 off).
"""

from __future__ import annotations

import enum
import math
from typing import Optional, Tuple

import torch

from ..core.check import check
from ..core.dtype import as_float, host_tensor, true_div
from ..core.linalg import f32_matmul_precision

__all__ = [
    "add_weighted",
    "adjust_brightness",
    "adjust_brightness_accumulative",
    "adjust_contrast",
    "adjust_contrast_with_mean_subtraction",
    "adjust_saturation", "adjust_saturation_with_gray_subtraction",
    "adjust_hue",
    "adjust_gamma",
    "adjust_sigmoid",
    "adjust_log",
    "invert",
    "solarize",
    "posterize",
    "sharpness",
    "equalize",
    "equalize3d",
    "equalize_clahe",
    "normalize",
    "denormalize",
    "normalize_min_max",
    "histogram",
    "histogram2d",
    "image_histogram2d",
    "integral_tensor",
    "integral_image",
    "zca_mean",
    "zca_whiten",
    "shift_rgb",
    "threshold_binary",
    "otsu_threshold",
    "adjust_saturation_raw", "adjust_hue_raw", "ThresholdType", "threshold",
    "linear_transform", "rescale_intensity",
]

_TWO_PI = 2.0 * math.pi


def _bcast_factor(factor, image: torch.Tensor) -> torch.Tensor:
    """A scalar factor, or one per batch item shaped to broadcast; a
    Python number is filled on the device (no host copy)."""
    if isinstance(factor, (int, float)):
        return torch.full((), float(factor), dtype=image.dtype,
                          device=image.device)
    f = torch.as_tensor(factor, dtype=image.dtype, device=image.device)
    if f.ndim == 0:
        return f
    return f.reshape(f.shape[0], *([1] * (image.ndim - 1)))


def _clip01(x: torch.Tensor, clip_output: bool = True) -> torch.Tensor:
    return x.clamp(0.0, 1.0) if clip_output else x


def add_weighted(src1: torch.Tensor, alpha: float, src2: torch.Tensor,
                 beta: float, gamma: float) -> torch.Tensor:
    return as_float(src1) * alpha + as_float(src2) * beta + gamma


def adjust_brightness(image: torch.Tensor, factor,
                      clip_output: bool = True) -> torch.Tensor:
    """Additive brightness."""
    image = as_float(image)
    return _clip01(image + _bcast_factor(factor, image), clip_output)


def adjust_brightness_accumulative(image: torch.Tensor, factor,
                                   clip_output: bool = True) -> torch.Tensor:
    """Multiplicative brightness."""
    image = as_float(image)
    return _clip01(image * _bcast_factor(factor, image), clip_output)


def adjust_contrast(image: torch.Tensor, factor,
                    clip_output: bool = True) -> torch.Tensor:
    image = as_float(image)
    return _clip01(image * _bcast_factor(factor, image), clip_output)


def adjust_contrast_with_mean_subtraction(image: torch.Tensor,
                                          factor) -> torch.Tensor:
    """Blend with the image's mean grey level (of each image)."""
    from .color import rgb_to_grayscale
    image = as_float(image)
    factor = _bcast_factor(factor, image)
    grey = rgb_to_grayscale(image) if image.shape[-3] == 3 else image
    mean = grey.mean(dim=(-3, -2, -1), keepdim=True)
    return (image * factor + mean * (1.0 - factor)).clamp(0.0, 1.0)


def adjust_saturation_raw(image: torch.Tensor, factor) -> torch.Tensor:
    """Scale S of an HSV image."""
    image = as_float(image)
    s = (image[..., 1:2, :, :] * _bcast_factor(factor, image)).clamp(0.0, 1.0)
    return torch.cat([image[..., 0:1, :, :], s, image[..., 2:3, :, :]],
                     dim=-3)


def adjust_hue_raw(image: torch.Tensor, factor) -> torch.Tensor:
    """Shift H (radians) of an HSV image, wrapped into [0, 2π)."""
    image = as_float(image)
    h = torch.remainder(image[..., 0:1, :, :] + _bcast_factor(factor, image),
                        _TWO_PI)
    return torch.cat([h, image[..., 1:, :, :]], dim=-3)


def adjust_saturation(image: torch.Tensor, factor) -> torch.Tensor:
    """Scale the HSV saturation of an RGB image."""
    from .color import hsv_to_rgb, rgb_to_hsv
    image = as_float(image)
    return hsv_to_rgb(adjust_saturation_raw(rgb_to_hsv(image), factor))


def adjust_saturation_with_gray_subtraction(image: torch.Tensor,
                                            factor) -> torch.Tensor:
    """Blend with the grey image (torchvision's saturation)."""
    from .color import rgb_to_grayscale
    image = as_float(image)
    factor = _bcast_factor(factor, image)
    grey = rgb_to_grayscale(image)
    return (image * factor + grey * (1.0 - factor)).clamp(0.0, 1.0)


def adjust_hue(image: torch.Tensor, factor) -> torch.Tensor:
    """Shift the hue of an RGB image by `factor` radians."""
    from .color import hsv_to_rgb, rgb_to_hsv
    image = as_float(image)
    return hsv_to_rgb(adjust_hue_raw(rgb_to_hsv(image), factor))


def adjust_gamma(image: torch.Tensor, gamma, gain=1.0) -> torch.Tensor:
    image = as_float(image)
    gamma = _bcast_factor(gamma, image)
    gain = _bcast_factor(gain, image)
    return (gain * torch.pow(image.clamp_min(1e-12), gamma)).clamp(0.0, 1.0)


def adjust_sigmoid(image: torch.Tensor, cutoff: float = 0.5,
                   gain: float = 10.0, inv: bool = False) -> torch.Tensor:
    image = as_float(image)
    out = 1.0 / (1.0 + torch.exp(gain * (cutoff - image)))
    return 1.0 - out if inv else out


def adjust_log(image: torch.Tensor, gain: float = 1.0, inv: bool = False,
               clip_output: bool = True) -> torch.Tensor:
    image = as_float(image)
    out = gain * (torch.exp2(image) - 1.0) if inv else \
        gain * torch.log2(1.0 + image)
    return _clip01(out, clip_output)


def invert(image: torch.Tensor, max_val: float = 1.0) -> torch.Tensor:
    return max_val - as_float(image)


def solarize(image: torch.Tensor, thresholds=0.5,
             additions=None) -> torch.Tensor:
    """Invert the pixels at or above the threshold (after `additions`,
    clipped)."""
    image = as_float(image)
    th = _bcast_factor(thresholds, image)
    if additions is not None:
        image = (image + _bcast_factor(additions, image)).clamp(0.0, 1.0)
    return torch.where(image >= th, 1.0 - image, image)


def posterize(image: torch.Tensor, bits) -> torch.Tensor:
    """Keep the top `bits` bits (scalar, or one per batch item) of each
    8-bit level; 8 bits leave the image exactly as it is."""
    image = as_float(image)
    if isinstance(bits, int) and not 0 <= bits <= 8:
        raise ValueError(f"posterize bits must be in [0, 8], got {bits}")
    bits = torch.as_tensor(bits, device=image.device)
    if bits.ndim:
        bits = bits.reshape(-1, *([1] * (image.ndim - 1)))
    shift = (8 - bits).to(torch.int32)
    q = torch.floor(image * 255.0).to(torch.int32)
    out = true_div(((q >> shift) << shift).to(image.dtype), 255.0)
    return torch.where(bits == 8, image, out)


def sharpness(image: torch.Tensor, factor) -> torch.Tensor:
    """Interpolate from the smoothed image (3x3 kernel [1 1 1; 1 5 1; 1 1
    1] / 13, clipped; the border rows and columns unsmoothed) to the input
    by `factor`: 0 the smoothed image, 1 the input, above 1 sharper."""
    from .filters import filter2d
    image = as_float(image)
    factor = _bcast_factor(factor, image)
    kern = host_tensor((((1.0, 1.0, 1.0), (1.0, 5.0, 1.0), (1.0, 1.0, 1.0)),),
                       image.device, image.dtype) / 13.0
    smooth = filter2d(image, kern, border_type="constant").clamp(0.0, 1.0)
    mask = torch.zeros(image.shape[-2:], dtype=image.dtype,
                       device=image.device)
    mask[1:-1, 1:-1] = 1.0
    result = image * (1.0 - mask) + smooth * mask
    return (result + (image - result) * factor).clamp(0.0, 1.0)


def _plane_histograms(q: torch.Tensor, nbins: int) -> torch.Tensor:
    """(N, P) integer bins in [0, nbins) → (N, nbins) int64 counts, one
    ``bincount`` over all planes."""
    N = q.shape[0]
    offs = torch.arange(N, device=q.device)[:, None] * nbins
    return torch.bincount((q + offs).reshape(-1),
                          minlength=N * nbins).reshape(N, nbins)


def equalize(image: torch.Tensor) -> torch.Tensor:
    """Histogram equalization of each plane over 256 levels, the PIL /
    torchvision integer LUT: the histogram binned as ``torch.histc`` over
    [0, 255] (bin width 255/256), the LUT looked up by truncation; a plane
    whose step is 0 is left as it is."""
    image = as_float(image)
    flat = image.reshape(-1, image.shape[-2] * image.shape[-1])
    v = (flat * 255.0).clamp(0, 255)
    q = v.to(torch.int64)
    hist = _plane_histograms((v * (256.0 / 255.0)).to(torch.int64).clamp(
        0, 255), 256)
    bins = torch.arange(256, device=image.device)
    last = torch.where(hist > 0, bins, -1).argmax(dim=-1, keepdim=True)
    last_nz_val = hist.gather(1, last)
    step = (hist.sum(dim=-1, keepdim=True) - last_nz_val) // 255
    lut = (hist.cumsum(dim=-1) + step // 2) // step.clamp_min(1)
    lut = torch.cat([torch.zeros_like(lut[:, :1]), lut[:, :-1]],
                    dim=-1).clamp(0, 255)
    out = true_div(lut.gather(1, q).to(image.dtype), 255.0)
    return torch.where(step == 0, flat, out).reshape(image.shape)


def equalize3d(volume: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W): ``equalize`` over each (batch, channel) volume."""
    v = as_float(volume)
    B, C, D, H, W = v.shape
    return equalize(v.reshape(B * C, 1, D * H, W)).reshape(B, C, D, H, W)


def _clahe_tiles(img: torch.Tensor, grid_size: Tuple[int, int]):
    """Tile geometry: (th, tw) each ceil(size / grid) made even, the image
    reflect-padded at the bottom and right to the tile grid, and its tiles
    as (B·C·gh·gw, th·tw)."""
    B, C, H, W = img.shape
    gh, gw = grid_size
    th, tw = -(-H // gh), -(-W // gw)
    th += th % 2
    tw += tw % 2
    img_p = torch.nn.functional.pad(img, (0, tw * gw - W, 0, th * gh - H),
                                    mode="reflect")
    tiles = img_p.reshape(B, C, gh, th, gw, tw).permute(0, 1, 2, 4, 3, 5)
    return th, tw, img_p, tiles.reshape(B * C * gh * gw, th * tw)


def _gather_luts(luts: torch.Tensor, ty: torch.Tensor, tx: torch.Tensor,
                 q: torch.Tensor) -> torch.Tensor:
    """luts (B, C, gh, gw, n) read at tile row ty (h,), tile column tx (w,)
    and level q (B, C, h, w) → (B, C, h, w)."""
    B, C, gh, gw, n = luts.shape
    idx = (ty[:, None] * gw + tx[None, :]) * n + q
    return luts.reshape(B, C, -1).gather(2, idx.reshape(B, C, -1)).reshape(
        q.shape)


def equalize_clahe(image: torch.Tensor, clip_limit: float = 40.0,
                   grid_size: Tuple[int, int] = (8, 8),
                   slow_and_differentiable: bool = False) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization (OpenCV's and the
    reference's): even tiles over a reflect-padded image, ``histc``-binned
    integer histograms, OpenCV's clip redistribution (uniform share plus
    one count to each of the first `residual` bins), floor'd LUTs, and
    interpolation between the LUTs of the neighbouring tiles by
    half-tile ramps.

    `slow_and_differentiable` keeps the reference's smooth variant (the
    excess spread evenly, normalized CDFs, bilinear tile weights). Its
    levels are rounded to integer bins, so, as in the reference, its output
    carries no gradient to the image."""
    image = as_float(image)
    orig_shape = image.shape
    img = image.reshape(-1, *orig_shape[-3:])
    B, C, H, W = img.shape
    gh, gw = grid_size
    nbins = 256
    th, tw, img_p, tiles = _clahe_tiles(img, grid_size)
    pixels = th * tw
    dev = img.device

    if slow_and_differentiable:
        q = torch.floor(tiles * (nbins - 1) + 0.5).clamp(0, nbins - 1).long()
        hist = _plane_histograms(q, nbins).to(img.dtype)
        if clip_limit > 0:
            limit = max(clip_limit * pixels / nbins, 1.0)
            excess = (hist - limit).clamp_min(0.0).sum(dim=-1, keepdim=True)
            hist = hist.clamp_max(limit) + excess / nbins
        cdf = hist.cumsum(dim=-1)
        luts = (cdf / cdf[..., -1:]).reshape(B, C, gh, gw, nbins)
        ty = true_div(torch.arange(H, dtype=img.dtype, device=dev), th) - 0.5
        tx = true_div(torch.arange(W, dtype=img.dtype, device=dev), tw) - 0.5
        ty0 = torch.floor(ty).clamp(0, gh - 1).long()
        tx0 = torch.floor(tx).clamp(0, gw - 1).long()
        ty1 = (ty0 + 1).clamp(0, gh - 1)
        tx1 = (tx0 + 1).clamp(0, gw - 1)
        wy = (ty - ty0).clamp(0.0, 1.0)[:, None]
        wx = (tx - tx0).clamp(0.0, 1.0)[None, :]
        qimg = torch.floor(img * (nbins - 1) + 0.5).clamp(0, nbins - 1).long()
        v00 = _gather_luts(luts, ty0, tx0, qimg)
        v01 = _gather_luts(luts, ty0, tx1, qimg)
        v10 = _gather_luts(luts, ty1, tx0, qimg)
        v11 = _gather_luts(luts, ty1, tx1, qimg)
        out = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
               + v10 * wy * (1 - wx) + v11 * wy * wx)
        return out.to(image.dtype).reshape(orig_shape)

    # histc's bins: floor(x · 256), 1.0 in bin 255
    q = torch.floor(tiles * nbins).clamp(0, nbins - 1).long()
    hist = _plane_histograms(q, nbins).to(torch.float32)
    if clip_limit > 0:
        max_val = max(clip_limit * pixels // nbins, 1.0)
        hist = hist.clamp_max(max_val)
        clipped = pixels - hist.sum(dim=-1, keepdim=True)
        residual = torch.remainder(clipped, float(nbins))
        hist = hist + (clipped - residual) / nbins
        hist = hist + (torch.arange(nbins, dtype=hist.dtype, device=dev)[None]
                       < residual).to(hist.dtype)
    luts = torch.floor((hist.cumsum(dim=-1) * ((nbins - 1) / pixels)).clamp(
        0, nbins - 1)).reshape(B, C, gh, gw, nbins)

    # half-tile row rr interpolates tile rows (rr - 1) // 2 and
    # (rr + 1) // 2 (clipped: the corners and borders take one LUT), its
    # weight ramp (2hh - 1 - k) / (2hh - 1) shifted by the half's parity
    hh, hw = th // 2, tw // 2
    Hp, Wp = img_p.shape[-2:]
    ys = torch.arange(Hp, device=dev)
    xs = torch.arange(Wp, device=dev)
    rr, cc = ys // hh, xs // hw
    k, l = ys % hh, xs % hw
    jt = ((rr - 1) // 2).clamp(0, gh - 1)
    jb = ((rr + 1) // 2).clamp(0, gh - 1)
    il = ((cc - 1) // 2).clamp(0, gw - 1)
    ir = ((cc + 1) // 2).clamp(0, gw - 1)
    wv = true_div((2 * hh - 1) - (k + hh * (1 - rr % 2)), 2.0 * hh - 1).to(
        img.dtype)[:, None]
    wh = true_div((2 * hw - 1) - (l + hw * (1 - cc % 2)), 2.0 * hw - 1).to(
        img.dtype)[None, :]
    # a pixel's level: x · 255 truncated
    qimg = (img_p * (nbins - 1.0)).clamp(0, nbins - 1).long()
    vtl = _gather_luts(luts, jt, il, qimg)
    vtr = _gather_luts(luts, jt, ir, qimg)
    vbl = _gather_luts(luts, jb, il, qimg)
    vbr = _gather_luts(luts, jb, ir, qimg)
    top = vtr + wh * (vtl - vtr)
    bot = vbr + wh * (vbl - vbr)
    out = true_div(bot + wv * (top - bot), nbins - 1.0)
    return out[..., :H, :W].to(image.dtype).reshape(orig_shape)


def normalize(image: torch.Tensor, mean, std) -> torch.Tensor:
    image = as_float(image)
    mean = torch.as_tensor(mean, dtype=image.dtype,
                           device=image.device).reshape(-1, 1, 1)
    std = torch.as_tensor(std, dtype=image.dtype,
                          device=image.device).reshape(-1, 1, 1)
    return (image - mean) / std


def denormalize(image: torch.Tensor, mean, std) -> torch.Tensor:
    image = as_float(image)
    mean = torch.as_tensor(mean, dtype=image.dtype,
                           device=image.device).reshape(-1, 1, 1)
    std = torch.as_tensor(std, dtype=image.dtype,
                          device=image.device).reshape(-1, 1, 1)
    return image * std + mean


def normalize_min_max(image: torch.Tensor, min_val: float = 0.0,
                      max_val: float = 1.0, eps: float = 1e-6
                      ) -> torch.Tensor:
    """Min-max rescale of each (batch, channel) plane to [min_val,
    max_val]."""
    image = as_float(image)
    B, C = image.shape[:2]
    flat = image.reshape(B, C, -1)
    mn = flat.amin(dim=-1).reshape(B, C, 1, 1)
    mx = flat.amax(dim=-1).reshape(B, C, 1, 1)
    return (max_val - min_val) * (image - mn) / (mx - mn + eps) + min_val


def histogram(x: torch.Tensor, bins: torch.Tensor, bandwidth: torch.Tensor,
              epsilon: float = 1e-10) -> torch.Tensor:
    """Differentiable soft histogram (Gaussian kernel density) of (B, N) →
    (B, bins)."""
    x = as_float(x)
    residuals = x[:, None, :] - bins.to(x.dtype)[None, :, None]
    pdf = torch.exp(-0.5 * (residuals / bandwidth) ** 2).mean(dim=-1)
    return pdf / (pdf.sum(dim=-1, keepdim=True) + epsilon)


@f32_matmul_precision
def histogram2d(x1: torch.Tensor, x2: torch.Tensor, bins: torch.Tensor,
                bandwidth: torch.Tensor,
                epsilon: float = 1e-10) -> torch.Tensor:
    """Joint soft histogram (B, bins, bins): a (bins, N) x (N, bins)
    product of the two kernel densities."""
    x1 = as_float(x1)
    x2 = as_float(x2)
    b = bins.to(x1.dtype)
    k1 = torch.exp(-0.5 * ((x1[:, None, :] - b[None, :, None])
                           / bandwidth) ** 2)
    k2 = torch.exp(-0.5 * ((x2[:, None, :] - b[None, :, None])
                           / bandwidth) ** 2)
    joint = torch.einsum("bin,bjn->bij", k1, k2) / x1.shape[-1]
    return joint / (joint.sum(dim=(-2, -1), keepdim=True) + epsilon)


def image_histogram2d(image: torch.Tensor, min_val: float = 0.0,
                      max_val: float = 255.0, n_bins: int = 256,
                      bandwidth: Optional[float] = None,
                      centers: Optional[torch.Tensor] = None,
                      return_pdf: bool = False):
    """(hist, pdf) over the last two dimensions: each value counted in the
    bins whose centre lies within one bandwidth; pdf zeros unless
    `return_pdf`."""
    image = as_float(image)
    if bandwidth is None:
        bandwidth = (max_val - min_val) / n_bins
    if centers is None:
        centers = min_val + bandwidth * (
            torch.arange(n_bins, dtype=image.dtype, device=image.device)
            + 0.5)
    mask = ((image[..., None] - centers).abs() / bandwidth <= 1.0).to(
        image.dtype)
    hist = mask.reshape(*image.shape[:-2], -1, n_bins).sum(dim=-2)
    pdf = hist / (hist.sum(dim=-1, keepdim=True) + 1e-10)
    return hist, (pdf if return_pdf else torch.zeros_like(pdf))


def integral_tensor(x: torch.Tensor) -> torch.Tensor:
    """Summed-area table over the last two dimensions."""
    return as_float(x).cumsum(dim=-1).cumsum(dim=-2)


def integral_image(image: torch.Tensor) -> torch.Tensor:
    return integral_tensor(image)


def _flatten_along(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x with `dim` moved first, the rest flattened: (N, D)."""
    x2 = x.movedim(dim, 0)
    return x2.reshape(x2.shape[0], -1)


@f32_matmul_precision
def zca_mean(x: torch.Tensor, dim: int = 0, unbiased: bool = True,
             eps: float = 1e-7, return_inverse: bool = False):
    """ZCA whitening of the samples along `dim`: (T, mean[, T⁻¹]) from the
    SVD of the covariance, eps added to the singular values only."""
    flat = _flatten_along(as_float(x), dim)
    N = flat.shape[0]
    mean = flat.mean(dim=0, keepdim=True)
    xc = flat - mean
    cov = xc.T @ xc / (N - 1 if unbiased else N)
    U, S, _ = torch.linalg.svd(cov)
    T = (U * (1.0 / torch.sqrt(S + eps))[None, :]) @ U.T
    if return_inverse:
        return T, mean, (U * torch.sqrt(S + eps)[None, :]) @ U.T
    return T, mean


@f32_matmul_precision
def zca_whiten(x: torch.Tensor, dim: int = 0, unbiased: bool = True,
               eps: float = 1e-7) -> torch.Tensor:
    x = as_float(x)
    T, mean = zca_mean(x, dim, unbiased, eps)
    x2 = x.movedim(dim, 0)
    out = (_flatten_along(x, dim) - mean) @ T
    return out.reshape(x2.shape).movedim(0, dim)


@f32_matmul_precision
def linear_transform(x: torch.Tensor, transform_matrix: torch.Tensor,
                     mean_vector: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Flatten along `dim`, subtract the mean, apply the matrix, shape
    back."""
    x = as_float(x)
    x2 = x.movedim(dim, 0)
    out = (_flatten_along(x, dim) - mean_vector.reshape(1, -1)) \
        @ transform_matrix
    return out.reshape(x2.shape).movedim(0, dim)


def shift_rgb(image: torch.Tensor, r_shift, g_shift,
              b_shift) -> torch.Tensor:
    image = as_float(image)
    shifts = torch.stack([torch.as_tensor(s, dtype=image.dtype,
                                          device=image.device)
                          for s in (r_shift, g_shift, b_shift)], dim=-1)
    return (image + shifts.reshape(-1, 3, 1, 1)).clamp(0.0, 1.0)


def threshold_binary(image: torch.Tensor, threshold,
                     max_val: float = 1.0) -> torch.Tensor:
    image = as_float(image)
    return torch.where(image > _bcast_factor(threshold, image), max_val, 0.0)


def otsu_threshold(image: torch.Tensor, nbins: int = 256,
                   return_mask: bool = False):
    """Otsu's threshold of each image, (B, 1), over `nbins` bins between
    its minimum and maximum; with `return_mask` also the mask of values
    above it."""
    image = as_float(image)
    B = image.shape[0]
    flat = image.reshape(B, -1)
    mn = flat.amin(dim=-1, keepdim=True)
    mx = flat.amax(dim=-1, keepdim=True)
    span = (mx - mn).clamp_min(1e-8)
    q = ((flat - mn) / span * (nbins - 1)).to(torch.int64).clamp(0, nbins - 1)
    hist = _plane_histograms(q, nbins).to(torch.float32)
    p = hist / hist.sum(dim=-1, keepdim=True)
    omega = p.cumsum(dim=-1)
    centers = torch.arange(nbins, dtype=torch.float32, device=image.device)
    mu = (p * centers[None]).cumsum(dim=-1)
    mu_t = mu[:, -1:]
    sigma_b = (mu_t * omega - mu) ** 2 / (omega * (1.0 - omega) + 1e-10)
    idx = sigma_b.argmax(dim=-1)
    th = (mn[:, 0] + true_div(idx, nbins - 1) * span[:, 0])[:, None]
    if return_mask:
        return th, (flat > th).reshape(image.shape)
    return th


class ThresholdType(enum.IntEnum):
    """OpenCV's fixed threshold types."""

    THRESH_BINARY = 0
    THRESH_BINARY_INV = 1
    THRESH_TRUNC = 2
    THRESH_TOZERO = 3
    THRESH_TOZERO_INV = 4
    THRESH_OTSU = 8


def threshold(image: torch.Tensor, thresh, maxval=255.0,
              type=ThresholdType.THRESH_BINARY) -> torch.Tensor:
    """OpenCV's fixed-level thresholding (Otsu: ``otsu_threshold``)."""
    image = as_float(image)
    t = int(type)
    check(not (t & int(ThresholdType.THRESH_OTSU)),
          "THRESH_OTSU is not supported here; use otsu_threshold instead")
    check(t in (0, 1, 2, 3, 4), f"unsupported threshold type {type}")
    thresh = torch.as_tensor(thresh, dtype=image.dtype, device=image.device)
    maxval = torch.as_tensor(maxval, dtype=image.dtype, device=image.device)
    mask = image > thresh
    zeros = torch.zeros_like(image)
    if t == ThresholdType.THRESH_BINARY:
        return torch.where(mask, maxval, zeros)
    if t == ThresholdType.THRESH_BINARY_INV:
        return torch.where(mask, zeros, maxval)
    if t == ThresholdType.THRESH_TRUNC:
        return torch.minimum(image, thresh)
    if t == ThresholdType.THRESH_TOZERO:
        return torch.where(mask, image, zeros)
    return torch.where(mask, zeros, image)


def rescale_intensity(x: torch.Tensor, factor) -> torch.Tensor:
    x = as_float(x)
    return x * torch.as_tensor(factor, dtype=x.dtype, device=x.device)
