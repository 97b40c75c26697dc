"""2-D and 3-D filtering (counterpart of ``kornia_tpu/ops/filters.py``).

Images are (B, C, H, W) float tensors, volumes (B, C, D, H, W). Every
separable blur with 1-D kernels and one of the four border rules goes
through the banded blur kernel (``ops/kernels.py::fused_separable_blur2d``)
on the card and through its plain version on the CPU: the Gaussian and box
blurs and what is built on them (``unsharp_mask``, ``guided_blur``,
``canny``'s smoothing). Other filters are grouped convolutions, shifted
slices or, for ``fft_conv``, ``torch.fft``.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..core.check import check, check_shape
from ..core.dtype import as_float
from . import kernels

__all__ = [
    "normalize_kernel2d",
    "get_box_kernel1d",
    "get_box_kernel2d",
    "get_gaussian_kernel1d",
    "get_gaussian_discrete_kernel1d",
    "get_gaussian_kernel2d",
    "get_sobel_kernel2d",
    "get_diff_kernel2d",
    "filter2d",
    "filter2d_separable",
    "box_blur",
    "gaussian_blur2d",
    "spatial_gradient",
    "get_motion_kernel2d",
    "motion_blur",
    "get_gaussian_erf_kernel1d",
    "get_laplacian_kernel1d",
    "get_laplacian_kernel2d",
    "get_gaussian_kernel3d",
    "get_hanning_kernel1d",
    "get_hanning_kernel2d",
    "get_pascal_kernel_1d",
    "get_pascal_kernel_2d",
    "filter3d",
    "fft_conv2d",
    "correlate2d",
    "convolve2d",
    "median_blur",
    "unsharp_mask",
    "bilateral_blur",
    "joint_bilateral_blur",
    "guided_blur",
    "max_blur_pool2d",
    "blur_pool2d",
    "edge_aware_blur_pool2d",
    "in_range",
    "spatial_gradient3d",
    "sobel",
    "laplacian",
    "canny",
    "gaussian", "laplacian_1d", "get_binary_kernel2d",
    "get_spatial_gradient_kernel2d", "get_spatial_gradient_kernel3d",
    "get_diff_kernel3d", "get_diff_kernel3d_2nd_order",
    "get_motion_kernel3d", "motion_blur3d", "correlate3d", "convolve3d",
    "fft_conv", "get_gaussian_kernel1d_t", "get_gaussian_kernel2d_t",
    "get_gaussian_kernel3d_t", "gaussian_blur2d_t",
]

_PAD_MODES = {"reflect": "reflect", "replicate": "replicate",
              "circular": "circular", "constant": "constant"}
_BANDED_BORDERS = ("reflect", "replicate", "circular", "constant")

Device = Optional[Union[str, torch.device]]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _pad2d(x: torch.Tensor, pad: Tuple[int, int, int, int],
           border_type: str) -> torch.Tensor:
    """pad = (top, bottom, left, right)."""
    t, b, l, r = pad
    return F.pad(x, (l, r, t, b), mode=_PAD_MODES[border_type])


# -----------------------------------------------------------------------------
# Kernel factories
# -----------------------------------------------------------------------------

def normalize_kernel2d(kernel: torch.Tensor) -> torch.Tensor:
    return kernel / kernel.abs().sum(dim=(-2, -1), keepdim=True)


def get_box_kernel1d(kernel_size: int, dtype: torch.dtype = torch.float32,
                     device: Device = None) -> torch.Tensor:
    """(1, K) box kernel, every tap 1/K."""
    return torch.full((1, kernel_size), 1.0 / kernel_size, dtype=dtype,
                      device=device)


def get_box_kernel2d(kernel_size, dtype: torch.dtype = torch.float32,
                     device: Device = None) -> torch.Tensor:
    """(1, Ky, Kx) box kernel, every tap 1/(Ky·Kx)."""
    ky, kx = _pair(kernel_size)
    return torch.full((1, ky, kx), 1.0 / (ky * kx), dtype=dtype,
                      device=device)


def get_gaussian_kernel1d(kernel_size: int, sigma, force_even: bool = False,
                          dtype: torch.dtype = torch.float32,
                          device: Device = None) -> torch.Tensor:
    """(1, K) normalized Gaussian (one row per sigma). `force_even` is
    accepted and, as in the reference, changes nothing: K is used as
    given."""
    if isinstance(sigma, (int, float)):  # a fill, not a host copy
        sigma = torch.full((1, 1), float(sigma), dtype=dtype, device=device)
    sigma = torch.as_tensor(sigma, dtype=dtype, device=device).reshape(-1, 1)
    x = torch.arange(kernel_size, dtype=dtype, device=sigma.device) \
        - (kernel_size - 1) / 2
    g = torch.exp(-(x[None, :] ** 2) / (2.0 * sigma ** 2))
    return g / g.sum(dim=-1, keepdim=True)


def get_gaussian_discrete_kernel1d(kernel_size: int, sigma,
                                   dtype: torch.dtype = torch.float32,
                                   device: Device = None) -> torch.Tensor:
    """Discrete Gaussian from modified Bessel functions, by the scaled
    recurrence on i0e/i1e: (num_sigmas, K)."""
    sigma = torch.as_tensor(sigma, dtype=dtype, device=device).reshape(-1)
    t = sigma ** 2
    tail = (kernel_size - 1) // 2
    out = [torch.special.i0e(t), torch.special.i1e(t)]
    for k in range(2, tail + 1):
        out.append(torch.clamp_min(out[k - 2] - 2 * (k - 1) / t * out[k - 1],
                                   0.0))
    full = torch.stack(out[tail:0:-1] + out[: tail + 1], dim=-1)
    return full / full.sum(dim=-1, keepdim=True)


def get_gaussian_kernel2d(kernel_size, sigma,
                          dtype: torch.dtype = torch.float32,
                          device: Device = None) -> torch.Tensor:
    """(1, Ky, Kx) separable outer-product Gaussian."""
    ky, kx = _pair(kernel_size)
    if isinstance(sigma, (int, float)):
        sy = sx = sigma
    else:
        sy, sx = sigma[0], sigma[1]
    gy = get_gaussian_kernel1d(ky, sy, dtype=dtype, device=device)
    gx = get_gaussian_kernel1d(kx, sx, dtype=dtype, device=device)
    return gy[..., :, None] * gx[..., None, :]


_SOBEL_X = [[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]]
_DIFF_X = [[0.0, 0.0, 0.0], [-0.5, 0.0, 0.5], [0.0, 0.0, 0.0]]
_DIFF_XX = [[0.0, 0.0, 0.0], [1.0, -2.0, 1.0], [0.0, 0.0, 0.0]]
_DIFF_XY = [[-0.25, 0.0, 0.25], [0.0, 0.0, 0.0], [0.25, 0.0, -0.25]]


def get_sobel_kernel2d(dtype: torch.dtype = torch.float32,
                       device: Device = None) -> torch.Tensor:
    """(2, 3, 3): stacked [gx, gy] sobel kernels."""
    gx = torch.tensor(_SOBEL_X, dtype=dtype, device=device)
    return torch.stack([gx, gx.T])


def get_diff_kernel2d(dtype: torch.dtype = torch.float32,
                      device: Device = None) -> torch.Tensor:
    gx = torch.tensor(_DIFF_X, dtype=dtype, device=device)
    return torch.stack([gx, gx.T])


def _sobel_kernel2d_2nd(dtype: torch.dtype = torch.float32,
                        device: Device = None) -> torch.Tensor:
    """(3, 5, 5): the sobel-of-sobel second-order kernels [gxx, gxy, gyy]."""
    smooth = torch.tensor([1.0, 4.0, 6.0, 4.0, 1.0], dtype=dtype,
                          device=device)
    d2 = torch.tensor([-1.0, 0.0, 2.0, 0.0, -1.0], dtype=dtype, device=device)
    d1a = torch.tensor([-1.0, -2.0, 0.0, 2.0, 1.0], dtype=dtype,
                       device=device)
    gxx = torch.outer(smooth, d2)
    gxy = torch.outer(d1a, -d1a)
    return torch.stack([gxx, gxy, gxx.T])


def _diff_kernel2d_2nd(dtype: torch.dtype = torch.float32,
                       device: Device = None) -> torch.Tensor:
    """(3, 3, 3): central second differences [gxx, gxy, gyy]."""
    gxx = torch.tensor(_DIFF_XX, dtype=dtype, device=device)
    gxy = torch.tensor(_DIFF_XY, dtype=dtype, device=device)
    return torch.stack([gxx, gxy, gxx.T])


# -----------------------------------------------------------------------------
# Filtering
# -----------------------------------------------------------------------------

def filter2d(x: torch.Tensor, kernel: torch.Tensor,
             border_type: str = "reflect", normalized: bool = False,
             padding: str = "same") -> torch.Tensor:
    """Correlate (B, C, H, W) with a (1|B, kH, kW) kernel per channel (no
    kernel flip, like the reference): 'same' size, the border padded by
    `border_type`, or with `padding` 'valid' only where the kernel fits."""
    x = as_float(x)
    check(x.ndim == 4, f"filter2d expects (B,C,H,W), got {tuple(x.shape)}")
    check(kernel.ndim == 3,
          f"kernel must be (B,kH,kW), got {tuple(kernel.shape)}")
    B, C, H, W = x.shape
    kernel = kernel.to(x.dtype)
    if normalized:
        kernel = normalize_kernel2d(kernel)
    kh, kw = kernel.shape[-2:]
    if padding == "same":
        x = _pad2d(x, (kh // 2, (kh - 1) // 2, kw // 2, (kw - 1) // 2),
                   border_type)
    if kernel.shape[0] == 1:
        return F.conv2d(x, kernel.expand(C, kh, kw)[:, None], groups=C)
    # per-sample kernels: one grouped convolution over (B·C) channels
    Hp, Wp = x.shape[-2:]
    w = kernel[:, None].expand(B, C, kh, kw).reshape(B * C, 1, kh, kw)
    out = F.conv2d(x.reshape(1, B * C, Hp, Wp), w, groups=B * C)
    return out.reshape(B, C, out.shape[-2], out.shape[-1])


def _as_1d(k: torch.Tensor) -> Optional[torch.Tensor]:
    """The kernel as a flat 1-D tensor when it is one ((K,) or (1, K))."""
    if k.ndim <= 1 or (k.ndim == 2 and k.shape[0] == 1):
        return k.reshape(-1)
    return None


def filter2d_separable(x: torch.Tensor, kernel_x: torch.Tensor,
                       kernel_y: torch.Tensor, border_type: str = "reflect",
                       normalized: bool = False) -> torch.Tensor:
    """Two 1-D passes. Shared 1-D kernels with one of the four border rules
    on f32 (B, C, H, W) images go through the banded blur kernel (on the
    CPU, its plain version); everything else (per-image kernels) through
    two grouped convolutions."""
    kxf = _as_1d(kernel_x)
    kyf = _as_1d(kernel_y)
    if (kxf is not None and kyf is not None and x.ndim == 4
            and border_type in _BANDED_BORDERS
            and x.dtype == torch.float32):
        if normalized:
            kxf = kxf / kxf.abs().sum()
            kyf = kyf / kyf.abs().sum()
        return kernels.fused_separable_blur2d(x, kyf, kxf, border_type)
    out = filter2d(x, kernel_y[..., :, None], border_type, normalized)
    return filter2d(out, kernel_x[..., None, :], border_type, normalized)


def box_blur(x: torch.Tensor, kernel_size, border_type: str = "reflect",
             separable: bool = True) -> torch.Tensor:
    """Mean over a (Ky, Kx) window. Separable: one banded blur launch on
    the card for every image and channel of (B, C, H, W)."""
    ky, kx = _pair(kernel_size)
    if separable:
        return filter2d_separable(x, get_box_kernel1d(kx, device=x.device),
                                  get_box_kernel1d(ky, device=x.device),
                                  border_type)
    return filter2d(x, get_box_kernel2d((ky, kx), device=x.device),
                    border_type)


def gaussian_blur2d(x: torch.Tensor, kernel_size, sigma,
                    border_type: str = "reflect",
                    separable: bool = True) -> torch.Tensor:
    ky, kx = _pair(kernel_size)
    if ky % 2 == 0 or kx % 2 == 0:
        raise ValueError(
            f"gaussian_blur2d kernel_size must be odd, got {(ky, kx)}")
    if isinstance(sigma, (int, float)):
        sy = sx = float(sigma)
    else:
        sy, sx = sigma
    dev = x.device
    if separable:
        return filter2d_separable(
            x, get_gaussian_kernel1d(kx, sx, device=dev),
            get_gaussian_kernel1d(ky, sy, device=dev), border_type)
    return filter2d(x, get_gaussian_kernel2d((ky, kx), (sy, sx), device=dev),
                    border_type)


def spatial_gradient(x: torch.Tensor, mode: str = "sobel", order: int = 1,
                     normalized: bool = True) -> torch.Tensor:
    """(B, C, H, W) → (B, C, 2, H, W) first derivatives [d/dx, d/dy]
    (order 1) or (B, C, 3, H, W) second ones [d²/dx², d²/dxdy, d²/dy²]
    (order 2), replicate border; `normalized` divides each kernel by the
    sum of its absolute taps."""
    x = as_float(x)
    if order == 1:
        kern = (get_sobel_kernel2d(x.dtype, x.device) if mode == "sobel"
                else get_diff_kernel2d(x.dtype, x.device))
    else:
        kern = (_sobel_kernel2d_2nd(x.dtype, x.device) if mode == "sobel"
                else _diff_kernel2d_2nd(x.dtype, x.device))
    if normalized:
        kern = normalize_kernel2d(kern)
    B, C, H, W = x.shape
    nk, kh, kw = kern.shape
    xp = _pad2d(x.reshape(B * C, 1, H, W),
                (kh // 2, kh // 2, kw // 2, kw // 2), "replicate")
    out = F.conv2d(xp, kern[:, None])
    return out.reshape(B, C, nk, H, W)


def get_motion_kernel2d(kernel_size: int, angle, direction=0.0,
                        dtype: torch.dtype = torch.float32,
                        mode: str = "nearest",
                        device: Device = None) -> torch.Tensor:
    """(B, K, K) motion-blur kernel: a horizontal line with an intensity
    ramp set by `direction`, rotated by `angle` degrees about the kernel
    centre (counter-clockwise in image coordinates, y down) by resampling,
    `mode` "nearest" (the reference's default) or "bilinear"; each kernel
    sums to one."""
    angle = torch.atleast_1d(torch.as_tensor(angle, dtype=dtype,
                                             device=device))
    dev = angle.device
    direction = torch.as_tensor(direction, dtype=dtype,
                                device=dev).expand(angle.shape)
    k = kernel_size
    direction = (direction.clamp(-1.0, 1.0) + 1.0) / 2.0
    ramp = direction[:, None] + (1.0 - 2.0 * direction[:, None]) * \
        torch.arange(k, dtype=dtype, device=dev) / (k - 1)
    kern = torch.zeros((angle.shape[0], k, k), dtype=dtype, device=dev)
    kern[:, k // 2, :] = ramp
    # inverse-mapped sampling of the line kernel about the centre
    theta = -torch.deg2rad(angle)
    cos, sin = torch.cos(theta), torch.sin(theta)
    ys, xs = torch.meshgrid(torch.arange(k, dtype=dtype, device=dev),
                            torch.arange(k, dtype=dtype, device=dev),
                            indexing="ij")
    c = (k - 1) / 2.0
    xs0, ys0 = xs - c, ys - c
    xr = cos[:, None, None] * xs0 + sin[:, None, None] * ys0 + c
    yr = -sin[:, None, None] * xs0 + cos[:, None, None] * ys0 + c
    x0 = torch.floor(xr).to(torch.int64)
    y0 = torch.floor(yr).to(torch.int64)
    wx = xr - x0
    wy = yr - y0
    batch = torch.arange(angle.shape[0], device=dev)[:, None, None]

    def tap(yy, xx):
        valid = (yy >= 0) & (yy < k) & (xx >= 0) & (xx < k)
        vals = kern[batch, yy.clamp(0, k - 1), xx.clamp(0, k - 1)]
        return torch.where(valid, vals, 0.0)

    if mode == "nearest":
        out = tap(torch.round(yr).to(torch.int64),
                  torch.round(xr).to(torch.int64))
    else:
        out = (tap(y0, x0) * (1 - wx) * (1 - wy)
               + tap(y0, x0 + 1) * wx * (1 - wy)
               + tap(y0 + 1, x0) * (1 - wx) * wy
               + tap(y0 + 1, x0 + 1) * wx * wy)
    return out / out.sum(dim=(-2, -1), keepdim=True)


def motion_blur(x: torch.Tensor, kernel_size: int, angle, direction=0.0,
                border_type: str = "constant",
                mode: str = "nearest") -> torch.Tensor:
    """Blur (B, C, H, W) along a line of `kernel_size` pixels at `angle`
    degrees (one angle, or one per sample)."""
    x = as_float(x)
    kernel = get_motion_kernel2d(kernel_size, angle, direction,
                                 dtype=x.dtype, mode=mode, device=x.device)
    return filter2d(x, kernel, border_type)



# -----------------------------------------------------------------------------
# Further kernel factories
# -----------------------------------------------------------------------------

def get_gaussian_erf_kernel1d(kernel_size: int, sigma,
                              dtype: torch.dtype = torch.float32,
                              device: Device = "cuda") -> torch.Tensor:
    """(num_sigmas, K) Gaussian integrated over each pixel's bin (erf)."""
    if isinstance(sigma, (int, float)):  # a fill, not a host copy
        sigma = torch.full((1, 1), float(sigma), dtype=dtype, device=device)
    sigma = torch.as_tensor(sigma, dtype=dtype, device=device).reshape(-1, 1)
    x = torch.arange(kernel_size, dtype=dtype, device=sigma.device) \
        - (kernel_size - 1) / 2
    s2 = sigma * math.sqrt(2.0)

    def cdf(t):
        return 0.5 * (1 + torch.special.erf(t / s2))

    g = cdf(x[None, :] + 0.5) - cdf(x[None, :] - 0.5)
    return g / g.sum(dim=-1, keepdim=True)


def get_gaussian_kernel3d(kernel_size, sigma,
                          dtype: torch.dtype = torch.float32,
                          device: Device = "cuda") -> torch.Tensor:
    """(1, Kz, Ky, Kx) separable Gaussian."""
    kz, ky, kx = ((kernel_size,) * 3 if isinstance(kernel_size, int)
                  else kernel_size)
    sz, sy, sx = ((sigma,) * 3 if isinstance(sigma, (int, float))
                  else sigma)
    gz, gy, gx = (get_gaussian_kernel1d(k, s, dtype=dtype, device=device)[0]
                  for k, s in ((kz, sz), (ky, sy), (kx, sx)))
    return (gz[:, None, None] * gy[None, :, None] * gx[None, None, :])[None]


def get_laplacian_kernel1d(kernel_size: int,
                           dtype: torch.dtype = torch.float32,
                           device: Device = "cuda") -> torch.Tensor:
    """(K,) ones with 1 - K at the centre."""
    k = torch.ones(kernel_size, dtype=dtype, device=device)
    k[kernel_size // 2] = 1.0 - kernel_size
    return k


def get_laplacian_kernel2d(kernel_size, dtype: torch.dtype = torch.float32,
                           device: Device = "cuda") -> torch.Tensor:
    """(1, Ky, Kx) ones with 1 - Ky·Kx at the centre."""
    ky, kx = _pair(kernel_size)
    k = torch.ones((ky, kx), dtype=dtype, device=device)
    k[ky // 2, kx // 2] = 1.0 - ky * kx
    return k[None]


def get_hanning_kernel1d(kernel_size: int,
                         dtype: torch.dtype = torch.float32,
                         device: Device = "cuda") -> torch.Tensor:
    x = torch.arange(kernel_size, dtype=dtype, device=device)
    return 0.5 - 0.5 * torch.cos(2.0 * math.pi * x / (kernel_size - 1))


def get_hanning_kernel2d(kernel_size, dtype: torch.dtype = torch.float32,
                         device: Device = "cuda") -> torch.Tensor:
    ky, kx = _pair(kernel_size)
    return get_hanning_kernel1d(ky, dtype, device)[:, None] * \
        get_hanning_kernel1d(kx, dtype, device)[None, :]


def get_pascal_kernel_1d(kernel_size: int, norm: bool = False,
                         dtype: torch.dtype = torch.float32,
                         device: Device = "cuda") -> torch.Tensor:
    """(K,) the binomial coefficients of row K - 1 of Pascal's triangle."""
    row = [1.0]
    for _ in range(kernel_size - 1):
        row = [1.0] + [row[i] + row[i + 1] for i in range(len(row) - 1)] \
            + [1.0]
    out = torch.tensor(row, dtype=dtype, device=device)
    return out / out.sum() if norm else out


def get_pascal_kernel_2d(kernel_size, norm: bool = True,
                         dtype: torch.dtype = torch.float32,
                         device: Device = "cuda") -> torch.Tensor:
    ky, kx = _pair(kernel_size)
    k = get_pascal_kernel_1d(ky, dtype=dtype, device=device)[:, None] * \
        get_pascal_kernel_1d(kx, dtype=dtype, device=device)[None, :]
    return k / k.sum() if norm else k


def gaussian(window_size: int, sigma, mean=None,
             dtype: torch.dtype = torch.float32,
             device: Device = "cuda") -> torch.Tensor:
    """Normalized Gaussian profile (B, window_size), one row per sigma;
    centred on `mean` (window_size // 2 by default), shifted by half a
    pixel for even windows."""
    sigma = torch.atleast_2d(torch.as_tensor(sigma, dtype=dtype,
                                             device=device))
    if mean is None:
        mean = float(window_size // 2)
    mean = torch.atleast_2d(torch.as_tensor(mean, dtype=sigma.dtype,
                                            device=sigma.device))
    x = torch.arange(window_size, dtype=sigma.dtype,
                     device=sigma.device) - mean
    if window_size % 2 == 0:
        x = x + 0.5
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum(dim=-1, keepdim=True)


def laplacian_1d(window_size: int, dtype: torch.dtype = torch.float32,
                 device: Device = "cuda") -> torch.Tensor:
    """[1, ..., 1 - window_size, ..., 1]."""
    return get_laplacian_kernel1d(window_size, dtype, device)


def get_binary_kernel2d(window_size, dtype: torch.dtype = torch.float32,
                        device: Device = "cuda") -> torch.Tensor:
    """(Ky·Kx, 1, Ky, Kx) one-hot patch-extraction kernels."""
    ky, kx = _pair(window_size)
    n = ky * kx
    return torch.eye(n, dtype=dtype, device=device).reshape(n, 1, ky, kx)


def get_spatial_gradient_kernel2d(mode: str, order: int,
                                  dtype: torch.dtype = torch.float32,
                                  device: Device = "cuda") -> torch.Tensor:
    """The first- or second-order sobel or diff kernel stack."""
    check(mode.lower() in ("sobel", "diff"),
          f"mode must be sobel|diff, got {mode}")
    check(order in (1, 2), f"order must be 1|2, got {order}")
    if mode == "sobel":
        return (get_sobel_kernel2d(dtype, device) if order == 1
                else _sobel_kernel2d_2nd(dtype, device))
    return (get_diff_kernel2d(dtype, device) if order == 1
            else _diff_kernel2d_2nd(dtype, device))


def _set_taps(n: int, taps, dtype, device) -> torch.Tensor:
    """(n, 1, 3, 3, 3) kernels with the listed (kernel, z, y, x, value)."""
    k = torch.zeros((n, 3, 3, 3), dtype=dtype, device=device)
    for i, z, y, x, v in taps:
        k[i, z, y, x] = v
    return k[:, None]


def get_diff_kernel3d(dtype: torch.dtype = torch.float32,
                      device: Device = "cuda") -> torch.Tensor:
    """(3, 1, 3, 3, 3) central differences [gx, gy, gz]."""
    return _set_taps(3, [(0, 1, 1, 0, -0.5), (0, 1, 1, 2, 0.5),
                         (1, 1, 0, 1, -0.5), (1, 1, 2, 1, 0.5),
                         (2, 0, 1, 1, -0.5), (2, 2, 1, 1, 0.5)],
                     dtype, device)


def get_diff_kernel3d_2nd_order(dtype: torch.dtype = torch.float32,
                                device: Device = "cuda") -> torch.Tensor:
    """(6, 1, 3, 3, 3) second differences [xx, yy, zz, xy, yz, xz]."""
    return _set_taps(6, [
        (0, 1, 1, 0, 1.0), (0, 1, 1, 1, -2.0), (0, 1, 1, 2, 1.0),
        (1, 1, 0, 1, 1.0), (1, 1, 1, 1, -2.0), (1, 1, 2, 1, 1.0),
        (2, 0, 1, 1, 1.0), (2, 1, 1, 1, -2.0), (2, 2, 1, 1, 1.0),
        (3, 1, 0, 0, 1.0), (3, 1, 0, 2, -1.0), (3, 1, 2, 0, -1.0),
        (3, 1, 2, 2, 1.0),
        (4, 0, 0, 1, 1.0), (4, 0, 2, 1, -1.0), (4, 2, 0, 1, -1.0),
        (4, 2, 2, 1, 1.0),
        (5, 0, 1, 0, 1.0), (5, 0, 1, 2, -1.0), (5, 2, 1, 0, -1.0),
        (5, 2, 1, 2, 1.0)], dtype, device)


def get_spatial_gradient_kernel3d(mode: str, order: int,
                                  dtype: torch.dtype = torch.float32,
                                  device: Device = "cuda") -> torch.Tensor:
    """The diff kernels of order 1 or 2 (the only mode, as in the
    reference)."""
    check(mode.lower() == "diff" and order in (1, 2),
          f"3d gradient kernels: mode=diff, order in (1, 2); got "
          f"{mode}/{order}")
    return (get_diff_kernel3d(dtype, device) if order == 1
            else get_diff_kernel3d_2nd_order(dtype, device))


def get_motion_kernel3d(kernel_size: int, angle, direction=0.0,
                        mode: str = "nearest",
                        dtype: torch.dtype = torch.float32,
                        device: Device = "cuda") -> torch.Tensor:
    """(B, k, k, k) motion kernel: an intensity-ramped line along x through
    the centre, rotated by the (yaw, pitch, roll) axis-angle in degrees
    (``rotate3d``, corner-aligned), each kernel summing to one."""
    from .warp3d import rotate3d
    check(kernel_size % 2 == 1 and kernel_size > 2,
          f"kernel_size must be odd and >2, got {kernel_size}")
    angle = torch.as_tensor(angle, dtype=dtype, device=device)
    if angle.ndim == 1:
        angle = angle[None]
    check_shape(angle, ["B", "3"], "angle")
    B = angle.shape[0]
    direction = torch.as_tensor(direction, dtype=dtype,
                                device=angle.device).expand(B)
    direction = (direction.clamp(-1.0, 1.0) + 1.0) / 2.0
    k = kernel_size
    ramp = direction[:, None] + (1.0 - 2.0 * direction[:, None]) * \
        torch.arange(k, dtype=dtype, device=angle.device) / (k - 1)
    kern = torch.zeros((B, k, k, k), dtype=dtype, device=angle.device)
    kern[:, k // 2, k // 2, :] = ramp
    kern = rotate3d(kern[:, None], angle[:, 0], angle[:, 1], angle[:, 2],
                    mode=mode, align_corners=True)[:, 0]
    return kern / kern.sum(dim=(1, 2, 3), keepdim=True)


get_gaussian_kernel1d_t = get_gaussian_kernel1d
get_gaussian_kernel2d_t = get_gaussian_kernel2d
get_gaussian_kernel3d_t = get_gaussian_kernel3d


# -----------------------------------------------------------------------------
# 3-D and FFT filtering
# -----------------------------------------------------------------------------

def filter3d(x: torch.Tensor, kernel: torch.Tensor,
             border_type: str = "replicate",
             normalized: bool = False) -> torch.Tensor:
    """Correlate (B, C, D, H, W) with the first (kD, kH, kW) kernel of
    `kernel`, per channel, 'same' size under `border_type`."""
    x = as_float(x)
    check(x.ndim == 5, f"filter3d expects (B,C,D,H,W), got {tuple(x.shape)}")
    C = x.shape[1]
    kernel = kernel.to(x.dtype)
    if normalized:
        kernel = kernel / kernel.abs().sum(dim=(-3, -2, -1), keepdim=True)
    kd, kh, kw = kernel.shape[-3:]
    x = F.pad(x, (kw // 2, (kw - 1) // 2, kh // 2, (kh - 1) // 2,
                  kd // 2, (kd - 1) // 2), mode=_PAD_MODES[border_type])
    w = kernel.reshape(-1, kd, kh, kw)[:1].expand(C, kd, kh, kw)[:, None]
    return F.conv3d(x, w, groups=C)


def fft_conv2d(x: torch.Tensor, kernel: torch.Tensor,
               border_type: str = "constant") -> torch.Tensor:
    """'same'-size correlation with a (1|B, kH, kW) kernel through
    ``torch.fft.rfft2`` / ``irfft2``: the padded image times the flipped,
    zero-padded kernel in the frequency domain."""
    x = as_float(x)
    B, C, H, W = x.shape
    kernel = kernel.to(x.dtype)
    kh, kw = kernel.shape[-2:]
    xp = _pad2d(x, (kh // 2, (kh - 1) // 2, kw // 2, (kw - 1) // 2),
                border_type)
    Hp, Wp = xp.shape[-2:]
    k = torch.flip(kernel, dims=(-2, -1))
    kpad = F.pad(k, (0, Wp - kw, 0, Hp - kh))
    Xf = torch.fft.rfft2(xp)
    Kf = torch.fft.rfft2(kpad)
    Kf = Kf[None] if k.shape[0] == 1 else Kf[:, None]
    out = torch.fft.irfft2(Xf * Kf, s=(Hp, Wp))
    return out[..., kh - 1:kh - 1 + H, kw - 1:kw - 1 + W]


def fft_conv(x: torch.Tensor, kernel: torch.Tensor,
             border_type: str = "reflect", normalized: bool = False,
             padding: str = "same", behaviour: str = "corr") -> torch.Tensor:
    """``fft_conv2d`` with the reference's options: `behaviour` 'conv'
    flips the kernel, `padding` 'valid' crops the same-size result."""
    kernel = kernel.to(as_float(x).dtype)
    if normalized:
        kernel = kernel / kernel.abs().sum(dim=(-2, -1), keepdim=True)
    if behaviour == "conv":
        kernel = torch.flip(kernel, dims=(-2, -1))
    out = fft_conv2d(x, kernel, border_type)
    if padding == "valid":
        kh, kw = kernel.shape[-2:]
        out = out[..., kh // 2:out.shape[-2] - (kh - 1) // 2,
                  kw // 2:out.shape[-1] - (kw - 1) // 2]
    return out


def correlate2d(x: torch.Tensor, kernel: torch.Tensor,
                border_type: str = "reflect") -> torch.Tensor:
    return filter2d(x, kernel, border_type)


def convolve2d(x: torch.Tensor, kernel: torch.Tensor,
               border_type: str = "reflect") -> torch.Tensor:
    """True convolution: the kernel flipped."""
    return filter2d(x, torch.flip(kernel, dims=(-2, -1)), border_type)


def correlate3d(x: torch.Tensor, kernel: torch.Tensor,
                border_type: str = "replicate",
                normalized: bool = False) -> torch.Tensor:
    return filter3d(x, kernel, border_type, normalized)


def convolve3d(x: torch.Tensor, kernel: torch.Tensor,
               border_type: str = "replicate",
               normalized: bool = False) -> torch.Tensor:
    return filter3d(x, torch.flip(kernel, dims=(-3, -2, -1)), border_type,
                    normalized)


def motion_blur3d(x: torch.Tensor, kernel_size: int, angle, direction=0.0,
                  border_type: str = "constant",
                  mode: str = "nearest") -> torch.Tensor:
    """Blur (B, C, D, H, W) along a rotated line (``get_motion_kernel3d``)."""
    x = as_float(x)
    kern = get_motion_kernel3d(kernel_size, angle, direction, mode,
                               dtype=x.dtype, device=x.device)
    return filter3d(x, kern, border_type)


# -----------------------------------------------------------------------------
# Further blurs
# -----------------------------------------------------------------------------

gaussian_blur2d_t = gaussian_blur2d


def _window_taps(xp: torch.Tensor, ky: int, kx: int, H: int, W: int):
    """The ky·kx shifted (…, H, W) views of a padded image, row-major."""
    return [xp[..., dy:dy + H, dx:dx + W]
            for dy in range(ky) for dx in range(kx)]


def median_blur(x: torch.Tensor, kernel_size,
                border_type: str = "constant") -> torch.Tensor:
    """Median over each (ky, kx) window, zero border by default; for an
    even window the lower of the two middles. The window's taps are
    stacked, (ky·kx, B, C, H, W), so memory grows with the window."""
    x = as_float(x)
    ky, kx = _pair(kernel_size)
    xp = _pad2d(x, (ky // 2, (ky - 1) // 2, kx // 2, (kx - 1) // 2),
                border_type)
    v = torch.stack(_window_taps(xp, ky, kx, *x.shape[-2:]), dim=0)
    return torch.median(v, dim=0).values


def unsharp_mask(x: torch.Tensor, kernel_size, sigma,
                 border_type: str = "reflect") -> torch.Tensor:
    blurred = gaussian_blur2d(x, kernel_size, sigma, border_type)
    return x + (x - blurred)


def bilateral_blur(x: torch.Tensor, kernel_size, sigma_color: float,
                   sigma_space, border_type: str = "reflect",
                   color_distance_type: str = "l1") -> torch.Tensor:
    return joint_bilateral_blur(x, x, kernel_size, sigma_color, sigma_space,
                                border_type, color_distance_type)


def joint_bilateral_blur(x: torch.Tensor, guidance: torch.Tensor,
                         kernel_size, sigma_color: float, sigma_space,
                         border_type: str = "reflect",
                         color_distance_type: str = "l1") -> torch.Tensor:
    """Edge-preserving blur: each window tap weighted by its spatial
    Gaussian times a Gaussian of the guidance's colour distance (l1 summed
    over channels, squared; or l2), accumulated tap by tap."""
    x = as_float(x)
    g = as_float(guidance)
    ky, kx = _pair(kernel_size)
    if isinstance(sigma_space, (int, float)):
        ss_y = ss_x = float(sigma_space)
    else:
        ss_y, ss_x = sigma_space
    H, W = x.shape[-2:]
    pad = (ky // 2, (ky - 1) // 2, kx // 2, (kx - 1) // 2)
    xs = _window_taps(_pad2d(x, pad, border_type), ky, kx, H, W)
    gs = _window_taps(_pad2d(g, pad, border_type), ky, kx, H, W)
    num = torch.zeros_like(x)
    den = torch.zeros_like(x[:, :1])
    for t, (tap_x, tap_g) in enumerate(zip(xs, gs)):
        oy, ox = t // kx - ky // 2, t % kx - kx // 2
        w_s = math.exp(-0.5 * ((oy / ss_y) ** 2 + (ox / ss_x) ** 2))
        diff = tap_g - g
        if color_distance_type == "l1":
            d2 = diff.abs().sum(dim=1, keepdim=True) ** 2
        else:
            d2 = (diff * diff).sum(dim=1, keepdim=True)
        w = w_s * torch.exp(-0.5 * d2 / (sigma_color ** 2))
        num = num + tap_x * w
        den = den + w
    return num / den


def guided_blur(guidance: torch.Tensor, x: torch.Tensor, kernel_size,
                eps: float, border_type: str = "reflect") -> torch.Tensor:
    """Guided filter (He et al.): box means only (one fused blur launch
    each on the card)."""
    g = as_float(guidance)
    x = as_float(x)

    def mean(t):
        return box_blur(t, kernel_size, border_type)

    mean_g = mean(g)
    mean_x = mean(x)
    var_g = mean(g * g) - mean_g * mean_g
    cov_gx = mean(g * x) - mean_g * mean_x
    a = cov_gx / (var_g + eps)
    b = mean_x - a * mean_g
    return mean(a) * g + mean(b)


def blur_pool2d(x: torch.Tensor, kernel_size: int = 3,
                stride: int = 2) -> torch.Tensor:
    """Anti-aliased downsampling: the normalized Pascal kernel, zero
    padding of (k - 1) // 2 a side, then `stride`."""
    x = as_float(x)
    k = get_pascal_kernel_2d(kernel_size, norm=True, dtype=x.dtype,
                             device=x.device)
    kh, kw = k.shape
    C = x.shape[1]
    return F.conv2d(x, k.expand(C, kh, kw)[:, None], stride=stride,
                    padding=((kh - 1) // 2, (kw - 1) // 2), groups=C)


def max_blur_pool2d(x: torch.Tensor, kernel_size: int = 3, stride: int = 2,
                    max_pool_size: int = 2,
                    ceil_mode: bool = False) -> torch.Tensor:
    """Max pool at stride 1 with no padding (the map shrinks by
    max_pool_size - 1), then ``blur_pool2d``. `ceil_mode` changes nothing
    at stride 1, as in the reference."""
    del ceil_mode
    x = F.max_pool2d(as_float(x), max_pool_size, stride=1)
    return blur_pool2d(x, kernel_size, stride)


def in_range(x: torch.Tensor, lower, upper,
             return_mask: bool = False) -> torch.Tensor:
    """(B, 1, H, W): 1 where every channel lies in [lower, upper] (per
    channel bounds), else 0; boolean with `return_mask`."""
    x = as_float(x)
    lo = torch.as_tensor(lower, dtype=x.dtype, device=x.device).reshape(
        1, -1, 1, 1)
    hi = torch.as_tensor(upper, dtype=x.dtype, device=x.device).reshape(
        1, -1, 1, 1)
    ok = ((x >= lo) & (x <= hi)).all(dim=1, keepdim=True)
    return ok if return_mask else ok.to(x.dtype)


def _max_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Max over k x k windows, 'same' size, zero outside (x >= 0)."""
    lo, hi = (k - 1) // 2, k // 2
    return F.max_pool2d(F.pad(x, (lo, hi, lo, hi)), k, stride=1)


def edge_aware_blur_pool2d(x: torch.Tensor, kernel_size: int = 3,
                           edge_threshold: float = 1.25,
                           edge_dilation_kernel_size: int = 3,
                           epsilon: float = 1e-6) -> torch.Tensor:
    """Blur everywhere (``blur_pool2d`` at stride 1) except on dilated
    strong edges of the log gradient magnitude, which keep the input."""
    x = as_float(x)
    blurred = blur_pool2d(x, kernel_size, stride=1)
    g = spatial_gradient(x, "sobel", 1, True)
    mag = torch.sqrt(g[:, :, 0] ** 2 + g[:, :, 1] ** 2 + epsilon)
    edges = torch.log1p(mag / epsilon).amax(dim=1, keepdim=True)
    edge_mask = edges > edge_threshold * math.log(1.0 / epsilon) / 2.0
    edge_mask = _max_same(edge_mask.to(x.dtype), edge_dilation_kernel_size)
    return x * edge_mask + blurred * (1.0 - edge_mask)


# -----------------------------------------------------------------------------
# Gradients and edges
# -----------------------------------------------------------------------------

def spatial_gradient3d(x: torch.Tensor, mode: str = "diff",
                       order: int = 1) -> torch.Tensor:
    """(B, C, D, H, W) → (B, C, 3, D, H, W) central differences [d/dx,
    d/dy, d/dz], replicate border (the reference's only mode and order)."""
    x = as_float(x)
    xp = F.pad(x, (1, 1, 1, 1, 1, 1), mode="replicate")
    gx = 0.5 * (xp[:, :, 1:-1, 1:-1, 2:] - xp[:, :, 1:-1, 1:-1, :-2])
    gy = 0.5 * (xp[:, :, 1:-1, 2:, 1:-1] - xp[:, :, 1:-1, :-2, 1:-1])
    gz = 0.5 * (xp[:, :, 2:, 1:-1, 1:-1] - xp[:, :, :-2, 1:-1, 1:-1])
    return torch.stack([gx, gy, gz], dim=2)


def sobel(x: torch.Tensor, normalized: bool = True,
          eps: float = 1e-6) -> torch.Tensor:
    g = spatial_gradient(x, "sobel", 1, normalized)
    return torch.sqrt(g[:, :, 0] ** 2 + g[:, :, 1] ** 2 + eps)


def laplacian(x: torch.Tensor, kernel_size, border_type: str = "reflect",
              normalized: bool = True) -> torch.Tensor:
    x = as_float(x)
    kern = get_laplacian_kernel2d(kernel_size, x.dtype, x.device)
    if normalized:
        kern = normalize_kernel2d(kern)
    return filter2d(x, kern, border_type)


#: hysteresis bodies run between two convergence tests
CANNY_CHECK_EVERY = 8
#: canny's hysteresis work: calls, loop bodies run and host reads (each
#: convergence test is one device→host read on the card)
canny_counts: Counter = Counter()


def _hysteresis_step(edges: torch.Tensor) -> torch.Tensor:
    """Weak (0.5) pixels 8-adjacent to a strong (1) one become strong."""
    weak = edges == 0.5
    strong = edges == 1.0
    near_strong = F.max_pool2d(strong.to(edges.dtype), 3, stride=1,
                               padding=1) > 0
    new_strong = (near_strong & weak) | strong
    return torch.where(new_strong, 1.0,
                       torch.where(weak, 0.5, 0.0)).to(edges.dtype)


def canny(x: torch.Tensor, low_threshold: float = 0.1,
          high_threshold: float = 0.2, kernel_size=5, sigma=1.0,
          hysteresis: bool = True,
          eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """Canny edges: (magnitude after non-maximum suppression, edges). The
    Gaussian blur (fused kernel on the card), unnormalized sobel
    gradients, strict-greater NMS along the nearest 45° direction (round
    half to even), thresholds, then hysteresis to convergence. The
    reference loops while one step changes the edges; once converged a
    step changes nothing, so the port runs CANNY_CHECK_EVERY steps between
    two tests (one host read each) and gets the same edges."""
    x = as_float(x)
    if x.shape[1] == 3:
        from .color import rgb_to_grayscale
        x = rgb_to_grayscale(x)
    blurred = gaussian_blur2d(x, kernel_size, sigma)
    g = spatial_gradient(blurred, "sobel", 1, normalized=False)
    gx, gy = g[:, :, 0], g[:, :, 1]
    mag = torch.sqrt(gx * gx + gy * gy + eps)
    ang8 = torch.round(torch.atan2(gy, gx) * (4.0 / math.pi))
    H, W = mag.shape[-2:]
    magp = F.pad(mag, (1, 1, 1, 1))
    # direction k: k = 0 along +x, counter-clockwise in image coordinates
    offs = [(0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0),
            (-1, 1)]
    pos_idx = torch.remainder(ang8, 8.0)
    neg_idx = torch.remainder(ang8 + 4.0, 8.0)
    diff_pos = torch.zeros_like(mag)
    diff_neg = torch.zeros_like(mag)
    for k, (dy, dx) in enumerate(offs):
        d = mag - magp[..., 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
        diff_pos = torch.where(pos_idx == k, d, diff_pos)
        diff_neg = torch.where(neg_idx == k, d, diff_neg)
    mag_nms = mag * (torch.minimum(diff_pos, diff_neg) > 0.0)
    edges = 0.5 * (mag_nms > low_threshold).to(x.dtype) + \
        0.5 * (mag_nms > high_threshold).to(x.dtype)
    if not hysteresis:
        return mag_nms, edges
    canny_counts["calls"] += 1
    while True:
        for _ in range(CANNY_CHECK_EVERY):
            old, edges = edges, _hysteresis_step(edges)
        canny_counts["steps"] += CANNY_CHECK_EVERY
        canny_counts["syncs"] += 1
        if torch.equal(edges, old):
            break
    return mag_nms, (edges == 1.0).to(x.dtype)
