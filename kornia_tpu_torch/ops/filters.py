"""2-D filtering (counterpart of ``kornia_tpu/ops/filters.py``, the part
the two-view path reaches).

Images are (B, C, H, W) float tensors. Every separable blur with 1-D
kernels and one of the four border rules goes through the banded blur
kernel (``ops/kernels.py::fused_separable_blur2d``) on the card and through
its plain version on the CPU; other filters are grouped convolutions.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from ..core.check import check
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
