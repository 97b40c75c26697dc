"""SIFT descriptor as dense convolutions (counterpart of
``kornia_tpu/feature/siftdesc.py``): gradient magnitude and orientation,
soft-binned orientation maps, triangular spatial pooling as a grouped
strided convolution, 4x4x8 descriptor with SIFT clipping and RootSIFT;
and its dense form, one descriptor a pixel."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.check import check
from ..core.dtype import as_float
from ..ops.filters import get_gaussian_kernel2d, spatial_gradient

__all__ = ["sift_describe", "SIFTDescriptor", "DenseSIFTDescriptor"]


def _get_pooling_kernel(ksize: int, dtype=torch.float32,
                        device=None) -> torch.Tensor:
    """Triangular (bilinear) pooling kernel (ksize, ksize)."""
    ks_2 = float(ksize) / 2.0
    xc2 = ks_2 - (torch.arange(ksize, dtype=dtype, device=device)
                  + 0.5 - ks_2).abs()
    return (xc2[:, None] * xc2[None, :]) / (ks_2 ** 2)


def sift_describe(patches: torch.Tensor, num_ang_bins: int = 8,
                  num_spatial_bins: int = 4, rootsift: bool = True,
                  clipval: float = 0.2, eps: float = 1e-10) -> torch.Tensor:
    """(B, 1, PS, PS) patches → (B, num_spatial_bins² · num_ang_bins)."""
    patches = as_float(patches)
    B, CH, PS, _ = patches.shape
    check(CH == 1, "sift_describe expects grayscale patches")
    dt, dev = patches.dtype, patches.device
    sig = PS / math.sqrt(2.0)
    gk = get_gaussian_kernel2d((PS, PS), (sig, sig), dt, dev)[0]
    grads = spatial_gradient(patches, "diff")
    gx = grads[:, :, 0]
    gy = grads[:, :, 1]
    mag = torch.sqrt(gx * gx + gy * gy + eps) * gk[None, None]
    ori = torch.remainder(torch.atan2(gy, gx + eps) + 2.0 * math.pi,
                          2.0 * math.pi)
    o_big = ori * num_ang_bins / (2.0 * math.pi)
    bo0f = torch.floor(o_big)
    wo1 = o_big - bo0f
    bo0 = torch.remainder(bo0f, num_ang_bins).long()
    bo1 = torch.remainder(bo0 + 1, num_ang_bins)
    oh0 = F.one_hot(bo0[:, 0], num_ang_bins).permute(0, 3, 1, 2).to(dt)
    oh1 = F.one_hot(bo1[:, 0], num_ang_bins).permute(0, 3, 1, 2).to(dt)
    ang_maps = oh0 * ((1.0 - wo1) * mag) + oh1 * (wo1 * mag)  # (B, A, PS, PS)
    # spatial pooling: grouped strided conv with the triangular kernel
    ksize = 2 * PS // (num_spatial_bins + 1)
    stride = PS // num_spatial_bins
    pad = ksize // 4
    pool = _get_pooling_kernel(ksize, dt, dev)
    w = pool.expand(num_ang_bins, ksize, ksize)[:, None]
    pooled = F.conv2d(F.pad(ang_maps, (pad, pad, pad, pad)), w, stride=stride,
                      groups=num_ang_bins)
    pooled = pooled[:, :, :num_spatial_bins, :num_spatial_bins]
    # element order [angular bin, y, x], as the reference
    desc = pooled.reshape(B, -1)

    def l2n(v):
        return v / torch.linalg.vector_norm(v, dim=-1,
                                            keepdim=True).clamp_min(eps)

    desc = l2n(torch.clamp(l2n(desc), 0.0, clipval))
    if rootsift:
        desc = torch.sqrt(desc / desc.sum(-1, keepdim=True).clamp_min(eps)
                          + eps)
    return desc


class SIFTDescriptor:
    """Callable with the reference module's API."""

    def __init__(self, patch_size: int = 41, num_ang_bins: int = 8,
                 num_spatial_bins: int = 4, rootsift: bool = True,
                 clipval: float = 0.2):
        self.patch_size = patch_size
        self.num_ang_bins = num_ang_bins
        self.num_spatial_bins = num_spatial_bins
        self.rootsift = rootsift
        self.clipval = clipval

    def __call__(self, patches: torch.Tensor) -> torch.Tensor:
        return sift_describe(patches, self.num_ang_bins,
                             self.num_spatial_bins, self.rootsift,
                             self.clipval)


class DenseSIFTDescriptor:
    """Dense SIFT: (B, 1, H, W) → (B, 128, H, W) for the defaults (one
    descriptor a pixel at stride 1). The soft-binned orientation maps are
    pooled once by the triangular kernel, and each of the 4x4 spatial bins
    is that map read at its own offset."""

    def __init__(self, num_ang_bins: int = 8, num_spatial_bins: int = 4,
                 spatial_bin_size: int = 4, rootsift: bool = True,
                 clipval: float = 0.2, stride: int = 1, padding: int = 1):
        self.num_ang_bins = num_ang_bins
        self.num_spatial_bins = num_spatial_bins
        self.spatial_bin_size = spatial_bin_size
        self.rootsift = rootsift
        self.clipval = clipval
        self.stride = stride
        self.padding = padding

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = as_float(x)
        B, C, H, W = x.shape
        eps = 1e-10
        nab = self.num_ang_bins
        grads = spatial_gradient(x, "diff")
        gx, gy = grads[:, :, 0], grads[:, :, 1]
        mag = torch.sqrt(gx * gx + gy * gy + eps)
        ori = torch.remainder(torch.atan2(gy, gx + eps) + 2 * math.pi,
                              2 * math.pi)
        o_big = ori * nab / (2.0 * math.pi)
        bo0f = torch.floor(o_big)
        wo1 = o_big - bo0f
        bo0 = torch.remainder(bo0f, nab).long()
        bo1 = torch.remainder(bo0 + 1, nab)
        oh0 = F.one_hot(bo0[:, 0], nab).permute(0, 3, 1, 2).to(x.dtype)
        oh1 = F.one_hot(bo1[:, 0], nab).permute(0, 3, 1, 2).to(x.dtype)
        ang = oh0 * ((1 - wo1) * mag) + oh1 * (wo1 * mag)  # (B, nab, H, W)
        ks = self.spatial_bin_size
        nsb = self.num_spatial_bins
        w = _get_pooling_kernel(ks, x.dtype, x.device).expand(nab, ks, ks)
        p = self.padding + ks * (nsb // 2)
        base = F.conv2d(F.pad(ang, (p, p, p, p)), w[:, None],
                        stride=self.stride, groups=nab)
        desc = torch.cat([base[:, :, iy * ks: iy * ks + H,
                               ix * ks: ix * ks + W]
                          for iy in range(nsb) for ix in range(nsb)], dim=1)

        def l2n(v):
            return v / torch.linalg.vector_norm(
                v, dim=1, keepdim=True).clamp_min(eps)

        desc = l2n(torch.clamp(l2n(desc), 0.0, self.clipval))
        if self.rootsift:
            desc = torch.sqrt(desc / desc.sum(1, keepdim=True).clamp_min(eps)
                              + eps)
        return desc

    forward = __call__
