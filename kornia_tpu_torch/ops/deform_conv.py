"""Deformable 2-D convolution, DCNv1 and v2 (counterpart of
``kornia_tpu/ops/deform_conv.py``; ``torchvision.ops.deform_conv2d``'s
semantics).

The input is laid out as (B, H·W, C) so that each of the four bilinear
corners of every (tap, output pixel) sample is one row gather of C
contiguous values; the kernel contraction is one (B, N, K, g, c) x (g, o,
c, K) product in true f32 (TF32 off).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..core.dtype import as_float
from ..core.linalg import f32_matmul_precision

__all__ = ["deform_conv2d"]

_IntPair = Union[int, Tuple[int, int]]


def _pair(v: _IntPair) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else (v[0], v[1])


@f32_matmul_precision
def deform_conv2d(x: torch.Tensor, offset: torch.Tensor,
                  weight: torch.Tensor, bias: Optional[torch.Tensor] = None,
                  stride: _IntPair = (1, 1), padding: _IntPair = (0, 0),
                  dilation: _IntPair = (1, 1),
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (B, C_in, H, W); offset (B, 2·G·kH·kW, Ho, Wo), (dy, dx) per
    kernel tap interleaved, G offset groups; weight (C_out, C_in / groups,
    kH, kW); bias (C_out,); mask (B, G·kH·kW, Ho, Wo) for DCNv2. →
    (B, C_out, Ho, Wo). Samples outside the input read zero."""
    x = as_float(x)
    offset = as_float(offset)
    weight = as_float(weight)
    B, C_in, H, W = x.shape
    C_out, C_in_per_group, kH, kW = weight.shape
    sH, sW = _pair(stride)
    pH, pW = _pair(padding)
    dH, dW = _pair(dilation)
    groups = C_in // C_in_per_group
    K = kH * kW
    G = offset.shape[1] // (2 * K)
    c_per_g = C_in // G
    Ho = (H + 2 * pH - dH * (kH - 1) - 1) // sH + 1
    Wo = (W + 2 * pW - dW * (kW - 1) - 1) // sW + 1
    N = Ho * Wo
    dt, dev = x.dtype, x.device

    off = offset.reshape(B, G, K, 2, Ho, Wo)
    oy = (torch.arange(Ho, dtype=dt, device=dev) * sH - pH)[:, None]
    ox = (torch.arange(Wo, dtype=dt, device=dev) * sW - pW)[None, :]
    ky = (torch.arange(kH, dtype=dt, device=dev) * dH).repeat_interleave(
        kW)[:, None, None]
    kx = (torch.arange(kW, dtype=dt, device=dev) * dW).repeat(kH)[
        :, None, None]
    sample_h = oy + ky + off[:, :, :, 0]          # (B, G, K, Ho, Wo)
    sample_w = ox + kx + off[:, :, :, 1]
    h0 = torch.floor(sample_h)
    w0 = torch.floor(sample_w)
    lh = sample_h - h0
    lw = sample_w - w0
    h0i, w0i = h0.long(), w0.long()
    xf = x.reshape(B, C_in, H * W).transpose(1, 2)  # (B, HW, C)

    def corner(hh, ww, wgt, g):
        valid = ((hh >= 0) & (hh < H) & (ww >= 0) & (ww < W)).to(dt)
        idx = (hh.clamp(0, H - 1) * W + ww.clamp(0, W - 1)).reshape(B, K * N)
        rows = torch.gather(xf[:, :, g * c_per_g:(g + 1) * c_per_g], 1,
                            idx[:, :, None].expand(B, K * N, c_per_g))
        return rows.reshape(B, K, N, c_per_g) * \
            (valid * wgt).reshape(B, K, N, 1)

    sampled = []
    for g in range(G):
        hh0, ww0 = h0i[:, g], w0i[:, g]
        flh, flw = lh[:, g], lw[:, g]
        v = (corner(hh0, ww0, (1 - flh) * (1 - flw), g)
             + corner(hh0, ww0 + 1, (1 - flh) * flw, g)
             + corner(hh0 + 1, ww0, flh * (1 - flw), g)
             + corner(hh0 + 1, ww0 + 1, flh * flw, g))
        if mask is not None:
            v = v * as_float(mask).reshape(B, G, K, N)[:, g][..., None]
        sampled.append(v)                          # (B, K, N, c_per_g)

    full = torch.cat([s.transpose(1, 2) for s in sampled], dim=-1)
    full = full.reshape(B, N, K, groups, C_in_per_group)
    wf = weight.reshape(groups, C_out // groups, C_in_per_group, K)
    out = torch.einsum("bnkgc,gock->bngo", full, wf).reshape(B, N, C_out)
    if bias is not None:
        out = out + as_float(bias)
    return out.transpose(1, 2).reshape(B, C_out, Ho, Wo)
