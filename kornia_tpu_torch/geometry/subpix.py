"""Subpixel localisation (counterpart of ``kornia_tpu/geometry/subpix.py``):
non-maximum suppression in 2-D and 3-D, the soft-argmax family (spatial
and windowed), Gaussian rendering, and the quadratic refinement of 3-D
extrema (one fit per voxel, and the iterative fit). The 3x3 systems are
solved by cofactors and Cramer's rule, per element, as the reference
does."""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.check import check
from ..core.dtype import as_float
from ..core.grid import create_meshgrid

__all__ = ["nms2d", "nms3d", "quad_fit3d_planes", "max_pool3d_same",
           "spatial_softmax2d", "spatial_expectation2d",
           "spatial_soft_argmax2d", "render_gaussian2d", "conv_soft_argmax2d",
           "conv_soft_argmax3d", "conv_quad_interp3d",
           "conv_quad_interp3d_planes", "nms3d_minmax",
           "iterative_quad_interp3d"]


def _max_non_center(x: torch.Tensor, kernel_size) -> torch.Tensor:
    """Max over every window tap but the centre, replicate border."""
    pads = []
    for k in reversed(kernel_size):
        pads += [k // 2, (k - 1) // 2]
    xp = F.pad(x, pads, mode="replicate")
    spatial = x.shape[2:]
    out = torch.full_like(x, -torch.inf)
    centre = tuple(k // 2 for k in kernel_size)
    for offs in torch.cartesian_prod(
            *[torch.arange(k) for k in kernel_size]).reshape(
                -1, len(kernel_size)).tolist():
        if tuple(offs) == centre:
            continue
        sl = tuple(slice(o, o + n) for o, n in zip(offs, spatial))
        out = torch.maximum(out, xp[(slice(None), slice(None)) + sl])
    return out


def nms2d(x: torch.Tensor, kernel_size: Tuple[int, int] = (3, 3),
          mask_only: bool = False) -> torch.Tensor:
    """Keep values STRICTLY greater than every neighbour in the window
    (centre excluded, replicate border, so plateaus die)."""
    x = as_float(x)
    mask = x > _max_non_center(x, kernel_size)
    return mask if mask_only else x * mask.to(x.dtype)


def nms3d(x: torch.Tensor, kernel_size: Tuple[int, int, int] = (3, 3, 3),
          mask_only: bool = False) -> torch.Tensor:
    """(B, C, D, H, W) NMS, strictly greater than every neighbour."""
    x = as_float(x)
    mask = x > _max_non_center(x, kernel_size)
    return mask if mask_only else x * mask.to(x.dtype)


def max_pool3d_same(x: torch.Tensor) -> torch.Tensor:
    """3x3x3 max over (D, H, W) with SAME padding by -inf
    (``lax.reduce_window`` in the reference)."""
    return F.max_pool3d(x, 3, stride=1, padding=1)


def quad_fit3d_planes(x: torch.Tensor, eps: float = 1e-7
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Quadratic fit on (B, C, D, H, W) by central differences, replicate
    border: (ox, oy, os, dval) planes, offsets clamped to [-0.5, 0.5].
    Fitting -x gives the same offsets and -dval."""
    x = as_float(x)
    D, H, W = x.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1, 1, 1), mode="replicate")

    def sl(dz, dy, dx):
        return xp[:, :, 1 + dz:1 + dz + D, 1 + dy:1 + dy + H,
                  1 + dx:1 + dx + W]

    gx = 0.5 * (sl(0, 0, 1) - sl(0, 0, -1))
    gy = 0.5 * (sl(0, 1, 0) - sl(0, -1, 0))
    gs = 0.5 * (sl(1, 0, 0) - sl(-1, 0, 0))
    dxx = sl(0, 0, 1) + sl(0, 0, -1) - 2 * x
    dyy = sl(0, 1, 0) + sl(0, -1, 0) - 2 * x
    dss = sl(1, 0, 0) + sl(-1, 0, 0) - 2 * x
    dxy = 0.25 * (sl(0, 1, 1) - sl(0, 1, -1) - sl(0, -1, 1) + sl(0, -1, -1))
    dxs = 0.25 * (sl(1, 0, 1) - sl(1, 0, -1) - sl(-1, 0, 1) + sl(-1, 0, -1))
    dys = 0.25 * (sl(1, 1, 0) - sl(1, -1, 0) - sl(-1, 1, 0) + sl(-1, -1, 0))
    # scale-invariant degeneracy test: normalise by the largest |entry|
    hscale = torch.maximum(
        torch.maximum(torch.maximum(dxx.abs(), dyy.abs()),
                      torch.maximum(dss.abs(), dxy.abs())),
        torch.clamp_min(torch.maximum(dxs.abs(), dys.abs()), 1e-20))
    a = dxx / hscale + eps
    b = dxy / hscale
    c = dxs / hscale
    d_ = dyy / hscale + eps
    e = dys / hscale
    f = dss / hscale + eps
    gxn = gx / hscale
    gyn = gy / hscale
    gsn = gs / hscale
    # cofactors of the symmetric [[a, b, c], [b, d, e], [c, e, f]]
    A00 = d_ * f - e * e
    A01 = c * e - b * f
    A02 = b * e - c * d_
    det = a * A00 + b * A01 + c * A02
    ok = det.abs() > 1e-6
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    A11 = a * f - c * c
    A12 = b * c - a * e
    A22 = a * d_ - b * b
    ox = (-(A00 * gxn + A01 * gyn + A02 * gsn) * inv_det).clamp(-0.5, 0.5)
    oy = (-(A01 * gxn + A11 * gyn + A12 * gsn) * inv_det).clamp(-0.5, 0.5)
    os_ = (-(A02 * gxn + A12 * gyn + A22 * gsn) * inv_det).clamp(-0.5, 0.5)
    dval = 0.5 * (gx * ox + gy * oy + gs * os_)
    return ox, oy, os_, dval


def spatial_softmax2d(x: torch.Tensor, temperature=1.0) -> torch.Tensor:
    """Softmax over H*W, per channel."""
    x = as_float(x)
    B, C, H, W = x.shape
    return torch.softmax(x.reshape(B, C, -1) * temperature,
                         dim=-1).reshape(B, C, H, W)


def spatial_expectation2d(p: torch.Tensor,
                          normalized_coordinates: bool = True
                          ) -> torch.Tensor:
    """Expected (x, y) under a (B, C, H, W) spatial distribution: (B, C,
    2)."""
    H, W = p.shape[-2:]
    grid = create_meshgrid(H, W, normalized_coordinates, p.dtype, p.device)
    ex = (p * grid[0, ..., 0]).sum((-2, -1))
    ey = (p * grid[0, ..., 1]).sum((-2, -1))
    return torch.stack([ex, ey], dim=-1)


def spatial_soft_argmax2d(x: torch.Tensor, temperature=1.0,
                          normalized_coordinates: bool = True
                          ) -> torch.Tensor:
    return spatial_expectation2d(spatial_softmax2d(x, temperature),
                                 normalized_coordinates)


def render_gaussian2d(mean: torch.Tensor, std: torch.Tensor,
                      size: Tuple[int, int],
                      normalized_coordinates: bool = True) -> torch.Tensor:
    """Axis-aligned Gaussians at (B, N, 2) means, normalised to sum 1:
    (B, N, H, W)."""
    H, W = size
    grid = create_meshgrid(H, W, normalized_coordinates, mean.dtype,
                           mean.device)[0]
    dx = grid[None, None, ..., 0] - mean[..., 0][..., None, None]
    dy = grid[None, None, ..., 1] - mean[..., 1][..., None, None]
    sx = std[..., 0][..., None, None]
    sy = std[..., 1][..., None, None]
    g = torch.exp(-0.5 * ((dx / sx) ** 2 + (dy / sy) ** 2))
    return g / g.sum((-2, -1), keepdim=True).clamp_min(1e-12)


def _window_sum(t: torch.Tensor, kernel_size, stride, padding
                ) -> torch.Tensor:
    """Sums over (k...) windows of the trailing 2 or 3 axes, zero padding
    (``lax.reduce_window`` with ``lax.add``)."""
    pads = []
    for p in reversed(padding):
        pads += [p, p]
    t = F.pad(t, pads)
    pool = F.avg_pool2d if len(kernel_size) == 2 else F.avg_pool3d
    return pool(t, tuple(kernel_size), tuple(stride), divisor_override=1)


def _soft_argmax_pools(x: torch.Tensor, axes, kernel_size, stride, padding,
                       temperature):
    """exp((x - max) / T) and the pooling of it: (e, pool, denominator)."""
    x_s = (x - x.amax(dim=axes, keepdim=True).detach()) / torch.clamp_min(
        torch.as_tensor(temperature, dtype=x.dtype, device=x.device), 1e-8)
    e = torch.exp(x_s)

    def pool(t):
        return _window_sum(t, kernel_size, stride, padding)

    return e, pool, pool(e).clamp_min(1e-12)


def conv_soft_argmax2d(
    x: torch.Tensor,
    kernel_size: Tuple[int, int] = (3, 3),
    stride: Tuple[int, int] = (1, 1),
    padding: Tuple[int, int] = (1, 1),
    temperature=1.0,
    normalized_coordinates: bool = True,
    output_value: bool = False,
):
    """Windowed soft-argmax: per window, the softmax-weighted pixel
    coordinates, (B, C, 2, Ho, Wo), and with `output_value` the
    softmax-weighted value."""
    x = as_float(x)
    H, W = x.shape[-2:]
    e, pool, den = _soft_argmax_pools(x, (-2, -1), kernel_size, stride,
                                      padding, temperature)
    grid = create_meshgrid(H, W, False, x.dtype, x.device)[0]
    ex = pool(e * grid[..., 0]) / den
    ey = pool(e * grid[..., 1]) / den
    if normalized_coordinates:
        ex = 2.0 * ex / max(W - 1, 1) - 1.0
        ey = 2.0 * ey / max(H - 1, 1) - 1.0
    coords = torch.stack([ex, ey], dim=2)
    if output_value:
        return coords, pool(e * x) / den
    return coords


def conv_soft_argmax3d(
    x: torch.Tensor,
    kernel_size: Tuple[int, int, int] = (3, 3, 3),
    stride: Tuple[int, int, int] = (1, 1, 1),
    padding: Tuple[int, int, int] = (1, 1, 1),
    temperature=1.0,
    normalized_coordinates: bool = False,
    output_value: bool = True,
):
    """(B, C, D, H, W) windowed soft-argmax: (x, y, z) coordinates (B, C,
    3, Do, Ho, Wo), and the value."""
    x = as_float(x)
    D, H, W = x.shape[-3:]
    e, pool, den = _soft_argmax_pools(x, (-3, -2, -1), kernel_size, stride,
                                      padding, temperature)
    zs, ys, xs = _axes3(D, H, W, x)
    ez = pool(e * zs) / den
    ey = pool(e * ys) / den
    ex = pool(e * xs) / den
    if normalized_coordinates:
        ez = 2.0 * ez / max(D - 1, 1) - 1.0
        ey = 2.0 * ey / max(H - 1, 1) - 1.0
        ex = 2.0 * ex / max(W - 1, 1) - 1.0
    coords = torch.stack([ex, ey, ez], dim=2)
    if output_value:
        return coords, pool(e * x) / den
    return coords


def _axes3(D: int, H: int, W: int, like: torch.Tensor):
    """The voxel index along each of (D, H, W), broadcastable."""
    def ar(n):
        return torch.arange(n, dtype=like.dtype, device=like.device)
    return (ar(D).reshape(D, 1, 1), ar(H).reshape(1, H, 1),
            ar(W).reshape(1, 1, W))


def conv_quad_interp3d_planes(
        x: torch.Tensor, strict_maxima_bonus: float = 10.0,
        eps: float = 1e-7
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quadratic refinement as planes: (ox, oy, os, refined), each (B, C,
    D, H, W); a voxel equal to its 3x3x3 maximum gains the bonus."""
    x = as_float(x)
    ox, oy, os_, dval = quad_fit3d_planes(x, eps)
    y_refined = x + dval
    if strict_maxima_bonus > 0:
        is_max = x == max_pool3d_same(x)
        y_refined = y_refined + strict_maxima_bonus * is_max.to(x.dtype)
    return ox, oy, os_, y_refined


def conv_quad_interp3d(x: torch.Tensor, strict_maxima_bonus: float = 10.0,
                       eps: float = 1e-7
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quadratic subpixel refinement of a (B, C, D, H, W) response:
    (coords (B, C, 3, D, H, W), the (x, y, s) offsets added to the grid;
    refined values)."""
    x = as_float(x)
    D, H, W = x.shape[-3:]
    ox, oy, os_, y_refined = conv_quad_interp3d_planes(
        x, strict_maxima_bonus, eps)
    zs, ys, xs = _axes3(D, H, W, x)
    return torch.stack([xs + ox, ys + oy, zs + os_], dim=2), y_refined


def nms3d_minmax(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Strict 3x3x3 local-maximum and local-minimum masks in one pass
    (replicate border: borders and plateaus die)."""
    x = as_float(x)
    D, H, W = x.shape[-3:]
    xp = F.pad(x, (1, 1, 1, 1, 1, 1), mode="replicate")
    max_n = torch.full_like(x, -torch.inf)
    min_n = torch.full_like(x, torch.inf)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                if dz == 1 and dy == 1 and dx == 1:
                    continue
                tap = xp[:, :, dz:dz + D, dy:dy + H, dx:dx + W]
                max_n = torch.maximum(max_n, tap)
                min_n = torch.minimum(min_n, tap)
    return x > max_n, x < min_n


def _solve_sym3x3(dxx, dyy, dss, dxy, dxs, dys, bx, by, bs, eps=1e-12):
    """Cramer's rule on the symmetric 3x3 Hessian system, per element:
    (sx, sy, ss, solved)."""
    det = (dxx * (dyy * dss - dys * dys) - dxy * (dxy * dss - dys * dxs)
           + dxs * (dxy * dys - dyy * dxs))
    ok = det.abs() > eps
    safe = torch.where(ok, det, 1.0)
    det_x = (bx * (dyy * dss - dys * dys) - dxy * (by * dss - dys * bs)
             + dxs * (by * dys - dyy * bs))
    det_y = (dxx * (by * dss - dys * bs) - bx * (dxy * dss - dys * dxs)
             + dxs * (dxy * bs - by * dxs))
    det_s = (dxx * (dyy * bs - by * dys) - dxy * (dxy * bs - by * dxs)
             + bx * (dxy * dys - dyy * dxs))
    z = torch.zeros_like(det)
    return (torch.where(ok, det_x / safe, z), torch.where(ok, det_y / safe, z),
            torch.where(ok, det_s / safe, z), ok)


def iterative_quad_interp3d(x: torch.Tensor, n_iters: int = 5,
                            strict_maxima_bonus: float = 10.0,
                            max_subpixel_shift: float = 0.6,
                            allow_scale_steps: bool = True,
                            precomputed_nms_mask: Optional[torch.Tensor] = None,
                            max_candidates: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative (SIFT-style) subpixel localisation of 3-D extrema, run
    densely at every voxel for a fixed `n_iters` (no host read); the NMS
    mask picks the outputs. `max_candidates` is accepted and has no effect,
    as in the reference. Returns (coords (B, C, 3, D, H, W) ordered
    [scale, x, y], values)."""
    x = as_float(x)
    check(x.ndim == 5, f"expected (B, C, D, H, W), got {tuple(x.shape)}")
    B, C, D, H, W = x.shape
    dev = x.device
    zs, ys, xs = _axes3(D, H, W, x)
    shape = (B, C, D, H, W)
    grid_coords = torch.stack([zs.expand(shape), xs.expand(shape),
                               ys.expand(shape)], dim=2)
    if D < 3 or H < 3 or W < 3:
        return grid_coords, x
    nms = (precomputed_nms_mask if precomputed_nms_mask is not None
           else nms3d(x, (3, 3, 3), True))
    inp = x.reshape(B * C, D, H, W)
    flat = inp.reshape(B * C, -1)

    def idx(n, view):
        return torch.arange(n, device=dev).reshape(view).expand(D, H, W)

    di, hi, wi = idx(D, (D, 1, 1)), idx(H, (1, H, 1)), idx(W, (1, 1, W))
    d_cur = di.expand(inp.shape)
    h_cur = hi.expand(inp.shape)
    w_cur = wi.expand(inp.shape)
    shift = torch.zeros((3,) + tuple(inp.shape), dtype=x.dtype, device=dev)
    gds = torch.zeros_like(inp)
    valid = torch.ones(inp.shape, dtype=torch.bool, device=dev)

    def tap(dc, hc, wc, dz, dy, dx):
        zz = (dc + dz).clamp(0, D - 1)
        yy = (hc + dy).clamp(0, H - 1)
        xx = (wc + dx).clamp(0, W - 1)
        return torch.gather(flat, 1, (zz * (H * W) + yy * W + xx).reshape(
            B * C, -1)).reshape(inp.shape)

    def step(valid, cur, s, hi_bound):
        new = cur + (valid & (s > max_subpixel_shift)).to(cur.dtype) \
            - (valid & (s < -max_subpixel_shift)).to(cur.dtype)
        valid = valid & (new >= 1) & (new <= hi_bound - 2)
        return valid, new.clamp(0, hi_bound - 1)

    for _ in range(n_iters):
        dc = d_cur.clamp(1, D - 2)
        hc = h_cur.clamp(1, H - 2)
        wc = w_cur.clamp(1, W - 2)

        def t(dz, dy, dx):
            return tap(dc, hc, wc, dz, dy, dx)

        c000 = t(0, 0, 0)
        p_xm, p_xp = t(0, 0, -1), t(0, 0, 1)
        p_ym, p_yp = t(0, -1, 0), t(0, 1, 0)
        p_sm, p_sp = t(-1, 0, 0), t(1, 0, 0)
        gx = 0.5 * (p_xp - p_xm)
        gy = 0.5 * (p_yp - p_ym)
        gs = 0.5 * (p_sp - p_sm)
        dxx = p_xp - 2 * c000 + p_xm
        dyy = p_yp - 2 * c000 + p_ym
        dss = p_sp - 2 * c000 + p_sm
        dxy = 0.25 * (t(0, 1, 1) - t(0, 1, -1) - t(0, -1, 1) + t(0, -1, -1))
        dxs = 0.25 * (t(1, 0, 1) - t(1, 0, -1) - t(-1, 0, 1) + t(-1, 0, -1))
        dys = 0.25 * (t(1, 1, 0) - t(1, -1, 0) - t(-1, 1, 0) + t(-1, -1, 0))
        sx, sy, ss, ok = _solve_sym3x3(dxx, dyy, dss, dxy, dxs, dys,
                                       -gx, -gy, -gs)
        valid = valid & ok
        vf = valid.to(x.dtype)
        sx, sy, ss = sx * vf, sy * vf, ss * vf
        shift = torch.where(valid[None], torch.stack([ss, sx, sy]), shift)
        gds = torch.where(valid, gx * sx + gy * sy + gs * ss, gds)
        valid, w_cur = step(valid, w_cur, sx, W)
        valid, h_cur = step(valid, h_cur, sy, H)
        if allow_scale_steps:
            valid, d_cur = step(valid, d_cur, ss, D)
    valid = valid & (shift.abs() <= 1.5).all(dim=0)
    fdt = x.dtype
    final_s = torch.where(valid, d_cur.to(fdt) + shift[0], di.to(fdt))
    final_x = torch.where(valid, w_cur.to(fdt) + shift[1], wi.to(fdt))
    final_y = torch.where(valid, h_cur.to(fdt) + shift[2], hi.to(fdt))
    refined = torch.stack([final_s, final_x, final_y],
                          dim=1).reshape(B, C, 3, D, H, W)
    coords = torch.where(nms[:, :, None], refined, grid_coords)
    y_ref = tap(d_cur, h_cur, w_cur, 0, 0, 0) + 0.5 * torch.where(
        valid, gds, 0.0)
    if strict_maxima_bonus > 0:
        y_ref = y_ref + strict_maxima_bonus * valid.to(fdt)
    return coords, torch.where(nms, y_ref.reshape(B, C, D, H, W), x)
