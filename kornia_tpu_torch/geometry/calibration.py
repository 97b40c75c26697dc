"""Calibration (counterpart of ``kornia_tpu/geometry/calibration.py``):
perspective-n-point (the DLT, a batched RANSAC around it with a pose-only
Gauss-Newton polish, and a Huber-IRLS pose refinement), Brown-Conrady lens
distortion of pixels in OpenCV's 14-coefficient order, its fixed-trip
iterative inverse, image undistortion by an inverse map, and the
Scheimpflug tilt projection.

Randomness: ``pnp_ransac`` draws its minimal samples by Gumbel top-6 over
the valid points. The noise comes from a ``torch.Generator`` or is
injected as an (S, N) tensor, so that tests can replay the reference's
``jax.random.gumbel`` draws.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
from torch.func import jacfwd

from ..core.check import check_shape
from ..core.dtype import as_float
from ..core.linalg import f32_matmul_precision, lstsq_nullspace
from ..core.sort import top_k
from ..losses.robust import huber_weight
from ..ops.warp import remap
from .conversions import (normalize_points_with_intrinsics,
                          vector_to_skew_symmetric_matrix)
from .ransac import _gumbel

__all__ = ["pnp_ransac", "solve_pnp_dlt", "refine_pose_gn", "distort_points",
           "undistort_points", "undistort_image", "tilt_projection"]


def solve_pnp_dlt(world_points: torch.Tensor, img_points: torch.Tensor,
                  intrinsics: torch.Tensor, svd_eps: float = 1e-4
                  ) -> torch.Tensor:
    """DLT PnP: (B, N ≥ 6, 3) world points, (B, N, 2) pixels and (B, 3, 3)
    K → (B, 3, 4) world→camera [R | t]."""
    check_shape(world_points, ["B", "N", "3"], "world_points")
    world_points = as_float(world_points)
    img_points = as_float(img_points)
    B = world_points.shape[0]
    xn = normalize_points_with_intrinsics(img_points, intrinsics)
    # centroid and scale normalisation of the world points for conditioning
    cen = world_points.mean(1, keepdim=True)
    scale = torch.linalg.vector_norm(world_points - cen,
                                     dim=-1).mean(1).clamp_min(1e-8)
    wp = (world_points - cen) / scale[:, None, None]
    X, Y, Z = wp[..., 0], wp[..., 1], wp[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    zeros = torch.zeros_like(X)
    ones = torch.ones_like(X)
    r1 = torch.stack([X, Y, Z, ones, zeros, zeros, zeros, zeros,
                      -u * X, -u * Y, -u * Z, -u], dim=-1)
    r2 = torch.stack([zeros, zeros, zeros, zeros, X, Y, Z, ones,
                      -v * X, -v * Y, -v * Z, -v], dim=-1)
    A = torch.cat([r1, r2], dim=1)  # (B, 2N, 12)
    p = lstsq_nullspace(A).reshape(B, 3, 4)
    # sign: the centroid in front of the camera
    depth_c = p[:, 2, 3]
    p = p * torch.sign(depth_c + (depth_c == 0).to(p.dtype))[:, None, None]
    # nearest rotation (Procrustes)
    U, S, Vt = torch.linalg.svd(p[:, :, :3])
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], dim=-1)
    R = (U * D[:, None, :]) @ Vt
    t = p[:, :, 3] / S.mean(-1)[:, None]
    # undo the world normalisation: x = R (X - cen) / scale + t
    t_full = (t - torch.einsum("bij,bj->bi", R, cen[:, 0])
              / scale[:, None]) * scale[:, None]
    return torch.cat([R, t_full[..., None]], dim=-1)


def _exp_so3_cal(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' exp map of (3,), differentiable at zero: the Taylor
    branches and the floor inside ``sqrt`` keep value and Jacobian finite
    where every Gauss-Newton step linearises. Per-element scalars keep a
    trailing axis (see ``conversions.py``)."""
    th2 = (w * w).sum(-1, keepdim=True)[..., None]
    small = th2 < 1e-12
    th = torch.sqrt(torch.where(small, 1.0, th2))
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
    Kx = vector_to_skew_symmetric_matrix(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + A * Kx \
        + B * (Kx @ Kx)


def _project_res(world_points, img_points, Rm, tm):
    Xc = world_points @ Rm.T + tm
    z = torch.where(Xc[:, 2].abs() > 1e-8, Xc[:, 2], 1e-8)
    return Xc[:, :2] / z[:, None] - img_points, Xc[:, 2]


def _gn_step(world_points, img_points, Rm, tm, sw):
    """One Gauss-Newton step on the residuals weighted by sw (N, 1): the
    candidate (R, t)."""
    def res_at(dx):
        rr, _ = _project_res(world_points, img_points,
                             _exp_so3_cal(dx[:3]) @ Rm, tm + dx[3:])
        return (rr * sw).reshape(-1)

    dx0 = torch.zeros(6, dtype=Rm.dtype, device=Rm.device)
    J = jacfwd(res_at)(dx0)  # (2N, 6)
    r0 = res_at(dx0)
    H = J.T @ J + 1e-6 * torch.eye(6, dtype=Rm.dtype, device=Rm.device)
    dx = -torch.linalg.solve_ex(H, J.T @ r0, check_errors=False)[0]
    return _exp_so3_cal(dx[:3]) @ Rm, tm + dx[3:]


@f32_matmul_precision
def pnp_ransac(world_points: torch.Tensor, img_points: torch.Tensor,
               generator: Optional[torch.Generator], inl_th: float,
               mask: Optional[torch.Tensor] = None,
               batch_size: int = 256, gn_iters: int = 5, *,
               gumbel: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Robust 3-D/2-D pose: `batch_size` minimal 6-point DLT samples at
    once, MSAC scoring, then `gn_iters` pose-only Gauss-Newton steps on the
    inlier set, each kept only if it lowers the truncated cost.

    world_points (N, 3); img_points (N, 2) normalised camera coordinates;
    `generator` (in the place of the reference's `key`; None takes the
    default one) draws the sampling noise, or gumbel (batch_size, N)
    injects it; inl_th in normalised units. Returns (R (3, 3), t (3,),
    inliers (N,), inlier count), world→camera."""
    world_points = as_float(world_points)
    img_points = as_float(img_points)
    N = world_points.shape[0]
    dev, dt = world_points.device, world_points.dtype
    if mask is None:
        mask = torch.ones(N, dtype=torch.bool, device=dev)
    if gumbel is not None and tuple(gumbel.shape) != (batch_size, N):
        raise ValueError(f"gumbel must be {(batch_size, N)}, got "
                         f"{tuple(gumbel.shape)}")
    th2 = inl_th * inl_th

    # minimal samples: Gumbel top-6 over the valid points
    noise = (gumbel.to(device=dev, dtype=dt) if gumbel is not None
             else _gumbel((batch_size, N), generator, dev))
    logits = torch.where(mask, 0.0, -math.inf).to(dt)
    _, sidx = top_k(noise + logits[None], 6)  # (S, 6)
    eye = torch.eye(3, dtype=dt, device=dev).expand(batch_size, 3, 3)
    P = solve_pnp_dlt(world_points[sidx], img_points[sidx], eye)  # (S, 3, 4)

    Xc = torch.einsum("sij,nj->sni", P[:, :, :3], world_points) \
        + P[:, None, :, 3]
    z = Xc[..., 2]
    proj = Xc[..., :2] / torch.where(z.abs() > 1e-8, z, 1e-8)[..., None]
    err = ((proj - img_points[None]) ** 2).sum(-1)
    err = torch.where(z > 1e-6, err, math.inf)  # cheirality
    err = torch.where(mask[None], err, th2)
    best = torch.argmin(err.clamp(0.0, th2).sum(-1))
    R, t = P[best, :, :3], P[best, :, 3]

    # pose-only GN on the inlier set of each step, accept-if-better
    for _ in range(gn_iters):
        r, z = _project_res(world_points, img_points, R, t)
        wf = (((r * r).sum(-1) < th2) & (z > 1e-6) & mask).to(dt)
        Rn, tn = _gn_step(world_points, img_points, R, t, wf[:, None])
        rn, _ = _project_res(world_points, img_points, Rn, tn)
        better = ((rn * rn).sum(-1).clamp(0, th2) * wf).sum() < \
            ((r * r).sum(-1).clamp(0, th2) * wf).sum()
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
    r, z = _project_res(world_points, img_points, R, t)
    inliers = ((r * r).sum(-1) < th2) & (z > 1e-6) & mask
    return R, t, inliers, inliers.sum()


def refine_pose_gn(world_points: torch.Tensor, img_points: torch.Tensor,
                   R0: torch.Tensor, t0: torch.Tensor, huber_delta: float,
                   mask: torch.Tensor, iters: int = 8
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Motion-only robust pose polish: Huber-IRLS Gauss-Newton over se3
    from (R0, t0), minimising the reprojection of `world_points` onto
    normalised `img_points` over the masked set; a step is kept only if it
    lowers the Huber cost, and an empty mask changes nothing."""
    d2 = huber_delta * huber_delta

    def cost(Rm, tm):
        r, z = _project_res(world_points, img_points, Rm, tm)
        r2 = (r * r).sum(-1)
        rho = torch.where(r2 < d2, r2,
                          2.0 * huber_delta * torch.sqrt(r2.clamp_min(1e-18))
                          - d2)
        return torch.where(mask & (z > 1e-6), rho, 0.0).sum()

    R, t = R0, t0
    c = cost(R, t)
    for _ in range(iters):
        r, z = _project_res(world_points, img_points, R, t)
        w = huber_weight((r * r).sum(-1), huber_delta) \
            * (mask & (z > 1e-6)).to(r.dtype)
        Rn, tn = _gn_step(world_points, img_points, R, t,
                          torch.sqrt(w)[:, None])
        cn = cost(Rn, tn)
        better = cn < c
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        c = torch.where(better, cn, c)
    return R, t


# -----------------------------------------------------------------------------
# Brown-Conrady distortion
# -----------------------------------------------------------------------------

def _coefficients(dist: torch.Tensor, dtype) -> torch.Tensor:
    """(..., ≤ 14) coefficients → (..., 14), the missing ones zero: k1, k2,
    p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, τx, τy."""
    d = torch.zeros((*dist.shape[:-1], 14), dtype=dtype, device=dist.device)
    d[..., : dist.shape[-1]] = dist.to(dtype)
    return d


def _intrinsics(K: torch.Tensor):
    """(fx, fy, cx, cy) of (..., 3, 3) K, each (..., 1)."""
    return (K[..., 0, 0][..., None], K[..., 1, 1][..., None],
            K[..., 0, 2][..., None], K[..., 1, 2][..., None])


def distort_points(points: torch.Tensor, K: torch.Tensor, dist: torch.Tensor,
                   new_K: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Distort (B, N, 2) pixels: normalised by `new_K` (default K), through
    the radial, tangential and thin-prism terms of `dist` (B, ≤ 14), back
    to pixels by K."""
    points = as_float(points)
    d = _coefficients(dist, points.dtype)
    fx, fy, cx, cy = _intrinsics(K if new_K is None else new_K)
    x = (points[..., 0] - cx) / fx
    y = (points[..., 1] - cy) / fy
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = (
        d[..., i:i + 1] for i in range(12))
    r2 = x * x + y * y
    rad = (1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3) / (
        1.0 + k4 * r2 + k5 * r2 ** 2 + k6 * r2 ** 3)
    xd = x * rad + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) \
        + s1 * r2 + s2 * r2 ** 2
    yd = y * rad + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y \
        + s3 * r2 + s4 * r2 ** 2
    fxo, fyo, cxo, cyo = _intrinsics(K)
    return torch.stack([xd * fxo + cxo, yd * fyo + cyo], dim=-1)


def undistort_points(points: torch.Tensor, K: torch.Tensor,
                     dist: torch.Tensor,
                     new_K: Optional[torch.Tensor] = None,
                     num_iters: int = 5) -> torch.Tensor:
    """The inverse of `distort_points` by OpenCV's fixed-point iteration,
    `num_iters` steps, back to pixels by `new_K` (default K)."""
    points = as_float(points)
    d = _coefficients(dist, points.dtype)
    fx, fy, cx, cy = _intrinsics(K)
    x0 = (points[..., 0] - cx) / fx
    y0 = (points[..., 1] - cy) / fy
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4 = (
        d[..., i:i + 1] for i in range(12))
    x, y = x0, y0
    for _ in range(num_iters):
        r2 = x * x + y * y
        inv_rad = (1.0 + k4 * r2 + k5 * r2 ** 2 + k6 * r2 ** 3) / (
            1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3)
        dx = (2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2
              + s2 * r2 ** 2)
        dy = (p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + s3 * r2
              + s4 * r2 ** 2)
        x, y = (x0 - dx) * inv_rad, (y0 - dy) * inv_rad
    fxn, fyn, cxn, cyn = _intrinsics(K if new_K is None else new_K)
    return torch.stack([x * fxn + cxn, y * fyn + cyn], dim=-1)


def undistort_image(image: torch.Tensor, K: torch.Tensor,
                    dist: torch.Tensor) -> torch.Tensor:
    """Undistort (B, C, H, W) by the inverse map: each output pixel samples
    the input where `distort_points` sends it (bilinear, zeros outside)."""
    image = as_float(image)
    B, _, H, W = image.shape
    dt, dev = image.dtype, image.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=dt, device=dev),
                            torch.arange(W, dtype=dt, device=dev),
                            indexing="ij")
    grid = torch.stack([xs, ys], dim=-1).reshape(1, -1, 2).expand(
        B, H * W, 2)
    src = distort_points(grid, K, dist)
    return remap(image, src[..., 0].reshape(B, H, W),
                 src[..., 1].reshape(B, H, W), align_corners=True)


def tilt_projection(taux: torch.Tensor, tauy: torch.Tensor,
                    return_inverse: bool = False,
                    device: Union[str, torch.device] = "cuda"):
    """The (..., 3, 3) Scheimpflug tilt projection of sensor tilts τx, τy
    (radians), and with `return_inverse` its inverse too; on the tilts'
    device, or on `device` when both are numbers."""
    given = [t for t in (taux, tauy) if isinstance(t, torch.Tensor)]
    if given:
        device = given[0].device
    dtype = given[0].dtype if given else torch.float32
    taux = torch.as_tensor(taux, dtype=dtype, device=device)
    tauy = torch.as_tensor(tauy, dtype=dtype, device=device)
    cx, sx = torch.cos(taux), torch.sin(taux)
    cy, sy = torch.cos(tauy), torch.sin(tauy)
    one, zero = torch.ones_like(cx), torch.zeros_like(cx)
    Rx = torch.stack([torch.stack([one, zero, zero], -1),
                      torch.stack([zero, cx, sx], -1),
                      torch.stack([zero, -sx, cx], -1)], -2)
    Ry = torch.stack([torch.stack([cy, zero, -sy], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([sy, zero, cy], -1)], -2)
    R = Ry @ Rx
    pz = R[..., 2, 2]
    P = torch.zeros_like(R)
    P[..., 0, 0] = pz
    P[..., 1, 1] = pz
    P[..., 0, 2] = -R[..., 0, 2]
    P[..., 1, 2] = -R[..., 1, 2]
    P[..., 2, 2] = 1.0
    tilt = P @ R.transpose(-1, -2)
    if not return_inverse:
        return tilt
    inv_P = torch.zeros_like(P)
    inv_P[..., 0, 0] = 1.0 / pz
    inv_P[..., 1, 1] = 1.0 / pz
    inv_P[..., 0, 2] = R[..., 0, 2] / pz
    inv_P[..., 1, 2] = R[..., 1, 2] / pz
    inv_P[..., 2, 2] = 1.0
    return tilt, R @ inv_P
