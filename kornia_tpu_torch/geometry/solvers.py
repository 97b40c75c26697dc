"""Batched closed-form polynomial solvers (counterpart of
``kornia_tpu/geometry/solvers.py``): real roots of quadratics, cubics and
quartics, Durand-Kerner roots, products of polynomials in (x, y, z), the
determinant polynomial of a 3x13 action matrix and the null vector of a
3x4 matrix. Everything is branch-free over the batch."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.dtype import as_float

__all__ = ["solve_quadratic", "solve_cubic", "solve_quartic", "poly_roots",
           "multiply_deg_one_poly", "multiply_deg_two_one_poly",
           "determinant_to_polynomial", "null_vector_3x4"]

_EPS = 1e-12


def solve_quadratic(coeffs: torch.Tensor) -> torch.Tensor:
    """Real roots of a·x² + b·x + c: (..., 3) → (..., 2), zeros where the
    roots are complex. The stable form (no cancellation in -b ± sqrt)."""
    coeffs = as_float(coeffs)
    a, b, c = coeffs[..., 0], coeffs[..., 1], coeffs[..., 2]
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(disc.clamp_min(0.0))
    q = -0.5 * (b + torch.sign(b + (b == 0).to(b.dtype)) * sq)
    a_ok = a.abs() > _EPS
    q_ok = q.abs() > _EPS
    a_safe = torch.where(a_ok, a, 1.0)
    q_safe = torch.where(q_ok, q, 1.0)
    r1 = torch.where(a_ok, q / a_safe, -c / q_safe)
    r2 = torch.where(q_ok, c / q_safe, r1)
    real = disc >= 0
    return torch.stack([torch.where(real, r1, 0.0),
                        torch.where(real, r2, 0.0)], dim=-1)


def _cbrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x) * x.abs().pow(1.0 / 3.0)


def solve_cubic(coeffs: torch.Tensor) -> torch.Tensor:
    """Real roots of a·x³ + b·x² + c·x + d: (..., 4) → (..., 3), zeros in
    place of complex ones. Three real roots by the trigonometric (Viète)
    form, one by Cardano's; a vanishing a falls back to the quadratic."""
    coeffs = as_float(coeffs)
    a, b, c, d = coeffs.unbind(-1)
    is_cubic = a.abs() > _EPS
    a_safe = torch.where(is_cubic, a, 1.0)
    # depressed cubic t³ + p·t + q, x = t - b / 3a
    b_n, c_n, d_n = b / a_safe, c / a_safe, d / a_safe
    p = c_n - b_n * b_n / 3.0
    q = 2.0 * b_n ** 3 / 27.0 - b_n * c_n / 3.0 + d_n
    shift = -b_n / 3.0
    disc = (q / 2.0) ** 2 + (p / 3.0) ** 3
    p_neg = p.clamp_max(-1e-12)
    m = 2.0 * torch.sqrt(-p_neg / 3.0)
    arg = (3.0 * q / (p_neg * m)).clamp(-1.0, 1.0)
    theta = torch.arccos(arg) / 3.0
    k = torch.arange(3, dtype=coeffs.dtype, device=coeffs.device)
    t_trig = m[..., None] * torch.cos(theta[..., None]
                                      - 2.0 * math.pi * k / 3.0)
    sq = torch.sqrt(disc.clamp_min(0.0))
    t_single = _cbrt(-q / 2.0 + sq) + _cbrt(-q / 2.0 - sq)
    one_root = torch.cat([t_single[..., None],
                          torch.zeros_like(t_trig[..., :2])], dim=-1)
    roots3 = torch.where((disc <= 0)[..., None], t_trig, one_root) \
        + shift[..., None]
    quad = solve_quadratic(torch.stack([b, c, d], dim=-1))
    quad3 = torch.cat([quad, torch.zeros_like(quad[..., :1])], dim=-1)
    return torch.where(is_cubic[..., None], roots3, quad3)


def solve_quartic(coeffs: torch.Tensor) -> torch.Tensor:
    """Real roots of a quartic: (..., 5) → (..., 4) by Durand-Kerner,
    zeros in place of complex ones."""
    roots = poly_roots(coeffs)
    return torch.where(roots.imag.abs() < 1e-4, roots.real, 0.0)


def poly_roots(coeffs: torch.Tensor, iters: int = 100,
               tol: float = 0.0) -> torch.Tensor:
    """All complex roots of polynomials (..., D+1), highest degree first,
    by Durand-Kerner iteration in complex64 → (..., D).

    The coefficients are balanced (z = s·u, s = max_k |c_k|^(1/k)).
    tol=0 runs `iters` steps; tol>0 stops after the first step in which
    every root of the batch moved less than `tol` (one host sync a step,
    the reference's residual-gated loop)."""
    coeffs = as_float(coeffs)
    dt, dev = coeffs.dtype, coeffs.device
    D = coeffs.shape[-1] - 1
    lead = coeffs[..., 0:1]
    lead = torch.where(lead.abs() > _EPS, lead, _EPS)
    monic = coeffs / lead
    ks = torch.arange(1, D + 1, dtype=dt, device=dev)
    mags = monic[..., 1:].abs()
    s = torch.pow(mags.clamp_min(1e-30), 1.0 / ks).amax(dim=-1)
    s = s.clamp_min(1e-6)[..., None]
    scaled = monic / torch.pow(s, torch.arange(D + 1, dtype=dt, device=dev))
    scaled = (scaled / scaled[..., 0:1]).to(torch.complex64)

    # initial guesses: a circle with an irrational rotation
    k = torch.arange(D, dtype=dt, device=dev)
    init = 1.2 * torch.exp(2j * math.pi * (k / D + 0.127))
    z = init.expand(*scaled.shape[:-1], D).to(torch.complex64)
    eye = torch.eye(D, dtype=torch.complex64, device=dev)

    def step_of(z: torch.Tensor) -> torch.Tensor:
        p = torch.zeros_like(z)
        for i in range(D + 1):
            p = p * z + scaled[..., i:i + 1]
        diff = z[..., :, None] - z[..., None, :] + eye
        denom = torch.prod(diff, dim=-1)
        step = p / torch.where(denom.abs() > 1e-20, denom, 1e-20)
        mag = step.abs()
        return torch.where(mag > 3.0, step * (3.0 / mag), step)

    for _ in range(iters):
        step = step_of(z)
        z = z - step
        if tol > 0.0 and not bool(step.abs().max() >= tol):
            break
    return z * s.to(torch.complex64)


def multiply_deg_one_poly(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Product of two degree-1 polynomials in (x, y, z, 1): (..., 4) coeffs
    [x, y, z, 1] → (..., 10) coeffs [x², xy, xz, x, y², yz, y, z², z, 1]."""
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        ax * bx,
        ax * by + ay * bx,
        ax * bz + az * bx,
        ax * bw + aw * bx,
        ay * by,
        ay * bz + az * by,
        ay * bw + aw * by,
        az * bz,
        az * bw + aw * bz,
        aw * bw,
    ], dim=-1)


def multiply_deg_two_one_poly(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Degree-2 (10 coeffs) times degree-1 (4 coeffs) → degree-3, 20 coeffs
    [x³, x²y, x²z, x², xy², xyz, xy, xz², xz, x,
     y³, y²z, y², yz², yz, y, z³, z², z, 1]."""
    (axx, axy, axz, ax, ayy, ayz, ay, azz, az, aw) = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    return torch.stack([
        axx * bx,
        axx * by + axy * bx,
        axx * bz + axz * bx,
        axx * bw + ax * bx,
        axy * by + ayy * bx,
        axy * bz + axz * by + ayz * bx,
        axy * bw + ax * by + ay * bx,
        axz * bz + azz * bx,
        axz * bw + ax * bz + az * bx,
        ax * bw + aw * bx,
        ayy * by,
        ayy * bz + ayz * by,
        ayy * bw + ay * by,
        ayz * bz + azz * by,
        ayz * bw + ay * bz + az * by,
        ay * bw + aw * by,
        azz * bz,
        azz * bw + az * bz,
        az * bw + aw * bz,
        aw * bw,
    ], dim=-1)


def determinant_to_polynomial(A: torch.Tensor) -> torch.Tensor:
    """Degree-10 determinant polynomial of the Nister 3x13 action matrix
    (B, 3, 13): per row the coefficients of three polynomials in z of
    degrees 3, 3 and 4 (highest first). The 3x3 determinant is evaluated at
    11 Chebyshev nodes (radius 2) and mapped to coefficients by the exact
    inverse Vandermonde → (B, 11), lowest degree first."""
    A = as_float(A)
    nodes = 2.0 * np.cos(np.pi * (2 * np.arange(11) + 1) / 22.0)
    v_inv = torch.as_tensor(np.linalg.inv(np.vander(nodes, 11,
                                                    increasing=True)),
                            dtype=A.dtype, device=A.device)
    z = torch.as_tensor(nodes, dtype=A.dtype, device=A.device)
    one = torch.ones_like(z)
    zp = torch.stack([z ** 3, z ** 2, z, one], -1)  # (11, 4)
    zp4 = torch.stack([z ** 4, z ** 3, z ** 2, z, one], -1)  # (11, 5)
    p0 = torch.einsum("bik,nk->bin", A[:, :, 0:4], zp)
    p1 = torch.einsum("bik,nk->bin", A[:, :, 4:8], zp)
    p2 = torch.einsum("bik,nk->bin", A[:, :, 8:13], zp4)
    M = torch.stack([p0, p1, p2], dim=2)  # (B, 3, 3, 11)
    det = (M[:, 0, 0] * (M[:, 1, 1] * M[:, 2, 2] - M[:, 1, 2] * M[:, 2, 1])
           - M[:, 0, 1] * (M[:, 1, 0] * M[:, 2, 2] - M[:, 1, 2] * M[:, 2, 0])
           + M[:, 0, 2] * (M[:, 1, 0] * M[:, 2, 1] - M[:, 1, 1] * M[:, 2, 0]))
    return det @ v_inv.T


def null_vector_3x4(A: torch.Tensor) -> torch.Tensor:
    """Unnormalised null vector of rank-3 (..., 3, 4) matrices by the
    signed 3x3 minors (the 4-D cross product), no SVD."""
    A = as_float(A)

    def minor(cols):
        s = A[..., cols]
        return (s[..., 0, 0] * (s[..., 1, 1] * s[..., 2, 2]
                                - s[..., 1, 2] * s[..., 2, 1])
                - s[..., 0, 1] * (s[..., 1, 0] * s[..., 2, 2]
                                  - s[..., 1, 2] * s[..., 2, 0])
                + s[..., 0, 2] * (s[..., 1, 0] * s[..., 2, 1]
                                  - s[..., 1, 1] * s[..., 2, 0]))

    return torch.stack([minor([1, 2, 3]), -minor([0, 2, 3]),
                        minor([0, 1, 3]), -minor([0, 1, 2])], dim=-1)
