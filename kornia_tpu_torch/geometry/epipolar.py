"""Epipolar geometry (counterpart of ``kornia_tpu/geometry/epipolar.py``):
the weighted 8-point, the 7-point and the 5-point essential solvers, the
manifold polish of essential candidates, epipolar lines and distances,
essential and homography decompositions (with and without an SVD),
projection matrices and intrinsics, triangulation and the cheirality
choice of (R, t).

The 5-point solver is the reference's hidden-variable resultant: the ten
cubic constraints on E = xE1 + yE2 + zE3 + E4 form a 10x10 matrix C(z);
det C(z) is recovered as a degree-10 polynomial by evaluation at 11
Chebyshev nodes and an inverse Vandermonde, its roots by Durand-Kerner
(forward for |z| <= 1, column-reversed for |z| >= 1), (x, y) by inverse
iteration on C(z), and every candidate is polished by Gauss-Newton on the
constraints. All of it is float32 with the reference's conditioning.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.check import check, check_shape
from ..core.dtype import as_float
from ..core.linalg import (det_3x3, f32_matmul_precision, gauss_det,
                           inverse_3x3,
                           lstsq_nullspace, nullspace_inverse_iteration,
                           nullspace_qr)
from .homography import normalize_points
from .solvers import (multiply_deg_one_poly, multiply_deg_two_one_poly,
                      poly_roots, solve_cubic)

__all__ = [
    "run_8point",
    "run_7point",
    "run_5point",
    "find_fundamental",
    "normalize_transformation",
    "compute_correspond_epilines",
    "decompose_homography_matrix",
    "motion_from_homography_choose_solution",
    "left_to_right_epipolar_distance",
    "right_to_left_epipolar_distance",
    "polish_essential",
    "decompose_essential_matrix",
    "essential_from_Rt",
    "fundamental_from_essential",
    "relative_camera_motion",
    "motion_from_essential",
    "motion_from_essential_choose_solution",
    "projection_from_KRt",
    "triangulate_points",
    "sampson_epipolar_distance",
    "symmetrical_epipolar_distance",
    "find_essential",
    "essential_from_fundamental",
    "KRt_from_projection",
    "projections_from_fundamental",
    "fundamental_from_projections",
    "cross_product_matrix", "intrinsics_like", "random_intrinsics",
    "scale_intrinsics", "projection_from_Rt", "depth_from_point",
    "get_perpendicular", "get_closest_point_on_epipolar_line",
    "matrix_cofactor_tensor", "decompose_essential_matrix_no_svd",
]


def _to_homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _design_matrix(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


# -----------------------------------------------------------------------------
# Fundamental matrix (weighted 8-point)
# -----------------------------------------------------------------------------

@f32_matmul_precision
def run_8point(points1: torch.Tensor, points2: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalized 8-point algorithm (B, N >= 8, 2) → (B, 3, 3), unit
    Frobenius norm; `weights` (B, N) weight the rows."""
    check_shape(points1, ["B", "N", "2"], "points1")
    points1 = as_float(points1)
    points2 = as_float(points2)
    p1n, T1 = normalize_points(points1)
    p2n, T2 = normalize_points(points2)
    A = _design_matrix(p1n, p2n)
    if weights is not None:
        A = A * torch.sqrt(weights.clamp_min(0.0))[..., None]
    if points1.shape[1] == 8:
        f = nullspace_qr(A)[..., 0]
    else:
        f = lstsq_nullspace(A)
    F = f.reshape(-1, 3, 3)
    # rank-2 projection
    U, S, Vt = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    F = (U * S[..., None, :]) @ Vt
    F = T2.transpose(-1, -2) @ F @ T1
    norm = torch.linalg.vector_norm(F.reshape(-1, 9), dim=-1)[..., None, None]
    return F / norm.clamp_min(1e-9)


def run_7point(points1: torch.Tensor, points2: torch.Tensor) -> torch.Tensor:
    """7-point algorithm (B, 7, 2) x2 → (B, 3, 3, 3): up to three
    fundamental matrices, scaled to F[2, 2] = ±1; zero roots of the cubic
    give the pencil's F2 member (the reference's padding)."""
    check_shape(points1, ["B", "7", "2"], "points1")
    points1 = as_float(points1)
    points2 = as_float(points2)
    B = points1.shape[0]
    p1n, T1 = normalize_points(points1)
    p2n, T2 = normalize_points(points2)
    # the exact 2-dimensional nullspace by Householder QR of Aᵀ
    V = nullspace_qr(_design_matrix(p1n, p2n))  # (B, 9, 2)
    F1 = V[..., :, 0].reshape(B, 3, 3)
    F2 = V[..., :, 1].reshape(B, 3, 3)
    D = F1 - F2
    # det(F2 + λ·D) as a cubic: its values at λ = -1, 0, 1, 2 through the
    # exact inverse Vandermonde
    dvals = torch.stack([det_3x3(F2 + lam * D) for lam in
                         (-1.0, 0.0, 1.0, 2.0)], dim=-1)  # (B, 4)
    v_inv = torch.as_tensor(np.linalg.inv(np.vander([-1.0, 0.0, 1.0, 2.0],
                                                    4)),
                            dtype=points1.dtype, device=points1.device)
    lams = solve_cubic(dvals @ v_inv.T)  # (B, 3)
    Fs = F2[:, None] + lams[..., None, None] * D[:, None]
    Fs = T2.transpose(-1, -2)[:, None] @ Fs @ T1[:, None]
    norm = Fs[..., 2:3, 2:3].abs().clamp_min(1e-9)
    return Fs / torch.where(Fs[..., 2:3, 2:3] >= 0, norm, -norm)


def find_fundamental(points1: torch.Tensor, points2: torch.Tensor,
                     weights: Optional[torch.Tensor] = None,
                     method: str = "8POINT") -> torch.Tensor:
    """The weighted 8-point F, or the 7-point candidates."""
    if method.upper() == "8POINT":
        return run_8point(points1, points2, weights)
    if method.upper() == "7POINT":
        return run_7point(points1, points2)
    raise ValueError(f"unknown method {method}")


def normalize_transformation(M: torch.Tensor,
                             eps: float = 1e-8) -> torch.Tensor:
    """Scale so that the last element is 1."""
    last = M[..., -1:, -1:]
    return M / (last + torch.where(last >= 0, eps, -eps))


def compute_correspond_epilines(points: torch.Tensor,
                                F: torch.Tensor) -> torch.Tensor:
    """Epipolar lines F·p of (B, N, 2) points, scaled to a unit normal."""
    lines = _to_homog(as_float(points)) @ F.transpose(-1, -2)
    n = torch.linalg.vector_norm(lines[..., :2], dim=-1, keepdim=True)
    return lines / n.clamp_min(1e-9)


# -----------------------------------------------------------------------------
# Essential matrix — 5 point (hidden-variable resultant)
# -----------------------------------------------------------------------------

def _essential_constraints(E_basis: torch.Tensor) -> torch.Tensor:
    """The 10 cubic constraints on E = x E1 + y E2 + z E3 + E4: E_basis
    (B, 4, 3, 3) → (B, 10, 20) coefficients (multiply_deg_two_one_poly's
    monomial order): det E = 0 and 2 E Eᵀ E - tr(E Eᵀ) E = 0."""
    e = E_basis.movedim(1, -1)  # (B, 3, 3, 4)

    def d1_mul(i1, j1, i2, j2):
        return multiply_deg_one_poly(e[:, i1, j1], e[:, i2, j2])

    def d2_mul(p2, i, j):
        return multiply_deg_two_one_poly(p2, e[:, i, j])

    det = (d2_mul(d1_mul(1, 1, 2, 2) - d1_mul(1, 2, 2, 1), 0, 0)
           + d2_mul(d1_mul(1, 2, 2, 0) - d1_mul(1, 0, 2, 2), 0, 1)
           + d2_mul(d1_mul(1, 0, 2, 1) - d1_mul(1, 1, 2, 0), 0, 2))
    EEt = [[sum(d1_mul(i, k, j, k) for k in range(3)) for j in range(3)]
           for i in range(3)]
    tr = EEt[0][0] + EEt[1][1] + EEt[2][2]
    rows = []
    for i in range(3):
        for j in range(3):
            acc = sum(d2_mul(2.0 * EEt[i][k], k, j) for k in range(3))
            rows.append(acc - d2_mul(tr, i, j))
    return torch.stack([det] + rows, dim=1)


# (x, y)-monomial groups of the 20-monomial order, with the indices of their
# z-polynomial coefficients (ordered z⁰, z¹, z², z³)
_GROUPS = [[0], [1], [4], [10], [3, 2], [6, 5], [12, 11], [9, 8, 7],
           [15, 14, 13], [19, 18, 17, 16]]

# 11 Chebyshev nodes on [-1, 1] and the inverse Vandermonde (f64 on the host)
_NODES = np.cos((2 * np.arange(11) + 1) / 22.0 * np.pi)
_VAND_INV = np.linalg.inv(np.vander(_NODES, 11))  # coeffs z^10 ... z^0


def _c_matrix_at(constraints: torch.Tensor, z: torch.Tensor,
                 reverse: bool = False) -> torch.Tensor:
    """C(z) (..., 10, 10) from constraints (..., 10, 20) and z broadcast
    against (..., 1). With `reverse`, the column-reversed C̃(u) whose det
    has roots u = 1/z."""
    cols = []
    for idxs in _GROUPS:
        seq = list(reversed(idxs)) if reverse else idxs
        acc = constraints[..., seq[0]]
        zp = z
        for i in seq[1:]:
            acc = acc + constraints[..., i] * zp
            zp = zp * z
        cols.append(acc)
    return torch.stack(torch.broadcast_tensors(*cols), dim=-1)


def _monomials3(x, y, z):
    """Degree <= 3 monomials in multiply_deg_two_one_poly order."""
    one = torch.ones_like(x)
    return torch.stack(
        [x * x * x, x * x * y, x * x * z, x * x, x * y * y, x * y * z, x * y,
         x * z * z, x * z, x, y * y * y, y * y * z, y * y, y * z * z, y * z,
         y, z * z * z, z * z, z, one], dim=-1)


def _monomials3_jac(x, y, z):
    """d(monomials)/d(x, y, z): (..., 20, 3)."""
    o = torch.zeros_like(x)
    one = torch.ones_like(x)
    dx = [3 * x * x, 2 * x * y, 2 * x * z, 2 * x, y * y, y * z, y, z * z, z,
          one, o, o, o, o, o, o, o, o, o, o]
    dy = [o, x * x, o, o, 2 * x * y, x * z, x, o, o, o, 3 * y * y, 2 * y * z,
          2 * y, z * z, z, one, o, o, o, o]
    dz = [o, o, x * x, o, o, x * y, o, 2 * x * z, x, o, o, y * y, o,
          2 * y * z, y, o, 3 * z * z, 2 * z, one, o]
    return torch.stack([torch.stack(dx, -1), torch.stack(dy, -1),
                        torch.stack(dz, -1)], dim=-1)


def _polish_xyz(constraints: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                zs: torch.Tensor, iters: int = 6):
    """Damped Gauss-Newton on r(x, y, z) = C · mono(x, y, z) for every
    candidate root, within a trust radius around its seed so that distinct
    roots stay distinct. constraints (B, 10, 20); xs, ys, zs (B, R)."""
    xyz = torch.stack([xs, ys, zs], dim=-1)  # (B, R, 3)
    trust = 0.05 * (1.0 + torch.linalg.vector_norm(xyz, dim=-1))
    eye = torch.eye(3, dtype=xyz.dtype, device=xyz.device)

    def residual(p):
        m = _monomials3(p[..., 0], p[..., 1], p[..., 2])
        return torch.einsum("bce,bre->brc", constraints, m)

    for _ in range(iters):
        r = residual(xyz)  # (B, R, 10)
        J = torch.einsum("bce,brek->brck", constraints,
                         _monomials3_jac(xyz[..., 0], xyz[..., 1],
                                         xyz[..., 2]))  # (B, R, 10, 3)
        JtJ = J.transpose(-1, -2) @ J + 1e-10 * eye
        step = (inverse_3x3(JtJ) @ (J.transpose(-1, -2)
                                    @ r[..., None]))[..., 0]
        mag = torch.linalg.vector_norm(step, dim=-1)
        step = torch.where((mag > trust)[..., None],
                           step * (trust / mag)[..., None], step)
        new = xyz - step
        better = (residual(new) ** 2).sum(-1) < (r ** 2).sum(-1)
        xyz = torch.where(better[..., None], new, xyz)
    return xyz[..., 0], xyz[..., 1], xyz[..., 2]


@f32_matmul_precision
def run_5point(points1: torch.Tensor, points2: torch.Tensor,
               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """5-point essential solver (B, N, 2) → (B, 20, 3, 3) candidates, unit
    Frobenius norm, invalid ones zeroed (at least one survives)."""
    check_shape(points1, ["B", "N", "2"], "points1")
    points1 = as_float(points1)
    points2 = as_float(points2)
    B, N, _ = points1.shape
    dt, dev = points1.dtype, points1.device
    A = _design_matrix(points1, points2)  # (B, N, 9)
    if weights is not None:
        A = A * torch.sqrt(weights.clamp_min(0.0))[..., None]
    if N == 5:
        # exact 4-dim nullspace by Householder QR of Aᵀ
        V = nullspace_qr(A)  # (B, 9, 4)
    else:
        # overdetermined: the 4 smallest eigenvectors of AᵀA
        _, V = torch.linalg.eigh(torch.einsum("bni,bnj->bij", A, A))
        V = V[..., :, :4]
    E_basis = V.movedim(-1, 1).reshape(B, 4, 3, 3)

    constraints = _essential_constraints(E_basis)  # (B, 10, 20)
    constraints = constraints / torch.linalg.vector_norm(
        constraints, dim=-1, keepdim=True).clamp_min(1e-12)

    vinv = torch.as_tensor(_VAND_INV, dtype=dt, device=dev)

    def det_coeffs(reverse: bool) -> torch.Tensor:
        dets = [gauss_det(_c_matrix_at(
            constraints, torch.tensor(zk, dtype=dt, device=dev), reverse))
            for zk in _NODES]
        return torch.stack(dets, dim=-1) @ vinv.T  # (B, 11): z^10 ... z^0

    roots_fwd = poly_roots(det_coeffs(False), tol=1e-5)  # roots z
    roots_rev = poly_roots(det_coeffs(True), tol=1e-5)  # roots u = 1/z
    inv_u = 1.0 / torch.where(roots_rev.abs() > 1e-4, roots_rev,
                              torch.full_like(roots_rev, 1e-4))
    z_fwd = roots_fwd.real.clamp(-1.5, 1.5)
    u_rev = roots_rev.real

    def solve_root(v: torch.Tensor, reverse: bool):
        """(x, y) from the null vector of C(v) (or C̃(v)) per root."""
        Cv = _c_matrix_at(constraints[:, None], v[..., None], reverse)
        m = nullspace_inverse_iteration(Cv)  # (B, R, 10)
        w = m[..., 9]
        w_safe = torch.where(w.abs() > 1e-12, w, 1e-12)
        x = m[..., 7] / w_safe
        y = m[..., 8] / w_safe
        if reverse:
            v_safe = torch.where(v.abs() > 1e-6, v, 1e-6)
            return x / v_safe, y / v_safe
        return x, y

    xs_f, ys_f = solve_root(z_fwd, False)
    xs_r, ys_r = solve_root(u_rev, True)
    xs = torch.cat([xs_f, xs_r], dim=-1)
    ys = torch.cat([ys_f, ys_r], dim=-1)
    z_roots = torch.cat([z_fwd, inv_u.real], dim=-1)  # (B, 20)
    xs, ys, z_roots = _polish_xyz(constraints, xs, ys, z_roots, iters=6)

    E = (xs[..., None, None] * E_basis[:, None, 0]
         + ys[..., None, None] * E_basis[:, None, 1]
         + z_roots[..., None, None] * E_basis[:, None, 2]
         + E_basis[:, None, 3])  # (B, 20, 3, 3)
    R_cand = E.shape[1]
    E = E / torch.linalg.vector_norm(E.reshape(B, R_cand, 9), dim=-1
                                     )[..., None, None].clamp_min(1e-12)
    # validity: post-polish constraint residual, scale-invariant
    resid = torch.einsum("bce,bre->brc", constraints,
                         _monomials3(xs, ys, z_roots))
    scale2 = (1.0 + xs ** 2 + ys ** 2 + z_roots ** 2) ** 3
    r2 = (resid ** 2).sum(-1)
    ok = r2 < 1e-6 * scale2
    # the lowest-residual candidate always survives
    best = torch.argmin(r2 / scale2, dim=-1)
    ok = ok.clone()
    ok[torch.arange(B, device=dev), best] = True
    return torch.where(ok[..., None, None], E, 0.0)


# -----------------------------------------------------------------------------
# Manifold polish of essential candidates
# -----------------------------------------------------------------------------

def _hat(t: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 3, 3) skew-symmetric cross matrix."""
    z = torch.zeros_like(t[..., 0])
    return torch.stack([
        torch.stack([z, -t[..., 2], t[..., 1]], -1),
        torch.stack([t[..., 2], z, -t[..., 0]], -1),
        torch.stack([-t[..., 1], t[..., 0], z], -1)], dim=-2)


def _exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: (..., 3) tangent → (..., 3, 3) rotation, f32-safe at
    small angles."""
    th2 = (w * w).sum(-1)
    th = torch.sqrt(th2 + 1e-24)[..., None, None]
    K = _hat(w) / th
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    return torch.where((th2 > 1e-12)[..., None, None], R, eye + _hat(w))


def polish_essential(E: torch.Tensor, points1: torch.Tensor,
                     points2: torch.Tensor, iters: int = 3,
                     weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gauss-Newton polish of essential candidates on the (R, t) manifold
    (3 rotation + 2 tangent-sphere parameters), minimising the weighted
    epipolar residuals x2ᵀ [t]x R x1. Zero (invalid) candidates pass
    through; a polished candidate is kept only if its mean squared residual
    decreased. E (B, R, 3, 3); points (B, N, 2) normalized coordinates;
    weights (B, N). Returns (B, R, 3, 3)."""
    E = as_float(E)
    p1 = _to_homog(as_float(points1))  # (B, N, 3)
    p2 = _to_homog(as_float(points2))
    dt, dev = E.dtype, E.device
    sqw = (torch.ones(p1.shape[:2], dtype=dt, device=dev) if weights is None
           else torch.sqrt(as_float(weights).clamp_min(0.0)))  # (B, N)
    valid = E.abs().sum((-1, -2)) > 1e-8  # (B, R)
    eye = torch.eye(3, dtype=dt, device=dev)
    R1, _, t0 = decompose_essential_matrix(
        torch.where(valid[..., None, None], E, eye))
    Rm, t = R1, t0[..., 0]  # (B, R, 3, 3), (B, R, 3)

    def res(Em):  # (B, R, 3, 3) → (B, R, N)
        return sqw[:, None, :] * torch.einsum("bni,brij,bnj->brn", p2, Em, p1)

    basis = [_hat(eye[i]) for i in range(3)]
    for _ in range(iters):
        # orthonormal basis of the tangent plane at t
        e = eye[torch.argmin(t.abs(), dim=-1)]
        b1 = torch.linalg.cross(t, e)
        b1 = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True)
        b2 = torch.linalg.cross(t, b1)
        # residual and Jacobian at d = 0 (where t is renormalized):
        # rotation columns [t]x [e_i]x R, translation columns [ṫ]x R with
        # ṫ the derivative of the normalized t + b·d
        n = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
        tn0 = t / n
        r = res(_hat(tn0) @ Rm)
        cols = [res(_hat(tn0) @ (bi @ Rm)) for bi in basis]
        for bv in (b1, b2):
            tdot = bv / n - t * (t * bv).sum(-1, keepdim=True) / n ** 3
            cols.append(res(_hat(tdot) @ Rm))
        J = torch.stack(cols, dim=-1)  # (B, R, N, 5)
        JtJ = J.transpose(-1, -2) @ J + 1e-8 * torch.eye(5, dtype=dt,
                                                         device=dev)
        d = -torch.linalg.solve(JtJ, (J.transpose(-1, -2)
                                      @ r[..., None]))[..., 0]
        Rn = _exp_so3(d[..., :3]) @ Rm
        tn = t + b1 * d[..., 3:4] + b2 * d[..., 4:5]
        tn = tn / torch.linalg.vector_norm(tn, dim=-1, keepdim=True)
        better = (res(_hat(tn) @ Rn) ** 2).sum(-1) < (r * r).sum(-1)
        Rm = torch.where(better[..., None, None], Rn, Rm)
        t = torch.where(better[..., None], tn, t)
    E_pol = _hat(t) @ Rm / math.sqrt(2.0)

    def msr(Em):
        return (res(Em) ** 2).mean(-1)

    keep = valid & (msr(E_pol) < msr(E))
    return torch.where(keep[..., None, None], E_pol, E)


# -----------------------------------------------------------------------------
# Decomposition, triangulation, cheirality
# -----------------------------------------------------------------------------

def fundamental_from_essential(E: torch.Tensor, K1: torch.Tensor,
                               K2: torch.Tensor) -> torch.Tensor:
    """F = K2⁻ᵀ E K1⁻¹."""
    return inverse_3x3(K2).transpose(-1, -2) @ E @ inverse_3x3(K1)


def relative_camera_motion(R1: torch.Tensor, t1: torch.Tensor,
                           R2: torch.Tensor, t2: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(R, t) of camera 2 relative to camera 1 (world→camera poses, t as
    (..., 3, 1))."""
    R = R2 @ R1.transpose(-1, -2)
    return R, t2 - R @ t1


def essential_from_Rt(R1: torch.Tensor, t1: torch.Tensor, R2: torch.Tensor,
                      t2: torch.Tensor) -> torch.Tensor:
    """E = [t]ₓ R of two world→camera poses."""
    from .conversions import vector_to_skew_symmetric_matrix
    R, t = relative_camera_motion(R1, t1, R2, t2)
    return vector_to_skew_symmetric_matrix(t[..., 0]) @ R


def decompose_essential_matrix(E: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """E → (R1, R2, t) candidates via SVD, with proper rotations."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.where(torch.linalg.det(U) < 0, -1.0, 1.0)[..., None, None]
    Vt = Vt * torch.where(torch.linalg.det(Vt) < 0, -1.0, 1.0)[..., None,
                                                                 None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2:3]


def motion_from_essential(E: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All 4 (R, t) candidates: (B, 4, 3, 3), (B, 4, 3, 1)."""
    R1, R2, t = decompose_essential_matrix(E)
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-3))


def projection_from_KRt(K: torch.Tensor, R: torch.Tensor,
                        t: torch.Tensor) -> torch.Tensor:
    """P = K [R | t]."""
    return K @ torch.cat([R, t], dim=-1)


@f32_matmul_precision
def triangulate_points(P1: torch.Tensor, P2: torch.Tensor,
                       points1: torch.Tensor,
                       points2: torch.Tensor) -> torch.Tensor:
    """Batched DLT triangulation: P (B, 3, 4), points (B, N, 2) →
    (B, N, 3); the null vector by inverse iteration."""
    points1 = as_float(points1)
    points2 = as_float(points2)

    def rows(P, pts):
        r0 = pts[..., 0:1] * P[..., None, 2, :] - P[..., None, 0, :]
        r1 = pts[..., 1:2] * P[..., None, 2, :] - P[..., None, 1, :]
        return r0, r1

    a0, a1 = rows(P1, points1)
    a2, a3 = rows(P2, points2)
    A = torch.stack([a0, a1, a2, a3], dim=-2)  # (B, N, 4, 4)
    A = A / torch.linalg.vector_norm(A, dim=-1, keepdim=True).clamp_min(1e-9)
    X_h = nullspace_inverse_iteration(A, iters=3)
    w = X_h[..., 3:]
    return X_h[..., :3] / (w + torch.where(w >= 0, 1e-9, -1e-9))


def decompose_homography_matrix(H: torch.Tensor
                                ) -> Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]:
    """A calibrated homography H = R + t·nᵀ/d (normalised coordinates) →
    its four (R, t, n) candidates by Faugeras' SVD method:
    (R (B, 4, 3, 3), t (B, 4, 3, 1), n (B, 4, 3, 1)), each plane normal
    turned toward the camera (n_z > 0)."""
    U, D, Vt = torch.linalg.svd(H)
    d1, d2, d3 = D[..., 0], D[..., 1], D[..., 2]
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d1 = d1 / d2
    d3 = d3 / d2
    span = (d1 * d1 - d3 * d3).clamp_min(1e-12)
    x1 = torch.sqrt(((d1 * d1 - 1.0) / span).clamp_min(0.0))
    x3 = torch.sqrt(((1.0 - d3 * d3) / span).clamp_min(0.0))
    sin_t = torch.sqrt(((d1 * d1 - 1.0) * (1.0 - d3 * d3)).clamp_min(0.0)) \
        / (d1 + d3).clamp_min(1e-9)
    cos_t = (1.0 + d1 * d3) / (d1 + d3).clamp_min(1e-9)
    V = Vt.transpose(-1, -2)
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)
    Rs, ts, ns = [], [], []
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            st = e1 * e3 * sin_t
            Rp = torch.stack([torch.stack([cos_t, zero, -st], -1),
                              torch.stack([zero, one, zero], -1),
                              torch.stack([st, zero, cos_t], -1)], -2)
            tp = torch.stack([e1 * x1, zero, -e3 * x3], dim=-1)[..., None] \
                * (d1 - d3)[..., None, None]
            np_ = torch.stack([e1 * x1, zero, e3 * x3], dim=-1)[..., None]
            R = s[..., None, None] * U @ Rp @ Vt
            t = U @ tp
            n = V @ np_
            flip = torch.sign(n[..., 2, 0] + 1e-12)[..., None, None]
            Rs.append(R)
            ts.append(t * flip)
            ns.append(n * flip)
    return (torch.stack(Rs, dim=-3), torch.stack(ts, dim=-3),
            torch.stack(ns, dim=-3))


def motion_from_homography_choose_solution(
        H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
        mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The (R, t, n) of the four homography decompositions that puts the
    most triangulated (masked) points in front of both cameras
    (normalised coordinates) → (R (B, 3, 3), t (B, 3, 1), n (B, 3, 1))."""
    Rs, ts, ns = decompose_homography_matrix(H)
    B = H.shape[0]
    eye = torch.eye(3, dtype=H.dtype, device=H.device).expand(B, 3, 3)
    P1 = torch.cat([eye, torch.zeros((B, 3, 1), dtype=H.dtype,
                                     device=H.device)], dim=-1)
    counts = []
    for i in range(4):
        X = triangulate_points(P1, torch.cat([Rs[:, i], ts[:, i]], dim=-1),
                               x1, x2)
        X2 = torch.einsum("bij,bnj->bni", Rs[:, i], X) \
            + ts[:, i][..., 0][:, None]
        ok = (X[..., 2] > 0) & (X2[..., 2] > 0)
        if mask is not None:
            ok = ok & mask
        counts.append(ok.sum(-1))
    best = torch.argmax(torch.stack(counts, dim=-1), dim=-1)
    rows = torch.arange(B, device=H.device)
    return Rs[rows, best], ts[rows, best], ns[rows, best]


@f32_matmul_precision
def motion_from_essential_choose_solution(
        E: torch.Tensor, K1: torch.Tensor, K2: torch.Tensor,
        x1: torch.Tensor, x2: torch.Tensor,
        mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The cheirality-correct (R, t) of E by triangulated in-front counts
    → (R (B, 3, 3), t (B, 3, 1), X (B, N, 3))."""
    Rs, ts = motion_from_essential(E)
    B = E.shape[0]
    eye = torch.eye(3, dtype=E.dtype, device=E.device).expand(B, 3, 3)
    zero_t = torch.zeros((B, 3, 1), dtype=E.dtype, device=E.device)
    P1 = projection_from_KRt(K1, eye, zero_t)
    counts, Xs = [], []
    for i in range(4):
        R, t = Rs[:, i], ts[:, i]
        X = triangulate_points(P1, projection_from_KRt(K2, R, t), x1, x2)
        X2 = torch.einsum("bij,bnj->bni", R, X) + t[..., 0][:, None, :]
        ok = (X[..., 2] > 0) & (X2[..., 2] > 0)
        if mask is not None:
            ok = ok & mask
        counts.append(ok.sum(-1))
        Xs.append(X)
    best = torch.argmax(torch.stack(counts, dim=-1), dim=-1)  # (B,)
    rows = torch.arange(B, device=E.device)
    return Rs[rows, best], ts[rows, best], torch.stack(Xs, dim=1)[rows, best]


# -----------------------------------------------------------------------------
# Epipolar distances
# -----------------------------------------------------------------------------

def _epipolar_lines(pts1, pts2, Fm):
    p1 = _to_homog(as_float(pts1))
    p2 = _to_homog(as_float(pts2))
    line1_in_2 = p1 @ Fm.transpose(-1, -2)  # "...ij,...nj->...ni"
    line2_in_1 = p2 @ Fm
    numerator = (p2 * line1_in_2).sum(-1) ** 2
    return line1_in_2, line2_in_1, numerator


def sampson_epipolar_distance(pts1: torch.Tensor, pts2: torch.Tensor,
                              Fm: torch.Tensor, squared: bool = True,
                              eps: float = 1e-8) -> torch.Tensor:
    """First-order geometric error of correspondences under F."""
    l12, l21, num = _epipolar_lines(pts1, pts2, Fm)
    den = (l12[..., 0] ** 2 + l12[..., 1] ** 2
           + l21[..., 0] ** 2 + l21[..., 1] ** 2)
    out = num / den.clamp_min(eps)
    return out if squared else torch.sqrt(out + eps)


def symmetrical_epipolar_distance(pts1: torch.Tensor, pts2: torch.Tensor,
                                  Fm: torch.Tensor, squared: bool = True,
                                  eps: float = 1e-8) -> torch.Tensor:
    """Sum of squared point-to-epipolar-line distances in both images."""
    l12, l21, num = _epipolar_lines(pts1, pts2, Fm)
    den_inv = (1.0 / (l12[..., 0] ** 2 + l12[..., 1] ** 2).clamp_min(eps)
               + 1.0 / (l21[..., 0] ** 2 + l21[..., 1] ** 2).clamp_min(eps))
    out = num * den_inv
    return out if squared else torch.sqrt(out + eps)


def left_to_right_epipolar_distance(pts1: torch.Tensor, pts2: torch.Tensor,
                                    Fm: torch.Tensor) -> torch.Tensor:
    """Distance of p2 from its epipolar line F·p1."""
    p2 = _to_homog(as_float(pts2))
    line1_in_2 = _to_homog(as_float(pts1)) @ Fm.transpose(-1, -2)
    num = (p2 * line1_in_2).sum(-1).abs()
    return num / torch.sqrt(line1_in_2[..., 0] ** 2
                            + line1_in_2[..., 1] ** 2 + 1e-12)


def right_to_left_epipolar_distance(pts1: torch.Tensor, pts2: torch.Tensor,
                                    Fm: torch.Tensor) -> torch.Tensor:
    """Distance of p1 from its epipolar line Fᵀ·p2."""
    return left_to_right_epipolar_distance(pts2, pts1, Fm.transpose(-1, -2))


def find_essential(points1: torch.Tensor, points2: torch.Tensor,
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The 5-point solver's (B, 20, 3, 3) candidates."""
    return run_5point(points1, points2, weights)


def essential_from_fundamental(F: torch.Tensor, K1: torch.Tensor,
                               K2: torch.Tensor) -> torch.Tensor:
    """E = K2ᵀ F K1."""
    return K2.transpose(-1, -2) @ F @ K1


def KRt_from_projection(P: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """P → (K, R, t) by an RQ decomposition of P[:, :3] (the QR of the
    row-flipped transpose), K's diagonal made positive and K[2, 2] = 1."""
    M = P[..., :3]
    perm = [2, 1, 0]
    Q_, R_ = torch.linalg.qr(M[..., perm, :].transpose(-1, -2))
    K = R_.transpose(-1, -2)[..., perm, :][..., :, perm]
    R = Q_.transpose(-1, -2)[..., perm, :]
    sign = torch.sign(torch.diagonal(K, dim1=-2, dim2=-1))
    sign = torch.where(sign == 0, 1.0, sign)
    K = K * sign[..., None, :]
    R = R * sign[..., :, None]
    t = torch.linalg.solve(K, P[..., :, 3:4])
    K = K / K[..., 2:3, 2:3].clamp_min(1e-9)
    return K, R, t


def fundamental_from_projections(P1: torch.Tensor,
                                 P2: torch.Tensor) -> torch.Tensor:
    """F from two (..., 3, 4) projections by the 4x4 determinants of their
    row pairs."""
    X = [P1[..., [1, 2], :], P1[..., [2, 0], :], P1[..., [0, 1], :]]
    Y = [P2[..., [1, 2], :], P2[..., [2, 0], :], P2[..., [0, 1], :]]
    return torch.stack([
        torch.stack([torch.linalg.det(torch.cat([x, y], dim=-2)) for x in X],
                    dim=-1) for y in Y], dim=-2)


def projections_from_fundamental(F: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The canonical pair P1 = [I | 0], P2 = [[e']ₓ F | e'] (e' the null
    vector of Fᵀ, its sign LAPACK's choice)."""
    from .conversions import vector_to_skew_symmetric_matrix
    B = F.shape[0]
    P1 = torch.cat([torch.eye(3, dtype=F.dtype, device=F.device),
                    torch.zeros((3, 1), dtype=F.dtype, device=F.device)],
                   dim=-1).expand(B, 3, 4)
    e2 = lstsq_nullspace(F.transpose(-1, -2))
    P2 = torch.cat([vector_to_skew_symmetric_matrix(e2) @ F, e2[..., :, None]],
                   dim=-1)
    return P1, P2


def cross_product_matrix(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 3, 3) skew matrix."""
    from .conversions import vector_to_skew_symmetric_matrix
    return vector_to_skew_symmetric_matrix(x)


def intrinsics_like(focal: float, input: torch.Tensor) -> torch.Tensor:
    """(B, 3, 3) intrinsics with the principal point at the centre of the
    (B, C, H, W) input."""
    check(input.ndim == 4, f"expected (B, C, H, W), got {tuple(input.shape)}")
    check(focal > 0, f"focal must be positive, got {focal}")
    B, _, H, W = input.shape
    K = torch.tensor([[focal, 0.0, W / 2.0], [0.0, focal, H / 2.0],
                      [0.0, 0.0, 1.0]], dtype=as_float(input).dtype,
                     device=input.device)
    return K.expand(B, 3, 3)


def random_intrinsics(low, high, generator: Optional[torch.Generator] = None,
                      device="cuda") -> torch.Tensor:
    """(1, 3, 3) intrinsics with fx, fy, cx, cy ~ U[low, high), drawn from
    `generator` (None: one seeded with 0, as the reference's default key)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    fx, fy, cx, cy = low + (high - low) * torch.rand(
        4, generator=generator, device=generator.device)
    z, o = torch.zeros_like(fx), torch.ones_like(fx)
    return torch.stack([fx, z, cx, z, fy, cy, z, z, o]).reshape(1, 3, 3)


def scale_intrinsics(camera_matrix: torch.Tensor,
                     scale_factor) -> torch.Tensor:
    """Scale the focal lengths and the principal point."""
    K = as_float(camera_matrix)
    s = torch.as_tensor(scale_factor, dtype=K.dtype, device=K.device)
    mask = torch.zeros((3, 3), dtype=K.dtype, device=K.device)
    mask[0, 0] = mask[1, 1] = mask[0, 2] = mask[1, 2] = 1.0
    if s.ndim:
        s = s[..., None, None]
    return K * ((s - 1.0) * mask + 1.0)


def projection_from_Rt(rmat: torch.Tensor, tvec: torch.Tensor
                       ) -> torch.Tensor:
    """P = [R | t]."""
    check(tuple(rmat.shape[-2:]) == (3, 3),
          f"R must be (*, 3, 3), got {tuple(rmat.shape)}")
    check(tuple(tvec.shape[-2:]) == (3, 1),
          f"t must be (*, 3, 1), got {tuple(tvec.shape)}")
    return torch.cat([as_float(rmat), as_float(tvec)], dim=-1)


def depth_from_point(R: torch.Tensor, t: torch.Tensor,
                     X: torch.Tensor) -> torch.Tensor:
    """Depth (camera z) of (..., N, 3) world points under [R | t]."""
    Xc = R @ as_float(X).transpose(-2, -1)
    return Xc[..., 2, :] + t[..., 2, :]


def get_perpendicular(lines: torch.Tensor,
                      points: torch.Tensor) -> torch.Tensor:
    """The line through each point perpendicular to the given (a, b, c)
    line."""
    check_shape(lines, ["*", "N", "3"], "lines")
    if points.shape[-1] == 2:
        points = _to_homog(as_float(points))
    infinity_point = lines * torch.tensor([1.0, 1.0, 0.0], dtype=lines.dtype,
                                          device=lines.device)
    return torch.linalg.cross(points, infinity_point.expand_as(points))


def get_closest_point_on_epipolar_line(pts1: torch.Tensor,
                                       pts2: torch.Tensor,
                                       Fm: torch.Tensor) -> torch.Tensor:
    """Foot of the perpendicular from pts2 onto the epipolar line of
    pts1."""
    from .conversions import convert_points_from_homogeneous
    if pts1.shape[-1] == 2:
        pts1 = _to_homog(as_float(pts1))
    if pts2.shape[-1] == 2:
        pts2 = _to_homog(as_float(pts2))
    line1in2 = compute_correspond_epilines(pts1[..., :2], Fm)
    perp = get_perpendicular(line1in2, pts2)
    return convert_points_from_homogeneous(torch.linalg.cross(line1in2, perp))


def matrix_cofactor_tensor(M: torch.Tensor) -> torch.Tensor:
    """Cofactor matrix det(M)·M⁻ᵀ of (*, 3, 3) inputs from cross products
    of the columns (defined for singular M, such as E)."""
    c0 = torch.linalg.cross(M[..., 1], M[..., 2])
    c1 = torch.linalg.cross(M[..., 2], M[..., 0])
    c2 = torch.linalg.cross(M[..., 0], M[..., 1])
    return torch.stack([c0, c1, c2], dim=-1)


def decompose_essential_matrix_no_svd(E_mat: torch.Tensor
                                      ) -> Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor]:
    """(R1, R2, t) from E without an SVD: Horn's (1990) baseline and
    orientation formulas, cross products and one argmax."""
    check(tuple(E_mat.shape[-2:]) == (3, 3),
          f"E must be (*, 3, 3), got {tuple(E_mat.shape)}")
    E = as_float(E_mat).reshape(-1, 3, 3)
    e1, e2, e3 = E[..., 0], E[..., 1], E[..., 2]
    scale = torch.sqrt(0.5 * (E * E).sum((-1, -2)))
    crosses = torch.stack([torch.linalg.cross(e1, e2),
                           torch.linalg.cross(e2, e3),
                           torch.linalg.cross(e3, e1)], dim=1)  # (B, 3, 3)
    norms = torch.linalg.vector_norm(crosses, dim=-1, keepdim=True)
    largest = torch.argmax(norms[..., 0], dim=-1)
    scaled = scale[:, None, None] * crosses / norms.clamp_min(1e-12)
    b1 = torch.take_along_dim(scaled, largest[:, None, None].expand(-1, 1, 3),
                              dim=1)[:, 0]  # (B, 3)
    b1_unit = b1 / torch.linalg.vector_norm(b1, dim=-1,
                                            keepdim=True).clamp_min(1e-12)
    B1 = cross_product_matrix(b1)
    bb = (b1 * b1).sum(-1)[:, None, None].clamp_min(1e-12)
    cof = matrix_cofactor_tensor(E)
    return (cof - B1 @ E) / bb, (cof - (-B1) @ E) / bb, b1_unit[..., None]
