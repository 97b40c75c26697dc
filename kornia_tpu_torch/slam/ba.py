"""Bundle adjustment with a dense Schur complement (counterpart of
``kornia_tpu/slam/ba.py``).

State: camera poses as a batched Se3 (world→camera) and points (P, 3);
steps are tangent increments applied as exp(dx) ∘ T. Observations are
fixed arrays (O,) ``cam_idx`` / ``pt_idx`` / ``uv`` / ``valid``, so padded
lists need no special case.

- The per-observation 2×6 and 2×3 Jacobians are ``torch.func.jacfwd`` of
  the one-observation residual at zero tangents, under ``torch.func.vmap``:
  one forward-mode pass over the nine tangent directions.
- The normal equations keep the bipartite structure: H_cc (C, 6, 6) and
  H_pp (P, 3, 3) block-diagonal, summed with ``index_add_``, and the
  coupling W as a dense (C, P, 6, 3) scatter. The reduced camera system
  S = H_cc - W H_pp⁻¹ Wᵀ is one batched product, solved by Cholesky;
  points back-substitute through the 3×3 inverses.
- Levenberg-Marquardt with accept/reject runs a fixed number of
  iterations. State and λ stay on the device and are selected with
  ``torch.where``; no iteration reads a value on the host. On CUDA,
  ``index_add_`` sums with atomics, so two card runs differ in the last
  bits.
- A factorisation that fails does not raise: ``cholesky_ex`` reports it
  on the device and the factor is set to NaN, so the step's cost is NaN,
  fails ``new_cost < cost`` and λ grows, as the reference's NaN does.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch
from torch.func import jacfwd, vmap

from ..core.linalg import f32_matmul_precision
from ..geometry.liegroup import Quaternion, Se3, So3, _matvec
from ..losses.robust import (cauchy_weight, geman_mcclure_weight,
                             huber_weight, tukey_weight)

__all__ = ["BAProblem", "BAState", "bundle_adjust", "reprojection_residuals"]


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """Observations: cam_idx, pt_idx (O,) int64; uv (O, 2) pixels;
    valid (O,) bool (padding mask); K (3, 3) shared intrinsics."""

    cam_idx: torch.Tensor
    pt_idx: torch.Tensor
    uv: torch.Tensor
    valid: torch.Tensor
    K: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BAState:
    poses: Se3  # (C,) world→camera
    points: torch.Tensor  # (P, 3)


def _where_state(accept: torch.Tensor, a: BAState, b: BAState) -> BAState:
    return BAState(
        Se3(So3(Quaternion(torch.where(accept, a.poses.r.q.data,
                                       b.poses.r.q.data))),
            torch.where(accept, a.poses.t, b.poses.t)),
        torch.where(accept, a.points, b.points))


def _project(pose_q: torch.Tensor, pose_t: torch.Tensor, X: torch.Tensor,
             K: torch.Tensor) -> torch.Tensor:
    """Project world points with poses (wxyz quaternion + t)."""
    Xc = _matvec(So3.from_wxyz(pose_q).matrix(), X) + pose_t
    z = torch.where(Xc[..., 2].abs() > 1e-8, Xc[..., 2], 1e-8)
    u = K[..., 0, 0] * Xc[..., 0] / z + K[..., 0, 2]
    v = K[..., 1, 1] * Xc[..., 1] / z + K[..., 1, 2]
    return torch.stack([u, v], dim=-1)


def _residual_one(dx_cam: torch.Tensor, dx_pt: torch.Tensor,
                  pose_q: torch.Tensor, pose_t: torch.Tensor,
                  X: torch.Tensor, uv: torch.Tensor,
                  K: torch.Tensor) -> torch.Tensor:
    """Residual at a tangent perturbation (dx_cam (..., 6), dx_pt (..., 3));
    batched over leading dimensions."""
    dT = Se3.exp(dx_cam)
    Rd = dT.r.matrix()
    R_new = Rd @ So3.from_wxyz(pose_q).matrix()
    t_new = _matvec(Rd, pose_t) + dT.t
    Xc = _matvec(R_new, X + dx_pt) + t_new
    z = torch.where(Xc[..., 2].abs() > 1e-8, Xc[..., 2], 1e-8)
    u = K[..., 0, 0] * Xc[..., 0] / z + K[..., 0, 2]
    v = K[..., 1, 1] * Xc[..., 1] / z + K[..., 1, 2]
    return torch.stack([u, v], dim=-1) - uv


def _gather(state: BAState, problem: BAProblem):
    return (state.poses.r.q.data[problem.cam_idx],
            state.poses.t[problem.cam_idx], state.points[problem.pt_idx])


def _residuals(state: BAState, problem: BAProblem) -> torch.Tensor:
    """(O, 2) residuals at zero tangents, padding included."""
    q, t, X = _gather(state, problem)
    z = torch.zeros((), dtype=X.dtype, device=X.device)
    return _residual_one(z.expand(6), z.expand(3), q, t, X, problem.uv,
                         problem.K)


def _jacobians(state: BAState, problem: BAProblem
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-observation Jc (O, 2, 6) and Jp (O, 2, 3) at zero tangents."""
    q, t, X = _gather(state, problem)

    def res9(d, qq, tt, XX, uv, K):
        return _residual_one(d[:6], d[6:], qq, tt, XX, uv, K)

    d0 = torch.zeros(9, dtype=X.dtype, device=X.device)
    J = vmap(jacfwd(res9), in_dims=(None, 0, 0, 0, 0, None))(
        d0, q, t, X, problem.uv, problem.K)  # (O, 2, 9)
    return J[..., :6], J[..., 6:]


def reprojection_residuals(state: BAState,
                           problem: BAProblem) -> torch.Tensor:
    """(O, 2) residuals at the current state, zero where not valid."""
    return torch.where(problem.valid[:, None], _residuals(state, problem),
                       0.0)


def _weighted(state: BAState, problem: BAProblem, weight_fn: Callable):
    """Residuals, their squared norms and the IRLS weights (zero where not
    valid), and the robust cost sum(w r²)."""
    r = _residuals(state, problem)
    r2 = (r * r).sum(-1)
    w = weight_fn(r2) * problem.valid.to(r.dtype)
    return r, r2, w, (w * r2).sum()


def _cost(state: BAState, problem: BAProblem,
          weight_fn: Callable) -> torch.Tensor:
    return _weighted(state, problem, weight_fn)[3]


def _segment_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n, *x.shape[1:]), dtype=x.dtype,
                       device=x.device).index_add_(0, idx, x)


def _weighted_blocks(state: BAState, problem: BAProblem, weight_fn: Callable):
    """Weighted residuals r_w (O, 2), Jacobians Jc (O, 2, 6), Jp (O, 2, 3),
    the cost and the unweighted residuals."""
    r, _, w, cost = _weighted(state, problem, weight_fn)
    Jc, Jp = _jacobians(state, problem)
    sw = torch.sqrt(w)
    return r * sw[:, None], Jc * sw[:, None, None], Jp * sw[:, None, None], \
        cost, r


def _build_normal_eqs(state: BAState, problem: BAProblem, C: int, P: int,
                      weight_fn: Callable):
    """H_cc (C,6,6), H_pp (P,3,3), W (C,P,6,3), b_c (C,6), b_p (P,3), the
    cost and the residuals."""
    r_w, Jc, Jp, cost, r = _weighted_blocks(state, problem, weight_fn)
    H_cc = _segment_sum(torch.einsum("oki,okj->oij", Jc, Jc),
                        problem.cam_idx, C)
    H_pp = _segment_sum(torch.einsum("oki,okj->oij", Jp, Jp),
                        problem.pt_idx, P)
    b_c = _segment_sum(torch.einsum("oki,ok->oi", Jc, r_w), problem.cam_idx, C)
    b_p = _segment_sum(torch.einsum("oki,ok->oi", Jp, r_w), problem.pt_idx, P)
    # dense coupling: the per-observation blocks scattered into (C, P, 6, 3)
    W = _segment_sum(torch.einsum("oki,okj->oij", Jc, Jp),
                     problem.cam_idx * P + problem.pt_idx, C * P)
    return H_cc, H_pp, W.view(C, P, 6, 3), b_c, b_p, cost, r


def _fix_gauge(S_mat: torch.Tensor, rhs: torch.Tensor, n_fix: int,
               block: int):
    """Zero the first n_fix blocks' rows, columns and right-hand side, unit
    diagonal there. Writes both tensors in place (each caller's are fresh);
    at the pose graph's sizes a masked copy would cost its (6N)² bytes
    three times over."""
    k = n_fix * block
    S_mat[:k] = 0.0
    S_mat[:, :k] = 0.0
    S_mat.diagonal()[:k] = 1.0
    rhs[:k] = 0.0
    return S_mat, rhs


def _cholesky_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x of (A + 1e-8 I) x = b for SPD A (n, n), b (n,), through Cholesky;
    A's diagonal is written in place. A failed factorisation gives NaN
    (the reference's semantics), without a host read of its status."""
    A.diagonal().add_(1e-8)
    L, info = torch.linalg.cholesky_ex(A, check_errors=False)
    y = torch.linalg.solve_triangular(L, b[:, None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(0, 1), y, upper=True)[:, 0]
    # the status is applied to the (n,) solution, not to the (n, n) factor:
    # at the pose graph's sizes a masked copy of L is hundreds of MB
    return torch.where(info == 0, x, torch.nan)


def _inv(A: torch.Tensor) -> torch.Tensor:
    """Batched LU inverse; a singular block gives inf/NaN, not an error."""
    return torch.linalg.inv_ex(A, check_errors=False)[0]


def _add_diag_blocks(S: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """S (C, C, b, b) with D (C, b, b) added to its diagonal blocks."""
    torch.diagonal(S, dim1=0, dim2=1).add_(D.permute(1, 2, 0))
    return S


def _reduced_system(H_cc, H_pp, W, b_c, b_p, lam, fix_first_cam: int):
    """The damped reduced camera system through the Schur complement:
    S (C·6, C·6) and its right-hand side, gauge-fixed, and H_pp⁻¹."""
    C = H_cc.shape[0]
    eye6 = torch.eye(6, dtype=H_cc.dtype, device=H_cc.device)
    eye3 = torch.eye(3, dtype=H_pp.dtype, device=H_pp.device)
    Hpp_inv = _inv(H_pp + lam * eye3)
    WHinv = torch.einsum("cpij,pjk->cpik", W, Hpp_inv)  # (C, P, 6, 3)
    S = -torch.einsum("cpik,dpjk->cdij", WHinv, W)  # (C, C, 6, 6)
    S = _add_diag_blocks(S, H_cc + lam * eye6)
    rhs = b_c - torch.einsum("cpik,pk->ci", WHinv, b_p)
    S_mat = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    rhs_vec = rhs.reshape(C * 6)
    n_fix = int(fix_first_cam)
    if n_fix:
        # monocular windows fix TWO cameras: the 6-dof frame and the scale
        S_mat, rhs_vec = _fix_gauge(S_mat, rhs_vec, n_fix, 6)
    return S_mat, rhs_vec, Hpp_inv


def _schur_solve(H_cc, H_pp, W, b_c, b_p, lam, fix_first_cam: int):
    """The GN step (dx_c (C, 6), dx_p (P, 3)) solving the damped H dx = -b:
    the reduced camera system by Cholesky, points back-substituted."""
    S_mat, rhs_vec, Hpp_inv = _reduced_system(H_cc, H_pp, W, b_c, b_p, lam,
                                              fix_first_cam)
    dx_c = _cholesky_solve(S_mat, rhs_vec).reshape(H_cc.shape[0], 6)
    Wt_dxc = torch.einsum("cpij,ci->pj", W, dx_c)
    dx_p = torch.einsum("pij,pj->pi", Hpp_inv, b_p - Wt_dxc)
    return -dx_c, -dx_p


def _zero_first(dx: torch.Tensor, n: int) -> torch.Tensor:
    """dx with its first n rows set to exactly 0 (NaN rows too)."""
    return torch.cat([torch.zeros_like(dx[:n]), dx[n:]])


def _apply_step(state: BAState, dx_c: torch.Tensor,
                dx_p: torch.Tensor) -> BAState:
    dT = Se3.exp(dx_c)
    new_t = _matvec(dT.r.matrix(), state.poses.t) + dT.t
    return BAState(Se3(dT.r * state.poses.r, new_t), state.points + dx_p)


def _robust_kernels(robust_delta: float) -> dict:
    """The IRLS weight of each robust kernel at scale `robust_delta`."""
    return {
        "huber": lambda r2: huber_weight(r2, robust_delta),
        "cauchy": lambda r2: cauchy_weight(r2, robust_delta),
        "geman_mcclure": lambda r2: geman_mcclure_weight(r2, robust_delta),
        "tukey": lambda r2: tukey_weight(r2, 3.0 * robust_delta),
        "none": torch.ones_like,
    }


def _lm_update(accept: torch.Tensor, lam: torch.Tensor, lo: float,
              hi: float) -> torch.Tensor:
    """λ halves on an accepted step and quadruples on a rejected one."""
    return torch.where(accept, lam * 0.5, lam * 4.0).clamp(lo, hi)


@f32_matmul_precision
def bundle_adjust(
    state: BAState,
    problem: BAProblem,
    num_cameras: int,
    num_points: int,
    num_iters: int = 10,
    init_lambda: float = 1e-3,
    robust_delta: float = 3.0,
    robust: str = "huber",
    fix_first_cam: int = 1,
) -> Tuple[BAState, torch.Tensor]:
    """Levenberg-Marquardt BA → (state, per-iteration costs (num_iters,)).

    fix_first_cam: the number of leading cameras held fixed for gauge
    freedom (True == 1); monocular sliding windows fix 2, the second pose
    anchoring the scale.

    robust: 'huber' | 'cauchy' | 'geman_mcclure' | 'tukey' | 'none'.
    The redescending kernels (tukey, geman_mcclure) reject everything from
    a poor start; use them to polish, or through ``bundle_adjust_sparse``'s
    graduated non-convexity."""
    C, P = num_cameras, num_points
    weight_fn = _robust_kernels(robust_delta)[robust]
    n_fix = int(fix_first_cam)
    lam = torch.full((), init_lambda, dtype=state.points.dtype,
                     device=state.points.device)
    costs = []
    for _ in range(num_iters):
        H_cc, H_pp, W, b_c, b_p, cost, _ = _build_normal_eqs(
            state, problem, C, P, weight_fn)
        dx_c, dx_p = _schur_solve(H_cc, H_pp, W, b_c, b_p, lam, n_fix)
        if n_fix:
            dx_c = _zero_first(dx_c, n_fix)
        new_state = _apply_step(state, dx_c, dx_p)
        new_cost = _cost(new_state, problem, weight_fn)
        accept = new_cost < cost
        state = _where_state(accept, new_state, state)
        lam = _lm_update(accept, lam, 1e-8, 1e4)
        costs.append(torch.where(accept, new_cost, cost))
    return state, torch.stack(costs)
