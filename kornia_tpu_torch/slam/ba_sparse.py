"""Bundle adjustment with a sparse Schur complement and graduated
non-convexity (counterpart of ``kornia_tpu/slam/ba_sparse.py``).

The dense path (``ba.py``) materialises the coupling W as (C, P, 6, 3) and
pays an O(C² P) product for the reduced camera system. Here observations
are regrouped into padded per-point tables (P, T) with a mask (T = the
longest track), and S = H_cc - W H_pp⁻¹ Wᵀ is assembled from per-point
camera-pair blocks (P, T, T, 6, 6) scattered by camera pair with
``index_add_``: O(P T²) work and memory.

Graduated non-convexity (Yang et al. 2020) anneals the robust kernel's
scale from about the largest initial residual down to the target over
``gnc_stages`` stages, which lets the redescending kernels (tukey,
geman_mcclure, welsch) start far from the optimum. The annealing scale is
a device scalar: no stage reads it on the host.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..core.linalg import f32_matmul_precision
from ..losses.robust import (cauchy_weight, geman_mcclure_weight,
                             huber_weight, tukey_weight, welsch_weight)
from .ba import (BAProblem, BAState, _add_diag_blocks, _apply_step,
                 _cholesky_solve, _cost, _fix_gauge, _inv, _lm_update,
                 _robust_kernels, _segment_sum, _weighted_blocks,
                 _where_state, _zero_first, reprojection_residuals)

__all__ = ["build_point_tables", "bundle_adjust_sparse", "gnc_weight_fn"]


def build_point_tables(cam_idx: np.ndarray, pt_idx: np.ndarray,
                       valid: np.ndarray, num_points: int,
                       max_track: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Host side: group observation indices by point.

    Returns (obs_idx (P, T) int32 indices into the observation arrays,
    obs_mask (P, T) bool). T = max_track or the longest observed track.
    """
    pt = np.asarray(pt_idx)
    v = np.asarray(valid).astype(bool)
    P = num_points
    lists: list[list[int]] = [[] for _ in range(P)]
    for o in range(pt.shape[0]):
        if v[o]:
            lists[int(pt[o])].append(o)
    T = max_track or max((len(l) for l in lists), default=1)
    T = max(T, 1)
    obs_idx = np.zeros((P, T), np.int32)
    obs_mask = np.zeros((P, T), bool)
    for p, l in enumerate(lists):
        n = min(len(l), T)
        obs_idx[p, :n] = l[:n]
        obs_mask[p, :n] = True
    return obs_idx, obs_mask


_GNC_KERNELS = {
    "tukey": tukey_weight,
    "geman_mcclure": geman_mcclure_weight,
    "welsch": welsch_weight,
    "cauchy": cauchy_weight,
    "huber": huber_weight,
}


def gnc_weight_fn(base: str, delta: float, mu: torch.Tensor) -> Callable:
    """The GNC surrogate weight: the kernel at scale sqrt(mu) * delta.

    mu ≥ 1; mu → 1 is the target kernel, a large mu approaches the
    quadratic (all-inlier) loss (the GNC-GM schedule of Yang et al. 2020,
    written on the scale)."""
    k = _GNC_KERNELS[base]

    def fn(r2):
        return k(r2, torch.sqrt(mu) * delta)

    return fn


def _sparse_system(state, lam, problem, obs_idx, obs_mask, C, P, weight_fn,
                   fix_first_cam):
    """The damped reduced camera system assembled from per-point camera-pair
    blocks: S (C·6, C·6) and its right-hand side (gauge-fixed), what the
    point back-substitution needs, and the cost."""
    r_w, Jc, Jp, cost, _ = _weighted_blocks(state, problem, weight_fn)
    cam = problem.cam_idx
    H_cc = _segment_sum(torch.einsum("oki,okj->oij", Jc, Jc), cam, C)
    H_pp = _segment_sum(torch.einsum("oki,okj->oij", Jp, Jp),
                        problem.pt_idx, P)
    b_c = _segment_sum(torch.einsum("oki,ok->oi", Jc, r_w), cam, C)
    b_p = _segment_sum(torch.einsum("oki,ok->oi", Jp, r_w), problem.pt_idx, P)
    W_obs = torch.einsum("oki,okj->oij", Jc, Jp)  # (O, 6, 3)

    eye6 = torch.eye(6, dtype=H_cc.dtype, device=H_cc.device)
    eye3 = torch.eye(3, dtype=H_pp.dtype, device=H_pp.device)
    Hpp_inv = _inv(H_pp + lam * eye3)  # (P, 3, 3)

    # per-point padded gathers
    m = obs_mask.to(r_w.dtype)  # (P, T)
    Wp = W_obs[obs_idx] * m[..., None, None]  # (P, T, 6, 3)
    cams = cam[obs_idx]  # (P, T)
    WHinv = torch.einsum("ptij,pjk->ptik", Wp, Hpp_inv)  # (P, T, 6, 3)

    # reduced camera system: (P, T, T) camera-pair blocks by camera pair
    S_pairs = torch.einsum("ptik,psjk->ptsij", WHinv, Wp)  # (P, T, T, 6, 6)
    pair_idx = (cams[:, :, None] * C + cams[:, None, :]).reshape(-1)
    S_off = _segment_sum(S_pairs.reshape(-1, 6, 6), pair_idx, C * C)
    S = _add_diag_blocks(-S_off.view(C, C, 6, 6), H_cc + lam * eye6)

    # reduced rhs: b_c - sum_p WHinv_p b_p[p], scattered by camera
    rhs_obs = torch.einsum("ptik,pk->pti", WHinv, b_p)  # (P, T, 6)
    rhs = b_c - _segment_sum(rhs_obs.reshape(-1, 6), cams.reshape(-1), C)

    S_mat = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    rhs_vec = rhs.reshape(C * 6)
    if fix_first_cam:
        S_mat, rhs_vec = _fix_gauge(S_mat, rhs_vec, 1, 6)
    return S_mat, rhs_vec, (Hpp_inv, Wp, cams, b_p), cost


def _sparse_lm_step(state, lam, problem, obs_idx, obs_mask, C, P,
                    weight_fn, fix_first_cam):
    S_mat, rhs_vec, (Hpp_inv, Wp, cams, b_p), cost = _sparse_system(
        state, lam, problem, obs_idx, obs_mask, C, P, weight_fn,
        fix_first_cam)
    dx_c = _cholesky_solve(S_mat, rhs_vec).reshape(C, 6)
    # back-substitution: dx_p = Hpp_inv (b_p - sum_t W_ptᵀ dx_c[cam_pt])
    Wt_dxc = torch.einsum("ptij,pti->pj", Wp, dx_c[cams])
    dx_p = torch.einsum("pij,pj->pi", Hpp_inv, b_p - Wt_dxc)
    return -dx_c, -dx_p, cost


@f32_matmul_precision
def bundle_adjust_sparse(
    state: BAState,
    problem: BAProblem,
    obs_idx: torch.Tensor,
    obs_mask: torch.Tensor,
    num_cameras: int,
    num_points: int,
    num_iters: int = 10,
    init_lambda: float = 1e-3,
    robust_delta: float = 3.0,
    robust: str = "huber",
    fix_first_cam: bool = True,
    gnc_stages: int = 0,
) -> Tuple[BAState, torch.Tensor]:
    """LM bundle adjustment with sparse Schur assembly.

    obs_idx/obs_mask come from `build_point_tables`. With `gnc_stages > 0`
    the robust kernel's scale is annealed over that many stages (needed by
    the redescending kernels far from the optimum). Returns (state,
    per-iteration costs); with GNC, num_iters is the total, split evenly
    over the stages. fix_first_cam holds camera 0 only (a bool, unlike the
    dense path's count)."""
    C, P = num_cameras, num_points
    obs_idx = obs_idx.long()

    def run(state, lam, weight_fn, iters):
        costs = []
        for _ in range(iters):
            dx_c, dx_p, cost = _sparse_lm_step(
                state, lam, problem, obs_idx, obs_mask, C, P, weight_fn,
                fix_first_cam)
            if fix_first_cam:
                dx_c = _zero_first(dx_c, 1)
            new_state = _apply_step(state, dx_c, dx_p)
            new_cost = _cost(new_state, problem, weight_fn)
            accept = new_cost < cost
            state = _where_state(accept, new_state, state)
            lam = _lm_update(accept, lam, 1e-8, 1e4)
            costs.append(torch.where(accept, new_cost, cost))
        return state, lam, costs

    lam = torch.full((), init_lambda, dtype=state.points.dtype,
                     device=state.points.device)
    if gnc_stages <= 0:
        kernels = _robust_kernels(robust_delta)
        kernels["welsch"] = lambda r2: welsch_weight(r2, robust_delta)
        state, _, costs = run(state, lam, kernels[robust], num_iters)
        return state, torch.stack(costs)

    # GNC: mu anneals geometrically from mu0 (quadratic-like) to 1 (the
    # target); mu0 comes from the worst initial residual, so the first
    # stage treats everything as an inlier (Yang et al. 2020 §III-B)
    iters_per = max(num_iters // gnc_stages, 1)
    r0 = reprojection_residuals(state, problem)
    r2max = (r0 * r0).sum(-1).max()
    mu0 = (2.0 * r2max / (robust_delta * robust_delta)).clamp(2.0, 1e8)
    factor = mu0 ** (-1.0 / max(gnc_stages - 1, 1))
    costs_all = []
    for s in range(gnc_stages):
        mu = mu0 * factor ** s
        state, lam, costs = run(state, lam,
                                gnc_weight_fn(robust, robust_delta, mu),
                                iters_per)
        costs_all += costs
    return state, torch.stack(costs_all)
