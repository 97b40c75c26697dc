"""Distributed bundle adjustment over a mesh of SPMD ranks (counterpart of
``kornia_tpu/parallel/dist_ba.py``).

The map is sharded along points, as in the reference: each rank on the
``data`` axis owns a block of points and the observations of those points
(cameras are replicated, observations never straddle ranks). Each rank
builds its local normal equations (``slam/ba.py``'s batched Jacobians on
its block), its H_pp blocks and its partial reduced camera system
S_local = W·H_pp⁻¹·Wᵀ. Where the reference ``psum``s {H_cc, b_c, cost, S,
rhs} in one LM iteration, the five are packed into one flat buffer and
summed with ONE ``all_reduce``; every rank then solves the replicated
camera system redundantly (the summed buffer is bitwise the same on every
rank, so every rank takes the same step and the same accept decision) and
back-substitutes its OWN point block with no further traffic. The
after-step cost is each rank's local weighted cost, all-reduced: a second,
scalar collective.

Global in, global out: the caller passes the global arrays (observations
(D · O_shard,), points (D · P_local, 3)), each rank takes its block
[r·n, (r+1)·n), and the global state comes back on every rank through one
``all_gather`` of the point blocks after the last iteration.

Interface contract, as the reference's: observations are pre-partitioned
by point block, ``pt_idx`` is LOCAL to the shard and ``cam_idx`` global;
padding rows have valid=False.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ..core.linalg import f32_matmul_precision
from ..geometry.liegroup import Quaternion, Se3, So3
from ..losses.robust import huber_weight
from ..slam.ba import (BAProblem, BAState, _add_diag_blocks, _apply_step,
                       _build_normal_eqs, _cholesky_solve, _cost, _fix_gauge,
                       _inv, _lm_update, _segment_sum, _weighted_blocks,
                       _where_state, _zero_first)
from .mesh import Mesh, data_sharding

__all__ = ["distributed_bundle_adjust", "distributed_bundle_adjust_sparse",
           "build_sharded_point_tables"]


def _all_reduce_packed(mesh: Mesh, parts: List[torch.Tensor]
                       ) -> List[torch.Tensor]:
    """The sums over ``data`` of several tensors, through one all_reduce
    of their concatenation."""
    buf = mesh.all_reduce(torch.cat([p.reshape(-1) for p in parts]))
    out, i = [], 0
    for p in parts:
        out.append(buf[i:i + p.numel()].view(p.shape))
        i += p.numel()
    return out


def _local(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of a global array sharded on its leading axis."""
    return data_sharding(mesh, x.dim()).local(x)


def _replicated(mesh: Mesh, state: BAState, points_l: torch.Tensor
                ) -> BAState:
    return BAState(Se3(So3(Quaternion(state.poses.r.q.data.to(mesh.device))),
                       state.poses.t.to(mesh.device)), points_l)


def _gather_state(mesh: Mesh, state_l: BAState) -> BAState:
    """The global state from every rank's point block."""
    return BAState(state_l.poses, mesh.all_gather(state_l.points))


def _lm_iteration(mesh: Mesh, state: BAState, lam: torch.Tensor,
                  system: Callable, cost_of: Callable, fix_first_cam: bool
                  ) -> Tuple[BAState, torch.Tensor, torch.Tensor]:
    """One LM iteration on this rank's block: the step from the summed
    system, the summed cost after it, accept or reject on the device."""
    dx_c, dx_p, cost = system(state, lam)
    if fix_first_cam:
        dx_c = _zero_first(dx_c, 1)
    new_state = _apply_step(state, dx_c, dx_p)
    new_cost = mesh.all_reduce(cost_of(new_state))
    accept = new_cost < cost
    return (_where_state(accept, new_state, state),
            _lm_update(accept, lam, 1e-8, 1e4),
            torch.where(accept, new_cost, cost))


def _lm(mesh, state, init_lambda, num_iters, system, cost_of,
        fix_first_cam):
    lam = torch.full((), float(init_lambda), dtype=state.points.dtype,
                     device=state.points.device)
    costs = []
    for _ in range(num_iters):
        state, lam, cost = _lm_iteration(mesh, state, lam, system, cost_of,
                                         fix_first_cam)
        costs.append(cost)
    return _gather_state(mesh, state), torch.stack(costs)


# -----------------------------------------------------------------------------
# Dense coupling (VO-window scale)
# -----------------------------------------------------------------------------

def _local_normal_eqs(state_l: BAState, problem_l: BAProblem, C: int,
                      P_local: int, weight_fn: Callable):
    """Per-shard normal equations: ``slam.ba._build_normal_eqs`` on the
    rank's point block."""
    return _build_normal_eqs(state_l, problem_l, C, P_local, weight_fn)[:6]


def _dense_system(mesh: Mesh, state_l: BAState, problem_l: BAProblem,
                  lam: torch.Tensor, C: int, P_local: int,
                  weight_fn: Callable, fix_first_cam: bool):
    """The summed, damped, gauge-fixed reduced camera system S (C·6, C·6),
    its right-hand side, the summed cost, and the rank's (W, H_pp⁻¹, b_p)."""
    H_cc, H_pp, W, b_c, b_p, cost = _local_normal_eqs(
        state_l, problem_l, C, P_local, weight_fn)
    eye3 = torch.eye(3, dtype=H_pp.dtype, device=H_pp.device)
    eye6 = torch.eye(6, dtype=H_cc.dtype, device=H_cc.device)
    Hpp_inv = _inv(H_pp + lam * eye3)
    WHinv = torch.einsum("cpij,pjk->cpik", W, Hpp_inv)
    S_local = torch.einsum("cpik,dpjk->cdij", WHinv, W)
    rhs_local = torch.einsum("cpik,pk->ci", WHinv, b_p)
    H_cc, b_c, cost, S, rhs_red = _all_reduce_packed(
        mesh, [H_cc, b_c, cost, S_local, rhs_local])
    S = _add_diag_blocks(-S, H_cc + lam * eye6)
    S_mat = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    rhs = (b_c - rhs_red).reshape(C * 6)
    if fix_first_cam:
        S_mat, rhs = _fix_gauge(S_mat, rhs, 1, 6)
    return S_mat, rhs, cost, (W, Hpp_inv, b_p)


def _dense_blocks(mesh: Mesh, state: BAState, cam_idx, pt_idx, uv, valid,
                  K) -> Tuple[BAState, BAProblem]:
    """This rank's state (replicated poses, its point block) and its
    observations, on the mesh's device."""
    problem_l = BAProblem(_local(mesh, cam_idx).long(),
                          _local(mesh, pt_idx).long(), _local(mesh, uv),
                          _local(mesh, valid).bool(), K.to(mesh.device))
    return _replicated(mesh, state, _local(mesh, state.points)), problem_l


def _dense_step_fns(mesh, problem_l, C, P_local, weight_fn, fix_first_cam):
    def system(state_l, lam):
        S_mat, rhs, cost, (W, Hpp_inv, b_p) = _dense_system(
            mesh, state_l, problem_l, lam, C, P_local, weight_fn,
            fix_first_cam)
        sol = _cholesky_solve(S_mat, rhs).reshape(C, 6)
        # local point back-substitution: no communication
        Wt_dxc = torch.einsum("cpij,ci->pj", W, sol)
        dx_p = torch.einsum("pij,pj->pi", Hpp_inv, b_p - Wt_dxc)
        return -sol, -dx_p, cost

    def cost_of(state_l):
        return _cost(state_l, problem_l, weight_fn)

    return system, cost_of


@f32_matmul_precision
def distributed_bundle_adjust(
    mesh: Mesh,
    state: BAState,
    cam_idx: torch.Tensor,  # (D * O_shard,) global camera ids
    pt_idx: torch.Tensor,  # (D * O_shard,) LOCAL point ids within each shard
    uv: torch.Tensor,  # (D * O_shard, 2)
    valid: torch.Tensor,  # (D * O_shard,)
    K: torch.Tensor,
    num_cameras: int,
    num_iters: int = 8,
    init_lambda: float = 1e-3,
    robust_delta: float = 3.0,
    fix_first_cam: bool = True,
) -> Tuple[BAState, torch.Tensor]:
    """LM bundle adjustment with the map sharded over ``mesh['data']``.

    `state.points` has shape (D * P_shard, 3); poses are replicated.
    Returns the optimized global state and the costs (num_iters,), on
    every rank.

    DENSE coupling path — VO-window scale ONLY: every LM iteration
    materializes a per-shard (C, P_local, 6, 3) block, so memory grows as
    cameras x local points. Beyond the guard below use
    `distributed_bundle_adjust_sparse` (per-point track tables, O(chunk)
    memory).
    """
    C = num_cameras
    D = mesh.shape["data"]
    P_local = state.points.shape[0] // D
    # refusing beats running out of memory at SfM scale: the coupling
    # block alone is C * P_local * 18 floats per shard
    coupling_mb = C * P_local * 18 * 4 / 1e6
    if coupling_mb > 512:
        raise ValueError(
            f"distributed_bundle_adjust (dense) would materialize a "
            f"{coupling_mb:.0f} MB coupling block per shard "
            f"(C={C}, P_local={P_local}); use "
            f"distributed_bundle_adjust_sparse for problems this size")
    weight_fn = lambda r2: huber_weight(r2, robust_delta)
    state_l, problem_l = _dense_blocks(mesh, state, cam_idx, pt_idx, uv,
                                       valid, K)
    system, cost_of = _dense_step_fns(mesh, problem_l, C, P_local,
                                      weight_fn, fix_first_cam)
    return _lm(mesh, state_l, init_lambda, num_iters, system, cost_of,
               fix_first_cam)


# -----------------------------------------------------------------------------
# Sparse-Schur distributed BA (SfM scale)
# -----------------------------------------------------------------------------
#
# The dense path materialises the camera-point coupling W as (C, P_local, 6,
# 3), O(C·P) per shard. Here the map is stored as padded per-point track
# tables (P_local, T) of cameras, uv and mask, and the reduced camera system
# is assembled from per-point camera-pair blocks, a chunk of points at a
# time, so that per-rank memory is O(chunk · T² · 36) + O(C² · 36) floats,
# independent of P. Communication per LM iteration is still ONE packed
# all_reduce of {S (C²·36), H_cc, b_c, rhs, cost}, plus the scalar
# after-step cost.


def build_sharded_point_tables(cam_idx, pt_idx, uv, valid, num_points,
                               max_track: int = 0):
    """Host-side: regroup flat observations into per-point track tables.

    Points are assumed contiguously partitioned (shard s owns global ids
    [s*P_local, (s+1)*P_local)); `pt_idx` is GLOBAL here. Returns
    (cams (P, T) int32, uv_t (P, T, 2) f32, mask (P, T) bool), each rank
    taking its block of the leading axis.
    """
    pt = np.asarray(pt_idx)
    v = np.asarray(valid).astype(bool)
    cam = np.asarray(cam_idx)
    uvn = np.asarray(uv)
    counts = np.zeros(num_points, np.int64)
    order = np.argsort(pt, kind="stable")
    T = max_track
    if not T:
        cnt = np.bincount(pt[v], minlength=num_points)
        T = max(int(cnt.max()) if cnt.size else 1, 1)
    cams_t = np.zeros((num_points, T), np.int32)
    uv_t = np.zeros((num_points, T, 2), np.float32)
    mask_t = np.zeros((num_points, T), bool)
    for o in order:
        if not v[o]:
            continue
        p = int(pt[o])
        c = counts[p]
        if c < T:
            cams_t[p, c] = cam[o]
            uv_t[p, c] = uvn[o]
            mask_t[p, c] = True
            counts[p] = c + 1
    return cams_t, uv_t, mask_t


def _table_problem(cams: torch.Tensor, uv: torch.Tensor, mask: torch.Tensor,
                   K: torch.Tensor) -> BAProblem:
    """The (P_l, T) tables as flat observations of the local points."""
    P_l, T = cams.shape
    pts = torch.arange(P_l, device=cams.device).repeat_interleave(T)
    return BAProblem(cams.reshape(-1), pts, uv.reshape(-1, 2),
                     mask.reshape(-1), K)


def _sparse_local_eqs(state_l: BAState, problem_l: BAProblem, C: int,
                      weight_fn: Callable, lam: torch.Tensor, chunk: int):
    """Per-shard sparse-Schur normal equations from (P_local, T) tables.

    Returns the per-shard partials to be summed, S_off (C, C, 6, 6), H_cc,
    b_c, rhs_red and cost, and the local arrays (Hpp_inv, Wp, b_p) of the
    point back-substitution."""
    P_l = state_l.points.shape[0]
    T = problem_l.cam_idx.shape[0] // P_l
    cams = problem_l.cam_idx.view(P_l, T)
    r_w, Jc, Jp, cost, _ = _weighted_blocks(state_l, problem_l, weight_fn)
    r_w = r_w.view(P_l, T, 2)
    Jc = Jc.view(P_l, T, 2, 6)
    Jp = Jp.view(P_l, T, 2, 3)

    H_pp = torch.einsum("ptki,ptkj->pij", Jp, Jp)       # (P, 3, 3)
    b_p = torch.einsum("ptki,ptk->pi", Jp, r_w)         # (P, 3)
    H_cc = _segment_sum(
        torch.einsum("ptki,ptkj->ptij", Jc, Jc).reshape(-1, 6, 6),
        problem_l.cam_idx, C)
    b_c = _segment_sum(torch.einsum("ptki,ptk->pti", Jc, r_w).reshape(-1, 6),
                       problem_l.cam_idx, C)
    Wp = torch.einsum("ptki,ptkj->ptij", Jc, Jp)        # (P, T, 6, 3)

    eye3 = torch.eye(3, dtype=H_pp.dtype, device=H_pp.device)
    Hpp_inv = _inv(H_pp + lam * eye3)                   # (P, 3, 3)
    WHinv = torch.einsum("ptij,pjk->ptik", Wp, Hpp_inv)  # (P, T, 6, 3)

    # the (chunk, T, T, 6, 6) camera-pair blocks of `chunk` points at a time
    # are scattered into the (C·C, 6, 6) accumulator
    S_off = torch.zeros((C * C, 6, 6), dtype=Wp.dtype, device=Wp.device)
    rhs_red = torch.zeros((C, 6), dtype=Wp.dtype, device=Wp.device)
    for s in range(0, P_l, chunk):
        wh, wp = WHinv[s:s + chunk], Wp[s:s + chunk]
        cm, bp = cams[s:s + chunk], b_p[s:s + chunk]
        pairs = torch.einsum("ptik,psjk->ptsij", wh, wp)
        pair_idx = (cm[:, :, None] * C + cm[:, None, :]).reshape(-1)
        S_off.index_add_(0, pair_idx, pairs.reshape(-1, 6, 6))
        rhs_obs = torch.einsum("ptik,pk->pti", wh, bp)
        rhs_red.index_add_(0, cm.reshape(-1), rhs_obs.reshape(-1, 6))
    return (S_off.view(C, C, 6, 6), H_cc, b_c, rhs_red, cost,
            Hpp_inv, Wp, b_p)


def _sparse_system(mesh: Mesh, state_l: BAState, problem_l: BAProblem,
                   lam: torch.Tensor, C: int, weight_fn: Callable,
                   chunk: int, fix_first_cam: bool):
    """The summed, damped, gauge-fixed reduced camera system S (C·6, C·6),
    its right-hand side, the summed cost and the rank's (Hpp_inv, Wp, b_p)."""
    (S_off, H_cc, b_c, rhs_red, cost, Hpp_inv, Wp, b_p) = _sparse_local_eqs(
        state_l, problem_l, C, weight_fn, lam, chunk)
    S_off, H_cc, b_c, rhs_red, cost = _all_reduce_packed(
        mesh, [S_off, H_cc, b_c, rhs_red, cost])
    eye6 = torch.eye(6, dtype=H_cc.dtype, device=H_cc.device)
    S = _add_diag_blocks(-S_off, H_cc + lam * eye6)
    S_mat = S.permute(0, 2, 1, 3).reshape(C * 6, C * 6)
    rhs = (b_c - rhs_red).reshape(C * 6)
    if fix_first_cam:
        S_mat, rhs = _fix_gauge(S_mat, rhs, 1, 6)
    return S_mat, rhs, cost, (Hpp_inv, Wp, b_p)


def _sparse_blocks(mesh: Mesh, state: BAState, cams, uv, mask, K
                   ) -> Tuple[BAState, BAProblem]:
    problem_l = _table_problem(_local(mesh, cams).long(), _local(mesh, uv),
                               _local(mesh, mask).bool(), K.to(mesh.device))
    return _replicated(mesh, state, _local(mesh, state.points)), problem_l


@f32_matmul_precision
def distributed_bundle_adjust_sparse(
    mesh: Mesh,
    state: BAState,
    cams: torch.Tensor,   # (D * P_local, T) global camera ids, padded with 0
    uv: torch.Tensor,     # (D * P_local, T, 2)
    mask: torch.Tensor,   # (D * P_local, T) bool track-validity
    K: torch.Tensor,
    num_cameras: int,
    num_iters: int = 8,
    init_lambda: float = 1e-3,
    robust_delta: float = 3.0,
    fix_first_cam: bool = True,
    point_chunk: int = 256,
) -> Tuple[BAState, torch.Tensor]:
    """LM bundle adjustment, sparse-Schur, map sharded over ``mesh['data']``.

    `state.points` (D*P_local, 3) and the track tables are global, sharded
    on their leading axis; poses replicated. Build the tables with
    `build_sharded_point_tables`. Returns the global state and the costs
    on every rank.
    """
    C = num_cameras
    weight_fn = lambda r2: huber_weight(r2, robust_delta)
    D = mesh.shape["data"]
    P_local = state.points.shape[0] // D
    chunk = min(point_chunk, P_local)
    state_l, problem_l = _sparse_blocks(mesh, state, cams, uv, mask, K)

    def system(state_l, lam):
        S_mat, rhs, cost, (Hpp_inv, Wp, b_p) = _sparse_system(
            mesh, state_l, problem_l, lam, C, weight_fn, chunk,
            fix_first_cam)
        sol = _cholesky_solve(S_mat, rhs).reshape(C, 6)
        # local point back-substitution: no communication
        cams_l = problem_l.cam_idx.view(Wp.shape[:2])
        Wt_dxc = torch.einsum("ptij,pti->pj", Wp, sol[cams_l])
        dx_p = torch.einsum("pij,pj->pi", Hpp_inv, b_p - Wt_dxc)
        return -sol, -dx_p, cost

    def cost_of(state_l):
        return _cost(state_l, problem_l, weight_fn)

    return _lm(mesh, state_l, init_lambda, num_iters, system, cost_of,
               fix_first_cam)
