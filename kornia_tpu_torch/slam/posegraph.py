"""Pose-graph optimisation over Se3 and Sim3 (counterpart of
``kornia_tpu/slam/posegraph.py``).

Nodes are poses; edges are relative-pose measurements with scalar
information weights. Levenberg-Marquardt on the manifold with dense normal
equations: the four blocks of every edge are summed into a flat (N·N, b, b)
view with ``index_add_`` (the reference's ``.at[src, dst].add``), the
system is solved by Cholesky, and state and λ stay on the device for the
fixed number of iterations (``torch.where`` accept/reject, as in
``slam/ba.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch.func import jacfwd, vmap

from ..core.linalg import f32_matmul_precision
from ..geometry.liegroup import Quaternion, Se3, So3, _matvec
from ..losses.robust import huber_weight
from .ba import (_cholesky_solve, _fix_gauge, _lm_update, _segment_sum,
                 _zero_first)

__all__ = ["PoseGraph", "optimize_pose_graph", "optimize_pose_graph_sim3"]


@dataclasses.dataclass(frozen=True)
class PoseGraph:
    """Edges i → j with measured T_ij (an (E,) Se3, frame i ← frame j),
    information weights (E,) and validity (E,)."""

    src: torch.Tensor  # (E,) int64
    dst: torch.Tensor  # (E,) int64
    meas: Se3
    weight: torch.Tensor
    valid: torch.Tensor


def _edge_residual(dx_i: torch.Tensor, dx_j: torch.Tensor, qi, ti, qj, tj,
                   qm, tm) -> torch.Tensor:
    """log(T_meas⁻¹ · (exp(dx_i) Ti)⁻¹ · (exp(dx_j) Tj)) ∈ R⁶."""
    Ti = Se3(So3.from_wxyz(qi), ti)
    Tj = Se3(So3.from_wxyz(qj), tj)
    Tm = Se3(So3.from_wxyz(qm), tm)
    err = Tm.inverse() * ((Se3.exp(dx_i) * Ti).inverse()
                          * (Se3.exp(dx_j) * Tj))
    return err.log()


def _assemble(Ji, Jj, r, w, graph: PoseGraph, N: int, b: int):
    """Dense H (N·b, N·b) and gradient (N·b,) of the weighted edges."""
    sw = torch.sqrt(w)
    Ji = Ji * sw[:, None, None]
    Jj = Jj * sw[:, None, None]
    r_w = r * sw[:, None]
    Hij = torch.einsum("eki,ekj->eij", Ji, Jj)
    idx = torch.cat([graph.src * N + graph.src, graph.dst * N + graph.dst,
                     graph.src * N + graph.dst, graph.dst * N + graph.src])
    blocks = torch.cat([torch.einsum("eki,ekj->eij", Ji, Ji),
                        torch.einsum("eki,ekj->eij", Jj, Jj),
                        Hij, Hij.transpose(-1, -2)])
    H = _segment_sum(blocks, idx, N * N).view(N, N, b, b)
    g = _segment_sum(torch.cat([torch.einsum("eki,ek->ei", Ji, r_w),
                                torch.einsum("eki,ek->ei", Jj, r_w)]),
                     torch.cat([graph.src, graph.dst]), N)
    return H.permute(0, 2, 1, 3).reshape(N * b, N * b), g.reshape(N * b)


def _lm_solve(H: torch.Tensor, g: torch.Tensor, lam: torch.Tensor,
              fix_first: bool, b: int) -> torch.Tensor:
    """The damped step -(H + λI)⁻¹ g (written into H), gauge-fixed."""
    H.diagonal().add_(lam)
    if fix_first:
        H, g = _fix_gauge(H, g, 1, b)
    dx = -_cholesky_solve(H, g).reshape(-1, b)
    return _zero_first(dx, 1) if fix_first else dx


def _edge_weights(r: torch.Tensor, graph: PoseGraph, delta: float):
    r2 = (r * r).sum(-1)
    w = huber_weight(r2, delta) * graph.weight * graph.valid.to(r.dtype)
    return r2, w


@f32_matmul_precision
def optimize_pose_graph(
    poses: Se3,
    graph: PoseGraph,
    num_iters: int = 10,
    init_lambda: float = 1e-4,
    robust_delta: float = 1.0,
    fix_first: bool = True,
) -> Tuple[Se3, torch.Tensor]:
    """LM on the pose graph. poses: (N,) Se3. Returns (poses, costs
    (num_iters,))."""
    N = poses.t.shape[0]
    qm, tm = graph.meas.r.q.data, graph.meas.t

    def residuals(q, t):
        z = torch.zeros((), dtype=t.dtype, device=t.device).expand(6)
        return _edge_residual(z, z, q[graph.src], t[graph.src],
                              q[graph.dst], t[graph.dst], qm, tm)

    def jacobians(q, t):
        def res12(d, a, b_, c, d_, e, f):
            return _edge_residual(d[:6], d[6:], a, b_, c, d_, e, f)

        d0 = torch.zeros(12, dtype=t.dtype, device=t.device)
        J = vmap(jacfwd(res12), in_dims=(None, 0, 0, 0, 0, 0, 0))(
            d0, q[graph.src], t[graph.src], q[graph.dst], t[graph.dst],
            qm, tm)
        return J[..., :6], J[..., 6:]

    def cost_of(q, t):
        r2, w = _edge_weights(residuals(q, t), graph, robust_delta)
        return (w * r2).sum()

    q, t = poses.r.q.data, poses.t
    lam = torch.full((), init_lambda, dtype=t.dtype, device=t.device)
    costs = []
    for _ in range(num_iters):
        r = residuals(q, t)
        r2, w = _edge_weights(r, graph, robust_delta)
        cost = (w * r2).sum()
        H, g = _assemble(*jacobians(q, t), r, w, graph, N, 6)
        dT = Se3.exp(_lm_solve(H, g, lam, fix_first, 6))
        q_new = (dT.r * So3(Quaternion(q))).q.data
        t_new = _matvec(dT.r.matrix(), t) + dT.t
        new_cost = cost_of(q_new, t_new)
        accept = new_cost < cost
        q = torch.where(accept, q_new, q)
        t = torch.where(accept, t_new, t)
        lam = _lm_update(accept, lam, 1e-9, 1e4)
        costs.append(torch.where(accept, new_cost, cost))
    return Se3(So3(Quaternion(q)), t), torch.stack(costs)


# ---------------------------------------------------------------------------
# Sim(3): monocular loop closure
# ---------------------------------------------------------------------------

def _sim3_edge_residual(d_i, d_j, qi, ti, si, qj, tj, sj, qm, tm,
                        scale_weight=0.05):
    """Decoupled Sim(3) residual of edge i → j with 7-dof local updates
    d = (omega(3), dt(3), dlog_s(1)): R ← exp(omega) R, t ← t + dt,
    s ← s · exp(dlog_s).

    Node S_i maps x → s_i R_i x + t_i; the predicted relative transform
    S_i⁻¹ S_j has rotation R_iᵀ R_j, translation R_iᵀ (t_j - t_i) / s_i and
    scale s_j / s_i; the measurement is (R_m, t_m, s_m = 1). The scale
    prior is soft (scale_weight ≪ 1): monocular odometry edges observe no
    scale, and the translation residuals carry it."""
    Ri = (So3.exp(d_i[..., :3]) * So3.from_wxyz(qi)).matrix()
    Rj = (So3.exp(d_j[..., :3]) * So3.from_wxyz(qj)).matrix()
    ti = ti + d_i[..., 3:6]
    tj = tj + d_j[..., 3:6]
    lsi = (si + d_i[..., 6])[..., None]  # (..., 1): see conversions.py
    lsj = (sj + d_j[..., 6])[..., None]
    Rm = So3.from_wxyz(qm).matrix()
    RiT = Ri.transpose(-1, -2)
    r_rot = So3.from_matrix(Rm.transpose(-1, -2) @ (RiT @ Rj)).log()
    r_t = _matvec(RiT, tj - ti) * torch.exp(-lsi) - tm
    r_s = scale_weight * (lsj - lsi)
    return torch.cat([r_rot, r_t, r_s], dim=-1)


@f32_matmul_precision
def optimize_pose_graph_sim3(
    poses: Se3,
    graph: PoseGraph,
    num_iters: int = 15,
    init_lambda: float = 1e-4,
    robust_delta: float = 1.0,
    fix_first: bool = True,
) -> Tuple[Se3, torch.Tensor, torch.Tensor]:
    """LM over Sim(3) nodes (rotation, translation, log-scale; scales start
    at 1). Returns (corrected Se3 poses, per-node scales, costs). The Se3
    output folds each node's scale into its translation (camera centre
    c = -Rᵀ t / s): how a monocular trajectory absorbs scale drift around a
    closed loop."""
    N = poses.t.shape[0]
    qm, tm = graph.meas.r.q.data, graph.meas.t
    src, dst = graph.src, graph.dst

    def residuals(q, t, ls):
        z = torch.zeros((), dtype=t.dtype, device=t.device).expand(7)
        return _sim3_edge_residual(z, z, q[src], t[src], ls[src], q[dst],
                                   t[dst], ls[dst], qm, tm)

    def jacobians(q, t, ls):
        def res14(d, a, b, c, d_, e, f, g, h):
            return _sim3_edge_residual(d[:7], d[7:], a, b, c, d_, e, f, g, h)

        d0 = torch.zeros(14, dtype=t.dtype, device=t.device)
        J = vmap(jacfwd(res14), in_dims=(None,) + (0,) * 8)(
            d0, q[src], t[src], ls[src], q[dst], t[dst], ls[dst], qm, tm)
        return J[..., :7], J[..., 7:]

    def cost_of(q, t, ls):
        r2, w = _edge_weights(residuals(q, t, ls), graph, robust_delta)
        return (w * r2).sum()

    q, t = poses.r.q.data, poses.t
    ls = torch.zeros(N, dtype=t.dtype, device=t.device)
    lam = torch.full((), init_lambda, dtype=t.dtype, device=t.device)
    costs = []
    for _ in range(num_iters):
        r = residuals(q, t, ls)
        r2, w = _edge_weights(r, graph, robust_delta)
        cost = (w * r2).sum()
        H, g = _assemble(*jacobians(q, t, ls), r, w, graph, N, 7)
        dx = _lm_solve(H, g, lam, fix_first, 7)
        q_new = (So3.exp(dx[:, :3]) * So3.from_wxyz(q)).q.data
        t_new = t + dx[:, 3:6]
        ls_new = ls + dx[:, 6]
        new_cost = cost_of(q_new, t_new, ls_new)
        accept = new_cost < cost
        q = torch.where(accept, q_new, q)
        t = torch.where(accept, t_new, t)
        ls = torch.where(accept, ls_new, ls)
        lam = _lm_update(accept, lam, 1e-9, 1e4)
        costs.append(torch.where(accept, new_cost, cost))
    s = torch.exp(ls)
    return Se3(So3.from_wxyz(q), t * (1.0 / s)[:, None]), s, \
        torch.stack(costs)
