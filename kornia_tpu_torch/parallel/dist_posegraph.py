"""Distributed pose-graph optimisation via submap sharding (counterpart of
``kornia_tpu/parallel/dist_posegraph.py``).

Nested-dissection layout, as in the reference:

  * poses are partitioned into D SUBMAPS (one per rank on the ``data``
    axis); poses touched by cross-submap edges are SEPARATORS, replicated
    on every rank. Each rank's local pose table is [K separators; Ni own
    internals];
  * every rank assembles the normal equations of ITS edges only
    (intra-submap and its separator couplings; separator-separator edges
    are replicated with weight 1/D so that the sum reconstructs them);
  * internal poses are eliminated LOCALLY (a dense Cholesky of the rank's
    (Ni·6)² internal block);
  * the (K·6)² separator Schur system, its right-hand side and the cost
    are summed with ONE packed ``all_reduce``; every rank solves it
    redundantly and back-substitutes its internals with no further
    traffic. The after-step cost is each rank's local edge cost,
    all-reduced.

``distributed_pose_graph_streaming`` never forms the separator system:
block-CSR blocks, a block-Jacobi PCG whose matvec is one (K, 6)
``all_reduce``. Its CG runs `cg_iters` iterations with the converged ones
masked on the device (the reference's while_loop stops there), so the
loop reads nothing on the host.

Global in, global out: the caller passes the (N,) poses; each rank takes
its separators and internals, and the global poses come back on every
rank through one ``all_gather`` of the internal blocks after the last
iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..core.linalg import f32_matmul_precision
from ..geometry.liegroup import Quaternion, Se3, So3, _matvec
from ..losses.robust import huber_weight
from ..slam.ba import _cholesky_solve, _fix_gauge, _lm_update, _segment_sum
from ..slam.posegraph import PoseGraph, _edge_residual
from .mesh import Mesh

__all__ = ["partition_pose_graph", "distributed_pose_graph",
           "distributed_pose_graph_streaming", "PartitionedGraph"]


@dataclasses.dataclass
class PartitionedGraph:
    """Host-built static partition of a pose graph for D shards.

    sep_ids (K,): global pose ids of separators (pose 0 always included
    for gauge fixing). int_ids (D, Ni): global ids of each shard's
    internal poses (padded; int_valid marks real slots). Edges are stored
    per shard with LOCAL endpoint ids indexing [K seps; Ni internals];
    sep-sep edges are replicated into every shard with weight 1/D.
    """

    sep_ids: np.ndarray      # (K,)
    int_ids: np.ndarray      # (D, Ni)
    int_valid: np.ndarray    # (D, Ni)
    src: np.ndarray          # (D, E) local ids in [0, K + Ni)
    dst: np.ndarray          # (D, E)
    edge_id: np.ndarray      # (D, E) index into the original edge arrays
    edge_w: np.ndarray       # (D, E) weight multiplier (1 or 1/D), 0 = pad
    num_separators: int
    num_internal: int


def partition_pose_graph(src: np.ndarray, dst: np.ndarray,
                         valid: np.ndarray, num_poses: int, num_shards: int,
                         submap_of: Optional[np.ndarray] = None
                         ) -> PartitionedGraph:
    """Host-side: split poses into D submaps and classify edges.

    submap_of: (N,) shard id per pose; default = contiguous blocks (the
    natural layout for a trajectory: consecutive keyframes share a shard).
    """
    src = np.asarray(src)
    dst = np.asarray(dst)
    v = np.asarray(valid).astype(bool)
    N, D = num_poses, num_shards
    if submap_of is None:
        submap_of = np.minimum(np.arange(N) * D // max(N, 1), D - 1)
    submap_of = np.asarray(submap_of)

    cross = v & (submap_of[src] != submap_of[dst])
    sep_set = set(src[cross].tolist()) | set(dst[cross].tolist()) | {0}
    sep_ids = np.asarray(sorted(sep_set), np.int32)
    K = len(sep_ids)
    sep_rank = {int(g): i for i, g in enumerate(sep_ids)}

    int_lists = [[] for _ in range(D)]
    for p in range(N):
        if p not in sep_set:
            int_lists[submap_of[p]].append(p)
    Ni = max((len(l) for l in int_lists), default=1) or 1
    int_ids = np.zeros((D, Ni), np.int32)
    int_valid = np.zeros((D, Ni), bool)
    int_rank: Dict[int, Tuple[int, int]] = {}
    for s, l in enumerate(int_lists):
        for i, g in enumerate(l):
            int_ids[s, i] = g
            int_valid[s, i] = True
            int_rank[g] = (s, i)

    def local_id(g: int, shard: int) -> int:
        if g in sep_rank:
            return sep_rank[g]
        s, i = int_rank[g]
        if s != shard:
            raise AssertionError(f"pose {g} is internal to shard {s}, "
                                 f"not {shard}")
        return K + i

    e_lists = [[] for _ in range(D)]  # (edge_id, src_loc, dst_loc, w)
    for e in range(src.shape[0]):
        if not v[e]:
            continue
        a, b = int(src[e]), int(dst[e])
        a_sep, b_sep = a in sep_rank, b in sep_rank
        if a_sep and b_sep:
            for s in range(D):  # replicated, 1/D weight
                e_lists[s].append((e, sep_rank[a], sep_rank[b], 1.0 / D))
        else:
            s = int(submap_of[a]) if not a_sep else int(submap_of[b])
            e_lists[s].append((e, local_id(a, s), local_id(b, s), 1.0))

    E = max((len(l) for l in e_lists), default=1) or 1
    ed_src = np.zeros((D, E), np.int32)
    ed_dst = np.zeros((D, E), np.int32)
    ed_id = np.zeros((D, E), np.int32)
    ed_w = np.zeros((D, E), np.float32)
    for s, l in enumerate(e_lists):
        for i, (e, a, b, w) in enumerate(l):
            ed_src[s, i], ed_dst[s, i], ed_id[s, i], ed_w[s, i] = a, b, e, w
    return PartitionedGraph(sep_ids, int_ids, int_valid, ed_src, ed_dst,
                            ed_id, ed_w, K, Ni)


# -----------------------------------------------------------------------------
# The rank's part of the problem
# -----------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Shard:
    """One rank's edges (local endpoint ids, measurements, weights) and
    its internal slots."""

    src: torch.Tensor      # (E,) int64 in [0, K + Ni)
    dst: torch.Tensor
    mq: torch.Tensor       # (E, 4)
    mt: torch.Tensor       # (E, 3)
    w: torch.Tensor        # (E,) edge weight x partition weight
    ivalid: torch.Tensor   # (Ni,) bool
    int_ids: torch.Tensor  # (D, Ni) int64, every rank's
    int_valid: torch.Tensor  # (D, Ni) bool
    sep_ids: torch.Tensor  # (K,) int64


def _shard(mesh: Mesh, graph: PoseGraph, part: PartitionedGraph) -> _Shard:
    r, dev = mesh.rank("data"), mesh.device
    edge_id = torch.as_tensor(part.edge_id[r], dtype=torch.int64,
                              device=graph.weight.device)
    return _Shard(
        torch.as_tensor(part.src[r], dtype=torch.int64, device=dev),
        torch.as_tensor(part.dst[r], dtype=torch.int64, device=dev),
        graph.meas.r.q.data[edge_id].to(dev), graph.meas.t[edge_id].to(dev),
        torch.as_tensor(part.edge_w[r], device=dev)
        * graph.weight[edge_id].to(dev),
        torch.as_tensor(part.int_valid[r], device=dev),
        torch.as_tensor(part.int_ids, dtype=torch.int64, device=dev),
        torch.as_tensor(part.int_valid, device=dev),
        torch.as_tensor(part.sep_ids, dtype=torch.int64, device=dev))


def _tables(mesh: Mesh, poses: Se3, sh: _Shard):
    """The rank's local pose table [separators; own internals]."""
    q = poses.r.q.data.to(mesh.device)
    t = poses.t.to(mesh.device)
    ids = torch.cat([sh.sep_ids, sh.int_ids[mesh.rank("data")]])
    return q[ids], t[ids]


def _gather_poses(mesh: Mesh, poses: Se3, sh: _Shard, q_l: torch.Tensor,
                  t_l: torch.Tensor) -> Se3:
    """The global (N,) poses from every rank's table: separators from this
    rank's (they are the same on every rank), internals gathered."""
    K = sh.sep_ids.shape[0]
    q = poses.r.q.data.to(mesh.device).clone()
    t = poses.t.to(mesh.device).clone()
    q[sh.sep_ids] = q_l[:K]
    t[sh.sep_ids] = t_l[:K]
    ints = mesh.all_gather(torch.cat([q_l[K:], t_l[K:]], -1))  # (D·Ni, 7)
    ids = sh.int_ids.reshape(-1)[sh.int_valid.reshape(-1)]
    ints = ints[sh.int_valid.reshape(-1)]
    q[ids] = ints[:, :4]
    t[ids] = ints[:, 4:]
    return Se3(So3(Quaternion(q)), t)


def _edge_terms(q, t, sh: _Shard, robust_delta: float):
    """Sqrt-weighted Jacobians Ji, Jj (E, 6, 6), weighted residuals (E, 6)
    and the local cost of the rank's edges."""
    def res12(d, a, b, c, d_, e, f):
        return _edge_residual(d[:6], d[6:], a, b, c, d_, e, f)

    d0 = torch.zeros(12, dtype=t.dtype, device=t.device)
    args = (q[sh.src], t[sh.src], q[sh.dst], t[sh.dst], sh.mq, sh.mt)
    r = _edge_residual(d0[:6], d0[6:], *args)
    J = vmap(jacfwd(res12), in_dims=(None, 0, 0, 0, 0, 0, 0))(d0, *args)
    r2 = (r * r).sum(-1)
    ww = huber_weight(r2, robust_delta) * sh.w
    sw = torch.sqrt(ww)[:, None, None]
    return J[..., :6] * sw, J[..., 6:] * sw, r * sw[..., 0], (ww * r2).sum()


def _local_cost(q, t, sh: _Shard, robust_delta: float) -> torch.Tensor:
    z = torch.zeros(6, dtype=t.dtype, device=t.device)
    r = _edge_residual(z, z, q[sh.src], t[sh.src], q[sh.dst], t[sh.dst],
                       sh.mq, sh.mt)
    r2 = (r * r).sum(-1)
    return (huber_weight(r2, robust_delta) * sh.w * r2).sum()


def _damping(lam, K: int, sh: _Shard, D: int, dtype):
    """Per-node diagonal additions: λ/D on separators (summed over D ranks
    to λ), λ on internals, and 1 on padded internal slots."""
    pad = torch.cat([torch.ones(K, dtype=torch.bool, device=lam.device),
                     sh.ivalid])
    damp = torch.cat([(lam / D).expand(K), lam.expand(sh.ivalid.shape[0])])
    return (damp + (~pad).to(dtype))[:, None, None] * torch.eye(
        6, dtype=dtype, device=lam.device)


def _chol(A: torch.Tensor):
    """Cholesky factor of A + 1e-8 I and its status (0 = factored)."""
    A = A + 1e-8 * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return torch.linalg.cholesky_ex(A, check_errors=False)


def _chol_solve(L, info, B: torch.Tensor) -> torch.Tensor:
    """(L Lᵀ)⁻¹ B; NaN where the factorisation failed (the reference's
    semantics), without a host read."""
    return torch.where(info == 0, torch.cholesky_solve(B, L), torch.nan)


def _apply(q, t, dx):
    dT = Se3.exp(dx)
    return (dT.r * So3(Quaternion(q))).q.data, _matvec(dT.r.matrix(), t) + dT.t


def _lm(mesh, poses, sh, lm_iter, num_iters, init_lambda, robust_delta,
        fix_first):
    q, t = _tables(mesh, poses, sh)
    lam = torch.full((), float(init_lambda), dtype=t.dtype, device=t.device)
    ivalid = sh.ivalid.to(t.dtype)[:, None]
    costs = []
    for _ in range(num_iters):
        dx_s, dx_i, cost = lm_iter(q, t, lam)
        if fix_first:  # pose 0 is always separator rank 0
            dx_s = torch.cat([torch.zeros_like(dx_s[:1]), dx_s[1:]])
        q_new, t_new = _apply(q, t, torch.cat([dx_s, dx_i * ivalid]))
        new_cost = mesh.all_reduce(_local_cost(q_new, t_new, sh,
                                               robust_delta))
        accept = new_cost < cost
        q = torch.where(accept, q_new, q)
        t = torch.where(accept, t_new, t)
        lam = _lm_update(accept, lam, 1e-9, 1e4)
        costs.append(torch.where(accept, new_cost, cost))
    return _gather_poses(mesh, poses, sh, q, t), torch.stack(costs)


def _dense_separator_system(mesh: Mesh, q, t, lam, sh: _Shard, K: int,
                            robust_delta: float, fix_first: bool):
    """The summed separator Schur system S (K·6, K·6) and right-hand side
    (gauge-fixed), the summed cost, and what back-substitution needs."""
    D = mesh.shape["data"]
    Ni = sh.ivalid.shape[0]
    L = K + Ni
    Ji, Jj, r_w, cost = _edge_terms(q, t, sh, robust_delta)
    Hij = torch.einsum("eki,ekj->eij", Ji, Jj)
    idx = torch.cat([sh.src * L + sh.src, sh.dst * L + sh.dst,
                     sh.src * L + sh.dst, sh.dst * L + sh.src])
    blocks = torch.cat([torch.einsum("eki,ekj->eij", Ji, Ji),
                        torch.einsum("eki,ekj->eij", Jj, Jj),
                        Hij, Hij.transpose(-1, -2)])
    H = _segment_sum(blocks, idx, L * L).view(L, L, 6, 6)
    b = _segment_sum(torch.cat([torch.einsum("eki,ek->ei", Ji, r_w),
                                torch.einsum("eki,ek->ei", Jj, r_w)]),
                     torch.cat([sh.src, sh.dst]), L)
    torch.diagonal(H, dim1=0, dim2=1).add_(
        _damping(lam, K, sh, D, H.dtype).permute(1, 2, 0))

    # eliminate internals: the rank's dense Cholesky of H_ii
    H_ii = H[K:, K:].permute(0, 2, 1, 3).reshape(Ni * 6, Ni * 6)
    H_si = H[:K, K:].permute(0, 2, 1, 3).reshape(K * 6, Ni * 6)
    b_i = b[K:].reshape(Ni * 6)
    Lc, info = _chol(H_ii)
    sol = _chol_solve(Lc, info, torch.cat([H_si.T, b_i[:, None]], 1))
    Hinv_His, Hinv_bi = sol[:, :-1], sol[:, -1]
    # H_ss summed over ranks is the global block: sep-sep edges carry 1/D
    # on every rank, internal-separator blocks live on their owner only
    S_local = (H[:K, :K].permute(0, 2, 1, 3).reshape(K * 6, K * 6)
               - H_si @ Hinv_His)
    rhs_local = b[:K].reshape(K * 6) - H_si @ Hinv_bi
    buf = mesh.all_reduce(torch.cat([S_local.reshape(-1), rhs_local,
                                     cost[None]]))
    n = K * 6
    S = buf[:n * n].view(n, n).clone()
    rhs = buf[n * n:n * n + n].clone()
    if fix_first:
        S, rhs = _fix_gauge(S, rhs, 1, 6)
    return S, rhs, buf[-1], (Hinv_His, Hinv_bi)


@f32_matmul_precision
def distributed_pose_graph(
    mesh: Mesh,
    poses: Se3,
    graph: PoseGraph,
    part: PartitionedGraph,
    num_iters: int = 10,
    init_lambda: float = 1e-4,
    robust_delta: float = 1.0,
    fix_first: bool = True,
    max_separators: int = 384,
) -> Tuple[Se3, torch.Tensor]:
    """LM over the submap-sharded pose graph. Returns (poses (N,), costs),
    global, on every rank.

    poses: (N,) Se3 in GLOBAL order; the partition layout is internal.

    Refuses graphs whose separator count exceeds `max_separators`: this
    path materializes and sums the FULL (K*6)^2 separator Schur complement
    on every rank every iteration, O(K²) memory and traffic. Use
    `distributed_pose_graph_streaming` (block-CSR + PCG, O(K) memory and
    O(K) traffic per matvec) past that scale.
    """
    K, Ni = part.num_separators, part.num_internal
    if K > max_separators:
        raise ValueError(
            f"distributed_pose_graph: {K} separators > max_separators="
            f"{max_separators}; the dense (K*6)^2 Schur all_reduce "
            f"({(K * 6) ** 2 * 4 / 2 ** 20:.1f} MB replicated per rank "
            "per iteration) is past this path's design budget — use "
            "distributed_pose_graph_streaming for separator counts at "
            "this scale.")
    sh = _shard(mesh, graph, part)

    def lm_iter(q, t, lam):
        S, rhs, cost, (Hinv_His, Hinv_bi) = _dense_separator_system(
            mesh, q, t, lam, sh, K, robust_delta, fix_first)
        dx_s = -_cholesky_solve(S, rhs)
        # back-substitute internals locally: dx_i = -H_ii⁻¹(b_i + H_is dx_s)
        dx_i = -(Hinv_bi + Hinv_His @ dx_s)
        return dx_s.view(K, 6), dx_i.view(Ni, 6), cost

    return _lm(mesh, poses, sh, lm_iter, num_iters, init_lambda,
               robust_delta, fix_first)


@f32_matmul_precision
def distributed_pose_graph_streaming(
    mesh: Mesh,
    poses: Se3,
    graph: PoseGraph,
    part: PartitionedGraph,
    num_iters: int = 10,
    init_lambda: float = 1e-4,
    robust_delta: float = 1.0,
    fix_first: bool = True,
    cg_iters: int = 64,
    cg_tol: float = 1e-7,
) -> Tuple[Se3, torch.Tensor]:
    """Pose-graph LM whose separator system is NEVER materialized.

    The Hessian stays in block-CSR form (per-edge 6x6 blocks and per-node
    diagonal blocks), internals are eliminated through the Cholesky factor
    of the rank's internal block only, and the separator system is solved
    by block-Jacobi-preconditioned CG whose matvec

        S x = H_ss x - H_si (H_ii^-1 (H_is x))

    applies edge blocks by gather/scatter-add and costs one (K, 6)
    all_reduce: O(K) memory and traffic per matvec against the dense
    path's O(K²) per LM iteration. Same PartitionedGraph layout; the two
    paths agree to CG tolerance.
    """
    K, Ni = part.num_separators, part.num_internal
    D = mesh.shape["data"]
    sh = _shard(mesh, graph, part)
    src, dst = sh.src, sh.dst
    # edge classes for the block-CSR applications; masked edges use
    # clipped indices so that their zeroed contributions land in bounds
    is_ii = (src >= K) & (dst >= K)
    si = torch.where(is_ii, src - K, 0)
    di = torch.where(is_ii, dst - K, 0)
    is_ss = (src < K) & (dst < K)
    is_mix = (src < K) ^ (dst < K)  # one separator endpoint
    sep_end = torch.where(src < K, src, dst).clamp(0, K - 1)
    int_end = (torch.where(src < K, dst, src) - K).clamp(0, Ni - 1)
    src_s = src.clamp(0, K - 1)
    dst_s = dst.clamp(0, K - 1)

    def lm_iter(q, t, lam):
        dt = t.dtype
        Ji, Jj, r_w, cost = _edge_terms(q, t, sh, robust_delta)
        L = K + Ni
        Hd = _segment_sum(torch.cat([torch.einsum("eki,ekj->eij", Ji, Ji),
                                     torch.einsum("eki,ekj->eij", Jj, Jj)]),
                          torch.cat([src, dst]), L)
        Hoff = torch.einsum("eki,ekj->eij", Ji, Jj)  # block (src, dst)
        b = _segment_sum(torch.cat([torch.einsum("eki,ek->ei", Ji, r_w),
                                    torch.einsum("eki,ek->ei", Jj, r_w)]),
                         torch.cat([src, dst]), L)
        Hd = Hd + _damping(lam, K, sh, D, dt)

        # internal elimination: factor the rank's H_ii only
        m_ii = is_ii.to(dt)[:, None, None]
        H_ii = _segment_sum(
            torch.cat([Hd[K:], Hoff * m_ii,
                       Hoff.transpose(-1, -2) * m_ii]),
            torch.cat([torch.arange(Ni, device=q.device) * (Ni + 1),
                       si * Ni + di, di * Ni + si]), Ni * Ni)
        H_ii = H_ii.view(Ni, Ni, 6, 6).permute(0, 2, 1, 3).reshape(
            Ni * 6, Ni * 6)
        Lc, info = _chol(H_ii)

        def Hii_solve(v):  # (Ni, 6) -> (Ni, 6)
            return _chol_solve(Lc, info, v.reshape(Ni * 6, 1)).view(Ni, 6)

        # coupling separator -> internal: Hoff if src is the separator,
        # Hoffᵀ if dst is
        blk_si = torch.where((src < K)[:, None, None], Hoff,
                             Hoff.transpose(-1, -2)) \
            * is_mix.to(dt)[:, None, None]
        H_ss_off = Hoff * is_ss.to(dt)[:, None, None]

        def His_apply(x):  # (K, 6) -> (Ni, 6): internal rows of H_is x
            return _segment_sum(torch.einsum(
                "eji,ej->ei", blk_si, x[sep_end]), int_end, Ni)

        def Hsi_apply(u):  # (Ni, 6) -> (K, 6): separator rows of H_si u
            return _segment_sum(torch.einsum(
                "eij,ej->ei", blk_si, u[int_end]), sep_end, K)

        def S_matvec(x):  # x (K, 6) replicated; the summed S x
            # gauge: block 0 projected out on input and output, an
            # identity row for it (keeps the CG operator symmetric)
            xg = torch.cat([torch.zeros_like(x[:1]), x[1:]]) \
                if fix_first else x
            y = torch.einsum("kij,kj->ki", Hd[:K], xg)
            y = y + _segment_sum(torch.cat([
                torch.einsum("eij,ej->ei", H_ss_off, xg[dst_s]),
                torch.einsum("eji,ej->ei", H_ss_off, xg[src_s])]),
                torch.cat([src_s, dst_s]), K)
            y = y - Hsi_apply(Hii_solve(His_apply(xg)))
            y = mesh.all_reduce(y)
            if fix_first:
                y = torch.cat([x[:1], y[1:]])
            return y

        # rhs b_s - H_si H_ii⁻¹ b_i, the cost and the separator diagonal
        # (the block-Jacobi preconditioner): one packed all_reduce
        b_i = b[K:] * sh.ivalid.to(dt)[:, None]
        u0 = Hii_solve(b_i)
        buf = mesh.all_reduce(torch.cat([
            (b[:K] - Hsi_apply(u0)).reshape(-1), cost[None],
            Hd[:K].reshape(-1)]))
        rhs = buf[:K * 6].view(K, 6)
        cost = buf[K * 6]
        Md = buf[K * 6 + 1:].view(K, 6, 6)
        eye6 = torch.eye(6, dtype=dt, device=q.device)
        if fix_first:
            rhs = torch.cat([torch.zeros_like(rhs[:1]), rhs[1:]])
            Md = torch.cat([eye6[None], Md[1:]])
        Minv = torch.linalg.inv_ex(Md + 1e-8 * eye6, check_errors=False)[0]

        def precond(v):
            return torch.einsum("kij,kj->ki", Minv, v)

        # PCG on the separator system; converged iterations are masked
        x = torch.zeros_like(rhs)
        rr = rhs
        z = precond(rr)
        p = z
        rz = (rr * z).sum()
        thresh = cg_tol * cg_tol * (rhs * rhs).sum()
        for _ in range(cg_iters):
            active = (rr * rr).sum() > thresh
            Sp = S_matvec(p)
            alpha = rz / (p * Sp).sum().clamp_min(1e-30)
            x_n = x + alpha * p
            rr_n = rr - alpha * Sp
            z_n = precond(rr_n)
            rz_n = (rr_n * z_n).sum()
            p_n = z_n + rz_n / rz.clamp_min(1e-30) * p
            x = torch.where(active, x_n, x)
            rr = torch.where(active, rr_n, rr)
            p = torch.where(active, p_n, p)
            rz = torch.where(active, rz_n, rz)
        dx_s = -x
        if fix_first:
            dx_s = torch.cat([torch.zeros_like(dx_s[:1]), dx_s[1:]])
        # back-substitute internals: dx_i = -H_ii⁻¹(b_i + H_is dx_s)
        dx_i = -Hii_solve(b_i + His_apply(dx_s))
        return dx_s, dx_i, cost

    return _lm(mesh, poses, sh, lm_iter, num_iters, init_lambda,
               robust_delta, fix_first)
