"""Problems and SPMD workers of the port's distributed parity tests.

``kornia_tpu_torch.parallel.spmd.spawn`` starts each rank with a fresh
import of the worker's module, so the workers live here and not in the
test modules, which import JAX: a rank imports torch, numpy and the port
only, and reports whether JAX was imported (``jax_imported``).

Problems are numpy arrays drawn from a seed, so that the JAX package and
the port start from the same numbers. Each worker runs every case of its
test module in one world and returns rank 0's results as numpy arrays.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from kornia_tpu_torch import convert
from kornia_tpu_torch.slam.ba import _project


def _rot_y(angles: np.ndarray) -> np.ndarray:
    """wxyz quaternions of rotations by `angles` about y."""
    z = np.zeros_like(angles)
    return np.stack([np.cos(angles / 2), z, np.sin(angles / 2), z],
                    -1).astype(np.float32)


def _quat_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack([aw * bw - ax * bx - ay * by - az * bz,
                     aw * bx + ax * bw + ay * bz - az * by,
                     aw * by - ax * bz + ay * bw + az * bx,
                     aw * bz + ax * by - ay * bx + az * bw], -1)


def _small_rot(rng, n: int, sigma: float) -> np.ndarray:
    """wxyz quaternions of random rotations of about `sigma` rad."""
    w = rng.normal(0, sigma, (n, 3))
    th = np.linalg.norm(w, axis=-1, keepdims=True)
    axis = w / np.maximum(th, 1e-12)
    return np.concatenate([np.cos(th / 2), axis * np.sin(th / 2)],
                          -1).astype(np.float32)


def _arc_cameras(C: int):
    """C cameras on a 0.6 rad arc, 2 apart along x (the scaling bench's)."""
    q = _rot_y(np.linspace(-0.3, 0.3, C))
    t = np.stack([np.linspace(-1, 1, C), np.zeros(C), np.zeros(C)],
                 -1).astype(np.float32)
    return q, t


def _uv(q, t, X, cam_idx, pt_idx, K) -> np.ndarray:
    return _project(torch.from_numpy(q[cam_idx]), torch.from_numpy(t[cam_idx]),
                    torch.from_numpy(X[pt_idx]), torch.from_numpy(K)).numpy()


K_BA = np.array([[200.0, 0, 128], [0, 200, 96], [0, 0, 1]], np.float32)


def dense_ba_arrays(D: int, P_local: int, C: int, seed: int = 0,
                    noise: float = 0.2) -> dict:
    """``tests/test_slam.py::TestDistributedBA``'s layout: every camera
    sees every point of every shard; observations grouped by shard, point
    ids local to it. A perturbed start (0.02 rad, 0.05 and 0.1)."""
    rng = np.random.default_rng(seed)
    q, t = _arc_cameras(C)
    P = D * P_local
    X = (rng.standard_normal((P, 3)) * 1.5 + [0.0, 0, 6.0]).astype(np.float32)
    cam_idx = np.concatenate([np.repeat(np.arange(C), P_local)] * D)
    pt_local = np.concatenate([np.tile(np.arange(P_local), C)] * D)
    pt_global = np.concatenate([np.tile(np.arange(P_local), C) + s * P_local
                                for s in range(D)])
    uv = _uv(q, t, X, cam_idx, pt_global, K_BA)
    uv = (uv + noise * rng.standard_normal(uv.shape)).astype(np.float32)
    q0 = _quat_mul(_small_rot(rng, C, 0.02), q).astype(np.float32)
    t0 = (t + 0.05 * rng.standard_normal((C, 3))).astype(np.float32)
    X0 = (X + 0.1 * rng.standard_normal((P, 3))).astype(np.float32)
    return dict(wxyz=q0, t=t0, points=X0, cam_idx=cam_idx.astype(np.int32),
                pt_idx=pt_local.astype(np.int32), pt_global=pt_global,
                uv=uv, valid=np.ones(cam_idx.shape[0], bool), K=K_BA, C=C)


def sparse_ba_arrays(C: int, P: int, T: int = 6, seed: int = 0,
                     noise: float = 0.1) -> dict:
    """``tests/test_dist_ba_sparse.py::_make_problem``'s map: every point
    seen by T consecutive cameras from a random start; flat observations
    with global point ids."""
    rng = np.random.default_rng(seed)
    q, t = _arc_cameras(C)
    X = (rng.standard_normal((P, 3)) * 1.5 + [0.0, 0, 6.0]).astype(np.float32)
    start = rng.integers(0, max(C - T, 1), P)
    cam_idx = (start[:, None] + np.arange(T)[None]).reshape(-1)
    pt_idx = np.repeat(np.arange(P), T)
    uv = _uv(q, t, X, cam_idx, pt_idx, K_BA)
    uv = (uv + noise * rng.standard_normal(uv.shape)).astype(np.float32)
    q0 = _quat_mul(_small_rot(rng, C, 0.02), q).astype(np.float32)
    t0 = (t + 0.05 * rng.standard_normal((C, 3))).astype(np.float32)
    X0 = (X + 0.1 * rng.standard_normal((P, 3))).astype(np.float32)
    return dict(wxyz=q0, t=t0, points=X0, cam_idx=cam_idx, pt_idx=pt_idx,
                uv=uv, valid=np.ones(P * T, bool), K=K_BA, C=C, P=P)


def loop_graph_arrays(N: int = 48, noise: float = 0.05, seed: int = 1
                      ) -> dict:
    """``tests/test_dist_posegraph.py::_loop_graph``: a circle of N poses,
    odometry edges, a loop edge and two chords; the start perturbed by
    `noise` (pose 0 exact)."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, N, endpoint=False)
    t_gt = np.stack([np.cos(ang) * 5, np.sin(ang) * 5, np.zeros(N)], -1)
    yaw = ang + np.pi / 2
    q_gt = np.stack([np.cos(yaw / 2), np.zeros(N), np.zeros(N),
                     np.sin(yaw / 2)], -1)
    src = np.array(list(range(N - 1)) + [0, 10, 20])
    dst = np.array(list(range(1, N)) + [N - 1, 30, 40])
    return _graph(q_gt, t_gt, src, dst, noise, rng)


def circuit_graph_arrays(N: int, n_extra: int, seed: int = 0,
                         noise: float = 0.03) -> dict:
    """``benchmarks/scaling_bench.py::_make_circuit_graph``: a circuit of
    radius 8 and random long-range edges (|i - j| > N/8)."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, N, endpoint=False)
    t_gt = np.stack([np.cos(ang) * 8, np.sin(ang) * 8, np.zeros(N)], -1)
    q_gt = np.stack([np.cos((ang + np.pi / 2) / 2), np.zeros(N),
                     np.zeros(N), np.sin((ang + np.pi / 2) / 2)], -1)
    extra = rng.integers(0, N, size=(n_extra, 2))
    extra = extra[np.abs(extra[:, 0] - extra[:, 1]) > N // 8]
    src = np.concatenate([np.arange(N - 1), extra[:, 0]])
    dst = np.concatenate([np.arange(1, N), extra[:, 1]])
    return _graph(q_gt, t_gt, src, dst, noise, rng)


def _se3_exp_np(xi: np.ndarray):
    """(wxyz, t) of exp of (N, 6) tangents (rho, omega), via the port."""
    from kornia_tpu_torch.geometry.liegroup import Se3
    T = Se3.exp(torch.from_numpy(xi.astype(np.float32)))
    return T.r.q.data.numpy(), T.t.numpy()


def _graph(q_gt, t_gt, src, dst, noise, rng) -> dict:
    """Edges measured from the ground truth T_i⁻¹ T_j; the start is
    exp(noise) ∘ T_gt with pose 0 exact."""
    q_gt = q_gt.astype(np.float32)
    t_gt = t_gt.astype(np.float32)

    def R(q):
        w, x, y, z = np.moveaxis(q, -1, 0)
        return np.stack([
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)], -1)], -2)

    qi_inv = q_gt[src] * np.array([1, -1, -1, -1], np.float32)
    mq = _quat_mul(qi_inv, q_gt[dst]).astype(np.float32)
    mt = np.einsum("eji,ej->ei", R(q_gt[src]),
                   t_gt[dst] - t_gt[src]).astype(np.float32)
    N = q_gt.shape[0]
    xi = noise * rng.standard_normal((N, 6))
    xi[0] = 0.0
    dq, dt = _se3_exp_np(xi)
    q0 = _quat_mul(dq, q_gt).astype(np.float32)
    t0 = (np.einsum("nij,nj->ni", R(dq), t_gt) + dt).astype(np.float32)
    E = src.shape[0]
    return dict(wxyz=q0, t=t0, src=src, dst=dst, meas_wxyz=mq, meas_t=mt,
                weight=np.ones(E, np.float32), valid=np.ones(E, bool), N=N,
                gt_t=t_gt)


def loftr_coarse_arrays(cfg_kw: dict, L: int, seed: int = 0):
    """Numpy weights of LoFTR's coarse transformer (Linear weights at
    1/sqrt(fan-in), layer norms near 1 and 0) and two views' (1, L, C)
    tokens at scale 0.5."""
    from kornia_tpu_torch.feature.loftr import LoFTRConfig, _param_specs
    cfg = LoFTRConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    params = {}
    for name, shape in _param_specs(cfg).items():
        if not name.startswith("loftr_coarse."):
            continue
        if name.endswith(("norm1.weight", "norm2.weight")):
            params[name] = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "norm" in name:
            params[name] = 0.1 * rng.standard_normal(shape)
        else:
            params[name] = rng.standard_normal(shape) / np.sqrt(shape[-1])
    params = {k: v.astype(np.float32) for k, v in params.items()}
    f0, f1 = (0.5 * rng.standard_normal((2, 1, L, cfg.coarse_dim))).astype(
        np.float32)
    return params, f0, f1


def _np(x):
    return x.detach().cpu().numpy()


def _state_np(state) -> dict:
    return dict(wxyz=_np(state.poses.r.q.data), t=_np(state.poses.t),
                points=_np(state.points))


def _ranks_agree(mesh, *tensors) -> bool:
    """Whether every rank holds bitwise the same tensors as rank 0."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])[None]
    every = mesh.all_gather(flat)
    return bool((every == every[:1]).all())


# The damping of the one-iteration comparisons. With one camera fixed the
# scale is a free gauge that only λ damps: at the default 1e-3 the first
# step's component along it is rounding noise amplified by 1/λ, and the
# JAX package's own first-iteration costs spread by 1.4% between 4 and 8
# shards and one device (138.7 to 140.6 on the sparse problem). At 0.1
# they agree to 2e-4.
ONE_STEP_LAMBDA = 0.1


def ba_worker(mesh, dense: dict, sparse: dict, tables, sparse_kw: dict
              ) -> dict:
    """Dense and sparse distributed BA: one iteration, and full runs."""
    from kornia_tpu_torch.parallel.dist_ba import (
        distributed_bundle_adjust, distributed_bundle_adjust_sparse)
    from kornia_tpu_torch.parallel.mesh import make_mesh
    dev = mesh.device
    out = {"jax_imported": "jax" in sys.modules}
    # a 2 x 2 grid of the same ranks: each axis sums over its own slice
    grid = make_mesh((2, 2), devices=[dev] * 4)
    r = torch.tensor([float(torch.distributed.get_rank())], device=dev)
    out["grid"] = dict(coords=(grid.rank("data"), grid.rank("model")),
                       data=float(grid.all_reduce(r.clone(), "data")),
                       model=float(grid.all_reduce(r.clone(), "model")))
    s0 = convert.ba_state_from_numpy(dense["wxyz"], dense["t"],
                                     dense["points"], dev)
    args = [torch.from_numpy(dense[k]).to(dev)
            for k in ("cam_idx", "pt_idx", "uv", "valid", "K")]
    for n, lam in ((1, ONE_STEP_LAMBDA), (8, 1e-3)):
        st, costs = distributed_bundle_adjust(mesh, s0, *args, dense["C"],
                                              num_iters=n, init_lambda=lam)
        out[f"dense_{n}"] = dict(_state_np(st), costs=_np(costs))
        out[f"dense_{n}_ranks_agree"] = _ranks_agree(
            mesh, st.poses.r.q.data, st.poses.t, st.points, costs)
    s0 = convert.ba_state_from_numpy(sparse["wxyz"], sparse["t"],
                                     sparse["points"], dev)
    cams, uv_t, mask = (torch.from_numpy(a).to(dev) for a in tables)
    K = torch.from_numpy(sparse["K"]).to(dev)
    for n in (1, sparse_kw["num_iters"]):
        kw = dict(sparse_kw, num_iters=n)
        if n == 1:
            kw["init_lambda"] = ONE_STEP_LAMBDA
        st, costs = distributed_bundle_adjust_sparse(
            mesh, s0, cams, uv_t, mask, K, sparse["C"], **kw)
        out[f"sparse_{n}"] = dict(_state_np(st), costs=_np(costs))
        out[f"sparse_{n}_ranks_agree"] = _ranks_agree(
            mesh, st.poses.r.q.data, st.poses.t, st.points, costs)
    return out


def graph_on(g: dict, device):
    return (convert.se3_from_numpy(g["wxyz"], g["t"], device),
            convert.pose_graph_from_numpy(g["src"], g["dst"], g["meas_wxyz"],
                                          g["meas_t"], g["weight"],
                                          g["valid"], device))


def posegraph_worker(mesh, graphs: dict, parts: dict, iters: dict) -> dict:
    """Dense and streaming distributed pose graphs on each named graph:
    ``iters[name]`` = ((path, num_iters, kwargs), ...)."""
    from kornia_tpu_torch.parallel import dist_posegraph as dpg
    out = {"jax_imported": "jax" in sys.modules}
    for name, runs in iters.items():
        poses, graph = graph_on(graphs[name], mesh.device)
        for path, n, kw in runs:
            fn = (dpg.distributed_pose_graph if path == "dense"
                  else dpg.distributed_pose_graph_streaming)
            p, costs = fn(mesh, poses, graph, parts[name], num_iters=n, **kw)
            key = f"{name}_{path}_{n}"
            out[key] = dict(wxyz=_np(p.r.q.data), t=_np(p.t),
                            costs=_np(costs))
            out[key + "_ranks_agree"] = _ranks_agree(mesh, p.r.q.data, p.t,
                                                     costs)
    return out


def loftr_worker(mesh, params: dict, cfg_kw: dict, f0: np.ndarray,
                 f1: np.ndarray) -> dict:
    """LoFTR's context-parallel coarse stage on global tokens."""
    from kornia_tpu_torch.feature.loftr import (LoFTRConfig,
                                                loftr_coarse_context_parallel)
    dev = mesh.device
    p = {k: torch.from_numpy(v).to(dev) for k, v in params.items()}
    mesh.reset_counts()
    o0, o1 = loftr_coarse_context_parallel(
        p, LoFTRConfig(**cfg_kw), torch.from_numpy(f0).to(dev),
        torch.from_numpy(f1).to(dev), mesh)
    return {"jax_imported": "jax" in sys.modules, "out0": _np(o0),
            "out1": _np(o1), "ranks_agree": _ranks_agree(mesh, o0, o1),
            "all_reduces": mesh.counts["all_reduce"]}


class StopAtStep(Exception):
    """Raised by the restart worker's step function to stop a run."""


def dense_lm_step(mesh, dense: dict):
    """A step function of run_restartable: one LM iteration of the dense
    distributed BA on {"state": global BAState, "lam": λ}."""
    from kornia_tpu_torch.parallel import dist_ba
    from kornia_tpu_torch.slam.ba import BAState
    from kornia_tpu_torch.losses.robust import huber_weight
    dev = mesh.device
    args = [torch.from_numpy(dense[k]).to(dev)
            for k in ("cam_idx", "pt_idx", "uv", "valid", "K")]
    C = dense["C"]
    P_local = dense["points"].shape[0] // mesh.shape["data"]
    weight_fn = lambda r2: huber_weight(r2, 3.0)

    def step(s):
        st_l, prob_l = dist_ba._dense_blocks(mesh, s["state"], *args)
        system, cost_of = dist_ba._dense_step_fns(mesh, prob_l, C, P_local,
                                                  weight_fn, True)
        st_l, lam, cost = dist_ba._lm_iteration(mesh, st_l, s["lam"],
                                                system, cost_of, True)
        g = dist_ba._gather_state(mesh, st_l)
        return {"state": BAState(g.poses, g.points), "lam": lam,
                "cost": cost}

    s0 = convert.ba_state_from_numpy(dense["wxyz"], dense["t"],
                                     dense["points"], dev)
    init = {"state": s0, "lam": torch.tensor(1e-3, device=dev),
            "cost": torch.tensor(0.0, device=dev)}
    return step, init


def restart_worker(mesh, dense: dict, ckpt_root: str, num_steps: int,
                   stop_at: int) -> dict:
    """run_restartable over dense distributed BA LM steps: an
    uninterrupted run, and a run stopped by StopAtStep at step `stop_at`
    and resumed; every rank checkpoints its own copy."""
    from kornia_tpu_torch.parallel.dist_ba import distributed_bundle_adjust
    from kornia_tpu_torch.utils.elastic import (latest_checkpoint,
                                                run_restartable)
    step, init = dense_lm_step(mesh, dense)
    root = os.path.join(ckpt_root, f"rank{mesh.rank('data')}")
    whole = run_restartable(step, init, num_steps, os.path.join(root, "a"),
                            checkpoint_every=2)
    calls = []

    def stopping(s):
        calls.append(1)
        if len(calls) == stop_at:
            raise StopAtStep(stop_at)
        return step(s)

    stopped_at = None
    try:
        run_restartable(stopping, init, num_steps, os.path.join(root, "b"),
                        checkpoint_every=2)
    except StopAtStep as e:
        stopped_at = e.args[0]
    newest = latest_checkpoint(os.path.join(root, "b"))
    calls.clear()

    def counting(s):
        calls.append(1)
        return step(s)

    resumed = run_restartable(counting, init, num_steps,
                              os.path.join(root, "b"), checkpoint_every=2)
    direct, costs = distributed_bundle_adjust(
        mesh, init["state"], *[torch.from_numpy(dense[k]).to(mesh.device)
                               for k in ("cam_idx", "pt_idx", "uv", "valid",
                                         "K")], dense["C"],
        num_iters=num_steps)
    return {"jax_imported": "jax" in sys.modules, "stopped_at": stopped_at,
            "newest_step": newest[0], "resumed_steps": len(calls),
            "whole": _state_np(whole["state"]),
            "resumed": _state_np(resumed["state"]),
            "direct": _state_np(direct), "whole_cost": _np(whole["cost"]),
            "direct_costs": _np(costs),
            "listing": sorted(os.listdir(os.path.join(root, "b")))}


def failing_worker(mesh, bad: int) -> None:
    """Rank `bad` raises before the world's first collective."""
    if mesh.rank("data") == bad:
        raise ValueError(f"rank {bad} fails")
    mesh.all_reduce(torch.ones(1, device=mesh.device))


def card_worker(mesh, dense: dict, params: dict, cfg_kw: dict,
                f0: np.ndarray, f1: np.ndarray) -> dict:
    """Dense distributed BA (8 iterations) and LoFTR's context-parallel
    coarse stage on the rank's card."""
    from kornia_tpu_torch.parallel.dist_ba import distributed_bundle_adjust
    dev = mesh.device
    s0 = convert.ba_state_from_numpy(dense["wxyz"], dense["t"],
                                     dense["points"], dev)
    st, costs = distributed_bundle_adjust(
        mesh, s0, *[torch.from_numpy(dense[k]).to(dev)
                    for k in ("cam_idx", "pt_idx", "uv", "valid", "K")],
        dense["C"], num_iters=8)
    out = loftr_worker(mesh, params, cfg_kw, f0, f1)
    out["ba"] = dict(_state_np(st), costs=_np(costs))
    out["ba_ranks_agree"] = _ranks_agree(mesh, st.poses.r.q.data, st.poses.t,
                                         st.points, costs)
    out["device"] = str(dev)
    return out
