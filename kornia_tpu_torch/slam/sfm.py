"""Incremental structure from motion (counterpart of
``kornia_tpu/slam/sfm.py``).

Works on observation tracks (point id ↔ pixel in each view), the output of
any matcher front end:

1. initialise from views (0, 1): the 5-point essential matrix, its pose,
   triangulation;
2. register each further view by PnP on the reconstructed points, and
   triangulate the points it newly covers with view 0;
3. global LM bundle adjustment (``slam/ba.py``);
4. re-triangulate every point from its first and last observing views with
   the refined poses, and a shorter second bundle adjustment.

Control flow runs on the host in numpy around device calls, as in the
reference. Step 4 triangulates all points in one batched call (the
reference calls the triangulation once per point).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..geometry.calibration import solve_pnp_dlt
from ..geometry.conversions import normalize_points_with_intrinsics
from ..geometry.epipolar import (motion_from_essential_choose_solution,
                                 projection_from_KRt, run_5point,
                                 sampson_epipolar_distance,
                                 triangulate_points)
from ..geometry.liegroup import Se3, So3
from .ba import BAProblem, BAState, bundle_adjust, reprojection_residuals

__all__ = ["incremental_sfm", "SfmResult"]


@dataclasses.dataclass
class SfmResult:
    poses: Se3  # (V,) world→camera
    points: torch.Tensor  # (n, 3), the reconstructed points in id order
    point_valid: np.ndarray  # (P,) which point ids were reconstructed
    final_rms: float


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _retriangulate(Ps: torch.Tensor, obs: np.ndarray, vis: np.ndarray,
                   ids_rec: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Each reconstructed point (ids_rec) seen twice or more, triangulated
    from its first and last observing views with projections Ps (V, 3, 4),
    in one batched call. Points whose result is not finite keep their
    value. Returns the new (n, 3) points."""
    vis_rec = vis[:, ids_rec]
    V = vis.shape[0]
    sel = np.where(vis_rec.sum(0) >= 2)[0]
    out = points.copy()
    if sel.size == 0:
        return out
    v0 = vis_rec[:, sel].argmax(0)
    v1 = V - 1 - vis_rec[::-1, sel].argmax(0)
    pid = ids_rec[sel]
    dev = Ps.device
    x0 = torch.from_numpy(obs[v0, pid][:, None]).to(dev)
    x1 = torch.from_numpy(obs[v1, pid][:, None]).to(dev)
    v0_t = torch.from_numpy(v0).to(dev)
    v1_t = torch.from_numpy(v1).to(dev)
    X = triangulate_points(Ps[v0_t], Ps[v1_t], x0, x1)[:, 0].cpu().numpy()
    ok = np.isfinite(X).all(-1)
    out[sel[ok]] = X[ok]
    return out


def incremental_sfm(observations, visible, K, ba_iters: int = 10,
                    generator: Optional[torch.Generator] = None,
                    device: Union[str, torch.device] = "cuda") -> SfmResult:
    """Reconstruct cameras and points from multi-view tracks.

    observations (V, P, 2) pixels and visible (V, P) bool, as arrays or
    tensors; K (3, 3). `generator` stands in the place of the reference's
    `key`, which it draws nothing from: both are unused."""
    obs = np.array(_host(observations), np.float32)
    vis = np.array(_host(visible), bool)
    dev = torch.device(device)
    K = torch.as_tensor(K, dtype=torch.float32).to(dev)
    V, P, _ = obs.shape

    def on(a, dtype=torch.float32):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev, dtype)

    eye = torch.eye(3, device=dev)[None]
    zero_t = torch.zeros((1, 3, 1), device=dev)

    # --- 1. initialise from views (0, 1) -----------------------------------
    both = vis[0] & vis[1]
    x0 = normalize_points_with_intrinsics(on(obs[0][both]), K)
    x1 = normalize_points_with_intrinsics(on(obs[1][both]), K)
    E_cands = run_5point(x0[None, :5], x1[None, :5])[0]  # (NC, 3, 3)
    res = sampson_epipolar_distance(x0[None], x1[None], E_cands).amax(-1)
    valid_c = torch.linalg.vector_norm(E_cands.flatten(1), dim=-1) > 0.5
    E = E_cands[torch.argmin(torch.where(valid_c, res, torch.inf))]
    R1, t1, _ = motion_from_essential_choose_solution(
        E[None], eye, eye, x0[None], x1[None])
    M1 = np.eye(4)
    M1[:3, :3] = R1[0].cpu().numpy()
    M1[:3, 3] = t1[0, :, 0].cpu().numpy()
    poses_np = [np.eye(4), M1]

    P0 = projection_from_KRt(K[None], eye, zero_t)
    X01 = triangulate_points(P0, projection_from_KRt(K[None], R1, t1),
                             on(obs[0][both])[None],
                             on(obs[1][both])[None])[0].cpu().numpy()
    points = np.zeros((P, 3), np.float32)
    point_ok = np.zeros(P, bool)
    idx_both = np.where(both)[0]
    in_front = X01[:, 2] > 0.1
    points[idx_both[in_front]] = X01[in_front]
    point_ok[idx_both[in_front]] = True

    # --- 2. register the other views by PnP, triangulate new points --------
    for v in range(2, V):
        seen = vis[v] & point_ok
        if seen.sum() >= 6:
            Rt = solve_pnp_dlt(on(points[seen])[None], on(obs[v][seen])[None],
                               K[None])[0]
            Mv = np.eye(4)
            Mv[:3, :] = Rt.cpu().numpy()
        else:  # too few known points: chain the previous pose
            Mv = poses_np[-1].copy()
        poses_np.append(Mv)
        new = vis[0] & vis[v] & ~point_ok
        if new.sum() > 0:
            Pv = projection_from_KRt(K[None], on(Mv[None, :3, :3]),
                                     on(Mv[None, :3, 3:4]))
            Xn = triangulate_points(P0, Pv, on(obs[0][new])[None],
                                    on(obs[v][new])[None])[0].cpu().numpy()
            okn = Xn[:, 2] > 0.1
            idx_new = np.where(new)[0]
            points[idx_new[okn]] = Xn[okn]
            point_ok[idx_new[okn]] = True

    # --- 3. global bundle adjustment over the reconstructed points ---------
    pt_map = -np.ones(P, np.int64)
    pt_map[point_ok] = np.arange(point_ok.sum())
    cam_idx, pt_idx, uvs = [], [], []
    for v in range(V):
        ids = np.where(vis[v] & point_ok)[0]
        cam_idx.append(np.full(ids.size, v))
        pt_idx.append(pt_map[ids])
        uvs.append(obs[v][ids])
    cam_idx = on(np.concatenate(cam_idx), torch.int64)
    problem = BAProblem(cam_idx, on(np.concatenate(pt_idx), torch.int64),
                        on(np.concatenate(uvs)),
                        torch.ones(cam_idx.shape[0], dtype=torch.bool,
                                   device=dev), K)
    R_stack = on(np.stack([M[:3, :3] for M in poses_np]))
    t_stack = on(np.stack([M[:3, 3] for M in poses_np]))
    state0 = BAState(Se3(So3.from_matrix(R_stack), t_stack),
                     on(points[point_ok]))
    n_pts = int(point_ok.sum())
    state, _ = bundle_adjust(state0, problem, V, n_pts, num_iters=ba_iters,
                             robust="cauchy", robust_delta=3.0)

    # --- 4. re-triangulate from the refined poses, second BA ---------------
    # badly initialised points survive robust BA as down-weighted outliers;
    # triangulating every point from its first and last observing views
    # with the refined poses resets them into the basin
    Ps = projection_from_KRt(K[None], state.poses.r.matrix(),
                             state.poses.t[..., None])
    pts_new = _retriangulate(Ps, obs, vis, np.where(point_ok)[0],
                             state.points.cpu().numpy())
    state, _ = bundle_adjust(BAState(state.poses, on(pts_new)), problem, V,
                             n_pts, num_iters=max(ba_iters // 2, 4),
                             robust="cauchy", robust_delta=3.0)
    r = reprojection_residuals(state, problem)
    rms = float(torch.sqrt((r * r).sum(-1).mean()))
    return SfmResult(poses=state.poses, points=state.points,
                     point_valid=point_ok, final_rms=rms)
