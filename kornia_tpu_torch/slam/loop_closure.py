"""Loop detection and closure for the VO front end (counterpart of
``kornia_tpu/slam/loop_closure.py``).

1. Place recognition: one pooled global descriptor per frame (the
   normalised sum of its valid local descriptors, centred on the sequence
   mean); candidates are the best cosine match at least `min_separation`
   frames back.
2. Geometric verification: mutual-SNN match of the pair's cached
   descriptors, then PnP RANSAC of one frame's 2-D points against the
   other's back-projected map (the VO depth table), so a loop edge carries
   metric scale.
3. Closure: accepted edges and the odometry chain form a ``PoseGraph``;
   LM on the manifold spreads the accumulated drift around the cycle.

Verification runs on ``cuda`` unless the caller passes ``device="cpu"``;
candidate selection is host bookkeeping in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.dtype import float32_on as _f32
from ..core.linalg import f32_precision
from ..feature.matching import match_smnn
from ..geometry.calibration import pnp_ransac
from ..geometry.conversions import normalize_points_with_intrinsics
from ..geometry.liegroup import Se3, So3
from ..geometry.ransac import _gumbel
from .posegraph import (PoseGraph, optimize_pose_graph,
                        optimize_pose_graph_sim3)

__all__ = ["LoopEdge", "global_descriptors", "detect_loop_candidates",
           "verify_loop", "close_loops", "smooth_keyframe_graph"]

Device = Union[str, torch.device]


@dataclasses.dataclass
class LoopEdge:
    i: int  # query frame
    j: int  # revisited frame (j < i)
    num_inliers: int
    similarity: float
    T_rel: np.ndarray  # (4, 4) measured T_j^{-1} T_i (world→cam convention)


def global_descriptors(frame_cache: List[Dict[str, np.ndarray]]
                       ) -> np.ndarray:
    """(F, D) pooled place-recognition signatures from cached per-frame
    local descriptors: sum-pooled, normalised, centred on the sequence
    mean (VLAD-style) and normalised again."""
    pooled = []
    for fc in frame_cache:
        d = fc["desc"] * fc["valid"][:, None]
        g = d.sum(0)
        pooled.append(g / max(float(np.linalg.norm(g)), 1e-9))
    G = np.stack(pooled)
    G = G - G.mean(0, keepdims=True)
    return G / np.maximum(np.linalg.norm(G, axis=1, keepdims=True), 1e-9)


def detect_loop_candidates(gdesc: np.ndarray, min_separation: int = 10,
                           sim_th: float = 0.85,
                           max_candidates: int = 8
                           ) -> List[Tuple[int, int, float]]:
    """Best past match per frame, excluding the temporal neighborhood.
    Returns [(i, j, sim)] sorted by similarity, at most `max_candidates`
    (consecutive query frames matching the same revisit region are
    deduplicated to the strongest)."""
    F = gdesc.shape[0]
    sims = gdesc @ gdesc.T
    cands: List[Tuple[int, int, float]] = []
    for i in range(min_separation, F):
        past = sims[i, : i - min_separation + 1]
        j = int(np.argmax(past))
        s = float(past[j])
        if s >= sim_th:
            cands.append((i, j, s))
    cands.sort(key=lambda c: -c[2])
    picked: List[Tuple[int, int, float]] = []
    for i, j, s in cands:
        if any(abs(i - pi) < 3 for pi, _, _ in picked):
            continue
        picked.append((i, j, s))
        if len(picked) >= max_candidates:
            break
    return picked


def _verify_fn(Kf: int, matcher_th: float, ransac_batch: int,
               gn_iters: int):
    """The verification step for one map/query pair. The reference caches
    one compiled executable per (Kf, matcher_th, ransac_batch, gn_iters);
    here there is nothing to cache."""

    def fn(kp_j, d_j, v_j, depth_j, R_j, t_j, kp_i, d_i, v_i, K, gumbel,
           inl_th):
        """Match j→i, back-project j's map, PnP the query frame."""
        dists, idx, mvalid = match_smnn(d_j, d_i, matcher_th, v_j, v_i)
        x_j = normalize_points_with_intrinsics(kp_j, K)
        x_i = normalize_points_with_intrinsics(kp_i[idx[:, 1]], K)
        xh = torch.cat([x_j, torch.ones_like(x_j[:, :1])], -1)
        Xc = depth_j[:, None] * xh
        Xw = (Xc - t_j) @ R_j  # R_j^T (Xc - t_j)
        map_ok = mvalid & (depth_j > 0.0)
        R, t, inl, n = pnp_ransac(Xw, x_i, None, 2.0 * inl_th,
                                  mask=map_ok, batch_size=ransac_batch,
                                  gn_iters=gn_iters, gumbel=gumbel)
        return R, t, n, map_ok.sum()

    return fn


def verify_loop(frame_cache, poses, i: int, j: int, K,
                matcher_th: float = 0.95, inl_th: float = 2e-3,
                ransac_batch: int = 512,
                generator: Optional[torch.Generator] = None, *,
                gumbel: Optional[torch.Tensor] = None,
                device: Device = "cuda"
                ) -> Tuple[Optional[np.ndarray], int, int]:
    """PnP-verify candidate (i revisits j). The map frame is each of the
    two that carries a depth table (frame 0 never has one); the other
    frame's 2-D points solve PnP against its back-projected 3-D points.
    Returns (T_rel (4, 4) measured meas(j→i) = T_j⁻¹ T_i, n_inliers,
    n_map); T_rel is None when neither frame carries a map.

    PnP's sampling noise, (ransac_batch, K), is drawn once from
    `generator` (None: a generator seeded with i * 9973 + j, where the
    reference takes PRNGKey(i * 9973 + j)) or injected as `gumbel`; both
    directions use the same noise, as the reference's one key."""
    di = int((frame_cache[i]["depth"] > 0).sum())
    dj = int((frame_cache[j]["depth"] > 0).sum())
    if max(di, dj) == 0:
        return None, 0, 0
    Kf = frame_cache[i]["kp"].shape[0]
    if gumbel is None:
        if generator is None:
            generator = torch.Generator(device).manual_seed(i * 9973 + j)
        gumbel = _gumbel((ransac_batch, Kf), generator, device)
    gumbel = gumbel.to(device)
    K_t = _f32(K, device)

    def _try(m: int, q: int):
        """PnP the query frame q against map frame m's depth table."""
        fm, fq = frame_cache[m], frame_cache[q]
        fn = _verify_fn(fm["kp"].shape[0], matcher_th, ransac_batch, 5)
        with f32_precision():
            R, t, n, n_map = fn(
                _f32(fm["kp"], device), _f32(fm["desc"], device),
                torch.from_numpy(np.asarray(fm["valid"], bool)).to(device),
                _f32(fm["depth"], device),
                _f32(poses[m][:3, :3], device), _f32(poses[m][:3, 3], device),
                _f32(fq["kp"], device), _f32(fq["desc"], device),
                torch.from_numpy(np.asarray(fq["valid"], bool)).to(device),
                K_t, gumbel, float(np.float32(inl_th)))
            h = torch.cat([R.reshape(-1), t, n.reshape(1).to(R.dtype),
                           n_map.reshape(1).to(R.dtype)]).cpu().numpy()
        T_q = np.eye(4, dtype=np.float64)
        T_q[:3, :3] = h[:9].reshape(3, 3)
        T_q[:3, 3] = h[9:12]
        if q == i:  # measured pose of i in m=j's drift-local frame
            T_rel = np.linalg.inv(poses[j]) @ T_q
        else:  # measured pose of j against i's map
            T_rel = np.linalg.inv(T_q) @ poses[i]
        return T_rel, int(h[12]), int(h[13])

    # try both directions when both frames carry a map: degraded revisits
    # often verify against one frame's map but not the other's
    cands = [(i, j)] if dj == 0 else ([(j, i)] if di == 0 else
                                     [(i, j), (j, i)])
    best = None
    for m, q in cands:
        T_rel, n, n_map = _try(m, q)
        if best is None or n > best[1]:
            best = (T_rel, n, n_map)
    return best


def _se3_stack(Ts: List[np.ndarray], device) -> Se3:
    R = _f32(np.stack([T[:3, :3] for T in Ts]), device)
    t = _f32(np.stack([T[:3, 3] for T in Ts]), device)
    return Se3(So3.from_matrix(R), t)


def _graph(src, dst, rels, weights, device) -> PoseGraph:
    return PoseGraph(torch.tensor(src, dtype=torch.int64, device=device),
                     torch.tensor(dst, dtype=torch.int64, device=device),
                     _se3_stack(rels, device),
                     torch.tensor(weights, dtype=torch.float32,
                                  device=device),
                     torch.ones(len(src), dtype=torch.bool, device=device))


def close_loops(frame_cache, poses, K, min_separation: int = 10,
                sim_th: float = 0.85, min_inliers: int = 15,
                min_inlier_frac: float = 0.35, loop_weight: float = 3.0,
                pg_iters: int = 25, inl_th: float = 2e-3,
                optimizer: str = "se3",
                generator: Optional[torch.Generator] = None, *,
                draws: Optional[Dict[Tuple[int, int], torch.Tensor]] = None,
                device: Device = "cuda"
                ) -> Tuple[List[np.ndarray], List[LoopEdge]]:
    """Detect, verify, and close loops over a finished VO run.

    frame_cache: `VisualOdometry.frame_cache`; poses: (4, 4) world→cam
    per frame. Returns (corrected poses, accepted LoopEdges). With no
    accepted loop the poses are returned unchanged.

    Acceptance is fraction-dominant: inliers >= min_inlier_frac of the
    map-backed matches, with a moderate absolute floor.

    optimizer: "se3" (default) or "sim3" (per-node scale; its loop edges
    are not robustified). `draws` maps a candidate (i, j) to the PnP noise
    of its verification (``verify_loop``'s `gumbel`); other candidates
    draw from `generator`, or from ``verify_loop``'s default."""
    F = len(poses)
    gdesc = global_descriptors(frame_cache)
    cands = detect_loop_candidates(gdesc, min_separation, sim_th)
    edges: List[LoopEdge] = []
    for i, j, s in cands:
        T_rel, n, n_map = verify_loop(
            frame_cache, poses, i, j, K, inl_th=inl_th, generator=generator,
            gumbel=None if draws is None else draws.get((i, j)),
            device=device)
        if (T_rel is not None and n >= min_inliers
                and n >= min_inlier_frac * max(n_map, 1)):
            edges.append(LoopEdge(i=i, j=j, num_inliers=n, similarity=s,
                                  T_rel=T_rel))
    if not edges:
        return [p.copy() for p in poses], edges

    # pose graph: odometry chain + loop edges (meas(src→dst) = T_src⁻¹ T_dst,
    # the convention of slam/posegraph.py::_edge_residual)
    src = list(range(F - 1)) + [e.j for e in edges]
    dst = list(range(1, F)) + [e.i for e in edges]
    rels = [np.linalg.inv(poses[k]) @ poses[k + 1] for k in range(F - 1)]
    rels += [e.T_rel for e in edges]
    weights = [1.0] * (F - 1) + [loop_weight * min(e.num_inliers, 100) / 30.0
                                 for e in edges]
    with f32_precision():
        nodes = _se3_stack(poses, device)
        graph = _graph(src, dst, rels, weights, device)
        if optimizer == "sim3":
            # a verified loop edge must not be down-weighted for carrying
            # exactly the big residual it exists to close
            opt, _scales, _costs = optimize_pose_graph_sim3(
                nodes, graph, num_iters=pg_iters, robust_delta=1e6)
        else:
            opt, _costs = optimize_pose_graph(nodes, graph,
                                              num_iters=pg_iters)
        M = opt.matrix().cpu().numpy()
    return [M[k] for k in range(F)], edges


def smooth_keyframe_graph(frame_cache, poses, kf_frames, K,
                          skips: Tuple[int, ...] = (2, 4),
                          min_inliers: int = 20, pg_iters: int = 60,
                          inl_th: float = 2e-3,
                          generator: Optional[torch.Generator] = None, *,
                          draws: Optional[Dict[Tuple[int, int],
                                               torch.Tensor]] = None,
                          device: Device = "cuda"
                          ) -> List[np.ndarray]:
    """Short-range skip-edge pose graph over the keyframe chain: PnP edges
    between keyframes `s` apart (the loop-closure verification, so the
    edges carry world scale) cut the effective path length by `s`.

    poses: per-frame world→cam poses. kf_frames: frame index per
    keyframe. Returns corrected per-frame poses (keyframes moved by the
    graph; in-between frames are re-anchored by the caller, as
    VisualOdometry.smooth_keyframes does). `draws` maps a verified pair
    (frame b, frame a) to its PnP noise."""
    n = len(kf_frames)
    if n < 3:
        return [p.copy() for p in poses]
    src, dst, rels, weights = [], [], [], []
    for a in range(n - 1):
        fa, fb = kf_frames[a], kf_frames[a + 1]
        src.append(a)
        dst.append(a + 1)
        rels.append(np.linalg.inv(poses[fa]) @ poses[fb])
        weights.append(1.0)
    for s in skips:
        for a in range(n - s):
            fa, fb = kf_frames[a], kf_frames[a + s]
            T_rel, n_inl, n_map = verify_loop(
                frame_cache, poses, fb, fa, K, inl_th=inl_th,
                generator=generator,
                gumbel=None if draws is None else draws.get((fb, fa)),
                device=device)
            if T_rel is None or n_inl < min_inliers:
                continue
            src.append(a)
            dst.append(a + s)
            rels.append(T_rel)  # meas(fa→fb) = T_fa⁻¹ T_fb
            weights.append(min(n_inl, 100) / 30.0)
    if len(src) == n - 1:  # no skip edge verified: nothing to smooth
        return [p.copy() for p in poses]
    with f32_precision():
        nodes = _se3_stack([poses[k] for k in kf_frames], device)
        graph = _graph(src, dst, rels, weights, device)
        opt, _costs = optimize_pose_graph(nodes, graph, num_iters=pg_iters)
        M = opt.matrix().cpu().numpy()
    out = [p.copy() for p in poses]
    for a, k in enumerate(kf_frames):
        out[k] = M[a]
    return out
