"""Sequential monocular visual odometry with scale propagation, keyframes
and windowed bundle adjustment (counterpart of ``kornia_tpu/slam/vo.py``).

  * ``detect`` runs once per frame; the next pair reuses its features.
  * The pair step matches the frame against the last keyframe, runs
    essential and homography RANSAC (ORB-SLAM-style model choice) and PnP
    against the keyframe's map, and updates the per-keypoint depth table.
    Both branches of each choice are computed and selected with
    ``torch.where``, so the step reads the device once, after it ends.
  * A frame becomes a keyframe when its scale-free parallax clears
    `kf_parallax`, its matches to the keyframe decay, or `kf_max_skip`
    frames were skipped; in-between frames are anchored to their keyframe.
  * Bundle adjustment over chained keyframe tracks: a structure-only
    phase, a contamination gate, then GNC huber → cauchy → re-gated huber.

``VisualOdometry`` runs on ``cuda`` unless the caller passes
``device="cpu"``; the whole loop runs in true float32 (TF32 off). Poses
are float64 numpy arrays on the host, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.dtype import float32_on as _f32
from ..core.linalg import f32_precision
from ..feature.integrated import GFTTSIFTFeature, LocalFeatureMatcher
from ..feature.matching import DescriptorMatcher, match_smnn
from ..geometry.calibration import pnp_ransac
from ..geometry.conversions import normalize_points_with_intrinsics
from ..geometry.epipolar import (
    motion_from_essential_choose_solution,
    motion_from_homography_choose_solution,
    projection_from_KRt,
    triangulate_points,
)
from ..geometry.liegroup import Se3, So3
from ..geometry.ransac import _error as _ransac_error, ransac
from .ba import BAProblem, BAState, bundle_adjust, reprojection_residuals

__all__ = ["VisualOdometry", "VOResult"]

Device = Union[str, torch.device]


@dataclasses.dataclass
class VOResult:
    poses: List[np.ndarray]  # (4, 4) world→camera per frame
    num_inliers: List[int]


def _masked_median(x: torch.Tensor, mask: torch.Tensor, fill: float = 1.0
                   ) -> torch.Tensor:
    """Median over masked entries (the lower middle for an even count);
    `fill` when the mask is empty."""
    order = torch.sort(torch.where(mask, x, torch.inf)).values
    cnt = mask.sum()
    mid = (cnt - 1).clamp_min(0) // 2
    med = torch.gather(order, 0, mid.reshape(1))[0]
    return torch.where(cnt > 0, med, fill)


def _i64(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, np.int64)).to(device)


def _bool(x, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(x, bool)).to(device)


class VisualOdometry:
    """Monocular VO: detect once per frame → match → E/H RANSAC and PnP →
    scale-propagated chaining → keyframe bundle adjustment."""

    def __init__(self, K: torch.Tensor, num_features: int = 512,
                 window: int = 5, ransac_iters: int = 32,
                 ransac_batch: int = 256, inl_th_px: float = 1.5,
                 ba_iters: int = 12, matcher_th: float = 0.95,
                 global_ba_frames: int = 128,
                 kf_parallax: float = 0.022, kf_max_skip: int = 6,
                 kf_min_matches: int = 48, kf_match_decay: float = 0.45,
                 gnc_deltas: Tuple[float, float, float] = (24.0, 2.0, 1.0),
                 ba_track_budget: int = 4096,
                 incremental_ba: bool = True,
                 ba_map_feedback: bool = False,
                 incremental_fix: int = 2,
                 global_ba_passes: int = 2,
                 incremental_rot_gate: float = 0.2,
                 device: Device = "cuda"):
        self.device = torch.device(device)
        self._K_np = np.asarray(
            K.detach().cpu() if isinstance(K, torch.Tensor) else K,
            np.float32)
        self.K = _f32(self._K_np, self.device)
        self.window = window
        self.ba_iters = ba_iters
        self.global_ba_frames = global_ba_frames
        self.ransac_iters = ransac_iters
        self.ransac_batch = ransac_batch
        self.inl_th_px = inl_th_px
        self.matcher_th = matcher_th
        self.pnp_min_inliers = 20
        # keyframe promotion: parallax gate (baseline / median depth,
        # scale-free), forced on match decay or after max skip
        self.kf_parallax = kf_parallax
        self.kf_max_skip = kf_max_skip
        self.kf_min_matches = kf_min_matches
        self.kf_match_decay = kf_match_decay
        # GNC schedule (multiples of s_px): wide huber, cauchy, tight
        # re-gated huber
        self.gnc_deltas = gnc_deltas
        # track-table cap of the window and global BA; over it,
        # _build_window_tracks keeps a stratified selection
        self.ba_track_budget = ba_track_budget
        # the reference keeps this unvalidated: any value other than False
        # and "map-only" writes the window's poses back
        self.incremental_ba = incremental_ba
        self.ba_map_feedback = ba_map_feedback
        self.incremental_fix = incremental_fix
        self.global_ba_passes = global_ba_passes
        # incremental pose writes are gated on the window's rotation span
        self.incremental_rot_gate = incremental_rot_gate
        self.feature = GFTTSIFTFeature(num_features=num_features)
        self.matcher = LocalFeatureMatcher(
            self.feature, DescriptorMatcher("smnn", matcher_th))
        self._detect_jit = None
        self._pair_jit = None

    @property
    def _focal(self) -> float:
        return 0.5 * float(self._K_np[0, 0] + self._K_np[1, 1])

    # -- stage 1: per-frame features -----------------------------------
    def _detect_fn(self):
        if self._detect_jit is not None:
            return self._detect_jit
        feat, dev = self.feature, self.device

        def fn(img):
            lafs, resps, descs, valid = feat(_f32(img, dev))
            kp = lafs[0, :, :, 2]
            return kp, descs[0], valid[0]

        self._detect_jit = fn
        return fn

    # -- stage 2: pair pose + map update --------------------------------
    def _pair_fn(self):
        if self._pair_jit is not None:
            return self._pair_jit
        rb, ri, mth = self.ransac_batch, self.ransac_iters, self.matcher_th
        pnp_min = self.pnp_min_inliers

        def fn(kp0, d0, v0, kp1, d1, v1, K, generator, inl_th,
               depth_prev, has_prev, R0, t0, draws=None):
            """One tracking step (keyframe → frame i), absolute poses.

            depth_prev: (K,) per-keypoint map depth in the keyframe's
            camera, world scale (0 = no map point). R0/t0: world→cam of
            the keyframe. `draws`: (essential RANSAC, homography RANSAC,
            PnP) Gumbel noise in the place of `generator`'s."""
            g_e, g_h, g_p = draws if draws is not None else (None,) * 3
            dev, dt = kp0.device, kp0.dtype
            eye = torch.eye(3, dtype=dt, device=dev)
            dists, idx, mvalid = match_smnn(d0, d1, mth, v0, v1)
            mkp1 = kp1[idx[:, 1]]
            x0 = normalize_points_with_intrinsics(kp0, K)
            x1 = normalize_points_with_intrinsics(mkp1, K)

            # --- branch A: two-view E/H (bootstrap + fallback) ----------
            res_e = ransac(x0, x1, generator, "essential", inl_th=inl_th,
                           batch_size=rb, max_iterations=ri, mask=mvalid,
                           gumbel=g_e)
            res_h = ransac(x0, x1, generator, "homography", inl_th=inl_th,
                           batch_size=rb, max_iterations=ri, mask=mvalid,
                           gumbel=g_h)
            R_e, t_e, _ = motion_from_essential_choose_solution(
                res_e.model[None], eye[None], eye[None],
                x0[None], x1[None], mask=res_e.inliers[None])
            R_h, t_h, _ = motion_from_homography_choose_solution(
                res_h.model[None], x0[None], x1[None],
                mask=res_h.inliers[None])
            # planar/pure-rotation degeneracy: prefer H when it explains
            # nearly as many correspondences as E
            use_h = res_h.inlier_count > 0.85 * \
                res_e.inlier_count.clamp_min(1)
            R2v = torch.where(use_h, R_h[0], R_e[0])
            t2v = torch.where(use_h, t_h[0], t_e[0])
            inl_2v = torch.where(use_h, res_h.inliers, res_e.inliers) \
                & mvalid
            n_2v = torch.where(use_h, res_h.inlier_count,
                               res_e.inlier_count)
            t2v = t2v[:, 0] / torch.linalg.vector_norm(
                t2v[:, 0]).clamp_min(1e-9)

            # two-view translation scale from map-depth ratios
            zero = torch.zeros((3, 1), dtype=dt, device=dev)
            P0u = torch.cat([eye, zero], -1)
            P1u = torch.cat([R2v, t2v[:, None]], -1)
            Xu = triangulate_points(P0u[None], P1u[None],
                                    x0[None], x1[None])[0]
            zu0 = Xu[:, 2]
            zu1 = (Xu @ R2v.T + t2v)[:, 2]
            good_u = inl_2v & (zu0 > 1e-3) & (zu1 > 1e-3)
            common = good_u & (depth_prev > 0.0)
            ratio = depth_prev / zu0.clamp_min(1e-9)
            scale = _masked_median(ratio, common, fill=1.0)
            scale = torch.where(has_prev & (common.sum() >= 5), scale, 1.0)
            scale = scale.clamp(0.05, 20.0)
            R1_2v = R2v @ R0
            t1_2v = R2v @ t0 + scale * t2v

            # --- branch B: PnP against the map (primary tracking) -------
            x0h = torch.cat([x0, torch.ones_like(x0[:, :1])], -1)
            Xc0 = depth_prev[:, None] * x0h  # (K, 3) keyframe camera
            Xw = (Xc0 - t0) @ R0  # R0^T (Xc0 - t0)
            map_ok = mvalid & (depth_prev > 0.0)
            R1_p, t1_p, inl_p, n_p = pnp_ransac(
                Xw, x1, generator, 2.0 * inl_th, mask=map_ok,
                batch_size=rb // 2, gn_iters=5, gumbel=g_p)

            # PnP wins only with both absolute support and a healthy
            # inlier ratio
            n_map = map_ok.sum()
            use_pnp = has_prev & (n_p >= pnp_min) & \
                (n_p >= 0.6 * n_map.clamp_min(1))
            R1 = torch.where(use_pnp, R1_p, R1_2v)
            t1 = torch.where(use_pnp, t1_p, t1_2v)
            inliers = torch.where(use_pnp, inl_p, inl_2v)
            n_inl = torch.where(use_pnp, n_p, n_2v)

            # --- map update: triangulate matches at world scale ---------
            R_rel = R1 @ R0.T
            t_rel = t1 - R_rel @ t0
            P1 = torch.cat([R_rel, t_rel[:, None]], -1)
            X = triangulate_points(P0u[None], P1[None], x0[None],
                                   x1[None])[0]
            z0 = X[:, 2]
            z1 = (X @ R_rel.T + t_rel)[:, 2]

            # BA track gate: a loose (5x) residual bound under either final
            # two-view model
            e_e = _ransac_error("essential", x0, x1, res_e.model[None])[0]
            e_h = _ransac_error("homography", x0, x1, res_h.model[None])[0]
            loose = 25.0 * inl_th * inl_th
            track_mask = mvalid & ((e_e < loose) | (e_h < loose))

            good = track_mask & (z0 > 1e-3) & (z1 > 1e-3) \
                & (torch.linalg.vector_norm(t_rel) > 1e-6)
            # map densification: a matched keypoint whose fresh
            # triangulation fails the gate but which carries a map depth
            # keeps it, propagated through the relative motion
            z_prop = (Xc0 @ R_rel.T + t_rel)[:, 2]
            prop_ok = track_mask & (depth_prev > 0.0) & (z_prop > 1e-3)
            val = torch.where(good, z1, torch.where(prop_ok, z_prop, 0.0))
            # max scatter on zeros: duplicate/invalid indices write 0 and
            # can never clobber a real depth (exact, order-free)
            depth_next = torch.zeros_like(depth_prev).scatter_reduce_(
                0, idx[:, 1], val, "amax", include_self=True)
            # scale-free parallax of this pair: 1 / median unit depth
            zmed_u = _masked_median(zu0, good_u, fill=1e6)
            parallax = 1.0 / zmed_u.clamp_min(1e-6)
            f32 = torch.float32
            diag = torch.stack([map_ok.sum().to(f32), n_p.to(f32),
                                use_pnp.to(f32), n_2v.to(f32), scale,
                                parallax, mvalid.sum().to(f32),
                                use_h.to(f32)])
            return R1, t1, inliers, n_inl, depth_next, idx, track_mask, diag

        self._pair_jit = fn
        return fn

    def run(self, frames: List[torch.Tensor],
            generator: Optional[torch.Generator] = None,
            refine: bool = True, verbose: bool = False, *,
            draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor,
                                           torch.Tensor]]] = None
            ) -> VOResult:
        """frames: list of (1, 1, H, W) images. Returns world→cam poses
        with the first frame as identity; the first keyframe pair's
        baseline fixes the monocular scale, later steps propagate it
        through shared tracks. `refine` runs the keyframe bundle
        adjustment.

        Sampling noise comes from `generator` (on the VO's device; None: a
        generator seeded with 0), or is injected as `draws`, one
        (essential (ransac_iters, ransac_batch, K), homography (same),
        PnP (ransac_batch // 2, K)) Gumbel triple for each frame after the
        first."""
        if generator is None and draws is None:
            generator = torch.Generator(self.device).manual_seed(0)
        with f32_precision():
            return self._run(frames, generator, refine, verbose, draws)

    def _run(self, frames, generator, refine, verbose, draws) -> VOResult:
        detect = self._detect_fn()
        pair = self._pair_fn()
        dev = self.device
        inl_th = float(np.float32(self.inl_th_px / self._focal))

        poses = [np.eye(4)]
        inliers = []
        # keyframe bookkeeping: every frame is tracked against the last
        # keyframe; BA chains keyframes only
        kf_frames: List[int] = [0]  # frame index per keyframe
        kf_kps: List[np.ndarray] = []  # keypoints per keyframe
        kf_next: List[np.ndarray] = []  # per kf pair: (K,) next-kf index
        kf_inl: List[np.ndarray] = []  # per kf pair: (K,) track mask
        # non-keyframe anchors: frame -> (kf position, T_rel)
        anchors: Dict[int, Tuple[int, np.ndarray]] = {}
        # frames before the first promoted pair, retro-rescaled by their
        # parallax ratio
        pre_boot: List[Tuple[int, float]] = []
        # per-frame cache for loop closure: keypoints, descriptors,
        # validity and the frame's map-depth table
        self.frame_cache: List[Dict[str, np.ndarray]] = []
        kp_kf, d_kf, v_kf = detect(frames[0])
        kf_kps.append(kp_kf.cpu().numpy())
        self.frame_cache.append({"kp": kf_kps[0],
                                 "desc": d_kf.cpu().numpy(),
                                 "valid": v_kf.cpu().numpy(),
                                 "depth": np.zeros(kp_kf.shape[0],
                                                   np.float32)})
        Kf = kp_kf.shape[0]
        depth_kf = torch.zeros((Kf,), dtype=torch.float32, device=dev)
        has_map = torch.tensor(False, device=dev)
        R_kf = torch.eye(3, dtype=torch.float32, device=dev)
        t_kf = torch.zeros(3, dtype=torch.float32, device=dev)
        bootstrapped = False
        n_match_kf = Kf  # match support at the last promotion
        skipped = 0
        W = self.window
        for i in range(1, len(frames)):
            kp_cur, d_cur, v_cur = detect(frames[i])
            (R_cur, t_cur, inl, n_inl, depth_cur, idx, track_mask,
             diag) = pair(
                kp_kf, d_kf, v_kf, kp_cur, d_cur, v_cur, self.K, generator,
                inl_th, depth_kf, has_map, R_kf, t_kf,
                None if draws is None else draws[i - 1])
            # the one read of the step's results from the device
            h = _read_step(R_cur, t_cur, n_inl, diag, kp_cur, d_cur, v_cur,
                           depth_cur, idx, track_mask)
            d = h["diag"]
            parallax = float(d[5])
            n_match = int(d[6])
            M = np.eye(4)
            M[:3, :3] = h["R"]
            M[:3, 3] = h["t"]
            poses.append(M)
            inliers.append(h["n_inl"])
            promote = (parallax >= self.kf_parallax
                       or skipped >= self.kf_max_skip
                       or n_match < max(self.kf_min_matches,
                                        self.kf_match_decay * n_match_kf)
                       or i == len(frames) - 1)
            if verbose:
                print(f"  [vo] frame {i}: map={int(d[0])} pnp_inl={int(d[1])} "
                      f"use_pnp={bool(d[2])} n_2v={int(d[3])} "
                      f"scale={d[4]:.3f} plx={parallax:.4f} "
                      f"match={n_match} kf={promote}")
            cache = {"kp": h["kp"], "desc": h["desc"], "valid": h["valid"]}
            if not promote:
                if not bootstrapped:
                    # no world scale yet: unit-baseline two-view pose,
                    # rescaled once the first keyframe pair fixes scale
                    pre_boot.append((i, parallax))
                else:
                    kf_pose = poses[kf_frames[-1]]
                    anchors[i] = (len(kf_frames) - 1,
                                  M @ np.linalg.inv(kf_pose))
                skipped += 1
                self.frame_cache.append(dict(cache, depth=h["depth"]))
                continue
            # --- keyframe promotion -----------------------------------
            if not bootstrapped and pre_boot:
                # the promoted pair's unit baseline defines the world
                # scale; earlier skipped frames' true baseline fraction is
                # p_i / p_promoted
                p_p = max(parallax, 1e-6)
                for fi, p_i in pre_boot:
                    poses[fi][:3, 3] *= min(p_i / p_p, 1.0)
                    anchors[fi] = (0, poses[fi].copy())
                pre_boot = []
            bootstrapped = True
            kf_pos = len(kf_frames)
            kf_frames.append(i)
            kf_kps.append(h["kp"])
            kf_next.append(h["idx"])
            # BA tracks use the loose either-model gate, not the tight
            # RANSAC inliers
            kf_inl.append(h["track_mask"])
            n_match_kf = max(n_match, 1)
            skipped = 0
            depth_kf = depth_cur
            cache_depth = h["depth"]
            has_map = torch.tensor(True, device=dev)
            if refine and self.incremental_ba and kf_pos >= 2:
                # incremental local BA over the last <= W keyframes, before
                # the next tracking step
                s = max(0, kf_pos - W + 1)
                kf_poses = [poses[k] for k in kf_frames]
                ba_depth = self._refine_span(kf_kps, kf_next, kf_inl,
                                             kf_poses, s, kf_pos - s + 1,
                                             fix_first=min(
                                                 self.incremental_fix,
                                                 kf_pos - s))
                R_a = poses[kf_frames[s]][:3, :3]
                R_b = poses[kf_frames[kf_pos]][:3, :3]
                cos_span = 0.5 * (np.trace(R_b @ R_a.T) - 1.0)
                rot_span = float(np.arccos(np.clip(cos_span, -1.0, 1.0)))
                if (self.incremental_ba != "map-only"
                        and rot_span <= self.incremental_rot_gate):
                    for j, k in enumerate(kf_frames):
                        poses[k] = kf_poses[j]
                if ba_depth is not None:
                    # the loop-closure cache always gets the BA-refined
                    # map; PnP tracking feedback stays gated
                    cache_depth = np.where(ba_depth > 0.0, ba_depth,
                                           h["depth"]).astype(np.float32)
                    if self.ba_map_feedback:
                        depth_kf = _f32(cache_depth, dev)
            R_kf = _f32(poses[i][:3, :3], dev)
            t_kf = _f32(poses[i][:3, 3], dev)
            self.frame_cache.append(dict(cache, depth=cache_depth))
            kp_kf, d_kf, v_kf = kp_cur, d_cur, v_cur
        if refine and 3 <= len(kf_frames) <= self.global_ba_frames:
            # final pass over the keyframe chain (gauge anchored at the
            # first keyframe)
            kf_poses = [poses[k] for k in kf_frames]
            kf_poses = self._refine_tracks(kf_kps, kf_next, kf_inl,
                                           kf_poses)
            for j, k in enumerate(kf_frames):
                poses[k] = kf_poses[j]
        # re-anchor non-keyframe poses onto the refined keyframe chain
        for fi, (kpos, T_rel) in anchors.items():
            poses[fi] = T_rel @ poses[kf_frames[kpos]]
        self.kf_frames = kf_frames
        # the keyframe track tables + anchors, for refine_from_cache
        self._kf_tracks = (kf_kps, kf_next, kf_inl)
        self._anchors = dict(anchors)
        return VOResult(poses=poses, num_inliers=inliers)

    def smooth_keyframes(self, poses: List[np.ndarray],
                         skips: Tuple[int, ...] = (2, 4),
                         pg_iters: int = 60,
                         generator: Optional[torch.Generator] = None
                         ) -> List[np.ndarray]:
        """Skip-edge pose-graph smoothing over the keyframe chain
        (slam/loop_closure.py::smooth_keyframe_graph) + re-anchoring of
        the in-between frames. Requires a prior `run`."""
        if not hasattr(self, "kf_frames"):
            raise RuntimeError("smooth_keyframes requires a prior run()")
        from .loop_closure import smooth_keyframe_graph
        out = smooth_keyframe_graph(self.frame_cache, poses, self.kf_frames,
                                    self._K_np, skips=skips,
                                    pg_iters=pg_iters,
                                    inl_th=self.inl_th_px / self._focal,
                                    generator=generator, device=self.device)
        for fi, (kpos, T_rel) in self._anchors.items():
            out[fi] = T_rel @ out[self.kf_frames[kpos]]
        return out

    def refine_from_cache(self, poses: List[np.ndarray]
                          ) -> List[np.ndarray]:
        """Re-run the keyframe bundle adjustment from an updated pose set
        (global BA after loop closure) and re-anchor the non-keyframes,
        with the track tables cached by the last `run`. The tracks carry
        no loop-closing observations."""
        if not hasattr(self, "_kf_tracks"):
            raise RuntimeError("refine_from_cache requires a prior run()")
        kf_kps, kf_next, kf_inl = self._kf_tracks
        kf_poses = [poses[k] for k in self.kf_frames]
        with f32_precision():
            kf_poses = self._refine_tracks(kf_kps, kf_next, kf_inl,
                                           kf_poses)
        out = [p.copy() for p in poses]
        for j, k in enumerate(self.kf_frames):
            out[k] = kf_poses[j]
        for fi, (kpos, T_rel) in self._anchors.items():
            out[fi] = T_rel @ out[self.kf_frames[kpos]]
        return out

    # -- sliding-window BA over chained tracks ----------------------------
    def _ba_window_fn(self, C: int, T_max: int, O_max: int,
                      fix_first: int = 2):
        """Fixed-shape window BA: triangulate tracks from their first/last
        observations, then LM with the first `fix_first` cameras fixed
        (windows fix two; the global pass fixes one). The reference caches
        one compiled executable per shape; here there is nothing to
        cache."""
        ba_iters = self.ba_iters
        d_wide, d_cauchy, d_tight = self.gnc_deltas
        # robust deltas are pixel thresholds scaled with the focal length
        s_px = self._focal / 256.0

        def fn(R_stack, t_stack, obs_cam, obs_trk, obs_uv, obs_valid,
               tri_cam0, tri_uv0, tri_cam1, tri_uv1, trk_valid, K):
            P_all = projection_from_KRt(K.expand(C, 3, 3), R_stack,
                                        t_stack[..., None])
            X = triangulate_points(
                P_all[tri_cam0], P_all[tri_cam1],
                tri_uv0[:, None], tri_uv1[:, None])[:, 0]  # (T, 3)
            # cheirality guard: a track behind either triangulating camera
            # is excluded
            Xc0 = torch.einsum("tij,tj->ti", R_stack[tri_cam0], X) \
                + t_stack[tri_cam0]
            Xc1 = torch.einsum("tij,tj->ti", R_stack[tri_cam1], X) \
                + t_stack[tri_cam1]
            ok = trk_valid & (Xc0[:, 2] > 1e-4) & (Xc1[:, 2] > 1e-4)
            valid = obs_valid & ok[obs_trk]
            problem = BAProblem(obs_cam, obs_trk, obs_uv, valid, K)
            state0 = BAState(Se3(So3.from_matrix(R_stack), t_stack),
                             torch.where(ok[:, None], X, 1.0))
            # contamination gate: a track chaining two physical features
            # has a large mean init residual over all its observations
            # (the 400 px cap is the reference's, kept)
            r0 = reprojection_residuals(state0, problem)
            rn = torch.linalg.vector_norm(r0, dim=-1).clamp_max(400.0)
            dt = X.dtype
            cnt = torch.zeros(T_max, dtype=dt, device=X.device).index_add_(
                0, obs_trk, valid.to(dt))
            rsum = torch.zeros(T_max, dtype=dt, device=X.device).index_add_(
                0, obs_trk, torch.where(valid, rn, 0.0))
            rmean = rsum / cnt.clamp_min(1.0)
            ok = ok & (rmean < 2.0 * d_wide * s_px)
            valid = obs_valid & ok[obs_trk]
            problem = BAProblem(obs_cam, obs_trk, obs_uv, valid, K)
            # structure-only init: all cameras fixed pulls the points onto
            # the chained geometry first
            state0, _cs = bundle_adjust(
                state0, problem, C, T_max, num_iters=4,
                robust="huber", robust_delta=d_wide * s_px,
                fix_first_cam=C)
            # graduated non-convexity: wide huber, cauchy, then a tight
            # re-gated huber polish
            state, c0 = bundle_adjust(
                state0, problem, C, T_max, num_iters=max(ba_iters // 2, 4),
                robust="huber", robust_delta=d_wide * s_px,
                fix_first_cam=fix_first)
            state, c1 = bundle_adjust(
                state, problem, C, T_max, num_iters=ba_iters,
                robust="cauchy", robust_delta=d_cauchy * s_px,
                fix_first_cam=fix_first)
            res = reprojection_residuals(state, problem)
            good = valid & ((res * res).sum(-1)
                            < 4.0 * d_tight * d_tight * s_px * s_px)
            problem2 = BAProblem(obs_cam, obs_trk, obs_uv, good, K)
            state, c2 = bundle_adjust(
                state, problem2, C, T_max, num_iters=max(ba_iters // 2, 3),
                robust="huber", robust_delta=d_tight * s_px,
                fix_first_cam=fix_first)
            return (state.poses.matrix(), state.points, ok,
                    torch.cat([c0, c1, c2]))

        return fn

    def _refine_tracks(self, kps: List[np.ndarray], pair_next: List[np.ndarray],
                       pair_inl: List[np.ndarray], poses: List[np.ndarray]
                       ) -> List[np.ndarray]:
        """Chain per-pair matches into multi-frame tracks and
        bundle-adjust. Sequences up to `global_ba_frames` are refined as
        one window, `global_ba_passes` times (each pass re-triangulates
        from the previous pass's poses); longer ones by sliding windows of
        `self.window` frames with stride W-2."""
        N = len(kps)
        if N >= 3 and N <= self.global_ba_frames:
            poses = [p.copy() for p in poses]
            for _ in range(self.global_ba_passes):
                self._refine_span(kps, pair_next, pair_inl, poses, 0, N,
                                  fix_first=1)
            return poses
        W = min(self.window, N)
        if W < 3:
            return poses
        starts = list(range(0, N - W + 1, W - 2))
        if starts[-1] != N - W:
            starts.append(N - W)
        poses = [p.copy() for p in poses]
        for s in starts:
            self._refine_span(kps, pair_next, pair_inl, poses, s, W)
        return poses

    def _refine_span(self, kps, pair_next, pair_inl, poses, s: int, W: int,
                     fix_first: int = 2):
        """Bundle-adjust frames [s, s+W) in place (first `fix_first` fixed).

        Returns the refined map depth table of frame s+W-1 ((Kf,) z in
        that camera, world scale, 0 where no refined track exists), or
        None when the window could not be built."""
        if W < 3:
            return None
        Kf = kps[0].shape[0]
        T_budget = min(Kf * (W - 1), self.ba_track_budget)
        O_budget = min(2 * Kf * (W - 1), Kf * W)
        built = self._build_window_tracks(kps, pair_next, pair_inl, s, W,
                                          T_budget, O_budget)
        if built is None:
            return None
        (obs_cam, obs_trk, obs_uv, obs_valid, first_cam, first_uv,
         last_cam, last_uv, trk_valid, kp_at_last) = built
        ba = self._ba_window_fn(W, T_budget, O_budget, fix_first)
        dev = self.device
        R_stack = _f32(np.stack([poses[s + i][:3, :3] for i in range(W)]),
                       dev)
        t_stack = _f32(np.stack([poses[s + i][:3, 3] for i in range(W)]),
                       dev)
        M, X, ok, _costs = ba(
            R_stack, t_stack, _i64(obs_cam, dev), _i64(obs_trk, dev),
            _f32(obs_uv, dev), _bool(obs_valid, dev),
            _i64(first_cam, dev), _f32(first_uv, dev),
            _i64(last_cam, dev), _f32(last_uv, dev),
            _bool(trk_valid, dev), self.K)
        M = M.cpu().numpy()
        for i in range(fix_first, W):
            poses[s + i] = M[i]
        # refined map for the newest frame: depth of each surviving track
        # in camera s+W-1
        X = X.cpu().numpy()
        ok = ok.cpu().numpy()
        Rl, tl = M[W - 1][:3, :3], M[W - 1][:3, 3]
        z_last = X @ Rl[2] + tl[2]  # (T,)
        has = kp_at_last >= 0
        tid = np.where(has, kp_at_last, 0)
        depth = np.where(has & ok[tid] & (z_last[tid] > 1e-3),
                         z_last[tid], 0.0).astype(np.float32)
        return depth

    def _build_window_tracks(self, kps, pair_next, pair_inl, s: int, W: int,
                             T_budget: int, O_budget: int):
        """Chain tracks over frames [s, s+W); pad to (T_budget, O_budget)
        static shapes, keeping a stratified selection of the longest
        tracks when over budget."""
        Kf = kps[0].shape[0]
        track_of = np.full((W, Kf), -1, np.int64)
        n_trk = 0
        cams, trks, uvs = [], [], []
        first_cam = np.zeros(Kf * (W - 1), np.int64)
        first_kp = np.zeros(Kf * (W - 1), np.int64)
        for f in range(W - 1):
            nxt = pair_next[s + f]
            inl = pair_inl[s + f]
            js = np.nonzero(inl)[0]
            tids = track_of[f, js]
            new = tids < 0
            n_new = int(new.sum())
            new_ids = np.arange(n_trk, n_trk + n_new)
            tids = tids.copy()
            tids[new] = new_ids
            first_cam[new_ids] = f
            first_kp[new_ids] = js[new]
            n_trk += n_new
            # new tracks contribute their first observation
            cams.append(np.full(n_new, f))
            trks.append(new_ids)
            uvs.append(kps[s + f][js[new]])
            # all inlier matches contribute the next-frame observation
            cams.append(np.full(js.shape[0], f + 1))
            trks.append(tids)
            uvs.append(kps[s + f + 1][nxt[js]])
            track_of[f + 1, nxt[js]] = tids
        if n_trk < 8:
            return None
        obs_cam_all = np.concatenate(cams)
        obs_trk_all = np.concatenate(trks)
        obs_uv_all = np.concatenate(uvs).astype(np.float32)

        lengths = np.bincount(obs_trk_all, minlength=n_trk)
        kp_at_last = track_of[W - 1].copy()  # (Kf,) track id per keypoint
        if n_trk > T_budget or obs_cam_all.shape[0] > O_budget:
            # stratified selection: round-robin the longest tracks from
            # each first-frame bucket, so every inter-frame link keeps
            # constraints
            by_frame = [[] for _ in range(W)]
            order = np.argsort(-lengths[:n_trk], kind="stable")
            for t in order:
                by_frame[first_cam[t]].append(t)
            keep_list = []
            ptr = [0] * W
            while len(keep_list) < min(n_trk, T_budget):
                advanced = False
                for f in range(W):
                    if ptr[f] < len(by_frame[f]) and len(keep_list) < T_budget:
                        keep_list.append(by_frame[f][ptr[f]])
                        ptr[f] += 1
                        advanced = True
                if not advanced:
                    break
            keep = np.asarray(keep_list, np.int64)
            # trim further until the observation budget fits
            csum = np.cumsum(lengths[keep])
            n_keep = int(np.searchsorted(csum, O_budget, side="right"))
            keep = keep[:max(n_keep, 8)]
            remap = np.full(n_trk, -1, np.int64)
            remap[keep] = np.arange(keep.shape[0])
            sel = remap[obs_trk_all] >= 0
            obs_cam_all = obs_cam_all[sel]
            obs_trk_all = remap[obs_trk_all[sel]]
            obs_uv_all = obs_uv_all[sel]
            first_cam = first_cam[keep]
            first_kp = first_kp[keep]
            kp_at_last = np.where(kp_at_last >= 0, remap[kp_at_last], -1)
            n_trk = keep.shape[0]
        n_obs = obs_cam_all.shape[0]
        if n_obs > O_budget or n_trk < 8:
            return None

        obs_cam = np.zeros(O_budget, np.int64)
        obs_trk = np.zeros(O_budget, np.int64)
        obs_uv = np.zeros((O_budget, 2), np.float32)
        obs_valid = np.zeros(O_budget, bool)
        obs_cam[:n_obs] = obs_cam_all
        obs_trk[:n_obs] = obs_trk_all
        obs_uv[:n_obs] = obs_uv_all
        obs_valid[:n_obs] = True

        # first/last observation per track; duplicate-index assignment
        # keeps the last occurrence and observations are in frame order
        fc = np.zeros(T_budget, np.int64)
        fuv = np.zeros((T_budget, 2), np.float32)
        lc = np.zeros(T_budget, np.int64)
        luv = np.zeros((T_budget, 2), np.float32)
        lc[obs_trk_all] = obs_cam_all
        luv[obs_trk_all] = obs_uv_all
        kp_stack = np.stack(kps[s:s + W])  # (W, Kf, 2)
        fc[:n_trk] = first_cam[:n_trk]
        fuv[:n_trk] = kp_stack[first_cam[:n_trk], first_kp[:n_trk]]
        trk_valid = np.zeros(T_budget, bool)
        trk_valid[:n_trk] = lc[:n_trk] > fc[:n_trk]
        return (obs_cam, obs_trk, obs_uv, obs_valid, fc, fuv, lc, luv,
                trk_valid, kp_at_last)

    def refine_window(self, frames: List[torch.Tensor],
                      poses: List[np.ndarray],
                      generator: Optional[torch.Generator] = None
                      ) -> Tuple[List[np.ndarray], torch.Tensor]:
        """Windowed BA over the last `window` frames: matches each
        consecutive pair, triangulates from current poses, bundles.
        `generator` is accepted in the place of the reference's unused
        key."""
        dev = self.device
        W = min(self.window, len(frames))
        frames_w = frames[-W:]
        poses_w = poses[-W:]
        C = len(frames_w)
        cam_idx_list, pt_idx_list, uv_list = [], [], []
        pts3d_list = []
        n_pts = 0
        with f32_precision():
            for i in range(C - 1):
                out = self.matcher({"image0": _f32(frames_w[i], dev),
                                    "image1": _f32(frames_w[i + 1], dev)})
                kp0 = out["keypoints0"][0]
                kp1 = out["keypoints1"][0]
                valid = out["valid"][0].cpu().numpy()
                idx = np.where(valid)[0]
                if idx.size == 0:
                    continue
                P0 = projection_from_KRt(
                    self.K[None], _f32(poses_w[i][None, :3, :3], dev),
                    _f32(poses_w[i][None, :3, 3:4], dev))
                P1 = projection_from_KRt(
                    self.K[None], _f32(poses_w[i + 1][None, :3, :3], dev),
                    _f32(poses_w[i + 1][None, :3, 3:4], dev))
                X = triangulate_points(P0, P1, kp0[None], kp1[None])[0]
                Xv = X.cpu().numpy()[idx]
                kp0v = kp0.cpu().numpy()[idx]
                kp1v = kp1.cpu().numpy()[idx]
                m = idx.size
                pts3d_list.append(Xv)
                cam_idx_list += [np.full(m, i), np.full(m, i + 1)]
                pt_idx_list += [np.arange(n_pts, n_pts + m)] * 2
                uv_list += [kp0v, kp1v]
                n_pts += m
            if n_pts == 0:
                return poses, torch.zeros(1, device=dev)
            problem = BAProblem(
                _i64(np.concatenate(cam_idx_list), dev),
                _i64(np.concatenate(pt_idx_list), dev),
                _f32(np.concatenate(uv_list), dev),
                torch.ones(sum(len(c) for c in cam_idx_list),
                           dtype=torch.bool, device=dev), self.K)
            R_stack = _f32(np.stack([p[:3, :3] for p in poses_w]), dev)
            t_stack = _f32(np.stack([p[:3, 3] for p in poses_w]), dev)
            state0 = BAState(Se3(So3.from_matrix(R_stack), t_stack),
                             _f32(np.concatenate(pts3d_list), dev))
            state, costs = bundle_adjust(state0, problem, C, n_pts,
                                         num_iters=self.ba_iters,
                                         robust="cauchy", robust_delta=3.0)
        out_poses = list(poses[:-W])
        M = state.poses.matrix().cpu().numpy()
        for i in range(C):
            out_poses.append(M[i])
        return out_poses, costs


def _read_step(R, t, n_inl, diag, kp, desc, valid, depth, idx,
               track_mask) -> Dict[str, np.ndarray]:
    """Everything the host keeps of one pair step (pose, inlier count,
    diagnostics, the frame's features, depth table and match table), in
    one read from the device; keypoint indices are exact in float32."""
    n, D = kp.shape[0], desc.shape[-1]
    f = kp.dtype
    parts = [R.reshape(-1), t.reshape(-1), n_inl.to(f).reshape(1),
             diag.to(f), kp.reshape(-1), desc.reshape(-1), valid.to(f),
             depth.to(f), idx[:, 1].to(f), track_mask.to(f)]
    sizes = [p.numel() for p in parts]
    buf = torch.cat(parts).cpu().numpy()
    out = np.split(buf, np.cumsum(sizes)[:-1])
    return {"R": out[0].reshape(3, 3).astype(np.float64),
            "t": out[1].astype(np.float64), "n_inl": int(out[2][0]),
            "diag": out[3], "kp": out[4].reshape(n, 2),
            "desc": out[5].reshape(n, D), "valid": out[6] > 0.5,
            "depth": out[7].copy(), "idx": out[8].astype(np.int64),
            "track_mask": out[9] > 0.5}
