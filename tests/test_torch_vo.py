"""The port's visual odometry (kornia_tpu_torch.slam.vo) against the JAX
package's on the CPU.

One rendered sequence serves every reference leg: the reference's room
(``make_room_scene(tex_size=128)``) rendered by the reference along the first 8 poses of ``walk_trajectory(12)`` at
120x160, ``VisualOdometry(num_features=128, ransac_iters=8,
ransac_batch=128, incremental_ba=False, global_ba_passes=2)``. The JAX
pair step serves the teacher-forced steps and the refined run; its global
BA serves the window-BA leg, whose synthetic tracks are built at the same
shapes. The reference's per-frame RANSAC and PnP noise (``vo.py:180``,
``:350``) is replayed into the port. These JAX legs (the fixture ``ref``)
are read from their record (``tests/golden/port_references/vo.npz``,
written by ``tests/write_port_references.py`` from ``jax_reference``; the
``slow`` test ``tests/test_torch_port_references.py`` holds it to the JAX
package); the frames and the noise are still made by the JAX package here,
and their digest must be the record's.

Tolerances, stated per leg:
- teacher-forced pair steps (JAX features and state into both): the
  use_pnp / use_h choices, inlier sets, match and map counts equal;
  R 1e-4, t 1e-3; the depth tables' support equal outside 2 entries and
  their depths 1e-2 relative; scale and parallax 1e-3 relative;
- the refined run: keyframes and inlier counts equal, frame-cache
  keypoints 1e-2 px, rotations 2e-2, the two trajectories'
  centres within 1% of the path length after a Sim3 alignment (the global
  BA fixes one camera, so the scale gauge is free and the LM paths part),
  and the two ATEs against the truth within 0.5% of the path length;
- the window BA on the same synthetic tracks: rotations 1e-4, costs 1e-3
  relative, the gate's `ok` equal.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.slam import vo as jvo_mod
from kornia_tpu.utils import render as jr
from kornia_tpu_torch.geometry.liegroup import Se3, So3
from kornia_tpu_torch.metrics.metrics import ate_rmse
from kornia_tpu_torch.slam import vo as t_vo
from kornia_tpu_torch.slam.ba import BAProblem, BAState, bundle_adjust
from tests import port_references
from tests.torch_threads import one_torch_thread  # noqa: F401

H, W, NF, RI, RB = 120, 160, 128, 8, 128
N_FRAMES = 8
K = np.array([[0.8 * W, 0.0, W / 2], [0.0, 0.8 * W, H / 2],
              [0.0, 0.0, 1.0]], np.float32)
VO_KW = dict(num_features=NF, ransac_iters=RI, ransac_batch=RB,
             incremental_ba=False, global_ba_passes=2)
R_ATOL, T_ATOL, DEPTH_RTOL, DIAG_RTOL = 1e-4, 1e-3, 1e-2, 1e-3
REF_R_ATOL, REF_C_FRAC, REF_ATE_FRAC = 2e-2, 1e-2, 5e-3
BA_R_ATOL, BA_COST_RTOL = 1e-4, 1e-3


def _np(x):
    return np.array(x)


def _t(x):
    return torch.from_numpy(np.array(x))


@jax.jit
def _frame_draws(sub):
    """The reference pair step's noise for one frame's key: essential and
    homography RANSAC (one key a round) and PnP."""
    ke, kh, kp = jax.random.split(sub, 3)

    def rounds(k):
        out = []
        for _ in range(RI):
            k, s = jax.random.split(k)
            out.append(jax.random.gumbel(s, (RB, NF)))
        return jnp.stack(out)

    return rounds(ke), rounds(kh), jax.random.gumbel(kp, (RB // 2, NF))


def _replay(n_frames):
    """run()'s keys (PRNGKey(0), split once a frame) and their draws."""
    key = jax.random.PRNGKey(0)
    keys, draws = [], []
    for _ in range(1, n_frames):
        key, sub = jax.random.split(key)
        keys.append(sub)
        draws.append(tuple(_t(d) for d in _frame_draws(sub)))
    return keys, draws


def _centres(poses):
    return np.stack([-p[:3, :3].T @ p[:3, 3] for p in poses])


def _ate(est, gt):
    return float(ate_rmse(torch.from_numpy(np.float64(est)),
                          torch.from_numpy(np.float64(gt)), with_scale=True))


@pytest.fixture(scope="module")
def seq():
    return _seq()


def _seq():
    traj = jr.walk_trajectory(12)[:N_FRAMES]
    # the reference's make_room_scene(tex_size=128) at its default key,
    # its textures from one vmapped compile (bit-equal to its own loop)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr, "_fractal_texture",
                   lambda key, size, contrast=1.0: jnp.zeros((size, size)))
        geom = jr.make_room_scene(tex_size=1)
    keys = jax.random.split(jax.random.PRNGKey(7), geom.origins.shape[0])
    tex = jax.jit(jax.vmap(lambda k: jr._fractal_texture(k, 128)))(keys)
    scene = jr.PlaneScene(geom.origins, geom.edge_u, geom.edge_v, tex)
    render = jax.jit(lambda T: jr.render_scene(scene, jnp.asarray(K), T,
                                               H, W)[0])
    frames = [render(jnp.asarray(T)) for T in traj]
    gt = _centres(traj)
    length = float(np.sum(np.linalg.norm(np.diff(gt, axis=0), axis=1)))
    return dict(traj=traj, frames=frames, gt=gt, length=length,
                render=render)


def _reference(seq, draws):
    """The reference: teacher-forced pair steps, then a refined run (one
    VisualOdometry, so one compile of each stage)."""
    vo = jvo_mod.VisualOdometry(jnp.asarray(K), **VO_KW)
    detect, pair = vo._detect_fn(), vo._pair_fn()
    inl_th = 1.5 / float(0.5 * (K[0, 0] + K[1, 1]))
    keys = draws["keys"]
    feats = [detect(f) for f in seq["frames"]]
    steps = []
    depth, has = jnp.zeros(NF), jnp.asarray(False)
    R0, t0 = jnp.eye(3), jnp.zeros(3)
    for i in range(1, N_FRAMES):
        (kp0, d0, v0), (kp1, d1, v1) = feats[i - 1], feats[i]
        inputs = (kp0, d0, v0, kp1, d1, v1, depth, has, R0, t0)
        out = pair(kp0, d0, v0, kp1, d1, v1, jnp.asarray(K), keys[i - 1],
                   inl_th, depth, has, R0, t0)
        steps.append(dict(inputs=[_np(x) for x in inputs],
                          out=[_np(x) for x in out],
                          draws=draws["draws"][i - 1]))
        depth, has, R0, t0 = out[4], jnp.asarray(True), out[0], out[1]
    refined = vo.run(seq["frames"], refine=True)
    return dict(vo=vo, steps=steps, inl_th=inl_th, refined=refined,
                kf_refined=list(vo.kf_frames))


@pytest.fixture(scope="module")
def draws():
    return _draws()


def _draws():
    keys, d = _replay(N_FRAMES)
    return dict(keys=keys, draws=d)


def _window_case(C, noise):
    """test_window_ba_matches_the_reference's synthetic tracks for C
    keyframes at `noise` px, the port's VO, and the window's inputs."""
    gt, kps, nexts, inls, rng = _line_tracks(C, NF, 6, contaminate=True,
                                             Km=K)
    kps = [k + rng.normal(0, noise, k.shape).astype(np.float32)
           for k in kps]
    poses = [g.copy() for g in gt]
    for i in range(1, C):
        poses[i][:3, 3] += rng.normal(0, 0.03, 3)
    tv = t_vo.VisualOdometry(K, num_features=NF, device="cpu")
    shapes, built, Rt = _window_inputs(tv, poses, kps, nexts, inls, C)
    return tv, shapes, built, Rt


def _inputs_digest(seq, draws, windows):
    """The key of the rendered frames and the replayed noise (made by the
    JAX package) and of the window-BA inputs (numpy)."""
    made = [np.asarray(f) for f in seq["frames"]]
    made += [d.numpy() for step in draws["draws"] for d in step]
    built = []
    for _, shapes, b, Rt in windows:
        built += [np.asarray(shapes), *Rt, *b]
    return port_references.inputs(built, made)


def jax_reference():
    """The JAX side of this module's reference legs (the fixture `ref`
    and the window BA at both noise levels) on the test's inputs: (the
    inputs' digest, the record), as tests/write_port_references.py
    records them."""
    sq, dr = _seq(), _draws()
    r = _reference(sq, dr)
    C = len(r["kf_refined"])
    windows = [_window_case(C, noise) for noise in WINDOW_NOISE]
    record = dict(
        steps=[dict(inputs=s["inputs"], out=s["out"]) for s in r["steps"]],
        inl_th=np.float64(r["inl_th"]),
        poses=[np.asarray(p) for p in r["refined"].poses],
        num_inliers=np.asarray(r["refined"].num_inliers),
        kf_refined=np.asarray(r["kf_refined"]),
        frame_cache=[{"kp": np.asarray(f["kp"]),
                      "valid": np.asarray(f["valid"])}
                     for f in r["vo"].frame_cache],
        window=[])
    for _, shapes, built, Rt in windows:
        (obs_cam, obs_trk, obs_uv, obs_valid, fc, fuv, lc, luv, trk_valid,
         _) = built
        fn = r["vo"]._ba_window_fn(C, shapes[0], shapes[1], 1)
        Mj, Xj, okj, cj = fn(
            jnp.asarray(Rt[0]), jnp.asarray(Rt[1]),
            jnp.asarray(obs_cam, jnp.int32), jnp.asarray(obs_trk, jnp.int32),
            jnp.asarray(obs_uv), jnp.asarray(obs_valid),
            jnp.asarray(fc, jnp.int32), jnp.asarray(fuv),
            jnp.asarray(lc, jnp.int32), jnp.asarray(luv),
            jnp.asarray(trk_valid), jnp.asarray(K))
        record["window"].append(dict(M=_np(Mj), X=_np(Xj), ok=_np(okj),
                                     cost=_np(cj)))
    return _inputs_digest(sq, dr, windows), record


WINDOW_NOISE = (0.0, 0.5)


@pytest.fixture(scope="module")
def ref(seq, draws):
    """The JAX reference legs, read from their record
    (tests/port_references.py; the JAX pair step, its run and the global
    BA compiled for about 90 s a run). The record was written from the
    same frames, noise and window-BA inputs (digest checked)."""
    rec = port_references.load("vo")
    C = len(rec["kf_refined"])
    windows = [_window_case(C, noise) for noise in WINDOW_NOISE]
    port_references.load("vo", _inputs_digest(seq, draws, windows))
    steps = [dict(inputs=list(s["inputs"]), out=list(s["out"]),
                  draws=draws["draws"][i])
             for i, s in enumerate(rec["steps"])]
    refined = SimpleNamespace(poses=list(rec["poses"]),
                              num_inliers=rec["num_inliers"].tolist())
    vo = SimpleNamespace(frame_cache=list(rec["frame_cache"]))
    return dict(steps=steps, inl_th=float(rec["inl_th"]), refined=refined,
                kf_refined=rec["kf_refined"].tolist(), vo=vo,
                window=dict(zip(WINDOW_NOISE, zip(windows,
                                                  rec["window"]))))


@pytest.fixture(scope="module")
def port(seq, draws):
    vo = t_vo.VisualOdometry(K, device="cpu", **VO_KW)
    frames = [_t(f) for f in seq["frames"]]
    refined = vo.run(frames, refine=True, draws=draws["draws"])
    return dict(vo=vo, frames=frames, refined=refined,
                kf_refined=list(vo.kf_frames))


# --- mirrors of tests/test_vo_ba_unit.py ---------------------------------

def _synthetic_problem(C=4, P=60, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    Km = torch.tensor([[200.0, 0, 128], [0, 200.0, 96], [0, 0, 1.0]])
    Xw = rng.uniform(-1.5, 1.5, (P, 3)).astype(np.float32)
    Xw[:, 2] += 5.0
    ts = np.stack([np.linspace(0, 1.2, C), np.zeros(C), np.zeros(C)],
                  1).astype(np.float32)
    angs = rng.normal(0, 0.02, (C, 3)).astype(np.float32)
    poses = Se3(So3.exp(torch.from_numpy(angs)), torch.from_numpy(ts))
    Rm = poses.r.matrix().numpy()
    cam = np.repeat(np.arange(C), P)
    pt = np.tile(np.arange(P), C)
    Xc = np.einsum("oij,oj->oi", Rm[cam], Xw[pt]) + ts[cam]
    uv = (Xc[:, :2] / Xc[:, 2:]) * 200.0 + np.array([128.0, 96.0])
    uv += rng.normal(0, noise, uv.shape)
    problem = BAProblem(torch.from_numpy(cam), torch.from_numpy(pt),
                        torch.from_numpy(uv.astype(np.float32)),
                        torch.ones(cam.shape[0], dtype=torch.bool), Km)
    return problem, poses, torch.from_numpy(Xw), C, P


def _line_tracks(W_, Kf, seed, contaminate=False, Km=None):
    """Kf points seen by W_ cameras translating along x (intrinsics Km,
    K_UNIT by default), every keypoint matched to itself in the next
    frame; optionally keypoint 0 of the last frame jumps to a wrong place
    (a merged track)."""
    Km = K_UNIT if Km is None else Km
    rng = np.random.default_rng(seed)
    Xw = rng.uniform(-1.5, 1.5, (Kf, 3)).astype(np.float32)
    Xw[:, 2] += 5.0
    gt = []
    for i in range(W_):
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.4 * i, 0.0, 0.0]
        gt.append(T)
    kps, nexts, inls = [], [], []
    for i in range(W_):
        Xc = Xw @ gt[i][:3, :3].T + gt[i][:3, 3]
        uv = (Xc[:, :2] / Xc[:, 2:]) * Km[0, 0] + Km[:2, 2]
        if contaminate and i == W_ - 1:
            uv[0] = uv[1] + np.array([90.0, 70.0])
        kps.append(uv.astype(np.float32))
        if i:
            nexts.append(np.arange(Kf))
            inls.append(np.ones(Kf, bool))
    return gt, kps, nexts, inls, rng


K_UNIT = np.array([[200.0, 0, 128], [0, 200.0, 96], [0, 0, 1.0]],
                  np.float32)


def test_structure_only_freezes_all_cameras():
    problem, poses, Xw, C, P = _synthetic_problem()
    rng = np.random.default_rng(1)
    bad_X = Xw + torch.from_numpy(
        rng.normal(0, 0.3, (P, 3)).astype(np.float32))
    state, costs = bundle_adjust(BAState(poses, bad_X), problem, C, P,
                                 num_iters=6, robust="huber",
                                 robust_delta=50.0, fix_first_cam=C)
    # cameras bit-identical, points moved toward the truth
    assert torch.equal(state.poses.t, poses.t)
    assert torch.equal(state.poses.r.q.data, poses.r.q.data)
    err0 = float(torch.linalg.vector_norm(bad_X - Xw))
    err1 = float(torch.linalg.vector_norm(state.points - Xw))
    assert err1 < 0.2 * err0, (err0, err1)


def test_window_ba_improves_perturbed_poses():
    vo = t_vo.VisualOdometry(K_UNIT, num_features=64, device="cpu")
    gt, kps, nexts, inls, rng = _line_tracks(4, 64, 2)
    poses = [g.copy() for g in gt]
    for i in range(2, 4):  # perturb the non-gauge cameras
        poses[i][:3, 3] += rng.normal(0, 0.06, 3)
    err0 = sum(np.linalg.norm(poses[i][:3, 3] - gt[i][:3, 3])
               for i in range(4))
    vo._refine_span(kps, nexts, inls, poses, 0, 4)
    err1 = sum(np.linalg.norm(poses[i][:3, 3] - gt[i][:3, 3])
               for i in range(4))
    assert err1 < 0.35 * err0, (err0, err1)


def _window_inputs(vo, gt, kps, nexts, inls, W_, fix_first=2):
    Kf = kps[0].shape[0]
    T_b = min(Kf * (W_ - 1), vo.ba_track_budget)
    O_b = min(2 * Kf * (W_ - 1), Kf * W_)
    built = vo._build_window_tracks(kps, nexts, inls, 0, W_, T_b, O_b)
    R = np.stack([g[:3, :3] for g in gt]).astype(np.float32)
    t = np.stack([g[:3, 3] for g in gt]).astype(np.float32)
    return (T_b, O_b), built, (R, t)


def _run_port_window(vo, shapes, built, Rt, W_, fix_first):
    (obs_cam, obs_trk, obs_uv, obs_valid, fc, fuv, lc, luv, trk_valid,
     _) = built
    ba = vo._ba_window_fn(W_, shapes[0], shapes[1], fix_first)
    return ba(_t(Rt[0]), _t(Rt[1]), _t(obs_cam), _t(obs_trk), _t(obs_uv),
              _t(obs_valid), _t(fc), _t(fuv), _t(lc), _t(luv),
              _t(trk_valid), vo.K)


def test_contamination_gate_drops_merged_track():
    vo = t_vo.VisualOdometry(K_UNIT, num_features=32, device="cpu")
    gt, kps, nexts, inls, _ = _line_tracks(4, 32, 3, contaminate=True)
    shapes, built, Rt = _window_inputs(vo, gt, kps, nexts, inls, 4)
    M, X, ok, costs = _run_port_window(vo, shapes, built, Rt, 4, 2)
    ok = ok.numpy()
    bad_tid = int(built[-1][0])
    assert not ok[bad_tid]
    assert ok[:32].sum() >= 32 - 4


def test_rot_gate_values():
    vo = t_vo.VisualOdometry(K_UNIT, device="cpu")
    assert vo.incremental_rot_gate == pytest.approx(0.2)

    def span(Ra, Rb):
        c = 0.5 * (np.trace(Rb @ Ra.T) - 1.0)
        return float(np.arccos(np.clip(c, -1.0, 1.0)))

    for ang, writes in ((0.14, True), (0.31, False)):
        Rz = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                       [-np.sin(ang), 0, np.cos(ang)]])
        assert (span(np.eye(3), Rz) <= vo.incremental_rot_gate) == writes


# --- helpers against the reference --------------------------------------

@pytest.mark.parametrize("mask", ["empty", "odd", "even", "all"])
def test_masked_median_matches_the_reference(mask):
    rng = np.random.default_rng(4)
    x = rng.normal(size=33).astype(np.float32)
    m = {"empty": np.zeros(33, bool), "odd": rng.random(33) < 0.4,
         "even": np.arange(33) < 12, "all": np.ones(33, bool)}[mask]
    if mask == "odd" and m.sum() % 2 == 0:
        m[np.nonzero(~m)[0][0]] = True
    want = jax.jit(jvo_mod._masked_median, static_argnums=2)(
        jnp.asarray(x), jnp.asarray(m), 7.5)
    got = t_vo._masked_median(torch.from_numpy(x), torch.from_numpy(m), 7.5)
    assert float(got) == float(want)


@pytest.mark.parametrize("budget", ["fits", "over_tracks", "over_obs"])
def test_build_window_tracks_equals_the_reference(budget):
    """Random pair tables (partial inlier masks, permuted next-frame
    indices); over budget the stratified selection runs."""
    rng = np.random.default_rng(5)
    Kf, W_ = 48, 6
    kps = [rng.uniform(0, 160, (Kf, 2)).astype(np.float32)
           for _ in range(W_)]
    nexts = [rng.permutation(Kf) for _ in range(W_ - 1)]
    inls = [rng.random(Kf) < 0.7 for _ in range(W_ - 1)]
    T_b, O_b = {"fits": (Kf * (W_ - 1), 2 * Kf * (W_ - 1)),
                "over_tracks": (60, 2 * Kf * (W_ - 1)),
                "over_obs": (Kf * (W_ - 1), 150)}[budget]
    jv = jvo_mod.VisualOdometry(jnp.asarray(K), num_features=Kf)
    tv = t_vo.VisualOdometry(K, num_features=Kf, device="cpu")
    want = jv._build_window_tracks(kps, nexts, inls, 0, W_, T_b, O_b)
    got = tv._build_window_tracks(kps, nexts, inls, 0, W_, T_b, O_b)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[3].sum() > 0
    if budget == "over_tracks":
        assert got[8].sum() <= T_b


# --- the port's own runs ---------------------------------------------------

def test_refine_from_cache_and_window_and_smoothing(seq, port):
    """The post-run entry points on the port's run: refine_from_cache from
    the refined poses (one pass), refine_window over the last frames, and the
    skip-edge smoothing, each returning finite poses that stay close to
    the truth."""
    vo = port["vo"]
    L = seq["length"]
    passes, vo.global_ba_passes = vo.global_ba_passes, 1
    try:
        again = vo.refine_from_cache(port["refined"].poses)
    finally:
        vo.global_ba_passes = passes
    assert len(again) == N_FRAMES and all(np.isfinite(p).all()
                                          for p in again)
    assert _ate(_centres(again), seq["gt"]) < 0.1 * L
    win, costs = vo.refine_window(port["frames"][-3:],
                                  port["refined"].poses)
    assert len(win) == N_FRAMES and torch.isfinite(costs).all()
    assert _ate(_centres(win), seq["gt"]) < 0.1 * L
    smooth = vo.smooth_keyframes(port["refined"].poses, skips=(3,))
    assert len(smooth) == N_FRAMES and all(np.isfinite(p).all()
                                           for p in smooth)
    assert _ate(_centres(smooth), seq["gt"]) < 0.1 * L


def test_run_with_a_generator(seq, port):
    """Without injected draws the run samples from a generator; the
    result is deterministic for a seed."""
    vo = t_vo.VisualOdometry(K, device="cpu", **VO_KW)
    frames = port["frames"][:3]
    a = vo.run(frames, torch.Generator().manual_seed(1), refine=False)
    b = vo.run(frames, torch.Generator().manual_seed(1), refine=False)
    for x, y in zip(a.poses, b.poses):
        np.testing.assert_array_equal(x, y)
    assert len(a.poses) == 3 and vo.kf_frames[0] == 0


def test_incremental_ba(seq, draws, port):
    """The per-keyframe window BA during tracking (the reference's
    default): from the third keyframe on, the frame cache holds the
    window's refined map, where the run without it (the port fixture's,
    same frames and noise) holds the pair step's triangulation; the poses
    stay finite and near the truth."""
    frames = port["frames"][:6]
    vo = t_vo.VisualOdometry(K, device="cpu",
                             **dict(VO_KW, incremental_ba=True))
    res = vo.run(frames, refine=True, draws=draws["draws"][:5])
    assert vo.kf_frames == port["kf_refined"][:6] == list(range(6))
    assert all(np.isfinite(p).all() for p in res.poses)
    L = float(np.sum(np.linalg.norm(np.diff(seq["gt"][:6], axis=0),
                                    axis=1)))
    assert _ate(_centres(res.poses), seq["gt"][:6]) < 0.1 * L
    for k in range(6):
        same = np.array_equal(vo.frame_cache[k]["depth"],
                              port["vo"].frame_cache[k]["depth"])
        assert same == (k < 2), k


@pytest.mark.parametrize("noise", [0.0, 0.5])
def test_window_ba_matches_the_reference(ref, noise):
    """The window BA (structure-only phase, gate, GNC schedule) on the
    same synthetic tracks, at the shapes of the reference run's global BA
    (one camera fixed), so that its compiled executable serves.

    Exact observations: the gate's `ok`, rotations 1e-4 and costs that
    reach zero (1e-6) — the first joint LM step alone, in the free scale
    gauge, differs by a few percent. With 0.5 px of noise: `ok`, the cost
    at the end of the wide-huber and cauchy phases 1e-3 relative,
    rotations 1e-3, and the polish's final cost 1e-2 relative (its re-gate
    at 2 px-equivalent can take one observation either side)."""
    C = len(ref["kf_refined"])
    (tv, shapes, built, Rt), rec = ref["window"][noise]
    Mj, okj, cj = rec["M"], rec["ok"], rec["cost"]
    Mt, Xt, okt, ct = _run_port_window(tv, shapes, built, Rt, C, 1)
    ct, cj = ct.numpy(), np.asarray(cj)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert not okt.numpy()[int(built[-1][0])]  # the merged track is gated
    Rt_, Rj_ = Mt.numpy()[:, :3, :3], np.asarray(Mj)[:, :3, :3]
    if noise == 0.0:
        np.testing.assert_allclose(Rt_, Rj_, atol=BA_R_ATOL, rtol=0)
        np.testing.assert_allclose(ct[-1], cj[-1], atol=1e-6, rtol=0)
        return
    np.testing.assert_allclose(Rt_, Rj_, atol=10 * BA_R_ATOL, rtol=0)
    i_huber, i_cauchy = max(tv.ba_iters // 2, 4) - 1, \
        max(tv.ba_iters // 2, 4) + tv.ba_iters - 1
    np.testing.assert_allclose(ct[[i_huber, i_cauchy]], cj[[i_huber, i_cauchy]],
                               rtol=BA_COST_RTOL)
    np.testing.assert_allclose(ct[-1], cj[-1], rtol=10 * BA_COST_RTOL)
    assert ct[-1] < ct[0]


# --- the pair step and whole runs against the reference -----------------

@pytest.mark.parametrize("step", range(N_FRAMES - 1))
def test_pair_step_teacher_forced(ref, step):
    s = ref["steps"][step]
    kp0, d0, v0, kp1, d1, v1, depth, has, R0, t0 = s["inputs"]
    pair = t_vo.VisualOdometry(K, device="cpu", **VO_KW)._pair_fn()
    out = pair(_t(kp0), _t(d0), _t(v0), _t(kp1), _t(d1), _t(v1), _t(K),
               None, float(np.float32(ref["inl_th"])), _t(depth),
               torch.tensor(bool(has)), _t(R0), _t(t0), s["draws"])
    R, t, inl, n_inl, depth_n, idx, track, diag = [o.numpy() for o in out]
    Rj, tj, inlj, nj, depthj, idxj, trackj, diagj = s["out"]
    np.testing.assert_array_equal(idx, idxj)
    # map, PnP inliers, use_pnp, two-view inliers; match count
    np.testing.assert_array_equal(diag[[0, 1, 2, 3, 6]],
                                  diagj[[0, 1, 2, 3, 6]])
    np.testing.assert_allclose(diag[4:6], diagj[4:6], rtol=DIAG_RTOL)
    np.testing.assert_array_equal(inl, inlj)
    assert int(n_inl) == int(nj)
    np.testing.assert_allclose(R, Rj, atol=R_ATOL, rtol=0)
    np.testing.assert_allclose(t, tj, atol=T_ATOL, rtol=0)
    assert (track != trackj).sum() <= 2
    assert ((depth_n > 0) != (depthj > 0)).sum() <= 2
    both = (depth_n > 0) & (depthj > 0)
    np.testing.assert_allclose(depth_n[both], depthj[both], rtol=DEPTH_RTOL)
    if step == 0:
        assert not diag[2]  # the bootstrap is two-view
    assert np.isfinite(diag).all()


def test_the_steps_reach_both_branches(ref):
    """The sequence exercises PnP tracking and the two-view fallback after
    the bootstrap."""
    use_pnp = [bool(s["out"][-1][2]) for s in ref["steps"]]
    assert use_pnp[0] is False and any(use_pnp) and not all(use_pnp[1:])


def test_refined_run_matches_the_reference(seq, ref, port):
    assert port["kf_refined"] == ref["kf_refined"]
    assert port["refined"].num_inliers == ref["refined"].num_inliers
    for a, b in zip(port["refined"].poses, ref["refined"].poses):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a[:3, :3], b[:3, :3], atol=REF_R_ATOL,
                                   rtol=0)
    ct = _centres(port["refined"].poses)
    cj = _centres(ref["refined"].poses)
    L = seq["length"]
    assert _ate(ct, cj) <= REF_C_FRAC * L, _ate(ct, cj) / L
    a_t, a_j = _ate(ct, seq["gt"]), _ate(cj, seq["gt"])
    assert abs(a_t - a_j) <= REF_ATE_FRAC * L, (a_t / L, a_j / L)
    # the frame cache: one entry a frame, keypoints within 1e-2 px
    fc_t, fc_j = port["vo"].frame_cache, ref["vo"].frame_cache
    assert len(fc_t) == len(fc_j) == N_FRAMES
    for a, b in zip(fc_t, fc_j):
        np.testing.assert_allclose(a["kp"], b["kp"], atol=1e-2, rtol=0)
        np.testing.assert_array_equal(a["valid"], b["valid"])


# --- a divergence kept: near-tied essential models on the loop -------------

@pytest.mark.slow  # the JAX 5-point solver compiles for about 35 s
def test_loop_step_essential_split_is_f32_rounding(seq, draws):
    """The loop trajectory's 4th step (frames 3 -> 4 of
    ``loop_trajectory(24)`` at 120x160), where the libraries' essential
    RANSAC chose different models in a teacher-forced run. Its one round
    (the confidence bound stops after 128 samples) on the same matches
    and Gumbel noise: the same minimal samples, and the same MSAC score
    for every candidate that both solvers return; the split is one
    candidate of one sample, whose degree-10 polynomial's coefficients
    differ by f32 rounding (below 1e-4 relative) and whose ill-conditioned
    complex roots, which seed the Gauss-Newton polish, move by percents
    with them. On the same coefficients both root finders agree. So the
    split is rounding, not an ordering or scoring difference."""
    from kornia_tpu.core.linalg import gauss_det as j_gauss_det
    from kornia_tpu.core.linalg import nullspace_qr as j_nullspace_qr
    from kornia_tpu.feature.matching import match_smnn
    from kornia_tpu.geometry import epipolar as j_epi
    from kornia_tpu.geometry import ransac as j_ran
    from kornia_tpu.geometry import solvers as j_sol
    from kornia_tpu.geometry.conversions import \
        normalize_points_with_intrinsics
    from kornia_tpu_torch.core.linalg import f32_precision
    from kornia_tpu_torch.core.sort import top_k
    from kornia_tpu_torch.geometry import epipolar as t_epi
    from kornia_tpu_torch.geometry import ransac as t_ran
    from kornia_tpu_torch.geometry import solvers as t_sol

    step = 3
    detect = jvo_mod.VisualOdometry(jnp.asarray(K), **VO_KW)._detect_fn()
    (kp0, d0, v0), (kp1, d1, v1) = [
        detect(seq["render"](jnp.asarray(T)))
        for T in jr.loop_trajectory(24)[step:step + 2]]
    _, idx, mvalid = match_smnn(d0, d1, 0.95, v0, v1)
    x0 = normalize_points_with_intrinsics(kp0, jnp.asarray(K))
    x1 = normalize_points_with_intrinsics(kp1[idx[:, 1]], jnp.asarray(K))
    th2 = float(np.float32(1.5 / float(0.5 * (K[0, 0] + K[1, 1])))) ** 2
    g = draws["draws"][step][0][0]  # round 0 of the essential noise
    mask = torch.from_numpy(np.array(mvalid))
    p1, p2 = _t(x0), _t(x1)
    _, ix = top_k(g + torch.where(mask, 0.0, -float("inf"))[None], 5)
    _, jix = jax.lax.top_k(jnp.asarray(g.numpy()) + jnp.where(
        mvalid, 0.0, -jnp.inf)[None], 5)
    np.testing.assert_array_equal(ix.numpy(), np.asarray(jix))
    S = ix.shape[0]

    @jax.jit
    def j_models_scores(a, b):
        models = j_epi.run_5point(a, b)
        flat = models.reshape(-1, 3, 3)
        msac, cnt = j_ran._msac_scores("essential", x0, x1, flat, mvalid,
                                       th2)
        ok = jnp.linalg.norm(flat.reshape(-1, 9), axis=-1) > 1e-6
        return flat, jnp.where(ok, msac, jnp.inf), cnt

    jm, js, jc = [np.asarray(a) for a in j_models_scores(x0[jix], x1[jix])]
    with f32_precision():
        tm = t_epi.run_5point(p1[ix], p2[ix]).reshape(-1, 3, 3)
        ts, tc = t_ran._msac_scores("essential", p1, p2, tm, mask, th2)
    ok = torch.linalg.vector_norm(tm.reshape(-1, 9), dim=-1) > 1e-6
    ts = torch.where(ok, ts, float("inf")).numpy()
    tm, tc = tm.numpy(), tc.numpy()
    jb, tb = int(np.argmin(js)), int(np.argmin(ts))
    print(f"round 0: JAX's best candidate {jb} (sample {jb // 20}) MSAC "
          f"{js[jb]:.6e}, {int(jc[jb])} inliers; the port's {tb} (sample "
          f"{tb // 20}) {ts[tb]:.6e}, {int(tc[tb])} inliers; the port's "
          f"candidate {jb} {ts[jb]:.6e}")
    # the port's scoring of JAX's candidates is JAX's, and most candidates
    # of the two solvers agree
    with f32_precision():
        ts_of_j, _ = t_ran._msac_scores("essential", p1, p2,
                                        torch.from_numpy(jm), mask, th2)
    fin = np.isfinite(js)
    np.testing.assert_allclose(ts_of_j.numpy()[fin], js[fin], rtol=1e-5)
    nj = jm / np.maximum(np.linalg.norm(jm, axis=(1, 2)), 1e-30)[:, None, None]
    nt = tm / np.maximum(np.linalg.norm(tm, axis=(1, 2)), 1e-30)[:, None, None]
    same = np.minimum(np.abs(nj - nt).max((1, 2)),
                      np.abs(nj + nt).max((1, 2))) < 1e-3
    same &= fin & np.isfinite(ts)
    assert same.sum() > 0.8 * fin.sum()
    # the split: the port lacks JAX's best model, and scores worse
    assert jb != tb and not same[jb] and ts[tb] > js[jb]

    # the split sample's reversed polynomial in both libraries
    smp = jb // 20

    def j_coeffs(a, b):
        x1_, y1_, x2_, y2_ = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
        A = jnp.stack([x2_ * x1_, x2_ * y1_, x2_, y2_ * x1_, y2_ * y1_, y2_,
                       x1_, y1_, jnp.ones_like(x1_)], -1)
        Eb = jnp.moveaxis(j_nullspace_qr(A), -1, 1).reshape(-1, 4, 3, 3)
        c = j_epi._essential_constraints(Eb)
        c = c / jnp.maximum(jnp.linalg.norm(c, axis=-1, keepdims=True),
                            1e-12)
        dets = [j_gauss_det(j_epi._c_matrix_at(
            c, jnp.asarray(z, jnp.float32), True)) for z in j_epi._NODES]
        return jnp.stack(dets, -1) @ jnp.asarray(j_epi._VAND_INV,
                                                 jnp.float32).T

    with f32_precision():
        A = t_epi._design_matrix(p1[ix][smp:smp + 1], p2[ix][smp:smp + 1])
        from kornia_tpu_torch.core.linalg import gauss_det, nullspace_qr
        c = t_epi._essential_constraints(
            nullspace_qr(A).movedim(-1, 1).reshape(1, 4, 3, 3))
        c = c / torch.linalg.vector_norm(c, dim=-1,
                                         keepdim=True).clamp_min(1e-12)
        tco = torch.stack([gauss_det(t_epi._c_matrix_at(
            c, torch.tensor(z, dtype=torch.float32), True))
            for z in t_epi._NODES], -1) @ torch.as_tensor(
            t_epi._VAND_INV, dtype=torch.float32).T
    jco = np.asarray(jax.jit(j_coeffs)(x0[jix][smp:smp + 1],
                                       x1[jix][smp:smp + 1]))
    rel = np.abs(tco.numpy() - jco).max() / np.abs(jco).max()
    j_roots = np.asarray(jax.jit(lambda c: j_sol.poly_roots(c, tol=1e-5))(
        jnp.asarray(jco)))[0]
    t_same = t_sol.poly_roots(torch.from_numpy(jco), tol=1e-5).numpy()[0]
    t_own = t_sol.poly_roots(tco, tol=1e-5).numpy()[0]
    move = max(np.abs(t_own - r).min() / abs(r) for r in j_roots)
    print(f"sample {smp}: coefficients {rel:.2e} apart (relative); on the "
          f"same coefficients the roots agree to "
          f"{max(np.abs(t_same - r).min() for r in j_roots):.2e}; on its "
          f"own the port's roots move by up to {move:.2%}")
    assert rel < 1e-4
    for r in j_roots:
        assert np.abs(t_same - r).min() <= 1e-3 * max(1.0, abs(r))
    assert move > 0.01
