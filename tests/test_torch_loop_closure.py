"""The port's loop closure (kornia_tpu_torch.slam.loop_closure) against the
JAX package's on the CPU, on synthetic frame caches (no rendering, no
detector), and the port's no-loop pass-through on a rendered walk.

The caches are those of ``tests/test_kf_smoothing.py``: keyframes that all
observe one 3-D cloud, descriptors shared across frames (so mutual-SNN
matches keypoint i to keypoint i), depths exact. A revisiting cache walks
out along x and comes back. The reference's PnP noise of each verification
(``jax.random.gumbel(PRNGKey(i * 9973 + j), (512, K))``, its default key,
``calibration.py:96``) is replayed into the port.

Tolerances: global descriptors 1e-6, candidates exactly; verify_loop's
inlier and map counts exactly, T_rel 1e-4 in rotation and 1e-3 in
translation; the Se3-closed trajectories 1e-3 (both LM graphs converge on
a consistent set of edges).
"""

import jax
import numpy as np
import pytest
import torch

from kornia_tpu.slam import loop_closure as jlc
from kornia_tpu_torch.slam import loop_closure as tlc
from tests.torch_threads import one_torch_thread  # noqa: F401

H, W = 192, 256
K = np.array([[0.8 * W, 0.0, W / 2], [0.0, 0.8 * W, H / 2],
              [0.0, 0.0, 1.0]], np.float32)
INL_TH = 1.5 / K[0, 0]
DESC_ATOL = 1e-6
T_R_ATOL, T_T_ATOL = 1e-4, 1e-3
POSE_ATOL = 1e-3


def _make_chain(xs, kf=96, seed=0):
    """Keyframes at camera x positions `xs`, all observing the same cloud.
    Returns (frame_cache, gt_poses)."""
    rng = np.random.default_rng(seed)
    Xw = rng.uniform(-1.5, 1.5, (kf, 3)).astype(np.float32)
    Xw[:, 0] *= 2.0  # wide enough that the visible sets change along x
    Xw[:, 2] += 6.0
    desc = rng.normal(0, 1, (kf, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    cache, gt = [], []
    for x in xs:
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [-x, 0.0, 0.0]  # world→cam: camera at +x
        gt.append(T.astype(np.float64))
        Xc = Xw @ T[:3, :3].T + T[:3, 3]
        uv = Xc @ K.T
        uv = uv[:, :2] / uv[:, 2:]
        inside = ((uv[:, 0] >= 0) & (uv[:, 0] < W)
                  & (uv[:, 1] >= 0) & (uv[:, 1] < H))
        cache.append({"kp": uv.astype(np.float32), "desc": desc,
                      "valid": inside,
                      "depth": np.where(inside, Xc[:, 2], 0.0)
                      .astype(np.float32)})
    return cache, gt


def _chain(n=6):
    return _make_chain([0.35 * i for i in range(n)])


def _revisit(n=16):
    """Out along x and back: frame n-1 stands where frame 0 stood."""
    half = n // 2
    xs = [0.3 * i for i in range(half)] + \
        [0.3 * (n - 1 - i) for i in range(half, n)]
    return _make_chain(xs)


_gumbel_jit = jax.jit(jax.random.gumbel, static_argnums=1)


def _ref_gumbel(i, j, kf, batch=512):
    return torch.from_numpy(np.asarray(
        _gumbel_jit(jax.random.PRNGKey(i * 9973 + j), (batch, kf))))


def _noised(gt, sigma, seed):
    rng = np.random.default_rng(seed)
    out = [p.copy() for p in gt]
    for i in range(1, len(gt)):
        out[i][:3, 3] += rng.normal(0, sigma, 3)
    return out


def _err(poses, gt):
    return sum(np.linalg.norm(p[:3, 3] - g[:3, 3]) for p, g in zip(poses, gt))


# --- mirrors of tests/test_kf_smoothing.py --------------------------------

@pytest.mark.parametrize("i,j", [(3, 0), (5, 2)])
def test_verify_loop_matches_the_reference(i, j):
    cache, gt = _chain()
    want = jlc.verify_loop(cache, gt, i, j, K, inl_th=INL_TH)
    got = tlc.verify_loop(cache, gt, i, j, K, inl_th=INL_TH,
                          gumbel=_ref_gumbel(i, j, 96), device="cpu")
    assert got[1] == want[1] and got[2] == want[2]
    assert got[1] >= 30
    np.testing.assert_allclose(got[0][:3, :3], want[0][:3, :3],
                               atol=T_R_ATOL, rtol=0)
    np.testing.assert_allclose(got[0][:3, 3], want[0][:3, 3],
                               atol=T_T_ATOL, rtol=0)
    expect = np.linalg.inv(gt[j]) @ gt[i]
    np.testing.assert_allclose(got[0][:3, 3], expect[:3, 3], atol=5e-2)
    np.testing.assert_allclose(got[0][:3, :3], expect[:3, :3], atol=2e-2)


def test_verify_loop_default_generator():
    """Without injected noise the port seeds a generator with
    i * 9973 + j: the same call gives the same answer."""
    cache, gt = _chain()
    a = tlc.verify_loop(cache, gt, 3, 0, K, inl_th=INL_TH, device="cpu")
    b = tlc.verify_loop(cache, gt, 3, 0, K, inl_th=INL_TH, device="cpu")
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] >= 30


def test_smoothing_pulls_noised_chain_toward_gt():
    cache, gt = _chain()
    noised = _noised(gt, 0.05, 1)
    kfs = list(range(len(gt)))
    draws = {(kfs[a + s], kfs[a]): _ref_gumbel(kfs[a + s], kfs[a], 96)
             for s in (2, 3) for a in range(len(gt) - s)}
    out = tlc.smooth_keyframe_graph(cache, noised, kfs, K, skips=(2, 3),
                                    min_inliers=20, pg_iters=60,
                                    inl_th=INL_TH, draws=draws,
                                    device="cpu")
    assert _err(out, gt) < 0.7 * _err(noised, gt)


def test_smoothing_no_edges_is_identity():
    cache, gt = _chain()
    for f in cache:
        f["depth"][:] = 0.0  # no maps -> no verified skip edge
    noised = [p.copy() for p in gt]
    noised[2][:3, 3] += 0.1
    out = tlc.smooth_keyframe_graph(cache, noised, list(range(len(gt))), K,
                                    skips=(2,), inl_th=INL_TH, device="cpu")
    for a, b in zip(out, noised):
        np.testing.assert_array_equal(a, b)


def test_smoothing_short_chain_passthrough():
    cache, gt = _chain(n=2)
    out = tlc.smooth_keyframe_graph(cache, gt, [0, 1], K, device="cpu")
    assert len(out) == 2
    np.testing.assert_array_equal(out[0], gt[0])


# --- place recognition ----------------------------------------------------

def _random_cache(rng, F, n, D):
    return [{"desc": rng.normal(size=(n, D)).astype(np.float32),
             "valid": rng.random(n) < 0.8} for _ in range(F)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_global_descriptors_and_candidates(seed):
    rng = np.random.default_rng(seed)
    cache = _random_cache(rng, 24, 64, 32)
    # revisits: late frames repeat early frames' descriptors with noise
    for i, j in ((14, 2), (21, 9)):
        cache[i] = {"desc": cache[j]["desc"] + 0.05 * rng.normal(
            size=(64, 32)).astype(np.float32), "valid": cache[j]["valid"]}
    want = jlc.global_descriptors(cache)
    got = tlc.global_descriptors(cache)
    np.testing.assert_allclose(got, want, atol=DESC_ATOL, rtol=0)
    for sep, th, m in ((10, 0.5, 8), (5, 0.2, 2), (3, 0.0, 8)):
        assert tlc.detect_loop_candidates(got, sep, th, m) == \
            jlc.detect_loop_candidates(want, sep, th, m)
    cands = tlc.detect_loop_candidates(got, 10, 0.5)
    assert (14, 2) in [(i, j) for i, j, _ in cands]


# --- closure ----------------------------------------------------------------

@pytest.mark.parametrize("optimizer", ["se3", "sim3"])
def test_close_loops_on_a_revisiting_cache(optimizer):
    cache, gt = _revisit()
    F = len(gt)
    # odometry with drift: each step yawed by 0.5 degrees and its
    # translation scaled up 4%
    ang = np.deg2rad(0.5)
    D = np.eye(4)
    D[:3, :3] = [[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                 [-np.sin(ang), 0, np.cos(ang)]]
    drifted = [gt[0].copy()]
    for k in range(1, F):
        rel = gt[k] @ np.linalg.inv(gt[k - 1])
        rel[:3, 3] *= 1.04
        drifted.append(D @ rel @ drifted[-1])
    kw = dict(min_separation=6, sim_th=0.9, min_inliers=15,
              min_inlier_frac=0.35, loop_weight=10.0, pg_iters=30,
              inl_th=INL_TH, optimizer=optimizer)
    gdesc = tlc.global_descriptors(cache)
    cands = tlc.detect_loop_candidates(gdesc, 6, 0.9)
    assert cands
    draws = {(i, j): _ref_gumbel(i, j, 96) for i, j, _ in cands}
    closed, edges = tlc.close_loops(cache, drifted, K, draws=draws,
                                    device="cpu", **kw)
    assert _err(closed, gt) < _err(drifted, gt)
    if optimizer == "sim3":
        # verification does not depend on the optimiser (the Se3 case holds
        # the edges to the reference); the Sim3 graph itself is held to the
        # reference by tests/test_torch_posegraph.py
        assert edges and all(e.i - e.j >= 6 for e in edges)
        assert all(np.isfinite(p).all() for p in closed)
        return
    closed_j, edges_j = jlc.close_loops(cache, drifted, K, **kw)
    assert [(e.i, e.j, e.num_inliers) for e in edges] == \
        [(e.i, e.j, e.num_inliers) for e in edges_j]
    assert edges and all(e.i - e.j >= 6 for e in edges)
    for a, b in zip(edges, edges_j):
        assert a.similarity == pytest.approx(b.similarity, abs=1e-6)
        np.testing.assert_allclose(a.T_rel[:3, :3], b.T_rel[:3, :3],
                                   atol=T_R_ATOL, rtol=0)
        np.testing.assert_allclose(a.T_rel[:3, 3], b.T_rel[:3, 3],
                                   atol=T_T_ATOL, rtol=0)
    for a, b in zip(closed, closed_j):
        np.testing.assert_allclose(a, b, atol=POSE_ATOL, rtol=0)


def test_close_loops_without_a_candidate_returns_the_poses():
    cache, gt = _chain()
    closed, edges = tlc.close_loops(cache, gt, K, min_separation=10,
                                    device="cpu")
    assert not edges
    for a, b in zip(closed, gt):
        np.testing.assert_array_equal(a, b)


def test_no_loop_no_change():
    """A non-revisiting rendered walk passes through unchanged (the port's
    own run: the port renders, tracks and closes; 128 features and 256
    samples a round, where tests/test_loop_closure.py takes 256 and
    512)."""
    from kornia_tpu_torch.slam.vo import VisualOdometry
    from kornia_tpu_torch.utils.render import (make_room_scene,
                                               render_sequence,
                                               walk_trajectory)

    h, w = 120, 160
    Kw = np.array([[0.8 * w, 0.0, w / 2], [0.0, 0.8 * w, h / 2],
                   [0.0, 0.0, 1.0]], np.float32)
    scene = make_room_scene(tex_size=128, device="cpu")
    frames, _ = render_sequence(scene, torch.from_numpy(Kw),
                                walk_trajectory(12), h, w)
    vo = VisualOdometry(Kw, num_features=128, ransac_iters=6,
                        ransac_batch=256, device="cpu")
    res = vo.run(frames, refine=False)
    closed, edges = tlc.close_loops(vo.frame_cache, res.poses, Kw,
                                    min_separation=10, sim_th=0.97,
                                    device="cpu")
    assert not edges
    for a, b in zip(closed, res.poses):
        np.testing.assert_allclose(a, b)
