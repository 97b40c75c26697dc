"""The port's PnP, scene generator, trajectory metrics and incremental SfM
(kornia_tpu_torch: geometry.calibration, geometry.scene, metrics.metrics,
slam.sfm) against the JAX package on the CPU.

Randomness is the reference's: the scene's normal draws and RANSAC's
Gumbel noise are drawn with ``jax.random`` exactly as the JAX functions
draw them, and injected into the port.

Tolerances: the scene 0 on K, R, t, points, E and F, 2e-5 on P and 1e-4 px
on the projections; pnp_ransac the same inlier set (exact) and
R, t within 1e-5 (five accepted Gauss-Newton steps); refine_pose_gn 1e-5;
the DLT 1e-4 (the null vector of a 12 × 12 Gram matrix by two libraries'
float32 eigh); ATE 1e-6 absolute (errors of about 0.01 left after
aligning coordinates of order 3) and RPE 1e-5 (an arccos at about 0.05
rad); incremental_sfm at 4 views × 48 points (the
setting of ``tests/test_sfm.py``) the same reconstructed set, final RMS
within 1e-4 px and camera centres within 1e-3 after the similarity
alignment, and the reference's own bounds (RMS < 0.8 px, Sim3 ATE < 0.05);
the batched re-triangulation equal to the per-point calls to 1e-5
relative.

The JAX 5-point solver compiles for about 35 s; ``incremental_sfm`` runs
it on one minimal sample, so the solver's candidates are also held here,
sample by sample through the same compiled program (``_J_RUN_5POINT``).
Both JAX results are read from their records
(``tests/golden/port_references/{five_point,sfm}.npz``, written by
``tests/write_port_references.py`` from ``five_point_jax_reference`` and
``sfm_jax_reference``; the ``slow`` test
``tests/test_torch_port_references.py`` holds them to the JAX package).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kornia_tpu.slam.sfm as j_sfm_mod
from kornia_tpu.geometry import calibration as j_cal
from kornia_tpu.geometry import epipolar as j_epi
from kornia_tpu.geometry.conversions import axis_angle_to_rotation_matrix
from kornia_tpu.geometry.scene import generate_scene as j_scene
from kornia_tpu.metrics import metrics as j_met
from kornia_tpu_torch.geometry import calibration as t_cal
from kornia_tpu_torch.geometry import epipolar as t_epi
from kornia_tpu_torch.geometry.epipolar import (projection_from_KRt,
                                                triangulate_points)
from kornia_tpu_torch.geometry.scene import generate_scene as t_scene
from kornia_tpu_torch.metrics import metrics as t_met
from kornia_tpu_torch.slam import sfm as t_sfm
from tests import port_references
from tests.test_torch_geometry import _same_up_to_sign, _scene
from tests.torch_threads import one_torch_thread  # noqa: F401

# one minimal sample (1, 5, 2), the shape at which incremental_sfm calls it
_J_RUN_5POINT = jax.jit(j_epi.run_5point)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scene_draws(key, V, N):
    """The normal draws of kornia_tpu.geometry.scene.generate_scene."""
    ks = jax.random.split(key, 4)
    return {"aa": _t(jax.random.normal(ks[0], (V, 3))),
            "t": _t(jax.random.normal(ks[1], (V, 3, 1))),
            "X": _t(jax.random.normal(ks[2], (N, 3)))}


def test_generate_scene_matches():
    key = jax.random.PRNGKey(3)
    s_j = j_scene(key, num_views=3, num_points=20, rotation_scale=0.15,
                  translation_scale=0.4)
    s_t = t_scene(num_views=3, num_points=20, rotation_scale=0.15,
                  translation_scale=0.4,
                  draws=_scene_draws(key, 3, 20), device="cpu")
    assert set(s_t) == set(s_j)
    for k in s_j:
        atol = 1e-4 if k == "points2d" else 2e-5 if k == "P" else 0.0
        np.testing.assert_allclose(s_t[k].numpy(), np.asarray(s_j[k]),
                                   atol=atol, rtol=0, err_msg=k)


def test_trajectory_metrics_match():
    rng = np.random.default_rng(0)
    gt = rng.standard_normal((30, 3)).astype(np.float32)
    R = np.asarray(axis_angle_to_rotation_matrix(
        jnp.asarray([[0.2, -0.1, 0.3]]))[0])
    est = (1.7 * gt @ R.T + np.float32([0.5, -1.0, 2.0])
           + 0.01 * rng.standard_normal((30, 3))).astype(np.float32)
    j_ate = jax.jit(j_met.ate_rmse, static_argnames=("align", "with_scale"))
    for kw in ({}, {"with_scale": True}, {"align": False}):
        np.testing.assert_allclose(
            float(t_met.ate_rmse(_t(est), _t(gt), **kw)),
            float(j_ate(jnp.asarray(est), jnp.asarray(gt), **kw)),
            rtol=0, atol=1e-6)
    T = np.tile(np.eye(4, dtype=np.float32), (12, 1, 1))
    T[:, :3, :3] = np.asarray(axis_angle_to_rotation_matrix(
        jnp.asarray(0.1 * rng.standard_normal((12, 3)).astype(np.float32))))
    T[:, :3, 3] = rng.standard_normal((12, 3))
    T2 = T.copy()
    # rotation errors of about 0.05 rad: arccos near 1 would only measure
    # rounding
    dR = axis_angle_to_rotation_matrix(jnp.asarray(
        0.05 * rng.standard_normal((12, 3)).astype(np.float32)))
    T2[:, :3, :3] = np.asarray(dR) @ T[:, :3, :3]
    T2[:, :3, 3] += 0.05 * rng.standard_normal((12, 3))
    j_rpe = jax.jit(j_met.rpe, static_argnums=(2,))
    for delta in (1, 3):
        for a, b in zip(t_met.rpe(_t(T2), _t(T), delta),
                        j_rpe(jnp.asarray(T2), jnp.asarray(T), delta)):
            np.testing.assert_allclose(float(a), float(b), rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def pnp():
    """tests/test_fuzz_geometry.py's PnP scene: 128 points, 20% outliers,
    normalised coordinates."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(11), 3)
    n = 128
    X = jax.random.normal(k1, (n, 3)) + jnp.asarray([0.0, 0.0, 5.0])
    R = axis_angle_to_rotation_matrix(jnp.asarray([[0.05, -0.1, 0.03]]))[0]
    t = jnp.asarray([0.2, 0.1, -0.3])
    Xc = X @ R.T + t
    uv = Xc[:, :2] / Xc[:, 2:]
    n_out = int(0.2 * n)
    uv = uv.at[:n_out].add(0.5 * jax.random.normal(k2, (n_out, 2)))
    return dict(X=X, uv=uv, R=R, t=t, key=k3, n=n, n_out=n_out)


def test_solve_pnp_dlt_matches(pnp):
    X, uv = pnp["X"][None, 40:], pnp["uv"][None, 40:]
    K = jnp.asarray([[300.0, 0, 160], [0, 300, 120], [0, 0, 1]])[None]
    px = uv * 300.0 + jnp.asarray([160.0, 120.0])
    M_j = jax.jit(j_cal.solve_pnp_dlt)(X, px, K)  # one compile, not one an op
    M_t = t_cal.solve_pnp_dlt(_t(X), _t(px), _t(K))
    np.testing.assert_allclose(M_t.numpy(), np.asarray(M_j), atol=1e-4,
                               rtol=0)


def test_pnp_ransac_matches_with_injected_gumbel(pnp):
    S = 256
    R_j, t_j, inl_j, n_j = jax.jit(
        j_cal.pnp_ransac, static_argnames=("inl_th", "batch_size",
                                           "gn_iters"))(
        pnp["X"], pnp["uv"], pnp["key"], inl_th=5e-3, batch_size=S,
        gn_iters=5)
    g = jax.random.gumbel(pnp["key"], (S, pnp["n"]))
    R_t, t_t, inl_t, n_t = t_cal.pnp_ransac(_t(pnp["X"]), _t(pnp["uv"]),
                                            None, 5e-3, batch_size=S,
                                            gn_iters=5, gumbel=_t(g))
    np.testing.assert_array_equal(inl_t.numpy(), np.asarray(inl_j))
    assert int(n_t) == int(n_j) >= pnp["n"] - pnp["n_out"] - 5
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-5)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(pnp["R"]), atol=1e-2)


def test_refine_pose_gn_matches(pnp):
    mask = jnp.arange(pnp["n"]) >= pnp["n_out"]
    R0 = axis_angle_to_rotation_matrix(jnp.asarray([[0.07, -0.12, 0.01]]))[0]
    t0 = pnp["t"] + 0.05
    R_j, t_j = jax.jit(j_cal.refine_pose_gn, static_argnums=(4,))(
        pnp["X"], pnp["uv"], R0, t0, 0.01, mask)
    R_t, t_t = t_cal.refine_pose_gn(_t(pnp["X"]), _t(pnp["uv"]), _t(R0),
                                    _t(t0), 0.01, _t(mask))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=1e-5)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-5)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(pnp["R"]), atol=1e-4)


def _centres(R, t):
    return np.einsum("vji,vj->vi", R, -t)


def _minimal_inputs():
    x1, x2, R, t = _scene(5 * 24, 4, noise=0.0)
    p1 = x1.reshape(24, 5, 2)
    p2 = x2.reshape(24, 5, 2)
    E_true = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                       [-t[1], t[0], 0]]) @ R
    E_true /= np.linalg.norm(E_true)
    return p1, p2, E_true


def five_point_jax_reference():
    """The JAX 5-point candidates of the test's samples, sample by sample
    through the program incremental_sfm's reference runs: (the inputs'
    digest, the candidates), as tests/write_port_references.py records
    them."""
    p1, p2, _ = _minimal_inputs()
    ref = np.concatenate([np.asarray(_J_RUN_5POINT(
        jnp.asarray(p1[b:b + 1]), jnp.asarray(p2[b:b + 1])))
        for b in range(24)])
    return port_references.inputs((p1, p2)), {"candidates": ref}


@pytest.fixture(scope="module")
def minimal_samples():
    """The samples and the recorded JAX candidates
    (tests/port_references.py; the solver's compile took about 35 s a
    run)."""
    p1, p2, E_true = _minimal_inputs()
    ref = port_references.load("five_point",
                               port_references.inputs((p1, p2)))
    return p1, p2, E_true, ref["candidates"]


def test_five_point_candidates_match_reference(minimal_samples):
    p1, p2, E_true, ref = minimal_samples
    out = t_epi.run_5point(_t(p1), _t(p2)).numpy()
    assert out.shape == ref.shape == (24, 20, 3, 3)
    def best(E):
        d = np.minimum(np.abs(E - E_true).reshape(20, 9).max(-1),
                       np.abs(E + E_true).reshape(20, 9).max(-1))
        return E[np.argmin(d)], d.min()

    found = 0
    for b in range(24):
        # the candidate nearest the true E agrees with the reference's, and
        # the port finds the true E exactly where the reference does (the
        # f32 solver misses about one minimal sample in a hundred)
        eo, do = best(out[b])
        er, dr = best(ref[b])
        assert (do < 1e-3) == (dr < 1e-3)
        assert _same_up_to_sign(eo, er, 1e-3)
        found += do < 1e-3
    assert found >= 22
    # the surviving candidates are, by and large, the same slots
    alive_o = np.abs(out).sum((-1, -2)) > 0
    alive_r = np.abs(ref).sum((-1, -2)) > 0
    assert (alive_o == alive_r).mean() > 0.95


def _sfm_inputs():
    """tests/test_sfm.py::test_reconstructs_synthetic_scene's scene and
    noisy observations (the JAX scene generator's draws)."""
    key = jax.random.PRNGKey(0)
    V, N = 4, 48
    s = j_scene(key, num_views=V, num_points=N, rotation_scale=0.15,
                translation_scale=0.4)
    obs = np.asarray(s["points2d"] + 0.3 * jax.random.normal(
        jax.random.fold_in(key, 1), s["points2d"].shape))
    vis = np.ones(obs.shape[:2], bool)
    K = np.asarray(s["K"][0])
    C_gt = _centres(np.asarray(s["R"]), np.asarray(s["t"])[..., 0])
    return obs, vis, K, C_gt


def sfm_jax_reference():
    """The JAX incremental_sfm on the test's inputs, its geometry helpers
    under jit (the eager path dispatches the 5-point solver and the
    triangulations op by op; its own algorithm is unchanged): (the inputs'
    digest, its result), as tests/write_port_references.py records
    them."""
    obs, vis, K, _ = _sfm_inputs()
    mp = pytest.MonkeyPatch()
    for name in ("triangulate_points", "motion_from_essential_choose_solution",
                 "solve_pnp_dlt", "sampson_epipolar_distance"):
        mp.setattr(j_sfm_mod, name, jax.jit(getattr(j_sfm_mod, name)))
    mp.setattr(j_sfm_mod, "run_5point", _J_RUN_5POINT)
    try:
        res_j = j_sfm_mod.incremental_sfm(jnp.asarray(obs), jnp.asarray(vis),
                                          jnp.asarray(K), ba_iters=10)
    finally:
        mp.undo()
    return (port_references.inputs((vis,), (obs, K)),
            {"R": np.asarray(res_j.poses.r.matrix()),
             "t": np.asarray(res_j.poses.t),
             "points": np.asarray(res_j.points),
             "point_valid": np.asarray(res_j.point_valid),
             "final_rms": np.float64(res_j.final_rms)})


@pytest.fixture(scope="module")
def sfm_run():
    """tests/test_sfm.py::test_reconstructs_synthetic_scene through the
    port, against the recorded JAX run (tests/port_references.py; it took
    about 50 s a run, most of it compiles)."""
    obs, vis, K, C_gt = _sfm_inputs()
    res_j = port_references.load("sfm",
                                 port_references.inputs((vis,), (obs, K)))
    res_t = t_sfm.incremental_sfm(obs, vis, _t(K), ba_iters=10,
                                  device="cpu")
    return res_j, res_t, C_gt


def test_incremental_sfm_matches(sfm_run):
    res_j, res_t, C_gt = sfm_run
    np.testing.assert_array_equal(res_t.point_valid, res_j["point_valid"])
    assert res_t.final_rms == pytest.approx(float(res_j["final_rms"]),
                                            abs=1e-4)
    assert res_t.final_rms < 0.8
    C_t = _centres(res_t.poses.r.matrix().numpy(), res_t.poses.t.numpy())
    C_j = _centres(res_j["R"], res_j["t"])
    ate_t = float(t_met.ate_rmse(_t(C_t), _t(C_gt), with_scale=True))
    ate_j = float(j_met.ate_rmse(jnp.asarray(C_j), jnp.asarray(C_gt),
                                 with_scale=True))
    assert ate_t < 0.05
    assert ate_t == pytest.approx(ate_j, abs=1e-3)
    # the two reconstructions agree up to a similarity
    assert float(t_met.ate_rmse(_t(C_t), _t(C_j), with_scale=True)) < 1e-3


def test_batched_retriangulation_equals_per_point_calls():
    rng = np.random.default_rng(4)
    V, P = 5, 30
    s = t_scene(num_views=V, num_points=P, rotation_scale=0.15,
                translation_scale=0.4,
                generator=torch.Generator().manual_seed(0), device="cpu")
    obs = (s["points2d"].numpy()
           + 0.3 * rng.standard_normal((V, P, 2))).astype(np.float32)
    vis = rng.random((V, P)) > 0.3
    vis[:, :2] = False  # never seen: kept
    vis[3, 2] = True
    vis[:3, 2] = vis[4:, 2] = False  # seen once: kept
    ids_rec = np.arange(P)
    pts = rng.standard_normal((P, 3)).astype(np.float32)
    Ps = projection_from_KRt(s["K"], s["R"], s["t"])
    batched = t_sfm._retriangulate(Ps, obs, vis, ids_rec, pts)
    loop = pts.copy()
    for ci, pid in enumerate(ids_rec):
        views = np.where(vis[:, pid])[0]
        if views.size < 2:
            continue
        v0, v1 = int(views[0]), int(views[-1])
        X = triangulate_points(Ps[v0][None], Ps[v1][None],
                               _t(obs[v0, pid][None, None]),
                               _t(obs[v1, pid][None, None]))[0, 0].numpy()
        if np.isfinite(X).all():
            loop[ci] = X
    np.testing.assert_array_equal(batched[:3], pts[:3])
    np.testing.assert_allclose(batched, loop, rtol=1e-5, atol=1e-6)
