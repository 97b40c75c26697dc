"""The port's two-view geometry (kornia_tpu_torch: core.linalg,
geometry.{solvers, homography, conversions, epipolar, ransac}) against the
JAX package on the CPU.

RANSAC is held to the reference with the reference's own random draws:
the ``jax.random.split`` / ``gumbel`` chain of
``kornia_tpu/geometry/ransac.py``, injected into the port. Its JAX result
and those draws are read from their record
(``tests/golden/port_references/ransac.npz``, written by
``tests/write_port_references.py`` from ``ransac_jax_reference``; the
``slow`` test ``tests/test_torch_port_references.py`` holds the record to
the JAX package). The 5-point solver's candidates are held in
tests/test_torch_sfm.py. The small
helpers' references run as one program each (``exact_jit``: each op
rounds as it does eagerly).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kornia_tpu.core import linalg as j_lin
from kornia_tpu.geometry import epipolar as j_epi
from kornia_tpu.geometry import solvers as j_sol
from kornia_tpu.geometry.conversions import \
    normalize_points_with_intrinsics as j_norm_k
from kornia_tpu.geometry.homography import normalize_points as j_norm
from kornia_tpu.geometry.ransac import ransac as j_ransac
from kornia_tpu_torch.core import linalg as t_lin
from kornia_tpu_torch.geometry import epipolar as t_epi
from kornia_tpu_torch.geometry import solvers as t_sol
from kornia_tpu_torch.geometry.conversions import \
    normalize_points_with_intrinsics as t_norm_k
from kornia_tpu_torch.geometry.homography import normalize_points as t_norm
from kornia_tpu_torch.geometry.ransac import ransac as t_ransac
from tests import port_references
from tests.torch_op_parity import exact_jit
from tests.torch_threads import one_torch_thread  # noqa: F401


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a)


def _rot(w):
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _scene(n, seed, outliers=0.0, noise=0.0):
    """Normalized correspondences of a random 3-D scene seen from two
    cameras, and the true (R, t)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-1.5, -1.5, 4.0], [1.5, 1.5, 8.0], (n, 3))
    R = _rot(np.array([0.05, -0.1, 0.03]))
    t = np.array([1.0, 0.2, 0.1])
    t /= np.linalg.norm(t)
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:]
    x1 = x1 + noise * rng.standard_normal(x1.shape)
    x2 = x2 + noise * rng.standard_normal(x2.shape)
    n_out = int(outliers * n)
    x2[:n_out] = rng.uniform(-0.4, 0.4, (n_out, 2))
    return x1.astype(np.float32), x2.astype(np.float32), R, t


def _same_up_to_sign(a, b, atol):
    a = np.asarray(a).reshape(-1)
    b = np.asarray(b).reshape(-1)
    return min(np.abs(a - b).max(), np.abs(a + b).max()) <= atol


def test_small_linalg_matches_reference():
    rng = np.random.default_rng(0)
    A = rng.standard_normal((16, 10, 10)).astype(np.float32)
    b = rng.standard_normal((16, 10)).astype(np.float32)
    M3 = rng.standard_normal((8, 3, 3)).astype(np.float32)
    B = rng.standard_normal((8, 3, 2)).astype(np.float32)
    # the reference's helpers in one program, each op rounding as eagerly
    det, sol, inv3, inv2, ref = exact_jit(lambda a, v, m, w: (
        j_lin.gauss_det(a), j_lin.gauss_solve(a, v), j_lin.inverse_3x3(m),
        j_lin.inverse_2x2(m[:, :2, :2]), j_lin.solve_refined(m, w)),
        A, b, M3, B)
    np.testing.assert_allclose(t_lin.gauss_det(_t(A)).numpy(), _np(det),
                               rtol=1e-5)
    np.testing.assert_allclose(t_lin.gauss_solve(_t(A), _t(b)).numpy(),
                               _np(sol), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(t_lin.inverse_3x3(_t(M3)).numpy(),
                               _np(inv3), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        t_lin.inverse_2x2(_t(M3[:, :2, :2])).numpy(), _np(inv2), rtol=1e-5,
        atol=1e-5)
    np.testing.assert_allclose(
        t_lin.solve_refined(_t(M3), _t(B)).numpy(), _np(ref), rtol=1e-4,
        atol=1e-4)


def test_nullspaces_match_reference():
    rng = np.random.default_rng(1)
    A = rng.standard_normal((12, 5, 9)).astype(np.float32)
    # near rank-deficient 10x10: inverse iteration finds the null vector
    C = rng.standard_normal((12, 10, 9)).astype(np.float32)
    C = np.concatenate([C, C[..., :1] + C[..., 1:2]], -1)
    G = rng.standard_normal((6, 12, 9)).astype(np.float32)
    qr, inv_it, lsq = exact_jit(lambda a, c, g: (
        j_lin.nullspace_qr(a), j_lin.nullspace_inverse_iteration(c),
        j_lin.lstsq_nullspace(g)), A, C, G)
    np.testing.assert_allclose(t_lin.nullspace_qr(_t(A)).numpy(), _np(qr),
                               atol=1e-5)
    out = t_lin.nullspace_inverse_iteration(_t(C)).numpy()
    for o, r in zip(out, _np(inv_it)):
        assert _same_up_to_sign(o, r, 1e-4)
    for o, r in zip(t_lin.lstsq_nullspace(_t(G)).numpy(), _np(lsq)):
        assert _same_up_to_sign(o, r, 1e-4)  # the eigenvector sign is free


def test_poly_roots_and_products_match_reference():
    rng = np.random.default_rng(2)
    c = rng.standard_normal((8, 11)).astype(np.float32)
    a = rng.standard_normal((5, 4)).astype(np.float32)
    b = rng.standard_normal((5, 4)).astype(np.float32)
    roots, p2_j, p3_j = exact_jit(lambda cc, x, y: (
        j_sol.poly_roots(cc, tol=1e-5), j_sol.multiply_deg_one_poly(x, y),
        j_sol.multiply_deg_two_one_poly(j_sol.multiply_deg_one_poly(x, y),
                                        y)), c, a, b)
    out = t_sol.poly_roots(_t(c), tol=1e-5).numpy()
    # same iteration, same order of roots; f32 complex arithmetic
    np.testing.assert_allclose(out, _np(roots), atol=1e-4)
    p2 = t_sol.multiply_deg_one_poly(_t(a), _t(b))
    np.testing.assert_allclose(p2.numpy(), _np(p2_j), atol=1e-6)
    np.testing.assert_allclose(
        t_sol.multiply_deg_two_one_poly(p2, _t(b)).numpy(), _np(p3_j),
        atol=1e-5)


def test_point_normalisation_matches_reference():
    rng = np.random.default_rng(3)
    p = rng.uniform(0, 640, (4, 50, 2)).astype(np.float32)
    K = np.array([[512.0, 0, 320], [0, 512, 240], [0, 0, 1]], np.float32)
    normed, normed_k = exact_jit(lambda x, k: (j_norm(x), j_norm_k(x[0], k)),
                                 p, K)
    for o, r in zip(t_norm(_t(p)), normed):
        np.testing.assert_allclose(o.numpy(), _np(r), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t_norm_k(_t(p[0]), _t(K)).numpy(),
                               _np(normed_k), atol=1e-6)


def test_eight_point_and_polish_match_reference():
    x1, x2, R, t = _scene(60, 5, noise=1e-3)
    w = (np.random.default_rng(5).random(60) > 0.2).astype(np.float32)
    F = t_epi.run_8point(_t(x1[None]), _t(x2[None]), _t(w[None]))[0]
    F_ref = _np(jax.jit(j_epi.run_8point)(
        jnp.asarray(x1[None]), jnp.asarray(x2[None]),
        jnp.asarray(w[None])))[0]
    assert _same_up_to_sign(F.numpy(), F_ref, 1e-4)
    E0 = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) \
        @ _rot(np.array([0.06, -0.09, 0.03]))
    E0 = (E0 / np.linalg.norm(E0)).astype(np.float32)
    cand = np.stack([E0, np.zeros((3, 3), np.float32)])[None]
    out = t_epi.polish_essential(_t(cand), _t(x1[None]), _t(x2[None]),
                                 iters=2, weights=_t(w[None]))[0].numpy()
    ref = _np(jax.jit(j_epi.polish_essential, static_argnames="iters")(
        jnp.asarray(cand), jnp.asarray(x1[None]), jnp.asarray(x2[None]),
        iters=2, weights=jnp.asarray(w[None])))[0]
    assert _same_up_to_sign(out[0], ref[0], 1e-4)
    np.testing.assert_array_equal(out[1], 0.0)


def test_pose_from_essential_matches_reference():
    x1, x2, R, t = _scene(40, 6, noise=5e-4)
    E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]) @ R
    E = (E / np.linalg.norm(E)).astype(np.float32)[None]
    eye = np.eye(3, dtype=np.float32)[None]
    mask = np.ones((1, 40), bool)
    mask[0, :3] = False
    Rt, tt, Xt = t_epi.motion_from_essential_choose_solution(
        _t(E), _t(eye), _t(eye), _t(x1[None]), _t(x2[None]), _t(mask))
    Rj, tj, Xj = jax.jit(j_epi.motion_from_essential_choose_solution)(
        jnp.asarray(E), jnp.asarray(eye), jnp.asarray(eye),
        jnp.asarray(x1[None]), jnp.asarray(x2[None]), jnp.asarray(mask))
    np.testing.assert_allclose(Rt.numpy(), _np(Rj), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), _np(tj), atol=1e-5)
    np.testing.assert_allclose(Xt.numpy(), _np(Xj), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(Rt.numpy()[0], R, atol=1e-3)
    for fn_t, fn_j in [(t_epi.sampson_epipolar_distance,
                        j_epi.sampson_epipolar_distance),
                       (t_epi.symmetrical_epipolar_distance,
                        j_epi.symmetrical_epipolar_distance)]:
        np.testing.assert_allclose(
            fn_t(_t(x1[None]), _t(x2[None]), _t(E)).numpy(),
            _np(fn_j(jnp.asarray(x1[None]), jnp.asarray(x2[None]),
                     jnp.asarray(E))), rtol=1e-4, atol=1e-10)


def _replay_gumbel(key, T, S, N):
    """The Gumbel noise of the reference's RANSAC rounds: round r splits
    the running key and draws gumbel(sub, (S, N))."""
    draws = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(sub, (S, N))))
    return torch.from_numpy(np.stack(draws))


_RANSAC_N, _RANSAC_T, _RANSAC_S, _RANSAC_TH = 300, 4, 64, 1.5e-3


def _ransac_inputs():
    n = _RANSAC_N
    x1, x2, R, t = _scene(n, 7, outliers=0.3, noise=2e-4)
    mask = np.ones(n, bool)
    mask[-7:] = False
    return x1, x2, mask


def ransac_jax_reference():
    """The JAX RANSAC on the test's inputs with PRNGKey(3): (the inputs'
    digest, its result and the Gumbel noise of its rounds), as
    tests/write_port_references.py records them."""
    x1, x2, mask = _ransac_inputs()
    key = jax.random.PRNGKey(3)
    ref = j_ransac(jnp.asarray(x1), jnp.asarray(x2), key, "essential",
                   inl_th=_RANSAC_TH, batch_size=_RANSAC_S,
                   max_iterations=_RANSAC_T, mask=jnp.asarray(mask))
    gumbel = _replay_gumbel(key, _RANSAC_T, _RANSAC_S, _RANSAC_N).numpy()
    return (port_references.inputs((x1, x2, mask)),
            {"model": _np(ref.model), "inliers": _np(ref.inliers),
             "score": _np(ref.score), "inlier_count": _np(ref.inlier_count),
             "gumbel": gumbel})


def test_ransac_with_reference_noise():
    """n = 300 > 192 takes the two-stage (prescore) path of the main path;
    tests/test_torch_twoview.py covers the single-stage one (n = 128).
    Against the recorded JAX result and its Gumbel noise
    (tests/port_references.py; the JAX RANSAC's compile took about 45 s a
    run)."""
    n = _RANSAC_N
    x1, x2, mask = _ransac_inputs()
    T, S, th = _RANSAC_T, _RANSAC_S, _RANSAC_TH
    rec = port_references.load("ransac",
                               port_references.inputs((x1, x2, mask)))
    ref = SimpleNamespace(**rec)
    out = t_ransac(_t(x1), _t(x2), model_type="essential", inl_th=th,
                   batch_size=S, max_iterations=T, mask=_t(mask),
                   gumbel=torch.from_numpy(rec["gumbel"]))
    np.testing.assert_array_equal(out.inliers.numpy(), _np(ref.inliers))
    assert int(out.inlier_count) == int(ref.inlier_count) > 0.6 * n
    assert _same_up_to_sign(out.model.numpy(), _np(ref.model), 1e-4)
    np.testing.assert_allclose(float(out.score), float(ref.score), rtol=1e-3)
