"""The port's planar and fundamental geometry (kornia_tpu_torch:
geometry.solvers, geometry.homography, the 7-point solver and the other
fundamental and homography helpers of geometry.epipolar, and the
homography, fundamental and 7-point models of geometry.ransac) against the
JAX package on the CPU.

RANSAC is held to the reference with the reference's own random draws: the
test replays the ``jax.random.split`` / ``gumbel`` chain of
``kornia_tpu/geometry/ransac.py`` and injects it into the port. Models are
compared up to scale, normalised by their [2, 2] entry; the homography
decomposition as a set of four (R, t, n), since the SVD's signs are free,
and its chosen solution one to one.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.geometry import epipolar as j_epi
from kornia_tpu.geometry import homography as j_hom
from kornia_tpu.geometry import solvers as j_sol
from kornia_tpu.geometry.ransac import ransac as j_ransac
from kornia_tpu_torch.geometry import epipolar as t_epi
from kornia_tpu_torch.geometry import homography as t_hom
from kornia_tpu_torch.geometry import ransac as t_ran
from kornia_tpu_torch.geometry import solvers as t_sol
from tests.torch_threads import one_torch_thread  # noqa: F401

K_PIX = np.array([[100.0, 0, 64], [0, 100, 48], [0, 0, 1]], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(a):
    return np.asarray(a)


def _rot(w):
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


def _two_views(seed, B, N, noise=0.0):
    """tests/test_geometry.py::make_scene's cameras and points, from numpy:
    pixel correspondences (B, N, 2) of a random cloud seen from two
    cameras."""
    rng = np.random.default_rng(seed)
    x1s, x2s = [], []
    for _ in range(B):
        R = _rot(rng.standard_normal(3) * 0.2)
        t = rng.standard_normal(3) * 0.5 + [1.0, 0.0, 0.0]
        X = rng.standard_normal((N, 3)) + [0.0, 0.0, 5.0]
        x1 = X @ K_PIX.T
        x2 = (X @ R.T + t) @ K_PIX.T
        x1s.append(x1[:, :2] / x1[:, 2:])
        x2s.append(x2[:, :2] / x2[:, 2:])
    x1, x2 = np.stack(x1s), np.stack(x2s)
    x1 = x1 + noise * rng.standard_normal(x1.shape)
    x2 = x2 + noise * rng.standard_normal(x2.shape)
    return x1.astype(np.float32), x2.astype(np.float32)


def _apply(H, p):
    ph = np.concatenate([p, np.ones_like(p[..., :1])], -1) @ H.T
    return ph[..., :2] / ph[..., 2:]


H_TRUE = np.array([[1.1, 0.02, 5.0], [-0.01, 0.95, -3.0], [1e-4, 0, 1.0]],
                  np.float32)


def _replay_gumbel(key, T, S, N):
    """The Gumbel noise of the reference's RANSAC rounds: round r splits
    the running key and draws gumbel(sub, (S, N))."""
    draws = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(sub, (S, N))))
    return torch.from_numpy(np.stack(draws))


def _ref(fn, *args, **static):
    """The JAX function, jitted (one compile, not one per eager op), on
    numpy arguments; numpy out."""
    out = jax.jit(functools.partial(fn, **static))(
        *[None if a is None else jnp.asarray(a) for a in args])
    return jax.tree_util.tree_map(np.asarray, out)


def _unit22(M):
    M = np.asarray(M, np.float64)
    return M / M[..., 2:3, 2:3]


# -----------------------------------------------------------------------------
# solvers
# -----------------------------------------------------------------------------

def test_quadratic_and_cubic_roots_match_reference():
    """tests/test_geometry.py's solver legs and a random batch that takes
    every branch: complex roots, one or three real cubic roots, a
    vanishing leading coefficient."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((64, 3)).astype(np.float32)
    q[:4] = [[1.0, -3.0, 2.0], [0.0, 2.0, -4.0], [1.0, 0.0, 1.0],
             [1.0, 0.0, 0.0]]
    np.testing.assert_allclose(t_sol.solve_quadratic(_t(q)).numpy(),
                               _ref(j_sol.solve_quadratic, q),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.sort(t_sol.solve_quadratic(_t(q[:1]))
                                       .numpy()[0]), [1, 2], atol=1e-5)
    c = rng.standard_normal((64, 4)).astype(np.float32)
    c[:4] = [[1.0, -6.0, 11.0, -6.0], [1.0, 0.0, 1.0, 0.0],
             [0.0, 1.0, -3.0, 2.0], [2.0, 0.0, 0.0, -16.0]]
    out = t_sol.solve_cubic(_t(c)).numpy()
    ref = _ref(j_sol.solve_cubic, c)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.sort(out[0]), [1, 2, 3], atol=1e-4)
    assert abs(out[1, 0]) < 1e-5 and abs(out[3, 0] - 2.0) < 1e-5
    # both branches of the discriminant occur in the batch
    disc_pos = np.array([np.sum(np.abs(np.roots(r).imag) > 1e-6) > 0
                         for r in c[4:].astype(np.float64)])
    assert disc_pos.any() and (~disc_pos).any()


def test_quartic_determinant_and_null_vector_match_reference():
    rng = np.random.default_rng(1)
    c = np.stack([np.poly([1.0, 2.0, -3.0, 5.0]),
                  np.poly([0.5, -1.0, 1 + 1j, 1 - 1j]).real]).astype(
                      np.float32)
    out = t_sol.solve_quartic(_t(c)).numpy()
    np.testing.assert_allclose(out, _ref(j_sol.solve_quartic, c), atol=1e-4)
    np.testing.assert_allclose(np.sort(out[0]), [-3, 1, 2, 5], atol=1e-3)
    A = rng.standard_normal((16, 3, 13)).astype(np.float32)
    out = t_sol.determinant_to_polynomial(_t(A)).numpy()
    ref = _ref(j_sol.determinant_to_polynomial, A)
    # the inverse Vandermonde amplifies the f32 rounding of the 11
    # determinant values: each package errs by about 5e-5 of the largest
    # coefficient against the exact expansion in float64
    exact = np.stack([_det_poly_f64(a) for a in A.astype(np.float64)])
    scale = np.abs(exact).max()
    assert np.abs(ref - exact).max() < 1e-4 * scale
    assert np.abs(out - exact).max() < 1e-4 * scale
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * scale)
    M = rng.standard_normal((16, 3, 4)).astype(np.float32)
    v = t_sol.null_vector_3x4(_t(M)).numpy()
    np.testing.assert_allclose(v, _ref(j_sol.null_vector_3x4, M), atol=1e-5)
    assert np.abs(np.einsum("bij,bj->bi", M, v)).max() < 1e-4


def _det_poly_f64(a):
    """det of the 3x3 polynomial matrix of one (3, 13) action matrix by
    exact polynomial products, lowest degree first."""
    P = [[a[i, 0:4], a[i, 4:8], a[i, 8:13]] for i in range(3)]

    def minor(r, c0, c1):
        return np.polysub(np.polymul(P[r][c0], P[r + 1][c1]),
                          np.polymul(P[r][c1], P[r + 1][c0]))

    d = np.polyadd(np.polysub(np.polymul(P[0][0], minor(1, 1, 2)),
                              np.polymul(P[0][1], minor(1, 0, 2))),
                   np.polymul(P[0][2], minor(1, 0, 1)))
    return np.concatenate([np.zeros(11 - len(d)), d])[::-1]


def _close22(out, ref, rel):
    """Models up to scale: normalised by [2, 2], within rel of each
    matrix's largest entry."""
    a, b = _unit22(out), _unit22(ref)
    scale = np.abs(b).max(axis=(-2, -1), keepdims=True)
    assert (np.abs(a - b) <= rel * scale).all(), np.abs(a - b).max()


# -----------------------------------------------------------------------------
# homography
# -----------------------------------------------------------------------------

def _planar_pairs(seed, B, N, noise=0.0):
    rng = np.random.default_rng(seed)
    p1 = (rng.random((B, N, 2)) * 100).astype(np.float32)
    p2 = _apply(H_TRUE.astype(np.float64), p1.astype(np.float64))
    p2 = p2 + noise * rng.standard_normal(p2.shape)
    return p1, p2.astype(np.float32)


@pytest.mark.parametrize("N", [4, 12])
def test_homography_dlt_matches_reference(N):
    """The minimal sample (Householder nullspace) and an over-determined
    weighted one (Gram eigenvector), and the reweighted form; within 2e-4
    of the largest entry (f32 DLTs: on these minimal samples each package
    errs by up to 1.1e-4 of it against the noise-free truth)."""
    p1, p2 = _planar_pairs(2, 6, N, noise=0.05 if N > 4 else 0.0)
    w = np.random.default_rng(3).random((6, N)).astype(np.float32)
    for weights in (None, w):
        out = t_hom.find_homography_dlt(
            _t(p1), _t(p2), None if weights is None else _t(weights))
        ref = _ref(j_hom.find_homography_dlt, p1, p2, weights)
        _close22(out.numpy(), ref, 2e-4)
        if N == 4 and weights is None:  # noise-free minimal samples
            np.testing.assert_allclose(_unit22(out.numpy()),
                                       np.broadcast_to(H_TRUE, (6, 3, 3)),
                                       atol=1e-3)
    if N > 4:
        out = t_hom.find_homography_dlt_iterated(_t(p1), _t(p2), _t(w),
                                                 n_iter=3)
        ref = _ref(j_hom.find_homography_dlt_iterated, p1, p2, w, n_iter=3)
        _close22(out.numpy(), ref, 2e-4)


def test_transfer_errors_and_sample_check_match_reference():
    p1, p2 = _planar_pairs(4, 3, 20, noise=0.5)
    H = np.broadcast_to(H_TRUE, (3, 3, 3)).copy()
    for fn in ("oneway_transfer_error", "symmetric_transfer_error"):
        for sq in (True, False):
            np.testing.assert_allclose(
                getattr(t_hom, fn)(_t(p1), _t(p2), _t(H), sq).numpy(),
                _ref(getattr(j_hom, fn), p1, p2, H, squared=sq),
                rtol=1e-4, atol=1e-6)
    # random samples, a flipped one and one with three collinear points
    # (a zero triple product: sign 0 must behave as in JAX)
    rng = np.random.default_rng(5)
    s1 = (rng.random((64, 4, 2)) * 10).astype(np.float32)
    s2 = _apply(H_TRUE.astype(np.float64), s1).astype(np.float32)
    s2[:16] = (rng.random((16, 4, 2)) * 10).astype(np.float32)
    s2[16, :, 0] *= -1.0
    s1[17] = [[0, 0], [1, 1], [2, 2], [0, 3]]
    s2[17] = [[0, 0], [1, 1], [2, 2], [3, 0]]
    out = t_hom.sample_is_valid_for_homography(_t(s1), _t(s2)).numpy()
    ref = _ref(j_hom.sample_is_valid_for_homography, s1, s2)
    np.testing.assert_array_equal(out, ref)
    assert out[18:].all() and not out[16] and out[:16].sum() < 16
    assert not out[17]  # the orientation of a zero product changes sign


def test_line_dlt_matches_reference():
    rng = np.random.default_rng(6)
    ends = (rng.random((2, 8, 2, 2)) * 100).astype(np.float32)
    ls2 = _apply(H_TRUE.astype(np.float64), ends.astype(np.float64))
    ls2 = (ls2 + 0.05 * rng.standard_normal(ls2.shape)).astype(np.float32)
    w = rng.random((2, 8)).astype(np.float32)
    out = t_hom.find_homography_lines_dlt_iterated(_t(ends), _t(ls2), _t(w))
    ref = _ref(j_hom.find_homography_lines_dlt_iterated, ends, ls2, w)
    # five reweighted refits: 5e-4 of the largest entry
    _close22(out.numpy(), ref, 5e-4)
    exact = _apply(H_TRUE.astype(np.float64), ends.astype(np.float64))
    H = t_hom.find_homography_lines_dlt(_t(ends), _t(exact.astype(np.float32)))
    np.testing.assert_allclose(_unit22(H.numpy()[0]), H_TRUE, atol=1e-3)
    for sq in (False, True):
        np.testing.assert_allclose(
            t_hom.line_segment_transfer_error_one_way(
                _t(ends), _t(ls2), out, sq).numpy(),
            _ref(j_hom.line_segment_transfer_error_one_way, ends, ls2,
                 out.numpy(), squared=sq), rtol=1e-4, atol=1e-4)


# -----------------------------------------------------------------------------
# epipolar: 7-point, fundamental helpers, homography decomposition
# -----------------------------------------------------------------------------

def test_seven_point_matches_reference():
    """tests/test_geometry.py::test_7point: every candidate, zero-padded
    roots included, in the reference's order."""
    x1, x2 = _two_views(7, 8, 7)
    out = t_epi.run_7point(_t(x1), _t(x2)).numpy()
    ref = _ref(j_epi.run_7point, x1, x2)
    # the cubic's roots in f32, then the scaling by F[2, 2]: 1e-3 of each
    # candidate's largest entry
    scale = np.abs(ref).max(axis=(-2, -1), keepdims=True)
    np.testing.assert_allclose(out / scale, ref / scale, atol=1e-3)
    best = np.stack([t_epi.sampson_epipolar_distance(
        _t(x1), _t(x2), _t(out[:, i])).numpy() for i in range(3)]).min(0)
    assert best.max() < 1e-3
    np.testing.assert_array_equal(
        t_epi.find_fundamental(_t(x1), _t(x2), method="7point").numpy(), out)


def test_fundamental_helpers_match_reference():
    x1, x2 = _two_views(8, 2, 16)
    F = t_epi.find_fundamental(_t(x1), _t(x2)).numpy()
    Fn = _ref(j_epi.find_fundamental, x1, x2)
    for a, b in zip(F, Fn):  # unit norm; the eigenvector's sign is free
        assert min(np.abs(a - b).max(), np.abs(a + b).max()) < 1e-4
    np.testing.assert_allclose(
        t_epi.normalize_transformation(_t(Fn)).numpy(),
        _ref(j_epi.normalize_transformation, Fn), rtol=1e-5)
    lines = t_epi.compute_correspond_epilines(_t(x1), _t(Fn)).numpy()
    np.testing.assert_allclose(
        lines, _ref(j_epi.compute_correspond_epilines, x1, Fn), atol=1e-5)
    assert np.abs((lines[..., :2] * x2).sum(-1) + lines[..., 2]).max() < 1e-2
    # distances of points 0.5 px off their epipolar lines
    x2n = x2 + 0.5 * np.random.default_rng(20).standard_normal(
        x2.shape).astype(np.float32)
    for fn in ("left_to_right_epipolar_distance",
               "right_to_left_epipolar_distance"):
        np.testing.assert_allclose(
            getattr(t_epi, fn)(_t(x1), _t(x2n), _t(Fn)).numpy(),
            _ref(getattr(j_epi, fn), x1, x2n, Fn), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def plane():
    """Normalised views of points on the plane nᵀX = d, and the calibrated
    homography R + t·nᵀ/d between them."""
    rng = np.random.default_rng(9)
    R = _rot(np.array([0.05, -0.08, 0.02]))
    t = np.array([0.3, -0.1, 0.05])
    n = np.array([0.1, -0.2, 1.0])
    n /= np.linalg.norm(n)
    d = 4.0
    uv = rng.uniform(-1, 1, (40, 2))
    # points on the plane along the rays (u, v, 1)
    X = np.concatenate([uv, np.ones((40, 1))], -1)
    X = X * (d / (X @ n))[:, None]
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:]
    H = (R + np.outer(t, n) / d).astype(np.float32)[None]
    return dict(H=H, x1=x1.astype(np.float32)[None],
                x2=x2.astype(np.float32)[None], R=R, t=t / d, n=n)


def test_homography_decomposition_matches_reference(plane):
    out = [o.numpy()[0] for o in t_epi.decompose_homography_matrix(
        _t(plane["H"]))]
    ref = [r[0] for r in _ref(j_epi.decompose_homography_matrix,
                              plane["H"])]
    flat = lambda Rs, ts, ns: np.concatenate(  # noqa: E731
        [Rs.reshape(4, 9), ts.reshape(4, 3), ns.reshape(4, 3)], -1)
    a, b = flat(*out), flat(*ref)
    # the same candidates, in any order (turning each normal toward the
    # camera makes the (e1, e3) and (-e1, -e3) pairs coincide)
    dist = np.abs(a[:, None] - b[None]).max(-1)
    assert dist.min(1).max() < 1e-4 and dist.min(0).max() < 1e-4
    # one of them is the truth (t scaled by 1/d)
    assert min(np.abs(row - np.concatenate([plane["R"].ravel(), plane["t"],
                                            plane["n"]])).max()
               for row in a) < 1e-4


def test_homography_motion_choice_matches_reference(plane):
    mask = np.ones((1, 40), bool)
    mask[0, :5] = False
    out = t_epi.motion_from_homography_choose_solution(
        _t(plane["H"]), _t(plane["x1"]), _t(plane["x2"]), _t(mask))
    ref = _ref(j_epi.motion_from_homography_choose_solution, plane["H"],
               plane["x1"], plane["x2"], mask)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), r, atol=1e-5)
    np.testing.assert_allclose(out[0].numpy()[0], plane["R"], atol=1e-4)
    np.testing.assert_allclose(out[2].numpy()[0, :, 0], plane["n"],
                               atol=1e-4)


# -----------------------------------------------------------------------------
# RANSAC
# -----------------------------------------------------------------------------

def _ransac_both(p1, p2, key, model_type, inl_th, S, T, mask=None,
                 scores=None):
    ref = j_ransac(jnp.asarray(p1), jnp.asarray(p2), key, model_type,
                   inl_th=inl_th, batch_size=S, max_iterations=T,
                   mask=None if mask is None else jnp.asarray(mask),
                   scores=None if scores is None else jnp.asarray(scores))
    out = t_ran.ransac(_t(p1), _t(p2), None, model_type, inl_th, S, T,
                       mask=None if mask is None else _t(mask),
                       scores=None if scores is None else _t(scores),
                       gumbel=_replay_gumbel(key, T, S, p1.shape[0]))
    np.testing.assert_array_equal(out.inliers.numpy(), _np(ref.inliers))
    assert int(out.inlier_count) == int(ref.inlier_count)
    np.testing.assert_allclose(float(out.score), float(ref.score), rtol=1e-3,
                               atol=1e-6)
    return out, ref


def _homography_outliers():
    """tests/test_geometry.py::test_homography_with_outliers' data, from
    numpy: 100 points, 30 gross outliers."""
    rng = np.random.default_rng(10)
    p1 = (rng.random((100, 2)) * 100).astype(np.float32)
    p2 = _apply(H_TRUE.astype(np.float64), p1).astype(np.float32)
    p2[:30] = (rng.random((30, 2)) * 100).astype(np.float32)
    return p1, p2


@pytest.mark.parametrize("prosac", [False, True])
def test_homography_ransac_matches_reference(prosac):
    """test_homography_with_outliers, plus the PROSAC schedule with scores
    that favour the inliers."""
    p1, p2 = _homography_outliers()
    scores = None
    if prosac:
        scores = np.random.default_rng(11).random(100).astype(np.float32)
        scores[30:] += 0.5
    out, ref = _ransac_both(p1, p2, jax.random.PRNGKey(12), "homography",
                            1.0, 512, 8, scores=scores)
    assert int(out.inlier_count) >= 65
    np.testing.assert_allclose(_unit22(out.model.numpy()), _unit22(ref.model),
                               rtol=1e-4, atol=1e-5)
    err = t_hom.oneway_transfer_error(_t(p1[None, 30:]), _t(p2[None, 30:]),
                                      out.model[None], squared=False)
    assert float(err.median()) < 1.0


def test_fundamental_ransac_matches_reference():
    """test_fundamental_ransac: 100 noisy points, 20 shifted by 30 px."""
    x1, x2 = _two_views(13, 1, 100, noise=0.2)
    x1, x2 = x1[0], x2[0]
    x2[:20] += 30.0
    out, ref = _ransac_both(x1, x2, jax.random.PRNGKey(14), "fundamental",
                            2.0, 256, 8)
    assert int(out.inlier_count) >= 60
    m = out.model.numpy()
    r = _np(ref.model)
    assert min(np.abs(m - r).max(), np.abs(m + r).max()) < 1e-4


def test_seven_point_ransac_with_prescore_matches_reference():
    """The 7-point model with N = 240 > 192: three candidates a sample,
    each sample's winner picked on the strided prescore."""
    x1, x2 = _two_views(15, 1, 240, noise=0.2)
    x1, x2 = x1[0], x2[0]
    x2[:40] += 25.0
    out, ref = _ransac_both(x1, x2, jax.random.PRNGKey(16),
                            "fundamental_7pt", 2.0, 64, 4)
    assert int(out.inlier_count) >= 180
    np.testing.assert_allclose(_unit22(out.model.numpy()), _unit22(ref.model),
                               rtol=1e-3, atol=1e-3)


def test_padded_mask_and_default_model():
    """test_padded_mask: the last 24 correspondences are padding. The
    default model is the reference's, a homography, and the RANSAC class
    runs the same estimator."""
    p1 = (np.random.default_rng(17).random((64, 2)) * 100).astype(np.float32)
    mask = np.arange(64) < 40
    out, ref = _ransac_both(p1, p1, jax.random.PRNGKey(18), "homography",
                            2.0, 128, 4, mask=mask)
    assert int(out.inlier_count) == 40
    np.testing.assert_allclose(out.model.numpy() / out.model.numpy()[2, 2],
                               np.eye(3), atol=1e-3)
    p1, p2 = _homography_outliers()
    g = _replay_gumbel(jax.random.PRNGKey(19), 4, 128, 100)
    res = t_ran.ransac(_t(p1), _t(p2), inl_th=1.0, batch_size=128,
                       max_iterations=4, gumbel=g)
    np.testing.assert_allclose(_unit22(res.model.numpy()), H_TRUE, atol=1e-3)
    model, inliers = t_ran.RANSAC(inl_th=1.0, batch_size=128, max_iter=4,
                                  max_lo_iters=3)(_t(p1), _t(p2), gumbel=g)
    np.testing.assert_array_equal(model.numpy(), res.model.numpy())
    np.testing.assert_array_equal(inliers.numpy(), res.inliers.numpy())
    gen = torch.Generator().manual_seed(0)
    res = t_ran.ransac(_t(p1), _t(p2), gen, inl_th=1.0, batch_size=128,
                       max_iterations=4)
    assert int(res.inlier_count) == 70 and res.rounds >= 1
