"""The port's bundle adjustment (kornia_tpu_torch: losses.robust, slam.ba,
slam.ba_sparse) against the JAX package on the CPU, at the size of
``tests/test_slam.py::make_ba_problem`` (5 cameras, 40 points, 200
observations, 0.3 px noise). Both packages start from the same state,
exported from JAX through ``kornia_tpu_torch.convert``.

Tolerances, each relative to the largest magnitude of the compared array
unless it says otherwise:
- robust weights and losses: 1e-6 absolute (values in [0, 1] or a few);
- residuals: 1e-4 px absolute (residuals up to about 100 px, float32);
- Jacobians Jc, Jp and every normal-equation block: 1e-5 (float32 sums of
  up to 40 products in another order);
- one Schur step on the same normal equations: 2e-3. The reduced system
  is ill-conditioned (with one camera fixed the scale is a gauge freedom
  that only λ damps), so the two libraries' Cholesky factorisations give
  steps that differ by about 1e-4 to 5e-4 of their size;
- bundle_adjust with two cameras fixed (no gauge freedom left): per-
  iteration costs 1e-3 relative, final poses and points 5e-4 absolute,
  quaternions 5e-5;
- with one camera fixed (the scale gauge free) the LM path differs from
  the first step on (the step along the gauge direction is rounding
  noise amplified by 1/λ), so the final cost is held to 1e-4 relative and
  the final residuals (invariant under the gauge) to 1e-3 px;
- bundle_adjust_sparse (camera 0 fixed, the scale free): final cost 1e-4
  relative to JAX's, and 1e-3 relative to the port's dense result, as
  ``tests/test_ba_sparse.py`` holds JAX's own pair;
- the sparse path's reduced camera system against the dense path's, from
  the same state (port against port): 1e-5 of the largest entry.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.losses import robust as j_rob
from kornia_tpu.slam import ba as j_ba
from kornia_tpu.slam import ba_sparse as j_bas
from kornia_tpu_torch import convert
from kornia_tpu_torch.losses import robust as t_rob
from kornia_tpu_torch.slam import ba as t_ba
from kornia_tpu_torch.slam import ba_sparse as t_bas
from tests.test_slam import make_ba_problem
from tests.torch_threads import one_torch_thread  # noqa: F401

NUM_ITERS = 6


def _port(state, problem):
    """A JAX BAState/BAProblem carried into the port as numpy arrays."""
    return (convert.ba_state_from_numpy(state.poses.r.q.data, state.poses.t,
                                        state.points, "cpu"),
            convert.ba_problem_from_numpy(problem.cam_idx, problem.pt_idx,
                                          problem.uv, problem.valid,
                                          problem.K, "cpu"))


def _rel_close(actual, expected, rtol):
    expected = np.asarray(expected)
    scale = np.abs(expected).max()
    np.testing.assert_allclose(np.asarray(actual), expected,
                               atol=rtol * scale, rtol=0)


def _problem(seed, noise=0.3):
    """make_ba_problem's initial state and problem, built under jit (the
    eager build dispatches its vmapped projections op by op)."""
    s0, problem = jax.jit(lambda k: make_ba_problem(k, noise=noise)[:2])(
        jax.random.PRNGKey(seed))
    return s0, problem, 5, 40


@pytest.fixture(scope="module")
def ba():
    s0, problem, C, P = _problem(0)
    ts, tp = _port(s0, problem)
    blocks = jax.jit(j_ba._build_normal_eqs, static_argnums=(2, 3, 4))(
        s0, problem, C, P, lambda r2: j_rob.huber_weight(r2, 3.0))
    return dict(j_state=s0, j_problem=problem, t_state=ts, t_problem=tp,
                C=C, P=P, j_blocks=blocks)


# --- robust kernels ---------------------------------------------------------

WEIGHTS = ["huber_weight", "cauchy_weight", "geman_mcclure_weight",
           "welsch_weight", "tukey_weight"]
LOSSES = ["charbonnier_loss", "cauchy_loss", "geman_mcclure_loss",
          "welsch_loss"]


@pytest.mark.parametrize("name", WEIGHTS)
def test_robust_weights_match(name):
    r2 = (np.random.default_rng(0).standard_normal(256) * 4.0) ** 2
    r2 = np.concatenate([r2, [0.0, 1.0, 21.95, 1e6]]).astype(np.float32)
    for c in (1.0, 3.0):
        np.testing.assert_allclose(
            getattr(t_rob, name)(torch.from_numpy(r2), c).numpy(),
            np.asarray(getattr(j_rob, name)(jnp.asarray(r2), c)),
            atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", LOSSES)
def test_robust_losses_match(name):
    rng = np.random.default_rng(1)
    a, b = (rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
            for _ in range(2))
    for red in ("none", "mean", "sum"):
        np.testing.assert_allclose(
            getattr(t_rob, name)(torch.from_numpy(a), torch.from_numpy(b),
                                 red).numpy(),
            np.asarray(getattr(j_rob, name)(jnp.asarray(a), jnp.asarray(b),
                                            red)),
            atol=1e-6 * (384 if red == "sum" else 1), rtol=0)


# --- residuals, Jacobians, normal equations, one step -----------------------

def test_reprojection_residuals_match(ba):
    r_j = jax.jit(j_ba.reprojection_residuals)(ba["j_state"], ba["j_problem"])
    r_t = t_ba.reprojection_residuals(ba["t_state"], ba["t_problem"])
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-4,
                               rtol=0)


def test_per_observation_jacobians_match(ba):
    s, p = ba["j_state"], ba["j_problem"]

    @jax.jit
    def jac(q, t, X, uv):
        z6, z3 = jnp.zeros(6), jnp.zeros(3)

        def one(qq, tt, XX, u):
            Jc = jax.jacfwd(lambda d: j_ba._residual_one(
                d, z3, qq, tt, XX, u, p.K))(z6)
            Jp = jax.jacfwd(lambda d: j_ba._residual_one(
                z6, d, qq, tt, XX, u, p.K))(z3)
            return Jc, Jp
        return jax.vmap(one)(q, t, X, uv)

    Jc_j, Jp_j = jac(s.poses.r.q.data[p.cam_idx], s.poses.t[p.cam_idx],
                     s.points[p.pt_idx], p.uv)
    Jc_t, Jp_t = t_ba._jacobians(ba["t_state"], ba["t_problem"])
    assert torch.isfinite(Jc_t).all() and torch.isfinite(Jp_t).all()
    _rel_close(Jc_t, Jc_j, 1e-5)
    _rel_close(Jp_t, Jp_j, 1e-5)


def test_normal_equation_blocks_match(ba):
    blocks_t = t_ba._build_normal_eqs(ba["t_state"], ba["t_problem"],
                                      ba["C"], ba["P"],
                                      t_ba._robust_kernels(3.0)["huber"])
    for name, bj, bt in zip(("H_cc", "H_pp", "W", "b_c", "b_p", "cost", "r"),
                            ba["j_blocks"], blocks_t):
        assert bt.shape == bj.shape, name
        _rel_close(bt, bj, 1e-5)


@pytest.mark.parametrize("fix,lam", [(1, 1.0), (2, 1e-3)])
def test_schur_step_matches(ba, fix, lam):
    blocks = ba["j_blocks"][:5]
    dx_j = jax.jit(j_ba._schur_solve, static_argnums=(6,))(*blocks, lam, fix)
    dx_t = t_ba._schur_solve(*(torch.from_numpy(np.array(b))
                               for b in blocks), torch.tensor(lam), fix)
    for a, b in zip(dx_t, dx_j):
        _rel_close(a, b, 2e-3)


# --- the LM loop ------------------------------------------------------------

def _run_dense(ba, robust, fix, init_lambda=1e-3):
    sj, cj = j_ba.bundle_adjust(ba["j_state"], ba["j_problem"], ba["C"],
                                ba["P"], num_iters=NUM_ITERS, robust=robust,
                                fix_first_cam=fix, init_lambda=init_lambda)
    st, ct = t_ba.bundle_adjust(ba["t_state"], ba["t_problem"], ba["C"],
                                ba["P"], num_iters=NUM_ITERS, robust=robust,
                                fix_first_cam=fix, init_lambda=init_lambda)
    return sj, np.asarray(cj), st, ct.numpy()


@pytest.mark.parametrize("robust", ["huber", "cauchy", "geman_mcclure",
                                    "tukey", "none"])
def test_bundle_adjust_two_fixed_matches(ba, robust):
    sj, cj, st, ct = _run_dense(ba, robust, 2)
    np.testing.assert_allclose(ct, cj, rtol=1e-3)
    np.testing.assert_allclose(st.points.numpy(), np.asarray(sj.points),
                               atol=5e-4, rtol=0)
    np.testing.assert_allclose(st.poses.t.numpy(), np.asarray(sj.poses.t),
                               atol=5e-4, rtol=0)
    np.testing.assert_allclose(st.poses.r.q.data.numpy(),
                               np.asarray(sj.poses.r.q.data), atol=5e-5,
                               rtol=0)


def test_bundle_adjust_one_fixed_matches(ba):
    sj, cj, st, ct = _run_dense(ba, "huber", 1)
    np.testing.assert_allclose(ct[-1], cj[-1], rtol=1e-4)
    assert np.all(np.diff(ct) <= 0)
    r_j = jax.jit(j_ba.reprojection_residuals)(sj, ba["j_problem"])
    r_t = t_ba.reprojection_residuals(st, ba["t_problem"])
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-3,
                               rtol=0)
    assert float(r_t.pow(2).sum(-1).mean().sqrt()) < 0.6  # the noise floor


def test_non_spd_system_rejects_the_step(ba):
    """λ = -1e3 makes the damped reduced system indefinite: the Cholesky
    fails, the step is NaN and rejected, as the reference's NaN is, and
    nothing raises. λ then clamps to 1e-8 and LM goes on as in JAX."""
    S = torch.diag(torch.tensor([1.0, -1.0, 2.0]))
    assert torch.isnan(t_ba._cholesky_solve(S, torch.ones(3))).all()
    sj, cj, st, ct = _run_dense(ba, "huber", 2, init_lambda=-1e3)
    cost0 = float(t_ba._cost(ba["t_state"], ba["t_problem"],
                             t_ba._robust_kernels(3.0)["huber"]))
    assert ct[0] == pytest.approx(cost0, rel=1e-6)  # rejected: unchanged
    assert ct[-1] < 0.5 * ct[0]
    np.testing.assert_allclose(ct, cj, rtol=1e-3)


# --- sparse Schur -----------------------------------------------------------

def test_build_point_tables_match(ba):
    p = ba["j_problem"]
    valid = np.asarray(p.valid) & (np.arange(p.valid.shape[0]) % 3 != 0)
    for v, T in ((np.asarray(p.valid), 0), (valid, 0), (valid, 3)):
        oi_j, om_j = j_bas.build_point_tables(p.cam_idx, p.pt_idx, v,
                                              ba["P"], T)
        oi_t, om_t = t_bas.build_point_tables(np.asarray(p.cam_idx),
                                              np.asarray(p.pt_idx), v,
                                              ba["P"], T)
        np.testing.assert_array_equal(oi_t, oi_j)
        np.testing.assert_array_equal(om_t, om_j)


def _run_sparse(j_state, j_problem, C, P, **kw):
    oi, om = j_bas.build_point_tables(j_problem.cam_idx, j_problem.pt_idx,
                                      j_problem.valid, P)
    sj, cj = j_bas.bundle_adjust_sparse(j_state, j_problem, jnp.asarray(oi),
                                        jnp.asarray(om), C, P, **kw)
    ts, tp = _port(j_state, j_problem)
    st, ct = t_bas.bundle_adjust_sparse(ts, tp, torch.from_numpy(oi),
                                        torch.from_numpy(om), C, P, **kw)
    return sj, np.asarray(cj), st, ct.numpy(), tp


def _rms(state, problem):
    r = t_ba.reprojection_residuals(state, problem)
    return float(r.pow(2).sum(-1).mean().sqrt())


def test_bundle_adjust_sparse_matches(ba):
    C, P = ba["C"], ba["P"]
    sj, cj, st, ct, tp = _run_sparse(ba["j_state"], ba["j_problem"], C, P,
                                     num_iters=10)
    np.testing.assert_allclose(ct[-1], cj[-1], rtol=1e-4)
    _, cd = t_ba.bundle_adjust(ba["t_state"], ba["t_problem"], C, P,
                               num_iters=10)
    np.testing.assert_allclose(ct[-1], cd[-1].item(), rtol=1e-3)
    assert _rms(st, tp) < 0.35  # the noise floor for noise = 0.3


def test_bundle_adjust_sparse_padded_tracks_match(ba):
    p = ba["j_problem"]
    valid = p.valid & (jnp.arange(p.valid.shape[0]) % 3 != 0)
    p2 = dataclasses.replace(p, valid=valid)
    sj, cj, st, ct, tp = _run_sparse(ba["j_state"], p2, ba["C"], ba["P"],
                                     num_iters=10)
    np.testing.assert_allclose(ct[-1], cj[-1], rtol=1e-4)
    assert ct[-1] < ct[0]
    assert _rms(st, tp) < 0.5


def test_bundle_adjust_sparse_gnc_tukey_matches():
    s0, problem, C, P = _problem(1, noise=0.1)
    bad = j_ba.BAState(s0.poses, s0.points + 0.8 * jax.random.normal(
        jax.random.PRNGKey(5), s0.points.shape))
    sj, cj, st, ct, tp = _run_sparse(bad, problem, C, P, num_iters=16,
                                     robust="tukey", robust_delta=2.0,
                                     gnc_stages=4)
    np.testing.assert_allclose(ct[-1], cj[-1], rtol=1e-4)
    assert _rms(st, tp) < 0.3  # GNC reaches the noise floor


@pytest.mark.parametrize("drop_every", [0, 3])
def test_sparse_and_dense_reduced_systems_agree(ba, drop_every):
    """The per-point camera-pair assembly of bundle_adjust_sparse gives the
    dense path's Schur complement S and right-hand side, with full and with
    padded tracks (every third observation dropped)."""
    C, P = ba["C"], ba["P"]
    state, prob = ba["t_state"], ba["t_problem"]
    if drop_every:
        prob = dataclasses.replace(
            prob, valid=torch.arange(prob.valid.shape[0]) % drop_every != 0)
    oi, om = t_bas.build_point_tables(prob.cam_idx.numpy(),
                                      prob.pt_idx.numpy(),
                                      prob.valid.numpy(), P)
    wf = t_ba._robust_kernels(3.0)["huber"]
    lam = torch.tensor(1e-3)
    S_d, r_d, _ = t_ba._reduced_system(
        *t_ba._build_normal_eqs(state, prob, C, P, wf)[:5], lam, 1)
    S_s, r_s, _, _ = t_bas._sparse_system(
        state, lam, prob, torch.from_numpy(oi).long(), torch.from_numpy(om),
        C, P, wf, True)
    _rel_close(S_s, S_d, 1e-5)
    _rel_close(r_s, r_d, 1e-5)
