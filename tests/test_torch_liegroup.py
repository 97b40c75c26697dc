"""The port's rotation conversions and Lie groups (kornia_tpu_torch:
geometry.conversions, geometry.liegroup) against the JAX package on the
CPU, at rotation angles 0, 1e-5, 0.3 and π - 1e-3 (both small-angle
branches, a generic angle, and the log map's far end).

Tolerances: ATOL = 2e-6 absolute on rotations, quaternions and tangents
(float32 results of the same formulas; the two libraries' transcendental
functions and matrix products may round differently), ATOL_T = 1e-5 on
translations and transformed points (values up to about 4), 1e-5 on the
Markley average (an eigenvector). The forward-mode Jacobians of Se3.exp and
Se3.log at tangent zero are held to be finite and equal to
``jax.jacfwd``'s within ATOL (ATOL_T for the log of a composed pose).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import jacfwd

from kornia_tpu.geometry import conversions as jc
from kornia_tpu.geometry import liegroup as jl
from kornia_tpu_torch.geometry import conversions as tc
from kornia_tpu_torch.geometry import liegroup as tl
from tests.torch_op_parity import exact_jit
from tests.torch_threads import one_torch_thread  # noqa: F401

ANGLES = [0.0, 1e-5, 0.3, math.pi - 1e-3]
ATOL = 2e-6
ATOL_T = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(torch_val, jax_val, atol=ATOL):
    np.testing.assert_allclose(torch_val.detach().numpy(), np.asarray(jax_val),
                               atol=atol, rtol=0)


def _axis_angles(angle, n=4, seed=0):
    rng = np.random.default_rng(seed)
    axes = rng.standard_normal((n, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    return (axes * angle).astype(np.float32)


def _tangents6(angle, seed=1):
    rng = np.random.default_rng(seed)
    rho = rng.standard_normal((4, 3)).astype(np.float32)
    return np.concatenate([rho, _axis_angles(angle, seed=seed)], -1)


# Each test's JAX side is one function of its input arrays, compiled once
# (exact_jit: each op rounds as it does eagerly) for all four angles.

def _conversions(aa, q_raw, m):
    q = m.angle_axis_to_quaternion(aa)
    R = m.quaternion_to_rotation_matrix(q)
    return [q, m.quaternion_to_angle_axis(q), R,
            m.axis_angle_to_rotation_matrix(aa),
            m.rotation_matrix_to_quaternion(R),
            m.vector_to_skew_symmetric_matrix(aa),
            m.normalize_quaternion(q_raw)]


@pytest.mark.parametrize("angle", ANGLES)
def test_conversions_match(angle):
    aa = _axis_angles(angle)
    q_raw = np.random.default_rng(2).standard_normal((4, 4)).astype(
        np.float32)
    want = exact_jit(lambda a, r: _conversions(a, r, jc), aa, q_raw)
    got = _conversions(_t(aa), _t(q_raw), tc)
    for g, w in zip(got, want):
        _close(g, w)


def _quaternion_ops(a, b, lg):
    qa = lg.Quaternion.from_axis_angle(a)
    qb = lg.Quaternion.from_axis_angle(b)
    out = [f(qa, qb) for f in (
        lambda x, y: (x * y).data, lambda x, y: (x + y).data,
        lambda x, y: (x - y).data, lambda x, y: (-x).data,
        lambda x, y: x.conj().data, lambda x, y: x.inv().data,
        lambda x, y: x.norm(), lambda x, y: x.normalize().data,
        lambda x, y: x.matrix(), lambda x, y: x.slerp(y, 0.3).data,
        lambda x, y: x.vec, lambda x, y: x.real)]
    return out + [qa.to_axis_angle(), lg.Quaternion.average(qa.data).data,
                  lg.Quaternion.identity((2,)).data,
                  lg.Quaternion.from_matrix(qa.matrix()).data]


@pytest.mark.parametrize("angle", ANGLES)
def test_quaternion_ops_match(angle):
    a, b = _axis_angles(angle, seed=3), _axis_angles(0.7, seed=4)
    want = exact_jit(lambda x, y: _quaternion_ops(x, y, jl), a, b)
    got = _quaternion_ops(_t(a), _t(b), tl)
    for i, (g, w) in enumerate(zip(got, want)):
        # the Markley average is an eigenvector
        _close(g, w, 1e-5 if i == 13 else ATOL)


def _so3_ops(v, w, pts, lg):
    r, s = lg.So3.exp(v), lg.So3.exp(w)
    K = lg.So3.hat(v)
    return [r.q.data, r.log(), (r * s).q.data, r * pts, r.act(pts[:, 0]),
            r.inverse().q.data, r.matrix(), r.adjoint(), K, lg.So3.vee(K),
            lg.So3.from_matrix(r.matrix()).q.data]


@pytest.mark.parametrize("angle", ANGLES)
def test_so3_ops_match(angle):
    v = _axis_angles(angle)
    w = _axis_angles(0.4, seed=5)
    pts = np.random.default_rng(6).standard_normal((4, 7, 3)).astype(
        np.float32)
    want = exact_jit(lambda *a: _so3_ops(*a, jl), v, w, pts)
    for g, r in zip(_so3_ops(_t(v), _t(w), _t(pts), tl), want):
        _close(g, r)


def _se3_ops(v, w, pts, lg):
    T, U = lg.Se3.exp(v), lg.Se3.exp(w)
    TU = T * U
    H = lg.Se3.hat(v)
    M = lg.Se3.from_matrix(T.matrix())
    qt = lg.Se3.from_qt(T.r.q.data, T.t)
    # (value, tolerance): translations and points to ATOL_T
    return [(T.r.q.data, ATOL), (T.t, ATOL_T), (T.log(), ATOL_T),
            (TU.r.q.data, ATOL), (TU.t, ATOL_T), (T * pts, ATOL_T),
            (T.act(pts[:, 0]), ATOL_T), (T.inverse().t, ATOL_T),
            (T.matrix(), ATOL_T), (T.adjoint(), ATOL_T), (H, ATOL),
            (lg.Se3.vee(H), ATOL), (M.r.q.data, ATOL), (M.t, ATOL_T),
            (qt.r.q.data, ATOL), (lg.Se3.identity((3,)).matrix(), ATOL)]


@pytest.mark.parametrize("angle", ANGLES)
def test_se3_ops_match(angle):
    v = _tangents6(angle)
    w = _tangents6(0.5, seed=7)
    pts = np.random.default_rng(8).standard_normal((4, 5, 3)).astype(
        np.float32)
    want = exact_jit(lambda *a: [x for x, _ in _se3_ops(*a, jl)], v, w, pts)
    for (g, tol), r in zip(_se3_ops(_t(v), _t(w), _t(pts), tl), want):
        _close(g, r, tol)


def _so2_se2_ops(th, v, w, pts, lg):
    r = lg.So2.exp(th)
    T, U = lg.Se2.exp(v), lg.Se2.exp(w)
    return [(r.z, ATOL), (r.log(), ATOL), (r.matrix(), ATOL),
            ((r * r.inverse()).z, ATOL), (r * pts, ATOL),
            (r.act(pts[:, 0]), ATOL), (lg.So2.hat(th), ATOL),
            (lg.So2.vee(lg.So2.hat(th)), ATOL), (T.t, ATOL_T),
            (T.log(), ATOL_T), ((T * U).t, ATOL_T), (T * pts, ATOL_T),
            (T.inverse().t, ATOL_T), (T.matrix(), ATOL_T),
            (lg.Se2.identity((2,)).matrix(), ATOL)]


@pytest.mark.parametrize("angle", ANGLES)
def test_so2_se2_ops_match(angle):
    rng = np.random.default_rng(9)
    th = np.array([angle, -angle, 0.5 * angle], np.float32)
    v = np.concatenate([rng.standard_normal((3, 2)), th[:, None]],
                       -1).astype(np.float32)
    w = rng.standard_normal((3, 3)).astype(np.float32)
    pts = rng.standard_normal((3, 4, 2)).astype(np.float32)
    want = exact_jit(lambda *a: [x for x, _ in _so2_se2_ops(*a, jl)],
                     th, v, w, pts)
    for (g, tol), r in zip(_so2_se2_ops(_t(th), _t(v), _t(w), _t(pts), tl),
                           want):
        _close(g, r, tol)


def test_se3_jacobians_at_zero_match_jax():
    """jacfwd of Se3.exp and of Se3.log ∘ (exp(d) · T) at d = 0: the
    linearisation point of every optimiser."""
    T_np = _tangents6(0.3)[0]
    T_t = tl.Se3.exp(_t(T_np))
    z_j, z_t = jnp.zeros(6), torch.zeros(6)

    def exp_j(d):
        e = jl.Se3.exp(d)
        return jnp.concatenate([e.r.q.data, e.t])

    def exp_t(d):
        e = tl.Se3.exp(d)
        return torch.cat([e.r.q.data, e.t])

    # the three Jacobians of the reference in one program
    J_j, L_j, I_j = exact_jit(lambda z, T: (
        jax.jacfwd(exp_j)(z),
        jax.jacfwd(lambda d: (jl.Se3.exp(d) * jl.Se3.exp(T)).log())(z),
        jax.jacfwd(lambda d: jl.Se3.exp(d).log())(z)), z_j, T_np)
    J_t = jacfwd(exp_t)(z_t)
    assert torch.isfinite(J_t).all()
    _close(J_t, J_j)
    L_t = jacfwd(lambda d: (tl.Se3.exp(d) * T_t).log())(z_t)
    assert torch.isfinite(L_t).all()
    _close(L_t, L_j, ATOL_T)
    # the log map at the identity itself, the Taylor branch's Jacobian
    I_t = jacfwd(lambda d: tl.Se3.exp(d).log())(z_t)
    assert torch.isfinite(I_t).all()
    _close(I_t, I_j)
    torch.testing.assert_close(I_t, torch.eye(6), atol=ATOL, rtol=0)


def test_random_elements_are_valid():
    gen = torch.Generator().manual_seed(0)
    q = tl.Quaternion.random((16,), generator=gen)
    torch.testing.assert_close(q.norm(), torch.ones(16), atol=1e-6, rtol=0)
    T = tl.Se3.random((8,), generator=gen)
    R = T.r.matrix()
    torch.testing.assert_close(R @ R.transpose(-1, -2),
                               torch.eye(3).expand(8, 3, 3), atol=1e-5,
                               rtol=0)
