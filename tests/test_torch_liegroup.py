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


@pytest.mark.parametrize("angle", ANGLES)
def test_conversions_match(angle):
    aa = _axis_angles(angle)
    q_j = jc.angle_axis_to_quaternion(jnp.asarray(aa))
    q_t = tc.angle_axis_to_quaternion(_t(aa))
    _close(q_t, q_j)
    _close(tc.quaternion_to_angle_axis(q_t), jc.quaternion_to_angle_axis(q_j),)
    R_j = jc.quaternion_to_rotation_matrix(q_j)
    R_t = tc.quaternion_to_rotation_matrix(q_t)
    _close(R_t, R_j)
    _close(tc.axis_angle_to_rotation_matrix(_t(aa)),
           jc.axis_angle_to_rotation_matrix(jnp.asarray(aa)))
    _close(tc.rotation_matrix_to_quaternion(R_t),
           jc.rotation_matrix_to_quaternion(R_j))
    _close(tc.vector_to_skew_symmetric_matrix(_t(aa)),
           jc.vector_to_skew_symmetric_matrix(jnp.asarray(aa)))
    q_raw = np.random.default_rng(2).standard_normal((4, 4)).astype(
        np.float32)
    _close(tc.normalize_quaternion(_t(q_raw)),
           jc.normalize_quaternion(jnp.asarray(q_raw)))


@pytest.mark.parametrize("angle", ANGLES)
def test_quaternion_ops_match(angle):
    a, b = _axis_angles(angle, seed=3), _axis_angles(0.7, seed=4)
    qa_j = jl.Quaternion.from_axis_angle(jnp.asarray(a))
    qb_j = jl.Quaternion.from_axis_angle(jnp.asarray(b))
    qa_t = tl.Quaternion.from_axis_angle(_t(a))
    qb_t = tl.Quaternion.from_axis_angle(_t(b))
    for f in (lambda x, y: (x * y).data, lambda x, y: (x + y).data,
              lambda x, y: (x - y).data, lambda x, y: (-x).data,
              lambda x, y: x.conj().data, lambda x, y: x.inv().data,
              lambda x, y: x.norm(), lambda x, y: x.normalize().data,
              lambda x, y: x.matrix(), lambda x, y: x.slerp(y, 0.3).data,
              lambda x, y: x.vec, lambda x, y: x.real):
        _close(f(qa_t, qb_t), f(qa_j, qb_j))
    _close(qa_t.to_axis_angle(), qa_j.to_axis_angle())
    _close(tl.Quaternion.average(qa_t.data).data,
           jl.Quaternion.average(qa_j.data).data, 1e-5)
    _close(tl.Quaternion.identity((2,)).data,
           jl.Quaternion.identity((2,)).data)
    _close(tl.Quaternion.from_matrix(qa_t.matrix()).data,
           jl.Quaternion.from_matrix(qa_j.matrix()).data)


@pytest.mark.parametrize("angle", ANGLES)
def test_so3_ops_match(angle):
    v = _axis_angles(angle)
    w = _axis_angles(0.4, seed=5)
    pts = np.random.default_rng(6).standard_normal((4, 7, 3)).astype(
        np.float32)
    r_j, s_j = jl.So3.exp(jnp.asarray(v)), jl.So3.exp(jnp.asarray(w))
    r_t, s_t = tl.So3.exp(_t(v)), tl.So3.exp(_t(w))
    _close(r_t.q.data, r_j.q.data)
    _close(r_t.log(), r_j.log())
    _close((r_t * s_t).q.data, (r_j * s_j).q.data)
    _close(r_t * _t(pts), r_j * jnp.asarray(pts))
    _close(r_t.act(_t(pts[:, 0])), r_j.act(jnp.asarray(pts[:, 0])))
    _close(r_t.inverse().q.data, r_j.inverse().q.data)
    _close(r_t.matrix(), r_j.matrix())
    _close(r_t.adjoint(), r_j.adjoint())
    K_t, K_j = tl.So3.hat(_t(v)), jl.So3.hat(jnp.asarray(v))
    _close(K_t, K_j)
    _close(tl.So3.vee(K_t), jl.So3.vee(K_j))
    _close(tl.So3.from_matrix(r_t.matrix()).q.data,
           jl.So3.from_matrix(r_j.matrix()).q.data)


@pytest.mark.parametrize("angle", ANGLES)
def test_se3_ops_match(angle):
    v = _tangents6(angle)
    w = _tangents6(0.5, seed=7)
    pts = np.random.default_rng(8).standard_normal((4, 5, 3)).astype(
        np.float32)
    T_j, U_j = jl.Se3.exp(jnp.asarray(v)), jl.Se3.exp(jnp.asarray(w))
    T_t, U_t = tl.Se3.exp(_t(v)), tl.Se3.exp(_t(w))
    _close(T_t.r.q.data, T_j.r.q.data)
    _close(T_t.t, T_j.t, ATOL_T)
    _close(T_t.log(), T_j.log(), ATOL_T)
    TU_t, TU_j = T_t * U_t, T_j * U_j
    _close(TU_t.r.q.data, TU_j.r.q.data)
    _close(TU_t.t, TU_j.t, ATOL_T)
    _close(T_t * _t(pts), T_j * jnp.asarray(pts), ATOL_T)
    _close(T_t.act(_t(pts[:, 0])), T_j.act(jnp.asarray(pts[:, 0])), ATOL_T)
    _close(T_t.inverse().t, T_j.inverse().t, ATOL_T)
    _close(T_t.matrix(), T_j.matrix(), ATOL_T)
    _close(T_t.adjoint(), T_j.adjoint(), ATOL_T)
    H_t, H_j = tl.Se3.hat(_t(v)), jl.Se3.hat(jnp.asarray(v))
    _close(H_t, H_j)
    _close(tl.Se3.vee(H_t), jl.Se3.vee(H_j))
    M_t = tl.Se3.from_matrix(T_t.matrix())
    M_j = jl.Se3.from_matrix(T_j.matrix())
    _close(M_t.r.q.data, M_j.r.q.data)
    _close(M_t.t, M_j.t, ATOL_T)
    qt_t = tl.Se3.from_qt(T_t.r.q.data, T_t.t)
    qt_j = jl.Se3.from_qt(T_j.r.q.data, T_j.t)
    _close(qt_t.r.q.data, qt_j.r.q.data)
    _close(tl.Se3.identity((3,)).matrix(), jl.Se3.identity((3,)).matrix())


@pytest.mark.parametrize("angle", ANGLES)
def test_so2_se2_ops_match(angle):
    rng = np.random.default_rng(9)
    th = np.array([angle, -angle, 0.5 * angle], np.float32)
    v = np.concatenate([rng.standard_normal((3, 2)), th[:, None]],
                       -1).astype(np.float32)
    w = rng.standard_normal((3, 3)).astype(np.float32)
    pts = rng.standard_normal((3, 4, 2)).astype(np.float32)
    r_j, r_t = jl.So2.exp(jnp.asarray(th)), tl.So2.exp(_t(th))
    _close(r_t.z, r_j.z)
    _close(r_t.log(), r_j.log())
    _close(r_t.matrix(), r_j.matrix())
    _close((r_t * r_t.inverse()).z, (r_j * r_j.inverse()).z)
    _close(r_t * _t(pts), r_j * jnp.asarray(pts))
    _close(r_t.act(_t(pts[:, 0])), r_j.act(jnp.asarray(pts[:, 0])))
    _close(tl.So2.hat(_t(th)), jl.So2.hat(jnp.asarray(th)))
    _close(tl.So2.vee(tl.So2.hat(_t(th))), jl.So2.vee(jl.So2.hat(
        jnp.asarray(th))))
    T_j, U_j = jl.Se2.exp(jnp.asarray(v)), jl.Se2.exp(jnp.asarray(w))
    T_t, U_t = tl.Se2.exp(_t(v)), tl.Se2.exp(_t(w))
    _close(T_t.t, T_j.t, ATOL_T)
    _close(T_t.log(), T_j.log(), ATOL_T)
    _close((T_t * U_t).t, (T_j * U_j).t, ATOL_T)
    _close(T_t * _t(pts), T_j * jnp.asarray(pts), ATOL_T)
    _close(T_t.inverse().t, T_j.inverse().t, ATOL_T)
    _close(T_t.matrix(), T_j.matrix(), ATOL_T)
    _close(tl.Se2.identity((2,)).matrix(), jl.Se2.identity((2,)).matrix())


def test_se3_jacobians_at_zero_match_jax():
    """jacfwd of Se3.exp and of Se3.log ∘ (exp(d) · T) at d = 0: the
    linearisation point of every optimiser."""
    T_np = _tangents6(0.3)[0]
    T_j = jl.Se3.exp(jnp.asarray(T_np))
    T_t = tl.Se3.exp(_t(T_np))
    z_j, z_t = jnp.zeros(6), torch.zeros(6)

    def exp_j(d):
        e = jl.Se3.exp(d)
        return jnp.concatenate([e.r.q.data, e.t])

    def exp_t(d):
        e = tl.Se3.exp(d)
        return torch.cat([e.r.q.data, e.t])

    J_j = jax.jit(jax.jacfwd(exp_j))(z_j)
    J_t = jacfwd(exp_t)(z_t)
    assert torch.isfinite(J_t).all()
    _close(J_t, J_j)
    L_j = jax.jit(jax.jacfwd(lambda d: (jl.Se3.exp(d) * T_j).log()))(z_j)
    L_t = jacfwd(lambda d: (tl.Se3.exp(d) * T_t).log())(z_t)
    assert torch.isfinite(L_t).all()
    _close(L_t, L_j, ATOL_T)
    # the log map at the identity itself, the Taylor branch's Jacobian
    I_j = jax.jit(jax.jacfwd(lambda d: jl.Se3.exp(d).log()))(z_j)
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
