"""Direct image registration of the port against the JAX package on the
CPU (``geometry/registration.py``), after ``tests/test_registration_vo.py``
at a smaller size: 32x32, 3 pyramid levels, 6 Adam steps a level.

The JAX registrator's parameters after each level are read by recording
its jitted level function; the port starts each level from the
reference's parameters of the level before (carried by
``convert.registration_state_from_numpy``) and must end it within 1e-4 of
the reference's (iterative: f32 rounding of the gradient through the warp
grows over the steps; the readings, 1e-7 to 1e-6, are in CHANGES.md).
The optimiser alone is held to ``optax.adam`` at 1e-7 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kornia_tpu.geometry import registration as jreg
from kornia_tpu.ops.warp import warp_perspective as jwarp
from kornia_tpu_torch.convert import registration_state_from_numpy
from kornia_tpu_torch.geometry import registration as treg
from kornia_tpu_torch.ops.warp import warp_perspective as twarp
from tests.torch_op_parity import check_close, rand
from tests.torch_threads import one_torch_thread  # noqa: F401

ITERS, LEVELS, LR = 6, 3, 1e-2
PARAM_ATOL = 1e-4


def _scene():
    """A smooth 32x32 image and its warp by a 5° rotation about the centre
    plus a 1.5 px shift (as the reference test's, at half the size)."""
    x = rand(1, 1, 32, 32, seed=0)
    for _ in range(4):
        x = (np.roll(x, 1, -1) + x + np.roll(x, -1, -1)) / 3
        x = (np.roll(x, 1, -2) + x + np.roll(x, -1, -2)) / 3
    a = np.deg2rad(5.0)
    c, s = np.cos(a), np.sin(a)
    cx = cy = 15.5
    M = np.array([[c, s, (1 - c) * cx - s * cy + 1.5],
                  [-s, c, s * cx + (1 - c) * cy], [0, 0, 1]], np.float32)
    dst = np.asarray(jwarp(jnp.asarray(x), jnp.asarray(M[None]), (32, 32)))
    return x.astype(np.float32), dst


SRC, DST = _scene()


@pytest.fixture(scope="module")
def jax_levels():
    """The reference's registration: its parameters after each level
    (coarsest first) and its final matrix, the level function's outputs
    recorded through jax.jit."""
    levels, real_jit = [], jax.jit

    def recording_jit(fn, *a, **k):
        jitted = real_jit(fn, *a, **k)

        def call(*args):
            out = jitted(*args)
            levels.append(np.asarray(out))
            return out
        return call

    reg = jreg.ImageRegistrator("homography", ITERS, LR, LEVELS)
    jax.jit = recording_jit
    try:
        M = np.asarray(reg.register(jnp.asarray(SRC), jnp.asarray(DST)))
    finally:
        jax.jit = real_jit
    assert [p.shape for p in levels] == [(8,)] * LEVELS
    return levels, M


def test_each_level_matches_reference(jax_levels):
    """Teacher-forced: each level from the reference's parameters."""
    levels, _ = jax_levels
    reg = treg.ImageRegistrator("homography", ITERS, LR, LEVELS)
    from kornia_tpu_torch.ops.pyramid import build_pyramid
    pyr_s = build_pyramid(torch.from_numpy(SRC), LEVELS)
    pyr_d = build_pyramid(torch.from_numpy(DST), LEVELS)
    start = np.zeros(8, np.float32)
    for i, lvl in enumerate(range(LEVELS - 1, -1, -1)):
        p0, _ = registration_state_from_numpy(start, 0, start, start, "cpu")
        got, state = reg.run_level(p0, pyr_s[lvl], pyr_d[lvl])
        check_close(got, levels[i], PARAM_ATOL, what=f"level {lvl}")
        assert int(state.count) == ITERS
        start = levels[i]


def test_register_matches_reference(jax_levels):
    """Untouched end to end, and the photometric error falls."""
    _, M_j = jax_levels
    reg = treg.ImageRegistrator("homography", ITERS, LR, LEVELS)
    src, dst = torch.from_numpy(SRC), torch.from_numpy(DST)
    M_t = reg.register(src, dst)
    check_close(M_t, M_j, 1e-3)
    warped = twarp(src, M_t, (32, 32))
    err = float((warped - dst).abs().mean())
    assert err < float((src - dst).abs().mean())


def test_adam_follows_optax():
    """From the same state, over seeded gradients: the updates and the
    state (count, mu, nu) of optax.adam."""
    rng = np.random.default_rng(1)
    grads = [rng.normal(0, s, 8).astype(np.float32)
             for s in (1e-1, 1e-3, 2.0, 1e-2, 5e-1)]
    params = rng.normal(0, 0.1, 8).astype(np.float32)
    opt = optax.adam(LR)
    js = opt.init(jnp.asarray(params))
    # two reference steps, then both libraries from that state
    for g in grads[:2]:
        _, js = opt.update(jnp.asarray(g), js, jnp.asarray(params))
    adam = js[0]
    _, ts = registration_state_from_numpy(params, np.asarray(adam.count),
                                          np.asarray(adam.mu),
                                          np.asarray(adam.nu), "cpu")
    for g in grads[2:]:
        uj, js = opt.update(jnp.asarray(g), js, jnp.asarray(params))
        ut, ts = treg.adam_update(torch.from_numpy(g), ts, LR)
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-7,
                                   atol=0)
    adam = js[0]
    assert int(ts.count) == int(adam.count)
    np.testing.assert_allclose(ts.mu.numpy(), np.asarray(adam.mu), rtol=1e-7)
    np.testing.assert_allclose(ts.nu.numpy(), np.asarray(adam.nu), rtol=1e-7)


@pytest.mark.parametrize("model", ["Homography", "Similarity"])
def test_models_match_reference(model):
    p = np.array([0.1, -0.05, 0.2, -0.3, 0.01, 0.02, 1e-3, -2e-3],
                 np.float32)[:getattr(jreg, model).n_params]
    want = np.asarray(getattr(jreg, model).matrix(jnp.asarray(p)))
    got = getattr(treg, model).matrix(torch.from_numpy(p))
    check_close(got, want, 1e-6)
    assert getattr(treg, model).init_params("cpu").shape == (
        getattr(jreg, model).n_params,)
    if model == "Similarity":  # rotation scaled by exp(log scale)
        np.testing.assert_allclose(float(torch.linalg.det(got[:2, :2])),
                                   np.exp(2 * p[1]), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        treg.BaseModel.matrix(torch.from_numpy(p))
