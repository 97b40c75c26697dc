"""Gradients through the port's blurs, losses and scale pyramid against
``jax.grad`` of the JAX package (its Pallas blurs in interpret mode, with
their custom VJPs), and Adam steps against optax.

On the CPU the blurs' autograd Functions run their plain forward and plain
adjoint; ``tests/test_torch_cuda.py`` runs the same Functions through the
CUDA kernels and compares them with the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kornia_tpu.losses import losses as j_losses
from kornia_tpu.ops import pallas_kernels as pk
from kornia_tpu.ops import pyramid as j_pyr
from kornia_tpu.ops.filters import get_gaussian_kernel1d as jax_gauss1d
from kornia_tpu_torch.losses import losses as t_losses
from kornia_tpu_torch.ops import kernels as K
from kornia_tpu_torch.ops import pyramid as t_pyr
from tests.torch_threads import one_torch_thread  # noqa: F401

BORDERS = ["reflect", "replicate", "circular", "constant"]
SIGMAS = [1.23, 1.55, 1.95]


def _leaf(a):
    return torch.tensor(np.asarray(a), requires_grad=True)


def _level_kernels():
    return [np.asarray(jax_gauss1d(2 * int(np.ceil(4 * s)) + 1, s))[0]
            for s in SIGMAS]


@pytest.mark.parametrize("border", BORDERS)
def test_fused_blur_grads_match_jax(border):
    """d/dx to 1e-5 and d/dtaps to 1e-3, as tests/test_pallas.py holds the
    JAX package's custom VJP; an even kernel along x checks the anchor."""
    rng = np.random.default_rng(10)
    x = rng.random((2, 3, 16, 20), dtype=np.float32)
    ky = np.asarray(jax_gauss1d(5, 1.0))[0]
    kx = rng.random(4, dtype=np.float32) / 2

    def loss(x, ky, kx):
        return (pk.fused_separable_blur2d(x, ky, kx, border,
                                          interpret=True) ** 2).sum()

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(x), jnp.asarray(ky), jnp.asarray(kx))
    tx, tky, tkx = _leaf(x), _leaf(ky), _leaf(kx)
    (K.fused_separable_blur2d(tx, tky, tkx, border) ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref[0]), atol=1e-5)
    np.testing.assert_allclose(tky.grad.numpy(), np.asarray(ref[1]),
                               atol=1e-3)
    np.testing.assert_allclose(tkx.grad.numpy(), np.asarray(ref[2]),
                               atol=1e-3)


def test_multi_level_blur_grad_matches_jax():
    """1e-4, as tests/test_multi_level_blur.py holds the JAX package's."""
    rng = np.random.default_rng(11)
    x = rng.random((1, 2, 32, 40), dtype=np.float32)
    kers = _level_kernels()

    def loss(x):
        out = pk.multi_level_blur(x, [jnp.asarray(k) for k in kers],
                                  [jnp.asarray(k) for k in kers],
                                  interpret=True)
        return (out * out).sum()

    ref = jax.jit(jax.grad(loss))(jnp.asarray(x))
    tx = _leaf(x)
    tk = [torch.tensor(k) for k in kers]
    out = K.multi_level_blur(tx, tk, tk)
    assert out.grad_fn is not None
    (out * out).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(ref), atol=1e-4)


def test_adjoints_are_transposes():
    """<blur(x), g> = <x, adjoint(g)> for both plain adjoints."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.random((1, 2, 24, 28), dtype=np.float32))
    k = torch.tensor(np.asarray(jax_gauss1d(7, 1.4))[0])
    for border in BORDERS:
        g = torch.from_numpy(rng.random((1, 2, 24, 28), dtype=np.float32))
        lhs = (K.fused_separable_blur2d_plain(x, k, k, border) * g).sum()
        rhs = (x * K.fused_separable_blur2d_adjoint(g, k, k, border)).sum()
        torch.testing.assert_close(lhs, rhs, rtol=1e-5, atol=0)
    kers = [torch.tensor(k) for k in _level_kernels()]
    g = torch.from_numpy(rng.random((3, 1, 2, 24, 28), dtype=np.float32))
    lhs = (K.multi_level_blur_plain(x, kers, kers) * g).sum()
    rhs = (x * K.multi_level_blur_adjoint(g, kers, kers)).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-5, atol=0)


def _images(seed, shape=(2, 3, 64, 64)):
    rng = np.random.default_rng(seed)
    target = rng.random(shape, dtype=np.float32)
    pred = (target + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return pred, target


def test_ssim_and_psnr_match_jax():
    """Values and gradients in both images at (2, 3, 64, 64): SSIM's map to
    1e-5, its gradients to 1e-6 (the mean over 24,576 pixels scales them
    to about 1e-5), PSNR to 1e-4 dB."""
    pred, target = _images(13)
    jp, jt = jnp.asarray(pred), jnp.asarray(target)
    tp, tt = _leaf(pred), _leaf(target)
    np.testing.assert_allclose(t_losses.ssim(tp, tt).detach().numpy(),
                               np.asarray(jax.jit(j_losses.ssim)(jp, jt)),
                               atol=1e-5)
    for name in ("ssim_loss", "psnr", "psnr_loss"):
        jfn, tfn = getattr(j_losses, name), getattr(t_losses, name)
        jval, (jgp, jgt) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
            jp, jt)
        tp.grad = tt.grad = None
        val = tfn(tp, tt)
        val.backward()
        atol = 1e-4 if name.startswith("psnr") else 1e-6
        np.testing.assert_allclose(val.item(), float(jval), atol=atol)
        np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgp),
                                   atol=1e-6, err_msg=name)
        np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jgt),
                                   atol=1e-6, err_msg=name)


def _dog_energy(octaves):
    return sum(((o[:, 1:] - o[:, :-1]) ** 2).sum() for o in octaves)


def test_scale_pyramid_grad_matches_jax():
    """Σ (DoG levels)² through ScalePyramid(3, 1.6, 32) at (2, 3, 64, 64):
    two octaves, each from one multi-level blur; 1e-5 relative to the
    largest gradient."""
    x = np.random.default_rng(14).random((2, 3, 64, 64), dtype=np.float32)
    ref = jax.jit(jax.grad(
        lambda v: _dog_energy(j_pyr.ScalePyramid(3, 1.6, 32)(v)[0])))(
            jnp.asarray(x))
    tx = _leaf(x)
    octaves = t_pyr.ScalePyramid(3, 1.6, 32)(tx)[0]
    assert len(octaves) == 2 and octaves[0].grad_fn is not None
    _dog_energy(octaves).backward()
    ref = np.asarray(ref)
    np.testing.assert_allclose(tx.grad.numpy(), ref,
                               atol=1e-5 * np.abs(ref).max())


def test_adam_steps_match_optax():
    """Three torch.optim.Adam steps (optax.adam's defaults) on the SSIM
    loss equal three optax.adam steps to 2e-5, 2e-3 of one step: where a
    pixel's gradient is near zero, Adam's m / sqrt(v) turns the last-digit
    differences of the two SSIM gradients into visible step differences."""
    pred, target = _images(15, (1, 3, 48, 48))
    lr = 1e-2
    params, jt = jnp.asarray(pred), jnp.asarray(target)
    opt = optax.adam(lr)
    state = opt.init(params)
    grad_fn = jax.jit(jax.grad(j_losses.ssim_loss))
    for _ in range(3):
        updates, state = opt.update(grad_fn(params, jt), state)
        params = optax.apply_updates(params, updates)
    tp, tt = _leaf(pred), torch.from_numpy(target)
    topt = torch.optim.Adam([tp], lr=lr)
    for _ in range(3):
        topt.zero_grad()
        t_losses.ssim_loss(tp, tt).backward()
        topt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(params),
                               atol=2e-5)


def test_build_pyramid_matches_jax():
    x = np.random.default_rng(16).random((1, 2, 40, 52), dtype=np.float32)
    ref = jax.jit(lambda v: j_pyr.build_pyramid(v, 3))(jnp.asarray(x))
    out = t_pyr.build_pyramid(torch.from_numpy(x), 3)
    assert [tuple(o.shape) for o in out] == [r.shape for r in ref]
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)
