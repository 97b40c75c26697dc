"""Parity of the port's dissolving diffusion model
(``kornia_tpu_torch/models/diffusion.py``) and ``RandomDissolving`` with
the JAX package.

The JAX model's parameters (drawn by its own init) cross through
``convert.diffusion_from_numpy``; the dissolve, its VAE latents and its
UNet's noise prediction are compared at 2 × 3 × 32 × 32 on three steps,
the JAX side in one program. Tolerances: 1e-4 for the latents and the
noise prediction (convolutions summed in other orders), 1e-5 for the
dissolved images in [0, 1]; the schedule to 1e-5 relative (a cumulative
product of 1000 float32 factors, associated in another order). Mirrors
tests/test_diffusion.py.
"""

import numpy as np
import pytest
import torch

import kornia_tpu_torch.augmentation as TA
from kornia_tpu_torch.convert import (aug_params_from_numpy,
                                      diffusion_from_numpy)
from kornia_tpu_torch.models.diffusion import (DDIMSchedule, DiffusionConfig,
                                               StableDiffusionDissolving)
from tests.torch_op_parity import (FAST_OPTIONS, check_close, exact_jit,
                                   rand)
from tests.torch_threads import one_torch_thread  # noqa: F401

X = rand(2, 3, 32, 32, seed=13)
STEPS = (0, 10, 49)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX model's parameters and, from one program, its dissolve,
    latents and noise prediction at each step and RandomDissolving's
    params and output."""
    import jax
    import jax.numpy as jnp
    from kornia_tpu.augmentation import RandomDissolving as JRD
    from kornia_tpu.models.diffusion import (
        StableDiffusionDissolving as JSD, _LATENT_SCALE)
    m = JSD()
    x0 = jnp.zeros((1, 32, 32, 3))
    one = jnp.asarray(1.0)
    m.params = jax.jit(m.model.init)(m._key, x0, jnp.asarray(1), one, one)
    aug = JRD(model=m, p=1.0)

    def program(x, steps):
        p = aug.generate_parameters(jax.random.PRNGKey(5), x.shape)
        # one compiled dissolve, mapped over the steps and the step that
        # RandomDissolving drew (its apply is the dissolve at that step)
        every = jax.lax.map(lambda s: m.dissolve(x, s),
                            jnp.concatenate([steps, p["step"][:1]]))
        out = {"dissolve": every[:-1], "aug": (p, every[-1])}
        nhwc = jnp.transpose(x, (0, 2, 3, 1)) * 2.0 - 1.0
        z = m.model.apply(m.params, nhwc,
                          method=lambda mdl, a: mdl.vae.encode(a))
        out["latent"] = jnp.transpose(z, (0, 3, 1, 2))
        t = jnp.mod(50 - m.schedule.timesteps[steps[1]], 1000)
        eps = m.model.apply(m.params, z * _LATENT_SCALE, t,
                            method=lambda mdl, a, b: mdl.unet(a, b))
        out["eps"] = jnp.transpose(eps, (0, 3, 1, 2))
        return out

    got = exact_jit(program, X, np.asarray(STEPS, np.int32), exact=False,
                    options=FAST_OPTIONS)
    params = jax.tree_util.tree_map(np.asarray, m.params)
    return params, jax.tree_util.tree_map(np.asarray, got)


@pytest.fixture(scope="module")
def port_model(jax_side):
    return diffusion_from_numpy(jax_side[0], device="cpu")


def test_ddim_schedule_matches_scaled_linear():
    s = DDIMSchedule(device="cpu")
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, 1000) ** 2
    np.testing.assert_allclose(s.alphas_cumprod.numpy(),
                               np.cumprod(1 - betas), rtol=1e-5)
    ts = s.timesteps.numpy()
    assert ts[0] == 981 and ts[-1] == 1  # descending, steps_offset = 1
    z = torch.ones(2, 4)
    x0 = s.predict_start_from_noise(torch.zeros_like(z), 100, z)
    np.testing.assert_allclose(
        x0.numpy(), 1.0 / np.sqrt(s.alphas_cumprod[100].item()), rtol=1e-5)


def test_schedule_matches_the_jax_tables():
    from kornia_tpu.models.diffusion import DDIMSchedule as JS
    j, t = JS(), DDIMSchedule(device="cpu")
    np.testing.assert_allclose(t.alphas_cumprod.numpy(),
                               np.asarray(j.alphas_cumprod), rtol=1e-5)
    np.testing.assert_array_equal(t.timesteps.numpy(),
                                  np.asarray(j.timesteps))


def test_configs_match_the_jax_package():
    from kornia_tpu.models.diffusion import DiffusionConfig as JC
    import dataclasses
    for ours, ref in ((DiffusionConfig(), JC()),
                      (DiffusionConfig.sd15_like(), JC.sd15_like())):
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("i", range(len(STEPS)))
def test_dissolve_matches_the_jax_model(i, jax_side, port_model):
    got = port_model.dissolve(torch.from_numpy(X), STEPS[i])
    check_close(got, jax_side[1]["dissolve"][i], 1e-5)
    # a step given as a tensor on the device: the same
    same = port_model.dissolve(torch.from_numpy(X), torch.tensor(STEPS[i]))
    assert torch.equal(same, got)


def test_latents_and_noise_prediction_match(jax_side, port_model):
    from kornia_tpu.models.diffusion import _LATENT_SCALE
    x = torch.from_numpy(X) * 2.0 - 1.0
    model = port_model.model
    z = model.vae.encode(x)
    check_close(z, jax_side[1]["latent"], 1e-4)
    t = torch.remainder(50 - port_model.schedule.timesteps[STEPS[1]], 1000)
    eps = model.unet(z * _LATENT_SCALE, t)
    scale = float(np.abs(jax_side[1]["eps"]).max())
    check_close(eps / scale, jax_side[1]["eps"] / scale, 1e-4)


def test_random_dissolving_replays_the_jax_params(jax_side, port_model):
    p_j, want = jax_side[1]["aug"]
    aug = TA.RandomDissolving(model=port_model, p=1.0)
    got = aug(torch.from_numpy(X), params=aug_params_from_numpy(p_j, "cpu"))
    check_close(got, want, 1e-5)
    prm = aug.generate_parameters(torch.Generator().manual_seed(0), X.shape)
    assert sorted(prm) == sorted(p_j)
    assert prm["step"].dtype == torch.int32 and prm["step"].shape == (2,)
    # same_on_batch by default: one gate for the batch; the step is drawn
    # per sample and the first taken, as in the JAX package
    assert bool((prm["apply_mask"] == prm["apply_mask"][0]).all())


def test_dissolve_range_and_step_conditioning(port_model):
    x = torch.from_numpy(X)
    y1, y2 = port_model.dissolve(x, 10), port_model.dissolve(x, 40)
    assert y1.shape == x.shape
    assert 0.0 <= y1.min() and y1.max() <= 1.0
    assert not torch.allclose(y1, y2)


def test_random_dissolving_gate_and_defaults(port_model):
    x = torch.from_numpy(X)
    out0 = TA.RandomDissolving(model=port_model, p=0.0)(x)
    assert torch.equal(out0, x)
    aug = TA.RandomDissolving(p=1.0)
    assert aug.step_range == (0, 49)
    steps = aug.generate_parameters(torch.Generator().manual_seed(0),
                                    (4096, 3, 8, 8))["step"]
    assert 0 <= steps.min() and steps.max() <= 49
    # the default model is built at first use, on the input's device
    out = aug(x, torch.Generator().manual_seed(0))
    assert isinstance(aug._dslv, StableDiffusionDissolving)
    assert aug._dslv.device == torch.device("cpu")
    assert out.shape == x.shape and bool(torch.isfinite(out).all())
