"""Parity of the port's intensity augmentations
(``kornia_tpu_torch/augmentation/intensity.py``) with the JAX package.

Every class draws its parameters in JAX and replays them in the port, at
2 × 3 × 32 × 32 (one JAX program for the module, tests/torch_aug_parity).
Tolerances: 1e-5 for the [0, 1] intensity ops; 0 (bit for bit) for the
integer and selection ops (posterize, equalize, CLAHE's LUTs, channel
shuffle and dropout, erasing, salt and pepper, rain; the first three's
references from the program compiled with EXACT_OPTIONS, whose integer
bins XLA's rewriting would move); 1e-4 for JPEG (its
DCT works on the 0-255 scale, tests/test_torch_volume_jpeg_dcn.py's
limit). The port's own sampler is held by statistics. Mirrors the
intensity legs of tests/test_augmentation.py and
tests/test_normalize_minmax.py.
"""

import math

import numpy as np
import pytest
import torch

import kornia_tpu_torch.augmentation as TA
from tests.torch_aug_parity import (AugCase, check_case, check_layout,
                                    references)
from tests.torch_op_parity import check_close, exact_jit, rand
from tests.torch_threads import one_torch_thread  # noqa: F401

ARRAYS = {"img": rand(2, 3, 32, 32, seed=1)}

CASES = {
    "RandomBrightness": AugCase(lambda A: A.RandomBrightness(p=1.0)),
    "RandomContrast": AugCase(lambda A: A.RandomContrast()),
    "RandomSaturation": AugCase(lambda A: A.RandomSaturation(p=1.0)),
    "RandomHue": AugCase(lambda A: A.RandomHue(p=1.0)),
    "RandomGamma": AugCase(lambda A: A.RandomGamma(gain=(0.8, 1.2),
                                                   p=1.0)),
    "ColorJiggle": AugCase(lambda A: A.ColorJiggle(0.3, 0.3, 0.3, 0.1,
                                                   p=1.0)),
    "RandomGrayscale": AugCase(lambda A: A.RandomGrayscale(p=0.5)),
    "RandomGaussianBlur": AugCase(lambda A: A.RandomGaussianBlur(
        (5, 5), (0.5, 2.0), p=1.0)),
    "RandomGaussianNoise": AugCase(lambda A: A.RandomGaussianNoise(
        std=0.05, p=1.0)),
    "RandomMotionBlur": AugCase(lambda A: A.RandomMotionBlur(p=1.0)),
    "RandomBoxBlur": AugCase(lambda A: A.RandomBoxBlur((5, 5), p=1.0)),
    "RandomMedianBlur": AugCase(lambda A: A.RandomMedianBlur(p=1.0)),
    "RandomSolarize": AugCase(lambda A: A.RandomSolarize(p=1.0)),
    "RandomPosterize": AugCase(lambda A: A.RandomPosterize(p=1.0), atol=0,
                               exact=True),
    "RandomSharpness": AugCase(lambda A: A.RandomSharpness(p=1.0)),
    "RandomEqualize": AugCase(lambda A: A.RandomEqualize(p=1.0), atol=0,
                              exact=True),
    "RandomCLAHE": AugCase(lambda A: A.RandomCLAHE(p=1.0), atol=0, exact=True),
    "RandomAutoContrast": AugCase(lambda A: A.RandomAutoContrast(p=1.0)),
    "RandomInvert": AugCase(lambda A: A.RandomInvert()),
    "RandomChannelShuffle": AugCase(lambda A: A.RandomChannelShuffle(
        p=1.0), atol=0),
    "RandomChannelDropout": AugCase(lambda A: A.RandomChannelDropout(
        p=1.0), atol=0),
    "RandomErasing": AugCase(lambda A: A.RandomErasing(p=1.0), atol=0),
    "RandomSaltAndPepper": AugCase(lambda A: A.RandomSaltAndPepper(p=1.0),
                                   atol=0),
    "RandomRGBShift": AugCase(lambda A: A.RandomRGBShift(0.2, 0.2, 0.2,
                                                         p=1.0)),
    "RandomPlanckianJitter": AugCase(lambda A: A.RandomPlanckianJitter(
        p=1.0)),
    "RandomPlanckianJitter[CIED]": AugCase(lambda A: A.RandomPlanckianJitter(
        "CIED", p=1.0)),
    "RandomLinearIllumination": AugCase(lambda A: A.RandomLinearIllumination(
        p=1.0)),
    "RandomPlasmaBrightness": AugCase(lambda A: A.RandomPlasmaBrightness(
        p=1.0), host_draw=True),
    "RandomPlasmaShadow": AugCase(lambda A: A.RandomPlasmaShadow(p=1.0),
                                  host_draw=True),
    "RandomPlasmaContrast": AugCase(lambda A: A.RandomPlasmaContrast(
        p=1.0), host_draw=True),
    "RandomJPEG": AugCase(lambda A: A.RandomJPEG((30.0, 90.0), p=1.0),
                          atol=1e-4),
    "Normalize": AugCase(lambda A: A.Normalize([0.485, 0.456, 0.406],
                                               [0.229, 0.224, 0.225])),
    "Denormalize": AugCase(lambda A: A.Denormalize([0.5, 0.4, 0.3],
                                                   [0.2, 0.25, 0.3])),
    "RandomSnow": AugCase(lambda A: A.RandomSnow((0.3, 0.6), (1.5, 2.5))),
    "RandomRain": AugCase(lambda A: A.RandomRain((20, 40), (3, 8),
                                                 (-3, 3), p=1.0), atol=0),
    "RandomGaussianIllumination": AugCase(
        lambda A: A.RandomGaussianIllumination(p=1.0)),
    "RandomLinearCornerIllumination": AugCase(
        lambda A: A.RandomLinearCornerIllumination(p=1.0)),
}


@pytest.fixture(scope="module")
def refs():
    return references(CASES, ARRAYS)


@pytest.mark.parametrize("name", list(CASES))
def test_replays_the_jax_params(name, refs):
    check_case(name, CASES[name], refs, ARRAYS)


@pytest.mark.parametrize("name", list(CASES))
def test_params_have_the_jax_layout(name, refs):
    check_layout(name, CASES[name], refs, ARRAYS)


def test_every_exported_class_has_a_case():
    import kornia_tpu.augmentation.intensity as J
    from kornia_tpu_torch.augmentation import intensity as T
    assert sorted(T.__all__) == sorted(J.__all__)
    aliases = {"ColorJitter", "RandomClahe", "RandomSaltAndPepperNoise"}
    # RandomDissolving's legs are in tests/test_torch_diffusion.py
    left = set(J.__all__) - aliases - {"RandomDissolving"} - {
        n.split("[")[0] for n in CASES}
    assert not left, left
    assert T.ColorJitter is T.ColorJiggle and T.RandomClahe is T.RandomCLAHE
    assert T.RandomSaltAndPepperNoise is T.RandomSaltAndPepper


# -- the port's own sampler ---------------------------------------------------

def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("p", [0.2, 0.5, 0.8])
def test_applied_share_is_p(p):
    B = 4096
    params = TA.RandomInvert(p=p).generate_parameters(_gen(), (B, 3, 4, 4))
    share = params["apply_mask"].float().mean().item()
    assert abs(share - p) <= 4 * math.sqrt(p * (1 - p) / B), share


def test_p_batch_gates_the_whole_batch():
    shares = [TA.RandomInvert(p=1.0, p_batch=0.5).generate_parameters(
        _gen(s), (64, 3, 4, 4))["apply_mask"].float().mean().item()
        for s in range(40)]
    assert set(shares) == {0.0, 1.0}
    assert 8 <= sum(shares) <= 32


def test_uniform_draws_cover_the_range():
    aug = TA.ColorJiggle(0.4, (0.5, 1.5), 0.3, 0.2, p=1.0)
    prm = aug.generate_parameters(_gen(), (4096, 3, 4, 4))
    for key, (lo, hi) in (("brightness", (0.6, 1.4)),
                          ("contrast", (0.5, 1.5)),
                          ("saturation", (0.7, 1.3)), ("hue", (-0.2, 0.2))):
        v = prm[key]
        assert lo <= v.min().item() and v.max().item() < hi
        assert abs(v.mean().item() - (lo + hi) / 2) <= \
            4 * (hi - lo) / math.sqrt(12 * 4096)


def test_same_on_batch_shares_one_draw():
    prm = TA.RandomBrightness(p=0.5, same_on_batch=True).generate_parameters(
        _gen(), (16, 3, 4, 4))
    assert torch.all(prm["factor"] == prm["factor"][0])
    assert len(set(prm["apply_mask"].tolist())) == 1
    perm = TA.RandomChannelShuffle(same_on_batch=True).generate_parameters(
        _gen(), (16, 3, 4, 4))["perm"]
    assert torch.all(perm == perm[0])


def test_integer_draws_and_permutations():
    g = _gen()
    bits = TA.RandomPosterize((2, 5)).generate_parameters(
        g, (4096, 3, 4, 4))["bits"]
    assert set(bits.tolist()) == {2, 3, 4, 5}
    perm = TA.RandomChannelShuffle().generate_parameters(
        g, (256, 5, 4, 4))["perm"]
    assert torch.all(torch.sort(perm, -1).values == torch.arange(5))
    drop = TA.RandomChannelDropout(2).generate_parameters(
        g, (256, 5, 4, 4))["drop"]
    assert torch.all(drop.sum(-1) == 2)


def test_generator_call_is_seeded_and_replayable():
    x = torch.from_numpy(ARRAYS["img"])
    aug = TA.ColorJiggle(p=0.5)
    a = aug(x, _gen(3))
    assert torch.equal(a, aug(x, _gen(3)))
    assert torch.equal(aug(x), aug(x, _gen(0)))  # the default: seed 0
    prm = aug.generate_parameters(_gen(5), x.shape)
    assert torch.equal(aug(x, params=prm), aug(x, params=prm))


def test_p_zero_is_the_identity():
    x = torch.from_numpy(ARRAYS["img"])
    out = TA.RandomBrightness((0.2, 0.4), p=0.0)(x, _gen())
    assert torch.equal(out, x)


def test_normalize_matches_its_formula():
    x = torch.from_numpy(ARRAYS["img"])
    out = TA.Normalize([0.5, 0.5, 0.5], [0.5, 0.5, 0.5])(x)
    torch.testing.assert_close(out, (x - 0.5) / 0.5, atol=1e-5, rtol=0)


# -- tests/test_normalize_minmax.py's legs, against the JAX package -------------

def _minmax_inputs():
    rng = np.random.default_rng(0)
    wide = np.stack([rng.uniform(0.4, 0.6, (8, 8)),
                     rng.uniform(0.0, 0.05, (8, 8)),
                     rng.uniform(-3.0, 7.0, (8, 8))]).astype(np.float32)[None]
    return wide, np.random.default_rng(1).uniform(
        0, 1, (2, 3, 6, 6)).astype(np.float32)


@pytest.mark.parametrize("kw", [{}, {"min_val": -1.0, "max_val": 1.0}])
def test_normalize_min_max_per_channel(kw):
    from kornia_tpu.ops.enhance import normalize_min_max as jfn
    from kornia_tpu_torch.ops.enhance import normalize_min_max as tfn
    for x in _minmax_inputs():
        want = np.asarray(exact_jit(lambda a: jfn(a, **kw), x))
        got = tfn(torch.from_numpy(x), **kw)
        check_close(got, want, 1e-5)
        lo, hi = kw.get("min_val", 0.0), kw.get("max_val", 1.0)
        flat = got.reshape(*got.shape[:2], -1)
        assert torch.all((flat.amin(-1) - lo).abs() < 1e-4)
        assert torch.all((flat.amax(-1) - hi).abs() < 1e-4)
    # batch items are normalised independently
    x = torch.from_numpy(_minmax_inputs()[1])
    torch.testing.assert_close(tfn(x[:1], **kw), tfn(x, **kw)[:1],
                               atol=1e-6, rtol=0)


def test_autocontrast_clip_flag():
    x = torch.from_numpy(ARRAYS["img"])
    prm = {"apply_mask": torch.ones(2, dtype=torch.bool)}
    clipped = TA.RandomAutoContrast(p=1.0)(x, params=prm)
    assert clipped.min() >= 0.0 and clipped.max() <= 1.0
    raw = TA.RandomAutoContrast(p=1.0, clip_output=False)(x, params=prm)
    torch.testing.assert_close(raw.clamp(0, 1), clipped, atol=1e-6, rtol=0)


def test_normalize_min_max_gradient():
    from kornia_tpu.ops.enhance import normalize_min_max as jfn
    from kornia_tpu_torch.ops.enhance import normalize_min_max as tfn
    from tests.torch_op_parity import check_grad
    x = (np.linspace(0, 1, 48, dtype=np.float32).reshape(1, 3, 4, 4) ** 2)
    check_grad(jfn, tfn, x)


def test_constant_tables_first_used_in_inference_mode_serve_a_backward():
    """Tables a class keeps per device are built outside inference mode,
    and the ops build theirs anew each call: a first call under
    `torch.inference_mode()` leaves nothing that a later backward cannot
    save."""
    from kornia_tpu_torch.ops.color import rgb_to_grayscale, rgb_to_xyz
    from kornia_tpu_torch.ops.enhance import sharpness
    from kornia_tpu_torch.ops.jpeg import jpeg_codec_differentiable
    from kornia_tpu_torch.ops.warp import warp_affine
    x = torch.rand(2, 3, 16, 16, generator=_gen())
    M = torch.tensor([[[0.9, 0.1, 1.0], [-0.1, 0.9, 0.5]]]).repeat(2, 1, 1)
    q = torch.tensor([60.0, 80.0])
    augs = [TA.Normalize((0.5, 0.4, 0.3), (0.2, 0.3, 0.4)),
            TA.RandomPlanckianJitter(p=1.0), TA.AutoAugment("cifar10")]

    def run(img, mat):
        outs = [rgb_to_grayscale(img), rgb_to_xyz(img), sharpness(img, 0.5),
                jpeg_codec_differentiable(img, q),
                warp_affine(img, mat, (16, 16))]
        return outs + [aug(img, _gen()) for aug in augs]

    with torch.inference_mode():
        run(x, M)
    xg, Mg = x.clone().requires_grad_(), M.clone().requires_grad_()
    sum(o.sum() for o in run(xg, Mg)).backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().sum() > 0
    assert torch.isfinite(Mg.grad).all() and Mg.grad.abs().sum() > 0


def test_constant_tables_handed_out_are_the_callers_own():
    """A matrix or params entry built from constants is new on each call,
    so a caller's write to it reaches no later call."""
    from kornia_tpu_torch.ops.warp import normal_transform_pixel
    first = normal_transform_pixel(9, 9)
    first[0, 0, 0] = 99.0
    assert normal_transform_pixel(9, 9)[0, 0, 0] == 0.25
    aug = TA.RandomPerspective(p=1.0)
    src = aug.generate_parameters(_gen(), (2, 3, 9, 9))["src"]
    src[0, 0, 0] = 99.0
    assert aug.generate_parameters(_gen(), (2, 3, 9, 9))["src"][0, 0, 0] == 0
    norm = TA.Normalize((0.5, 0.4, 0.3), (0.2, 0.3, 0.4))
    x = torch.rand(2, 3, 4, 4, generator=_gen())
    norm(x)[:] = 7.0
    torch.testing.assert_close(norm(x)[:, 0], (x[:, 0] - 0.5) / 0.2,
                               atol=1e-6, rtol=0)


def test_class_tables_follow_their_host_values():
    """A class's per-device copy of a table follows its host values: a
    caller may set ``Normalize.mean`` between calls."""
    x = torch.rand(2, 3, 4, 4, generator=_gen())
    norm = TA.Normalize((0.5, 0.4, 0.3), (0.2, 0.3, 0.4))
    norm(x)
    norm.mean = (0.1, 0.2, 0.3)
    torch.testing.assert_close(norm(x)[:, 0], (x[:, 0] - 0.1) / 0.2,
                               atol=1e-6, rtol=0)
