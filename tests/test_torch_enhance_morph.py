"""Intensity ops and morphology of the port against the JAX package
(``kornia_tpu/ops/{enhance,morphology}.py``) on the CPU.

Tolerances: 1e-5 absolute for maps of [0, 1] images; hue shifts on the
circle, 1e-4 rad (through RGB: 1e-5); bit for bit for the integer-valued
results (``equalize``, CLAHE's exact mode, ``posterize``, the thresholds,
flat morphology); 1e-4 for ZCA and the soft histograms (sums over many
terms). Gradients within 1e-4 of the largest.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kornia_tpu.ops.enhance as je
import kornia_tpu.ops.morphology as jm
import kornia_tpu_torch.ops.enhance as te
import kornia_tpu_torch.ops.morphology as tm
from tests.torch_op_parity import (Case, batch_references, check_close,
                                   check_grad, rand, run_case)
from tests.torch_threads import one_torch_thread  # noqa: F401

IMG = rand(2, 3, 16, 16)
# integer levels and saturated pixels: the LUTs' exact bins
LEVELS = (np.random.default_rng(1).integers(0, 256, (2, 3, 16, 16))
          / 255.0).astype(np.float32)
LEVELS[:, :, 0, :4] = 1.0
# one shape for every equalization case
NARROW = (0.3 + 0.2 * rand(2, 3, 16, 16, seed=2)).astype(np.float32)
VOL = rand(1, 2, 3, 8, 8, seed=3)
FACTOR = np.array([0.3, 1.4], np.float32)
HSV = np.concatenate([rand(2, 1, 8, 8, hi=2 * np.pi, seed=4),
                      rand(2, 2, 8, 8, seed=5)], axis=1)
SAMPLES = rand(6, 3, 4, 4, seed=6)
# well-conditioned covariances for ZCA: many more samples than dimensions
ZCA_X = rand(64, 3, 2, 2, seed=14)
ZCA_Y = rand(3, 40, 2, seed=15)

CASES = {
    "add_weighted": Case("add_weighted", (IMG, 0.3, LEVELS, 0.6, 0.05)),
    "adjust_brightness": Case("adjust_brightness", (IMG, 0.2)),
    "adjust_brightness_batch": Case("adjust_brightness",
                                    (IMG, FACTOR - 0.5, False)),
    "adjust_brightness_accumulative": Case("adjust_brightness_accumulative",
                                           (IMG, FACTOR)),
    "adjust_contrast": Case("adjust_contrast", (IMG, 1.1)),
    "adjust_contrast_with_mean_subtraction": Case(
        "adjust_contrast_with_mean_subtraction", (IMG, FACTOR)),
    "adjust_contrast_with_mean_subtraction_grey": Case(
        "adjust_contrast_with_mean_subtraction", (NARROW, 1.5)),
    "adjust_saturation": Case("adjust_saturation", (IMG, 1.3)),
    "adjust_saturation_with_gray_subtraction": Case(
        "adjust_saturation_with_gray_subtraction", (IMG, FACTOR)),
    "adjust_hue": Case("adjust_hue", (IMG, 0.3)),
    "adjust_hue_batch": Case("adjust_hue", (IMG, np.array([-2.5, 3.0],
                                                          np.float32))),
    "adjust_saturation_raw": Case("adjust_saturation_raw", (HSV, 1.7)),
    "adjust_hue_raw": Case("adjust_hue_raw", (HSV, -4.0), atol=1e-4,
                           circle=True),
    "adjust_gamma": Case("adjust_gamma", (IMG, 1.5)),
    "adjust_gamma_gain": Case("adjust_gamma", (IMG, FACTOR + 0.5, 0.8)),
    "adjust_sigmoid": Case("adjust_sigmoid", (IMG,)),
    "adjust_sigmoid_inv": Case("adjust_sigmoid", (IMG, 0.3, 5.0, True)),
    "adjust_log": Case("adjust_log", (IMG,)),
    "adjust_log_inv": Case("adjust_log", (IMG, 0.7, True, False)),
    "invert": Case("invert", (IMG,)),
    "solarize": Case("solarize", (IMG, 0.6), atol=0),
    "solarize_additions": Case("solarize", (IMG, FACTOR, FACTOR - 0.5)),
    # exact=True here and below: the jitted program's folding moves an
    # integer bin (EXACT_OPTIONS)
    "posterize_4": Case("posterize", (IMG, 4), atol=0, exact=True),
    "posterize_batch": Case("posterize", (LEVELS, np.array([1, 8])), atol=0),
    "posterize_0": Case("posterize", (LEVELS, 0), atol=0),
    "sharpness": Case("sharpness", (IMG, 0.7)),
    "sharpness_batch": Case("sharpness", (IMG, FACTOR * 3)),
    "equalize": Case("equalize", (IMG,), atol=0, exact=True),
    "equalize_levels": Case("equalize", (LEVELS,), atol=0),
    "equalize_narrow": Case("equalize", (NARROW,), atol=0),
    "equalize_constant": Case("equalize", (np.full((2, 3, 16, 16), 0.5,
                                                   np.float32),), atol=0),
    "equalize3d": Case("equalize3d", (VOL,), atol=0),
    "equalize_clahe": Case("equalize_clahe", (IMG,), atol=0, exact=True),
    # (3, 5) tiles of 6 x 4 pad 16 x 16 to 18 x 20
    "equalize_clahe_levels_grid": Case("equalize_clahe",
                                       (LEVELS, 2.0, (3, 5)), atol=0,
                                       exact=True),
    "equalize_clahe_narrow_no_clip": Case("equalize_clahe",
                                          (NARROW, 0.0, (3, 5)), atol=0,
                                          exact=True),
    "equalize_clahe_slow": Case("equalize_clahe", (IMG, 40.0, (8, 8), True)),
    "equalize_clahe_slow_grid": Case("equalize_clahe",
                                     (NARROW, 3.0, (3, 5), True)),
    "normalize": Case("normalize", (IMG, [0.4, 0.5, 0.6], [0.2, 0.3, 0.25])),
    "denormalize": Case("denormalize", (IMG, [0.4, 0.5, 0.6],
                                        [0.2, 0.3, 0.25])),
    "normalize_min_max": Case("normalize_min_max", (IMG,)),
    "normalize_min_max_range": Case("normalize_min_max", (IMG, -1.0, 2.0)),
    "histogram": Case("histogram", (rand(2, 50, seed=7),
                                    np.linspace(0, 1, 16, dtype=np.float32),
                                    np.float32(0.05)), atol=1e-4),
    "histogram2d": Case("histogram2d", (rand(2, 50, seed=7),
                                        rand(2, 50, seed=8),
                                        np.linspace(0, 1, 8,
                                                    dtype=np.float32),
                                        np.float32(0.1)), atol=1e-4),
    "image_histogram2d": Case("image_histogram2d", (IMG * 255,), atol=0),
    "image_histogram2d_pdf": Case("image_histogram2d", (IMG, 0.0, 1.0, 16,
                                                        None, None, True)),
    # sums up to 256: f32 rounding of the running sum, 1e-6 of the value
    "integral_tensor": Case("integral_tensor", (IMG,), rtol=1e-6),
    "integral_image": Case("integral_image", (IMG,), rtol=1e-6),
    "zca_mean": Case("zca_mean", (ZCA_X,), atol=1e-4, rtol=1e-4),
    "zca_mean_inverse": Case("zca_mean", (ZCA_Y, 1, False, 1e-3, True),
                             atol=1e-4, rtol=1e-4),
    "zca_whiten": Case("zca_whiten", (ZCA_X,), atol=1e-4, rtol=1e-4),
    "linear_transform": Case("linear_transform", (
        SAMPLES, rand(48, 48, seed=9), rand(48, seed=10))),
    "linear_transform_dim": Case("linear_transform", (
        SAMPLES, rand(96, 96, seed=11), rand(96, seed=12), 1), atol=1e-4),
    "shift_rgb": Case("shift_rgb", (IMG, FACTOR - 0.5, np.zeros(2,
                                                                np.float32),
                                    -FACTOR / 2)),
    "threshold_binary": Case("threshold_binary", (IMG, 0.4), atol=0),
    "otsu_threshold": Case("otsu_threshold", (LEVELS,), atol=0),
    "otsu_threshold_mask": Case("otsu_threshold", (IMG, 64, True), atol=0,
                                exact=True),
    "rescale_intensity": Case("rescale_intensity", (IMG, 2.5)),
}
for _t in je.ThresholdType:
    if _t != je.ThresholdType.THRESH_OTSU:
        CASES[f"threshold_{_t.name}"] = Case(
            "", (IMG * 255,), atol=0,
            jax_fn=lambda x, t=int(_t): je.threshold(x, 100.0, 200.0, t),
            torch_fn=lambda x, t=int(_t): te.threshold(
                x, 100.0, 200.0, te.ThresholdType(t)))


@pytest.fixture(scope="module")
def refs():
    return batch_references(CASES, je)


@pytest.mark.parametrize("name", list(CASES))
def test_enhance_matches_reference(name, refs):
    run_case(CASES[name], te, refs[name])


def test_threshold_refuses_otsu():
    with pytest.raises(ValueError):
        te.threshold(torch.from_numpy(IMG), 0.5, 1.0,
                     te.ThresholdType.THRESH_OTSU)


GRADS = {
    "equalize_clahe_slow": (
        lambda x: je.equalize_clahe(x, 40.0, (4, 4), True),
        lambda x: te.equalize_clahe(x, 40.0, (4, 4), True)),
    "adjust_hue": (lambda x: je.adjust_hue(x, 0.3),
                   lambda x: te.adjust_hue(x, 0.3)),
}


@pytest.mark.parametrize("name", list(GRADS))
def test_enhance_gradients(name):
    check_grad(*GRADS[name], IMG)


def test_clahe_slow_mode_carries_no_gradient():
    """Both libraries round the levels to integer bins in the
    differentiable mode, so the image's gradient is zero in each."""
    import jax
    g = jax.jit(jax.grad(lambda a: jnp.sum(je.equalize_clahe(
        a, 40.0, (4, 4), True))))(jnp.asarray(IMG))
    assert not np.asarray(g).any()
    x = torch.from_numpy(IMG).requires_grad_(True)
    assert not te.equalize_clahe(x, 40.0, (4, 4), True).requires_grad


# -----------------------------------------------------------------------------
# morphology
# -----------------------------------------------------------------------------

ONES = np.ones((3, 3), np.float32)
CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.float32)
SE = rand(3, 3, hi=0.2, seed=13)
ASYM = np.ones((2, 4), np.float32)
MORPH = {}


def _morph(op, kernel, atol, **kwargs):
    """A case of `op` with `kernel` as a constant of the JAX program, so
    that the reference can read it on the host and pick its flat route
    under jit as it does eagerly."""
    return Case(op, (IMG,), kwargs, atol=atol,
                jax_fn=lambda x, **kw: getattr(jm, op)(x, kernel, **kw),
                torch_fn=lambda x, **kw: getattr(tm, op)(
                    x, torch.from_numpy(kernel), **kw))


for _op in ("dilation", "erosion", "opening", "closing", "gradient",
            "top_hat", "bottom_hat"):
    MORPH[f"{_op}_flat"] = _morph(_op, ONES, 0)
    MORPH[f"{_op}_cross"] = _morph(_op, CROSS, 0)
    MORPH[f"{_op}_nonflat"] = _morph(_op, CROSS, 1e-6,
                                     structuring_element=SE)
for _op in ("dilation", "erosion"):
    MORPH[f"{_op}_asym_origin"] = _morph(_op, ASYM, 0, origin=(1, 3))
    MORPH[f"{_op}_constant_border"] = _morph(
        _op, CROSS, 0, border_type="constant", border_value=0.5)


@pytest.fixture(scope="module")
def morph_refs():
    return batch_references(MORPH, jm)


@pytest.mark.parametrize("name", list(MORPH))
def test_morphology_matches_reference(name, morph_refs):
    run_case(MORPH[name], tm, morph_refs[name])


def test_flat_route_reads_the_kernel_once():
    """A kernel tensor's values are read on the host once (and again only
    after it changes), not on every call."""
    k = torch.ones(3, 3)
    tm._ALL_ONES.pop(k, None)
    x = torch.from_numpy(IMG)
    tm.dilation(x, k)
    first = tm._ALL_ONES[k]
    tm.erosion(x, k)
    assert tm._ALL_ONES[k] is first and first[1]
    k[0, 0] = 0.0
    check_close(tm.dilation(x, k), jm.dilation(IMG, k.numpy()), 0)
    assert tm._ALL_ONES[k][1] is False
