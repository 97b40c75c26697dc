"""Borders wider than the image, and degenerate inputs, in the port against
the JAX package on the CPU.

``jnp.pad`` reflects or wraps as often as it takes, so a reflect or
circular border wider than the image still reads inside it; the port pads
by index under the same rule (``ops/filters.py::pad_border``). The probe
sizes are the smallest that crossed the old limit: 7x7 and 11x11 kernels on
a 3x4 image, CLAHE's default 8x8 grid on sides of 8 px or less, ``PadTo``
to 10x12 from 3x4. The degenerate inputs: ``max_blur_pool2d`` on a 1 px
high image (an empty map) and ZCA on one sample (NaN).

Tolerances: 1e-5 absolute on [0, 1] images; 1e-6 relative for
``filter3d``'s unnormalised 125-tap sums (about 30); CLAHE (the integer-binned
LUTs, the reference's exact program) bit for bit; the empty and NaN
results equal in shape and value (NaN equal to NaN).
"""

import numpy as np
import pytest

import kornia_tpu.augmentation as JA
import kornia_tpu.ops.enhance as je
import kornia_tpu.ops.filters as jf
import kornia_tpu_torch.augmentation as TA
import kornia_tpu_torch.ops.enhance as te
import kornia_tpu_torch.ops.filters as tf
from tests.torch_op_parity import Case, batch_references, rand, run_case
from tests.torch_threads import one_torch_thread  # noqa: F401

SMALL = rand(1, 2, 3, 4, seed=20)
K7 = rand(1, 7, 7, seed=21)
K11 = rand(1, 11, 11, seed=22)
VOL = rand(1, 1, 2, 3, 4, seed=23)
K3D = rand(1, 5, 5, 5, seed=24)
FLAT = rand(1, 2, 1, 5, seed=25)
ONE = rand(1, 3, seed=26)
CLAHE_IMGS = {f"{h}x{w}": rand(1, 2, h, w, seed=27 + i)
              for i, (h, w) in enumerate([(8, 8), (8, 9), (1, 5)])}


def _pair(jax_fn, torch_fn, args, **kw):
    return Case("", args, jax_fn=jax_fn, torch_fn=torch_fn, **kw)


CASES = {
    "filter2d_reflect_7x7": _pair(
        lambda x, k: jf.filter2d(x, k, "reflect"),
        lambda x, k: tf.filter2d(x, k, "reflect"), (SMALL, K7)),
    "filter2d_circular_11x11": _pair(
        lambda x, k: jf.filter2d(x, k, "circular"),
        lambda x, k: tf.filter2d(x, k, "circular"), (SMALL, K11)),
    "laplacian_7": _pair(lambda x: jf.laplacian(x, 7),
                         lambda x: tf.laplacian(x, 7), (SMALL,)),
    "bilateral_blur_7x7": _pair(
        lambda x: jf.bilateral_blur(x, (7, 7), 0.1, (1.5, 1.5)),
        lambda x: tf.bilateral_blur(x, (7, 7), 0.1, (1.5, 1.5)), (SMALL,)),
    "median_blur_reflect_5x5": _pair(lambda x: jf.median_blur(x, (5, 5)),
                                     lambda x: tf.median_blur(x, (5, 5)),
                                     (SMALL,)),
    "filter3d_reflect_5x5x5": _pair(
        lambda v, k: jf.filter3d(v, k, "reflect"),
        lambda v, k: tf.filter3d(v, k, "reflect"), (VOL, K3D), atol=0,
        rtol=1e-6),
    "filter3d_circular_5x5x5": _pair(
        lambda v, k: jf.filter3d(v, k, "circular"),
        lambda v, k: tf.filter3d(v, k, "circular"), (VOL, K3D), atol=0,
        rtol=1e-6),
    **{f"pad_to_{mode}": _pair(
        lambda x, m=mode: JA.PadTo((10, 12), pad_mode=m)(x),
        lambda x, m=mode: TA.PadTo((10, 12), pad_mode=m)(x), (SMALL,))
       for mode in ("reflect", "circular", "replicate")},
    **{f"equalize_clahe_{hw}": _pair(je.equalize_clahe, te.equalize_clahe,
                                     (img,), atol=0, exact=True)
       for hw, img in CLAHE_IMGS.items()},
    **{f"random_clahe_{hw}": _pair(
        lambda x: JA.RandomCLAHE(p=1.0).apply(x, {}),
        lambda x: TA.RandomCLAHE(p=1.0).apply(x, {}), (img,), atol=0,
        exact=True)
       for hw, img in CLAHE_IMGS.items()},
    "max_blur_pool2d_one_row": _pair(jf.max_blur_pool2d, tf.max_blur_pool2d,
                                     (FLAT,), atol=0),
    "zca_mean_one_sample": _pair(je.zca_mean, te.zca_mean, (ONE,), atol=0),
    "zca_mean_one_sample_inverse": _pair(
        lambda x: je.zca_mean(x, return_inverse=True),
        lambda x: te.zca_mean(x, return_inverse=True), (ONE,), atol=0),
    "zca_mean_one_sample_biased": _pair(
        lambda x: je.zca_mean(x, unbiased=False),
        lambda x: te.zca_mean(x, unbiased=False), (ONE,), atol=1e-3,
        rtol=1e-6),
    "zca_whiten_one_sample": _pair(je.zca_whiten, te.zca_whiten, (ONE,),
                                   atol=0),
}


@pytest.fixture(scope="module")
def refs():
    return batch_references(CASES, None)


@pytest.mark.parametrize("name", list(CASES))
def test_wide_borders_and_degenerate_inputs_match_reference(name, refs):
    run_case(CASES[name], None, refs[name])


@pytest.mark.parametrize("mode", ["reflect", "circular", "replicate"])
def test_pad_border_follows_numpy(mode):
    """The index pad against numpy's own rule, on every axis at once and
    pads of many times the side."""
    import torch
    x = rand(2, 3, 1, 4)
    pads = ((0, 0), (2, 5), (3, 0), (9, 10))
    want = np.pad(x, pads, {"reflect": "reflect", "circular": "wrap",
                            "replicate": "edge"}[mode])
    got = tf.pad_border(torch.from_numpy(x), pads[1:], mode)
    np.testing.assert_array_equal(got.numpy(), want)
