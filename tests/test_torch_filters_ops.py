"""2-D and 3-D filters and the pyramid ops of the port against the JAX
package (``kornia_tpu/ops/{filters,pyramid}.py``) on the CPU.

Tolerances: 1e-5 absolute for filters of [0, 1] images (the separable
blurs run the fused blur's plain version here, a dense band product, where
the JAX package convolves: sums in another order); 1e-4 for ``fft_conv``
(FFT rounding); kernel getters 1e-6; Canny's edges bit for bit and its
magnitude 1e-5.
"""

import jax
import pytest
import torch

import kornia_tpu.ops.filters as jf
import kornia_tpu.ops.pyramid as jp
import kornia_tpu_torch.ops.filters as tf
import kornia_tpu_torch.ops.pyramid as tp
from tests.torch_op_parity import (Case, batch_references, check_close,
                                   rand, run_case)
from tests.torch_threads import one_torch_thread  # noqa: F401

IMG = rand(2, 3, 16, 16)
GRAY = rand(2, 1, 16, 16, seed=1)
VOL = rand(1, 2, 5, 6, 7, seed=2)
K35 = rand(1, 3, 5, lo=-1.0, hi=1.0, seed=3)
K3D = rand(1, 3, 3, 3, seed=4)

_GETTERS = {
    "get_gaussian_erf_kernel1d": (5, 1.2),
    "get_gaussian_kernel3d": (3, 1.0),
    "get_gaussian_kernel3d_t": ((3, 5, 3), (1.0, 1.5, 0.8)),
    "get_gaussian_kernel1d_t": (7, 1.5),
    "get_gaussian_kernel2d_t": ((5, 3), (1.2, 0.7)),
    "get_laplacian_kernel1d": (5,),
    "get_laplacian_kernel2d": (3,),
    "get_hanning_kernel1d": (7,),
    "get_hanning_kernel2d": ((5, 7),),
    "get_pascal_kernel_1d": (5,),
    "get_pascal_kernel_2d": (3,),
    "gaussian": (7, 1.5),
    "laplacian_1d": (5,),
    "get_binary_kernel2d": ((2, 3),),
    "get_diff_kernel3d": (),
    "get_diff_kernel3d_2nd_order": (),
}
CASES = {f"{name}{args}": Case(name, args, atol=1e-6, device=True)
         for name, args in _GETTERS.items()}
CASES.update({
    "get_pascal_kernel_1d_norm": Case("get_pascal_kernel_1d", (4, True),
                                      atol=1e-6, device=True),
    "gaussian_even": Case("gaussian", (6, 1.5), atol=1e-6, device=True),
    "gaussian_mean": Case("gaussian", (7, 1.5, 2.0), atol=1e-6, device=True),
    "spatial_gradient_kernel2d_sobel_1": Case(
        "get_spatial_gradient_kernel2d", ("sobel", 1), atol=0, device=True),
    "spatial_gradient_kernel2d_sobel_2": Case(
        "get_spatial_gradient_kernel2d", ("sobel", 2), atol=0, device=True),
    "spatial_gradient_kernel2d_diff_2": Case(
        "get_spatial_gradient_kernel2d", ("diff", 2), atol=0, device=True),
    "spatial_gradient_kernel3d": Case("get_spatial_gradient_kernel3d",
                                      ("diff", 2), atol=0, device=True),
    "get_motion_kernel3d_bilinear": Case(
        "get_motion_kernel3d", (5, [[10.0, 0.0, 40.0], [0.0, 25.0, 0.0]],
                                -0.3, "bilinear"), device=True),
    "filter3d_replicate": Case("filter3d", (VOL, K3D)),
    "filter3d_reflect_normalized": Case("filter3d", (VOL, K3D, "reflect",
                                                     True)),
    "filter3d_constant": Case("filter3d", (VOL, K3D, "constant")),
    "filter3d_circular": Case("filter3d", (VOL, K3D, "circular")),
    "correlate3d": Case("correlate3d", (VOL, K3D)),
    "convolve3d": Case("convolve3d", (VOL, K3D, "reflect")),
    "motion_blur3d": Case("motion_blur3d", (VOL, 3, [15.0, 30.0, 45.0])),
    "spatial_gradient3d": Case("spatial_gradient3d", (VOL,)),
    "fft_conv2d": Case("fft_conv2d", (IMG, K35), atol=1e-4),
    "fft_conv2d_reflect": Case("fft_conv2d", (IMG, K35, "reflect"),
                               atol=1e-4),
    "fft_conv": Case("fft_conv", (IMG, K35), atol=1e-4),
    "fft_conv_valid_conv": Case("fft_conv", (IMG, K35, "replicate", True,
                                             "valid", "conv"), atol=1e-4),
    "correlate2d": Case("correlate2d", (IMG, K35)),
    "convolve2d": Case("convolve2d", (IMG, K35, "replicate")),
    "median_blur_3": Case("median_blur", (IMG, 3), atol=0),
    "median_blur_even_reflect": Case("median_blur", (IMG, (4, 2), "reflect"),
                                     atol=0),
    "unsharp_mask": Case("unsharp_mask", (IMG, 5, 1.5)),
    "bilateral_blur_l1": Case("bilateral_blur", (IMG, 5, 0.1, (1.5, 1.5))),
    "bilateral_blur_l2": Case("bilateral_blur", (IMG, (3, 5), 0.2, 1.0,
                                                 "replicate", "l2")),
    "joint_bilateral_blur": Case("joint_bilateral_blur",
                                 (IMG, rand(2, 3, 16, 16, seed=5), 3, 0.1,
                                  1.2)),
    "guided_blur": Case("guided_blur", (GRAY, IMG, 5, 0.01)),
    "guided_blur_rgb_guide": Case("guided_blur", (IMG, IMG, (3, 5), 0.1,
                                                  "replicate")),
    "blur_pool2d": Case("blur_pool2d", (IMG,)),
    "blur_pool2d_k4_s1": Case("blur_pool2d", (IMG, 4, 1)),
    "max_blur_pool2d": Case("max_blur_pool2d", (IMG,)),
    "max_blur_pool2d_ceil": Case("max_blur_pool2d", (IMG, 5, 3, 3, True)),
    "edge_aware_blur_pool2d": Case("edge_aware_blur_pool2d", (IMG,)),
    "edge_aware_blur_pool2d_even": Case("edge_aware_blur_pool2d",
                                        (IMG, 5, 0.8, 4)),
    "in_range": Case("in_range", (IMG, [0.2, 0.1, 0.0], [0.9, 0.8, 0.7]),
                     atol=0),
    "in_range_mask": Case("in_range", (IMG, [0.2, 0.1, 0.0],
                                       [0.9, 0.8, 0.7], True), atol=0),
    "sobel": Case("sobel", (IMG,)),
    "sobel_raw": Case("sobel", (IMG, False)),
    "laplacian": Case("laplacian", (IMG, 5)),
    "laplacian_unnormalized": Case("laplacian", (IMG, 3, "replicate",
                                                 False)),
    "gaussian_blur2d_t": Case("gaussian_blur2d_t", (IMG, 5, (1.5, 1.0))),
    "pyrup": Case("pyrup", (IMG,), jax_fn=jp.pyrup, torch_fn=tp.pyrup),
    "pyrup_corners": Case("pyrup", (IMG, "replicate", True),
                          jax_fn=jp.pyrup, torch_fn=tp.pyrup),
    "build_laplacian_pyramid": Case(
        "build_laplacian_pyramid", (rand(2, 3, 32, 24), 3),
        jax_fn=jp.build_laplacian_pyramid,
        torch_fn=tp.build_laplacian_pyramid),
})


@pytest.fixture(scope="module")
def refs():
    return batch_references(CASES, jf)


@pytest.mark.parametrize("name", list(CASES))
def test_filter_matches_reference(name, refs):
    run_case(CASES[name], tf, refs[name])


CANNY_KW = [{}, {"low_threshold": 0.05, "high_threshold": 0.3},
            {"hysteresis": False}, {"kernel_size": 3, "sigma": 0.8}]
CANNY_X = rand(2, 3, 32, 32, seed=11)


@pytest.fixture(scope="module")
def canny_refs():
    """The reference's four canny calls in one jitted program."""
    return jax.jit(lambda x: [jf.canny(x, **kw) for kw in CANNY_KW])(
        CANNY_X)


@pytest.mark.parametrize("kwargs", CANNY_KW)
def test_canny_matches_reference(kwargs, canny_refs):
    mag_j, edges_j = canny_refs[CANNY_KW.index(kwargs)]
    mag_t, edges_t = tf.canny(torch.from_numpy(CANNY_X), **kwargs)
    check_close(mag_t, mag_j, 1e-5)
    check_close(edges_t, edges_j, 0)


def test_canny_checks_convergence_every_k_steps():
    """The hysteresis runs CANNY_CHECK_EVERY steps between two tests of
    convergence: at least one test, each after k steps."""
    tf.canny_counts.clear()
    tf.canny(torch.from_numpy(rand(1, 1, 32, 32, seed=12)))
    c = tf.canny_counts
    assert c["calls"] == 1 and c["syncs"] >= 1
    assert c["steps"] == c["syncs"] * tf.CANNY_CHECK_EVERY
