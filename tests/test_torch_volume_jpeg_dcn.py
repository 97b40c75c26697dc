"""Volumetric warps, the differentiable JPEG codec and deformable
convolution of the port against the JAX package
(``kornia_tpu/ops/{warp3d,jpeg,deform_conv}.py``) on the CPU,
with the gradient legs of the JPEG codec, ``bilateral_blur`` and
``deform_conv2d``.

Tolerances: 1e-5 absolute for samples of [0, 1] volumes; bit for bit for
the integer crops; 1e-4 for the JPEG codec (its 0-255 planes round through
quantization), ``deform_conv2d`` and the 3-D solves (of the value, for
entries above 1); gradients within 1e-4 of the largest.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kornia_tpu.ops.deform_conv as jdc
import kornia_tpu.ops.filters as jf
import kornia_tpu.ops.jpeg as jj
import kornia_tpu.ops.warp3d as jw3
import kornia_tpu_torch.ops.deform_conv as tdc
import kornia_tpu_torch.ops.filters as tf
import kornia_tpu_torch.ops.jpeg as tj
import kornia_tpu_torch.ops.warp3d as tw3
from tests.torch_op_parity import (Case, batch_references, check_grad, rand,
                                   run_case)
from tests.torch_threads import one_torch_thread  # noqa: F401

VOL = rand(2, 2, 5, 6, 7)
GRID3 = rand(2, 3, 4, 5, 3, lo=-1.2, hi=1.2, seed=1)
M34 = np.array([[[0.98, 0.05, 0.02, 0.5], [-0.04, 1.01, 0.03, -0.3],
                 [0.01, -0.02, 0.97, 0.2]],
                [[1.05, 0.0, -0.05, -0.4], [0.02, 0.95, 0.0, 0.6],
                 [0.0, 0.04, 1.02, 0.1]]], np.float32)
M44 = np.concatenate([M34, np.array([[[1e-3, 0.0, 2e-3, 1.0]],
                                     [[0.0, -1e-3, 0.0, 1.0]]], np.float32)],
                     axis=1)
CENTER3 = np.array([[3.0, 2.5, 2.0], [1.0, 2.0, 3.0]], np.float32)
ANGLES3 = np.array([[10.0, 20.0, -15.0], [0.0, 35.0, 5.0]], np.float32)
BOX = np.array([[0, 0, 0], [5, 0, 0], [5, 4, 0], [0, 4, 0],
                [0, 0, 3], [5, 0, 3], [5, 4, 3], [0, 4, 3]], np.float32)
BOXES = np.stack([BOX * 0.8 + 0.3, BOX * 0.6 + 0.5])
BOXES_DST = np.stack([BOX * 0.5, BOX * 0.5])

CASES = {}
for mode in ("nearest", "bilinear"):
    for pad in ("zeros", "border"):
        for ac in (False, True):
            CASES[f"grid_sample3d_{mode}_{pad}_{ac}"] = Case(
                "grid_sample3d", (VOL, GRID3, mode, pad, ac),
                atol=0 if mode == "nearest" else 1e-5)
CASES.update({
    "warp_affine3d": Case("warp_affine3d", (VOL, M34, (4, 6, 5))),
    "warp_affine3d_half_pixel": Case("warp_affine3d", (
        VOL, M34, (5, 6, 7), "bilinear", "border", False)),
    "warp_perspective3d": Case("warp_perspective3d", (VOL, M44, (4, 5, 6))),
    "get_projective_transform": Case("get_projective_transform", (
        CENTER3, ANGLES3, np.array([[1.2], [0.8]], np.float32)), atol=1e-5),
    "get_projective_transform_aniso": Case("get_projective_transform", (
        CENTER3, ANGLES3, np.array([[1.2, 0.9, 1.0], [0.8, 1.0, 1.1]],
                                   np.float32)), atol=1e-5),
    "affine3d": Case("affine3d", (VOL, M34)),
    "rotate3d": Case("rotate3d", (VOL, np.array([10.0, 30.0], np.float32),
                                  np.float32(20.0), np.float32(-5.0))),
    "rotate3d_center_nearest": Case("rotate3d", (
        VOL, np.float32(15.0), np.float32(0.0), np.float32(25.0),
        CENTER3[:1], "nearest", "zeros", True), atol=1e-5),
    "crop_by_boxes3d": Case("crop_by_boxes3d", (VOL, BOXES, BOXES_DST,
                                                (3, 3, 3)), atol=1e-4),
    "crop_and_resize3d": Case("crop_and_resize3d", (VOL, BOXES, (3, 4, 4)),
                              atol=1e-4),
    "crop3d": Case("crop3d", (VOL, (1, 2, 3), (3, 3, 4)), atol=0),
    "center_crop3d": Case("center_crop3d", (VOL, (3, 4, 4)), atol=0),
    "crop_by_transform_mat3d": Case("crop_by_transform_mat3d", (
        VOL, M44, (3, 4, 4))),
    "warp_grid3d": Case("warp_grid3d", (rand(1, 3, 4, 5, 3, lo=-1.0,
                                             seed=2), M44), atol=1e-5),
    "homography_warp3d": Case("homography_warp3d", (VOL, M44, (4, 5, 6))),
    "homography_warp3d_pixels": Case("homography_warp3d", (
        VOL, M44, (4, 5, 6), "nearest", "border", True, False), atol=1e-5),
    "get_perspective_transform3d": Case("get_perspective_transform3d", (
        BOXES, BOXES_DST + rand(2, 8, 3, hi=0.1, seed=3)), atol=1e-4,
        rtol=1e-4),
    "get_shear_matrix3d": Case("get_shear_matrix3d", (
        CENTER3, 0.1, -0.2, 0.05, None, 0.3, -0.1), atol=1e-5),
    "get_affine_matrix3d": Case("get_affine_matrix3d", (
        np.array([[1.0, -2.0, 0.5], [0.0, 1.0, 2.0]], np.float32), CENTER3,
        np.array([[1.1], [0.9]], np.float32), ANGLES3), atol=1e-5),
    "get_affine_matrix3d_shear": Case("get_affine_matrix3d", (
        np.array([[1.0, -2.0, 0.5], [0.0, 1.0, 2.0]], np.float32), CENTER3,
        np.array([[1.1], [0.9]], np.float32), ANGLES3, 0.1, 0.0, -0.1),
        atol=1e-4),
})


@pytest.fixture(scope="module")
def refs():
    return batch_references(CASES, jw3)


@pytest.mark.parametrize("name", list(CASES))
def test_warp3d_matches_reference(name, refs):
    run_case(CASES[name], tw3, refs[name])


# -----------------------------------------------------------------------------
# differentiable JPEG
# -----------------------------------------------------------------------------

RGB = rand(2, 3, 32, 48, seed=4)
JPEG = {
    "quality_50": Case("jpeg_codec_differentiable",
                       (RGB, np.float32(50.0)), atol=1e-4),
    "quality_per_image": Case("jpeg_codec_differentiable", (
        RGB, np.array([10.0, 95.0], np.float32)), atol=1e-4),
    "padded_size": Case("jpeg_codec_differentiable", (
        rand(1, 3, 21, 30, seed=5), np.array([70.0], np.float32)),
        atol=1e-4),
}


@pytest.fixture(scope="module")
def jpeg_refs():
    return batch_references(JPEG, jj)


@pytest.mark.parametrize("name", list(JPEG))
def test_jpeg_matches_reference(name, jpeg_refs):
    run_case(JPEG[name], tj, jpeg_refs[name])


# -----------------------------------------------------------------------------
# deformable convolution
# -----------------------------------------------------------------------------

def _dcn_inputs(B, C_in, H, W, C_out, k, G, groups, seed, stride=1, pad=1,
                dil=1):
    Ho = (H + 2 * pad - dil * (k - 1) - 1) // stride + 1
    Wo = (W + 2 * pad - dil * (k - 1) - 1) // stride + 1
    x = rand(B, C_in, H, W, seed=seed)
    off = rand(B, 2 * G * k * k, Ho, Wo, lo=-2.5, hi=2.5, seed=seed + 1)
    w = rand(C_out, C_in // groups, k, k, lo=-0.5, hi=0.5, seed=seed + 2)
    return x, off, w, Ho, Wo


_X, _OFF, _W, _HO, _WO = _dcn_inputs(2, 8, 9, 11, 6, 3, 1, 1, 10)
_X2, _OFF2, _W2, _HO2, _WO2 = _dcn_inputs(1, 8, 10, 9, 4, 3, 2, 2, 20,
                                          stride=2, pad=2, dil=2)
DCN = {
    "dcn_v1": Case("deform_conv2d", (_X, _OFF, _W), {"padding": 1},
                   atol=1e-4),
    "dcn_v2_bias": Case("deform_conv2d", (_X, _OFF, _W), {
        "bias": rand(6, seed=30), "padding": (1, 1),
        "mask": rand(2, 9, _HO, _WO, seed=31)}, atol=1e-4),
    "dcn_groups_stride_dilation": Case("deform_conv2d", (_X2, _OFF2, _W2), {
        "stride": 2, "padding": 2, "dilation": (2, 2),
        "mask": rand(1, 18, _HO2, _WO2, seed=32)}, atol=1e-4),
}


@pytest.fixture(scope="module")
def dcn_refs():
    return batch_references(DCN, jdc)


@pytest.mark.parametrize("name", list(DCN))
def test_deform_conv2d_matches_reference(name, dcn_refs):
    run_case(DCN[name], tdc, dcn_refs[name])


GRADS = {
    "jpeg_codec_differentiable": (
        lambda x: jj.jpeg_codec_differentiable(x, jnp.float32(50.0)),
        lambda x: tj.jpeg_codec_differentiable(x, torch.tensor(50.0)),
        RGB),
    "bilateral_blur": (
        lambda x: jf.bilateral_blur(x, 5, 0.1, (1.5, 1.5)),
        lambda x: tf.bilateral_blur(x, 5, 0.1, (1.5, 1.5)),
        rand(2, 3, 16, 16, seed=6)),
    "deform_conv2d": (
        lambda x: jdc.deform_conv2d(x, jnp.asarray(_OFF), jnp.asarray(_W),
                                    padding=1),
        lambda x: tdc.deform_conv2d(x, torch.from_numpy(_OFF),
                                    torch.from_numpy(_W), padding=1),
        _X),
}


@pytest.mark.parametrize("name", list(GRADS))
def test_gradients_match_reference(name):
    jax_fn, torch_fn, x = GRADS[name]
    check_grad(jax_fn, torch_fn, x)


def test_deform_conv2d_offset_gradient():
    """The offsets' gradient too (ALIKED learns them)."""
    check_grad(lambda o: jdc.deform_conv2d(jnp.asarray(_X), o,
                                           jnp.asarray(_W), padding=1),
               lambda o: tdc.deform_conv2d(torch.from_numpy(_X), o,
                                           torch.from_numpy(_W), padding=1),
               _OFF)
