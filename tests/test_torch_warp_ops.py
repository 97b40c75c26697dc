"""Warps, resizes, crops and flips of the port, and the core grid, dtype
and linear-algebra helpers, against the JAX package
(``kornia_tpu/ops/warp.py``, ``kornia_tpu/core/{grid,dtype,linalg}.py``),
on the CPU.

Tolerances: 1e-5 absolute for samples of [0, 1] images; bit for bit for
nearest sampling, flips and integer crops; 1e-4 for the solves (the TPS
and perspective systems, the masked solves, eigenvalues); eigenvectors
compared up to sign. Gradients (``warp_affine``, antialiased ``resize``)
within 1e-4 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kornia_tpu.core.dtype as jd
import kornia_tpu.core.grid as jg
import kornia_tpu.core.linalg as jl
import kornia_tpu.ops.warp as jw
import kornia_tpu_torch.core.dtype as td
import kornia_tpu_torch.core.grid as tg
import kornia_tpu_torch.core.linalg as tl
import kornia_tpu_torch.ops.warp as tw
from tests.torch_op_parity import (Case, batch_references, check_close,
                                   check_grad, rand, run_case)
from tests.torch_threads import one_torch_thread  # noqa: F401

IMG = rand(2, 3, 12, 14)
GRID = rand(2, 5, 7, 2, lo=-1.3, hi=1.3, seed=1)
M23 = np.array([[[0.98, 0.05, 1.0], [-0.04, 1.01, -0.5]],
                [[1.1, -0.2, 2.0], [0.15, 0.9, 0.5]]], np.float32)
M33 = np.concatenate([M23, np.array([[[1e-3, -2e-3, 1.0]], [[0.0, 1e-3,
                                                               1.0]]],
                                    np.float32)], axis=1)
CENTER = np.array([[5.5, 6.0], [3.0, 4.0]], np.float32)
ANGLE = np.array([30.0, -45.0], np.float32)
SCALE = np.array([[1.2, 0.8], [0.9, 1.1]], np.float32)
SRC4 = np.array([[[1.0, 2.0], [10.0, 1.5], [11.0, 9.0], [2.0, 10.0]],
                 [[0.0, 0.0], [12.0, 1.0], [13.0, 11.0], [1.0, 10.0]]],
                np.float32)
DST4 = np.array([[[0.0, 0.0], [7.0, 0.0], [7.0, 5.0], [0.0, 5.0]]] * 2,
                np.float32)
CTRL_SRC = rand(2, 6, 2, lo=-0.9, hi=0.9, seed=2)
CTRL_DST = CTRL_SRC + rand(2, 6, 2, lo=-0.1, hi=0.1, seed=3)

CASES = {}
for mode in ("nearest", "bilinear", "bicubic"):
    for pad in ("zeros", "border", "reflection"):
        for ac in (False, True):
            # nearest with zeros or border padding is an exact gather; the
            # reflected coordinate differs in its last bits (remainder)
            exact = mode == "nearest" and pad != "reflection"
            CASES[f"grid_sample_{mode}_{pad}_{ac}"] = Case(
                "grid_sample", (IMG, GRID, mode, pad, ac),
                atol=0 if exact else 1e-5)
CASES.update({
    "remap_bicubic": Case("remap", (IMG, rand(12, 14, hi=13.0, seed=4),
                                    rand(12, 14, hi=11.0, seed=5), "bicubic",
                                    "reflection")),
    "resize_nearest_down": Case("resize", (IMG, (5, 9), "nearest"), atol=0),
    "resize_nearest_up": Case("resize", (IMG, (25, 31), "nearest"), atol=0),
    "resize_antialias_down": Case("resize", (IMG, (5, 6), "bilinear", None,
                                             "short", True)),
    "resize_antialias_one_axis": Case("resize", (IMG, (12, 5), "bilinear",
                                                 None, "short", True)),
    "resize_antialias_mixed": Case("resize", (IMG, (7, 20), "bilinear",
                                              None, "short", True)),
    "resize_antialias_bicubic": Case("resize", (IMG, (6, 7), "bicubic",
                                                None, "short", True)),
    "resize_antialias_up": Case("resize", (IMG, (20, 30), "bilinear", None,
                                           "short", True)),
    "resize_bicubic": Case("resize", (IMG, (9, 17), "bicubic")),
    "resize_bicubic_corners": Case("resize", (IMG, (9, 17), "bicubic",
                                              True)),
    "resize_area_side_long": Case("resize", (IMG, 8, "area", None, "long")),
    "resize_to_be_divisible": Case("resize_to_be_divisible", (IMG, 8)),
    "rescale_antialias": Case("rescale", (IMG, 0.5, "bilinear", True)),
    "rescale_pair": Case("rescale", (IMG, (1.5, 0.5))),
    "upscale_double": Case("upscale_double", (IMG,)),
    "warp_affine": Case("warp_affine", (IMG, M23, (10, 16))),
    "warp_affine_fill": Case("warp_affine", (IMG, M23, (12, 14), "bilinear",
                                             "zeros", True,
                                             np.array([0.1, 0.5, 0.9],
                                                      np.float32))),
    "warp_affine_bicubic_reflection": Case("warp_affine", (
        IMG, M23, (12, 14), "bicubic", "reflection", False)),
    "affine": Case("affine", (IMG, M23)),
    "rotate": Case("rotate", (IMG, ANGLE)),
    "rotate_center_nearest": Case("rotate", (IMG, np.float32(20.0), CENTER,
                                             "nearest", "border")),
    "translate": Case("translate", (IMG, np.array([[1.5, -2.0], [0.3, 0.7]],
                                                  np.float32))),
    "scale": Case("scale", (IMG, np.array([1.3, 0.7], np.float32))),
    "scale_center": Case("scale", (IMG, SCALE, CENTER)),
    "shear": Case("shear", (IMG, np.array([[0.1, -0.2], [0.3, 0.05]],
                                          np.float32))),
    "get_rotation_matrix2d": Case("get_rotation_matrix2d", (CENTER, ANGLE,
                                                           SCALE), atol=1e-6),
    "get_translation_matrix2d": Case("get_translation_matrix2d", (CENTER,),
                                     atol=0),
    "get_shear_matrix2d": Case("get_shear_matrix2d", (
        CENTER, np.array([0.1, -0.3], np.float32),
        np.array([0.2, 0.05], np.float32)), atol=1e-5),
    "get_shear_matrix2d_x_only": Case("get_shear_matrix2d", (
        CENTER, np.array([0.1, -0.3], np.float32)), atol=1e-5),
    "get_affine_matrix2d": Case("get_affine_matrix2d", (
        np.array([[1.0, 2.0], [-1.0, 0.5]], np.float32), CENTER, SCALE,
        ANGLE), atol=1e-5),
    "get_affine_matrix2d_shear": Case("get_affine_matrix2d", (
        np.array([[1.0, 2.0], [-1.0, 0.5]], np.float32), CENTER, SCALE,
        ANGLE, np.array([0.1, 0.2], np.float32),
        np.array([0.0, -0.1], np.float32)), atol=1e-4),
    "invert_affine_transform": Case("invert_affine_transform", (M23,),
                                    atol=1e-5),
    "get_perspective_transform": Case("get_perspective_transform",
                                      (SRC4, DST4), atol=1e-4),
    "normalize_homography": Case("normalize_homography", (M33, (12, 14),
                                                          (10, 16)),
                                 atol=1e-6),
    "denormalize_homography": Case("denormalize_homography",
                                   (M33, (12, 14), (10, 16)), atol=1e-4),
    "homography_warp": Case("homography_warp", (IMG, M33, (10, 12))),
    "homography_warp_pixel": Case("homography_warp", (
        IMG, M33, (10, 12), "bilinear", "zeros", False, False)),
    "warp_perspective_bicubic": Case("warp_perspective", (
        IMG, M33, (10, 12), "bicubic", "border")),
    "crop_and_resize": Case("crop_and_resize", (SRC4, (6, 8)),
                            jax_fn=lambda b, s: jw.crop_and_resize(
                                jnp.asarray(IMG), b, s),
                            torch_fn=lambda b, s: tw.crop_and_resize(
                                torch.from_numpy(IMG), b, s), atol=1e-4),
    # the destination box is a constant: the reference reads its size on
    # the host
    "crop_by_boxes": Case("", (IMG, SRC4), atol=1e-4,
                          jax_fn=lambda x, s: jw.crop_by_boxes(x, s, DST4),
                          torch_fn=lambda x, s: tw.crop_by_boxes(
                              x, s, torch.from_numpy(DST4))),
    "crop_by_indices": Case("crop_by_indices", (IMG, 2, 3, (5, 6)), atol=0),
    "center_crop": Case("center_crop", (IMG, (6, 9)), atol=0),
    "center_crop_larger": Case("center_crop", (IMG, (14, 16)), atol=1e-4),
    "crop_by_transform_mat": Case("crop_by_transform_mat", (
        IMG, M33[:1], (6, 8), "bilinear", "border")),
    "elastic_transform2d": Case("elastic_transform2d", (
        IMG, rand(2, 2, 12, 14, lo=-1.0, hi=1.0, seed=6))),
    "elastic_transform2d_small": Case("elastic_transform2d", (
        IMG, rand(2, 2, 12, 14, lo=-1.0, hi=1.0, seed=7), (7, 5),
        (2.0, 3.0), (0.5, 2.0), True, "bicubic", "border")),
    # kernel weights reach ~20: 1e-4 of the value, as for the other solves
    "get_tps_transform": Case("get_tps_transform", (CTRL_SRC, CTRL_DST),
                              atol=1e-4, rtol=1e-4),
    "warp_points_tps": Case("warp_points_tps", (
        rand(2, 9, 2, lo=-1.0, hi=1.0, seed=8), CTRL_DST,
        rand(2, 6, 2, seed=9), rand(2, 3, 2, seed=10)), atol=1e-5),
    "warp_image_tps": Case("", (IMG, CTRL_SRC, CTRL_DST),
                           jax_fn=lambda x, s, d: jw.warp_image_tps(
                               x, d, *jw.get_tps_transform(s, d)),
                           torch_fn=lambda x, s, d: tw.warp_image_tps(
                               x, d, *tw.get_tps_transform(s, d)),
                           atol=1e-4),
    "hflip": Case("hflip", (IMG,), atol=0),
    "vflip": Case("vflip", (IMG,), atol=0),
    "rot180": Case("rot180", (IMG,), atol=0),
})


@pytest.fixture(scope="module")
def refs():
    return batch_references(CASES, jw)


@pytest.mark.parametrize("name", list(CASES))
def test_warp_matches_reference(name, refs):
    run_case(CASES[name], tw, refs[name])


def test_homography_warper():
    want = jw.HomographyWarper(10, 12, "bicubic", "border")
    got = tw.HomographyWarper(10, 12, "bicubic", "border", device="cpu")
    H = M33 * np.float32(0.5) + np.eye(3, dtype=np.float32) * 0.5
    ref = jax.jit(want.__call__)(jnp.asarray(IMG), jnp.asarray(H))
    check_close(got(torch.from_numpy(IMG), torch.from_numpy(H)), ref, 1e-5)
    got.precompute_warp_grid(torch.from_numpy(H))
    check_close(got(torch.from_numpy(IMG)), ref, 1e-5)
    assert tw.BaseWarper(4, 5).height == jw.BaseWarper(4, 5).height == 4


GRADS = {
    "warp_affine": (
        lambda x: jw.warp_affine(x, jnp.asarray(M23), (10, 16)),
        lambda x: tw.warp_affine(x, torch.from_numpy(M23), (10, 16))),
    "resize_antialias": (
        lambda x: jw.resize(x, (5, 6), antialias=True),
        lambda x: tw.resize(x, (5, 6), antialias=True)),
}


@pytest.mark.parametrize("name", list(GRADS))
def test_warp_gradients(name):
    check_grad(*GRADS[name], IMG)


# -----------------------------------------------------------------------------
# core: grids, dtypes, linear algebra
# -----------------------------------------------------------------------------

SYM = rand(4, 3, 3, lo=-1.0, hi=1.0, seed=11)
SYM = SYM + np.swapaxes(SYM, -1, -2)
SQ4 = rand(3, 4, 4, lo=-1.0, hi=1.0, seed=12)
SQ4[1] = 0.0                     # a singular system
RHS = rand(3, 4, 2, seed=13)

CORE = {
    "create_meshgrid3d": Case("create_meshgrid3d", (3, 4, 5), atol=1e-6,
                              device=True),
    "create_meshgrid3d_pixels": Case("create_meshgrid3d", (3, 4, 5, False),
                                     atol=0, device=True),
    "normalize_pixel_coordinates3d": Case(
        "normalize_pixel_coordinates3d", (rand(2, 7, 3, hi=5.0), 3, 4, 6),
        atol=1e-6),
    "denormalize_pixel_coordinates3d": Case(
        "denormalize_pixel_coordinates3d",
        (rand(2, 7, 3, lo=-1.0, hi=1.0), 1, 4, 6), atol=1e-6),
    "safe_solve_with_mask": Case("safe_solve_with_mask", (RHS, SQ4),
                                 atol=1e-4),
    "safe_inverse_with_mask_2": Case("safe_inverse_with_mask",
                                     (SQ4[:, :2, :2],), atol=1e-4),
    "safe_inverse_with_mask_3": Case("safe_inverse_with_mask",
                                     (SQ4[:, :3, :3],), atol=1e-4),
    "safe_inverse_with_mask_4": Case("safe_inverse_with_mask", (SQ4,),
                                     atol=1e-4),
    "bf16_storage": Case("", (IMG,), jax_fn=lambda x: jd.bf16_storage(
        x).astype(jnp.float32), torch_fn=lambda x: td.bf16_storage(x).float(),
        atol=0),
}


def _core_mods(name):
    return (jg, tg) if "coordinates" in name or "meshgrid" in name else (
        jl, tl)


@pytest.fixture(scope="module")
def core_refs():
    refs = {}
    for jmod in (jg, jl):
        refs.update(batch_references({n: c for n, c in CORE.items()
                                      if _core_mods(n)[0] is jmod}, jmod))
    return refs


@pytest.mark.parametrize("name", list(CORE))
def test_core_matches_reference(name, core_refs):
    run_case(CORE[name], _core_mods(name)[1], core_refs[name])


def test_solve_dtype_is_float32():
    assert td.solve_dtype() is torch.float32
    assert jd.solve_dtype() == jnp.float32  # x64 is off in the tests


def _up_to_sign(got: np.ndarray, want: np.ndarray, atol: float):
    """Columns of eigenvector matrices (or vectors) equal up to sign."""
    sign = np.sign(np.sum(got * want, axis=-2 if got.ndim == want.ndim
                          and got.ndim > 2 else -1, keepdims=True))
    np.testing.assert_allclose(got * sign, want, atol=atol)


def test_eigh_smallest_and_symeig_3x3():
    v_t, vec_t = tl.eigh_smallest(torch.from_numpy(SYM))
    v_j, vec_j = jl.eigh_smallest(jnp.asarray(SYM))
    check_close(v_t, v_j, 1e-5)
    _up_to_sign(vec_t.numpy(), np.asarray(vec_j), 1e-4)
    w_t, V_t = tl.symeig_3x3(torch.from_numpy(SYM))
    w_j, V_j = jl.symeig_3x3(jnp.asarray(SYM))
    check_close(w_t, w_j, 1e-5)
    _up_to_sign(V_t.numpy(), np.asarray(V_j), 1e-4)
