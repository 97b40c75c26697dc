"""The port's two-view front end (kornia_tpu_torch: filters, warp, pyramid,
subpix, detector, orientation, SIFT, matching) against the JAX package on
the CPU, stage by stage.

Each stage of the port is fed the JAX stage's inputs, so that a difference
shows where it arises. The JAX side runs its CPU paths, which have the
semantics of its Pallas kernels (tests/test_pallas*.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.feature import integrated as j_int
from kornia_tpu.feature import laf as j_laf
from kornia_tpu.feature import matching as j_match
from kornia_tpu.geometry import subpix as j_subpix
from kornia_tpu.ops import filters as j_filters
from kornia_tpu.ops import pyramid as j_pyr
from kornia_tpu.ops import warp as j_warp
from kornia_tpu_torch.feature import integrated as t_int
from kornia_tpu_torch.feature import laf as t_laf
from kornia_tpu_torch.feature import matching as t_match
from kornia_tpu_torch.feature.orientation import \
    patch_dominant_gradient_orientation
from kornia_tpu_torch.geometry import subpix as t_subpix
from kornia_tpu_torch.ops import filters as t_filters
from kornia_tpu_torch.ops import pyramid as t_pyr
from kornia_tpu_torch.ops import warp as t_warp
from tests.torch_op_parity import EXACT_OPTIONS
from tests.torch_threads import one_torch_thread  # noqa: F401

NF = 96


def _t(a):
    return torch.from_numpy(np.array(a))


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.random((h, w)), 1.0).astype(np.float32)[None,
                                                                       None]


@pytest.fixture(scope="module")
def stages():
    """One image through the JAX SIFT front end, stage by stage."""
    x = _image(0, 96, 112)
    feat = j_int.SIFTFeature(num_features=NF)

    @jax.jit  # one compile instead of one per eager op
    def run(xj):
        pyr = j_pyr.ScalePyramid(3, 1.6, 32)(xj)
        lafs_d, resp_d, valid_d = feat.detector(xj)
        lafs_o = feat.orienter(lafs_d, xj)
        patches = j_laf.extract_patches_from_pyramid(xj, lafs_o, 41)
        descs = feat.descriptor(xj, lafs_o)
        return dict(pyr=pyr, lafs_d=lafs_d, resp_d=resp_d, valid_d=valid_d,
                    lafs_o=lafs_o, patches=patches, descs=descs)

    out = jax.tree_util.tree_map(np.asarray, run(jnp.asarray(x)))
    return dict(x=x, **out)


@pytest.fixture(scope="module")
def small_refs():
    """The references of the small stage tests, from one jitted program
    (one compile in the place of one an eager op), compiled with XLA's
    rewriting and fusion passes off (EXACT_OPTIONS), so that each op
    rounds as it does eagerly."""
    xg = _image(1, 21, 19)
    xb = np.random.default_rng(2).random((1, 2, 33, 40)).astype(np.float32)
    xr = _image(3, 60, 80)
    xw = _image(4, 40, 50)
    M = np.eye(3, dtype=np.float32)
    M[0, 2] = -4.0
    M[1, 0] = 0.01
    vol = np.random.default_rng(5).standard_normal(
        (1, 1, 6, 17, 19)).astype(np.float32)
    rng = np.random.default_rng(7)
    d1 = rng.random((64, 128)).astype(np.float32)
    d2 = np.concatenate([d1[:40] + 0.02 * rng.standard_normal((40, 128)),
                         rng.random((24, 128))]).astype(np.float32)
    d2 = d2[rng.permutation(64)]
    m1 = rng.random(64) > 0.1
    m2 = rng.random(64) > 0.1

    def run(xg, xb, xr, xw, M, vol, d1, d2, m1, m2):
        return dict(
            kernels=[j_filters.get_gaussian_kernel1d(k, s)
                     for k, s in [(15, 1.52), (5, 1.0), (9, 2.3)]]
            + [j_filters.get_gaussian_discrete_kernel1d(5, 1.6),
               j_filters.get_gaussian_kernel2d((41, 41), (29.0, 29.0))],
            gradient={m: j_filters.spatial_gradient(xg, m)
                      for m in ("sobel", "diff")},
            blur={b: j_filters.gaussian_blur2d(xb, 7, 1.4, b)
                  for b in ("reflect", "replicate", "circular", "constant")},
            resize=j_warp.resize(xr, (30, 40)), pyrdown=j_pyr.pyrdown(xr),
            warp=j_warp.warp_perspective(xw, M[None], (40, 50)),
            nms3d=j_subpix.nms3d(vol), nms2d=j_subpix.nms2d(vol[:, 0]),
            quad=j_subpix.quad_fit3d_planes(vol),
            smnn=j_match.DescriptorMatcher("smnn", 0.95)(d1, d2, m1, m2))

    args = tuple(map(jnp.asarray, (xg, xb, xr, xw, M, vol, d1, d2, m1,
                                   m2)))
    out = jax.tree_util.tree_map(np.asarray, jax.jit(run).lower(
        *args).compile(compiler_options=EXACT_OPTIONS)(*args))
    return dict(out, inputs=dict(xg=xg, xb=xb, xr=xr, xw=xw, M=M, vol=vol,
                                 d1=d1, d2=d2, m1=m1, m2=m2))


def test_gaussian_kernels_match_reference(small_refs):
    kers = small_refs["kernels"]
    for (k, s), ref in zip([(15, 1.52), (5, 1.0), (9, 2.3)], kers):
        np.testing.assert_allclose(
            t_filters.get_gaussian_kernel1d(k, s).numpy(), ref, atol=1e-7)
    np.testing.assert_allclose(
        t_filters.get_gaussian_discrete_kernel1d(5, 1.6).numpy(), kers[3],
        atol=1e-7)
    np.testing.assert_allclose(
        t_filters.get_gaussian_kernel2d((41, 41), (29.0, 29.0)).numpy(),
        kers[4], atol=1e-7)


@pytest.mark.parametrize("mode", ["sobel", "diff"])
def test_spatial_gradient_matches_reference(mode, small_refs):
    x = small_refs["inputs"]["xg"]
    out = t_filters.spatial_gradient(_t(x), mode)
    np.testing.assert_allclose(out.numpy(), small_refs["gradient"][mode],
                               atol=1e-6)


@pytest.mark.parametrize("border", ["reflect", "replicate", "circular",
                                    "constant"])
def test_gaussian_blur_matches_reference(border, small_refs):
    """The port's banded blur (plain version here) against the reference's
    two-pass convolution on the CPU: sums in another order."""
    x = small_refs["inputs"]["xb"]
    out = t_filters.gaussian_blur2d(_t(x), 7, 1.4, border)
    np.testing.assert_allclose(out.numpy(), small_refs["blur"][border],
                               atol=1e-6)


def test_resize_and_pyrdown_match_reference(small_refs):
    x = small_refs["inputs"]["xr"]
    np.testing.assert_allclose(t_warp.resize(_t(x), (30, 40)).numpy(),
                               small_refs["resize"], atol=1e-6)
    np.testing.assert_allclose(t_pyr.pyrdown(_t(x)).numpy(),
                               small_refs["pyrdown"], atol=1e-6)


def test_warp_perspective_matches_reference(small_refs):
    x, M = small_refs["inputs"]["xw"], small_refs["inputs"]["M"]
    out = t_warp.warp_perspective(_t(x), _t(M[None]), (40, 50))
    np.testing.assert_allclose(out.numpy(), small_refs["warp"], atol=1e-5)


def test_nms_and_quadratic_fit_match_reference(small_refs):
    vol = small_refs["inputs"]["vol"]
    np.testing.assert_array_equal(t_subpix.nms3d(_t(vol)).numpy(),
                                  small_refs["nms3d"])
    np.testing.assert_array_equal(t_subpix.nms2d(_t(vol[:, 0])).numpy(),
                                  small_refs["nms2d"])
    for o, r in zip(t_subpix.quad_fit3d_planes(_t(vol)), small_refs["quad"]):
        np.testing.assert_allclose(o.numpy(), r, atol=1e-5)


def test_scale_pyramid_levels(stages):
    octs, sigs, dists = t_pyr.ScalePyramid(3, 1.6, 32)(_t(stages["x"]))
    j_octs, j_sigs, j_dists = stages["pyr"]
    assert len(octs) == len(j_octs)
    for o, r in zip(octs, j_octs):
        # every octave in one multi-level blur (cumulative operators) vs
        # the reference's sequential chain: 2e-6, as the reference's own
        # tests/test_multi_level_blur.py holds the two
        np.testing.assert_allclose(o.numpy(), r, atol=2e-6)
    for a, b in zip(sigs + dists, j_sigs + j_dists):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6)


def test_detector_top_k(stages):
    det = t_int.SIFTFeature(num_features=NF).detector
    lafs, resp, valid = det(_t(stages["x"]))
    np.testing.assert_array_equal(valid.numpy(), stages["valid_d"])
    v = stages["valid_d"]
    assert v.sum() >= 10
    np.testing.assert_allclose(resp.numpy()[v], stages["resp_d"][v],
                               atol=1e-6)
    # centres and scales of the padded top-K, valid entries only
    np.testing.assert_allclose(lafs.numpy()[v], stages["lafs_d"][v],
                               atol=1e-3)


def test_patches_from_pyramid(stages):
    out = t_laf.extract_patches_from_pyramid(
        _t(stages["x"]), _t(stages["lafs_o"]), 41)
    # the reference's CPU path unnormalises through grid_sample's [-1, 1]
    # coordinates; the port samples pixel coordinates directly
    np.testing.assert_allclose(out.numpy(), stages["patches"], atol=1e-5)


def test_orientation(stages):
    orienter = t_int.SIFTFeature(num_features=NF).orienter
    lafs = orienter(_t(stages["lafs_d"]), _t(stages["x"]))
    v = stages["valid_d"]
    ang = t_laf.get_laf_orientation(lafs).numpy()[v]
    ang_ref = t_laf.get_laf_orientation(_t(stages["lafs_o"])).numpy()[v]
    d = (ang - ang_ref + 180.0) % 360.0 - 180.0
    # histogram peak interpolation on f32 sums: 0.05 degrees
    assert np.abs(d).max() < 0.05
    np.testing.assert_allclose(lafs.numpy()[..., 2][v],
                               stages["lafs_o"][..., 2][v], atol=1e-6)


def test_dominant_orientation_of_patches():
    patches = np.random.default_rng(6).random((5, 1, 19, 19)).astype(
        np.float32)
    from kornia_tpu.feature.orientation import \
        patch_dominant_gradient_orientation as ref_fn
    np.testing.assert_allclose(
        patch_dominant_gradient_orientation(_t(patches)).numpy(),
        np.asarray(jax.jit(ref_fn)(jnp.asarray(patches))), atol=1e-5)


def test_sift_descriptors(stages):
    desc = t_int.SIFTFeature(num_features=NF).descriptor
    out = desc(_t(stages["x"]), _t(stages["lafs_o"]))
    v = stages["valid_d"]
    # RootSIFT entries are in [0, 1]; conv sums in another order
    np.testing.assert_allclose(out.numpy()[v], stages["descs"][v],
                               atol=1e-5)


def test_masked_smnn_matches_reference(small_refs):
    d1, d2, m1, m2 = (small_refs["inputs"][k] for k in ("d1", "d2", "m1",
                                                         "m2"))
    out = t_match.DescriptorMatcher("smnn", 0.95)(_t(d1), _t(d2), _t(m1),
                                                  _t(m2))
    ref = small_refs["smnn"]
    valid = np.asarray(ref[2])
    assert valid.sum() >= 20
    np.testing.assert_array_equal(out[2].numpy(), valid)
    np.testing.assert_array_equal(out[1].numpy()[valid],
                                  np.asarray(ref[1])[valid])
    np.testing.assert_allclose(out[0].numpy()[valid],
                               np.asarray(ref[0])[valid], atol=1e-5)


def test_fast_patches_follow_the_tpu_bf16_mode(stages):
    """SIFTFeature(fast_patches=True) samples in the TPU kernel's bf16 mode
    on every device (the reference's CPU path ignores the mode and samples
    exactly): patches within 4e-3 of the exact ones, and not equal to them;
    descriptors within 2e-2 (RootSIFT entries in [0, 1])."""
    feat = t_int.SIFTFeature(num_features=NF, fast_patches=True)
    assert feat.descriptor.patch_mode == feat.orienter.patch_mode == "bf16"
    out = t_laf.extract_patches_from_pyramid(
        _t(stages["x"]), _t(stages["lafs_o"]), 41, patch_mode="bf16")
    np.testing.assert_allclose(out.numpy(), stages["patches"], atol=4e-3)
    assert not np.array_equal(out.numpy(), stages["patches"])
    desc = feat.descriptor(_t(stages["x"]), _t(stages["lafs_o"]))
    v = stages["valid_d"]
    np.testing.assert_allclose(desc.numpy()[v], stages["descs"][v], atol=2e-2)
