"""The port's GFTT front end (kornia_tpu_torch: spatial_gradient order 2,
the corner and blob responses, the scale-space detector with a response
function, single-scale detection, resize with an int size, upscale_double,
ScalePyramid(double_image), and the GFTT/SIFT presets) against the JAX
package on the CPU.

The JAX side runs its CPU paths (the XLA formulation of its Pallas
kernels), jitted once per module where the jitted result still passes.
Tolerances: responses 1e-5 of the largest |value| (GFTT subtracts nearly
equal f32 numbers in tr² - 4·det); detectors hold the validity masks equal,
responses to 1e-5 of the largest and LAFs to 1e-3 px; pyramid levels 2e-6
(the multi-level blur's cumulative operators against the reference's
sequential chain, as tests/test_multi_level_blur.py holds the two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.feature import detector as j_det
from kornia_tpu.feature import integrated as j_int
from kornia_tpu.feature import responses as j_resp
from kornia_tpu.ops import filters as j_filters
from kornia_tpu.ops import pyramid as j_pyr
from kornia_tpu.ops import warp as j_warp
from kornia_tpu_torch.feature import detector as t_det
from kornia_tpu_torch.feature import integrated as t_int
from kornia_tpu_torch.feature import responses as t_resp
from kornia_tpu_torch.ops import filters as t_filters
from kornia_tpu_torch.ops import pyramid as t_pyr
from kornia_tpu_torch.ops import warp as t_warp
from tests.torch_op_parity import exact_jit
from tests.torch_threads import one_torch_thread  # noqa: F401

NF = 64


def _t(a):
    return torch.from_numpy(np.array(a))


def _image(seed, h, w):
    rng = np.random.default_rng(seed)
    return gaussian_filter(rng.random((h, w)), 1.2).astype(
        np.float32)[None, None]


def _square(h=16, lo=4, hi=12):
    x = np.zeros((1, 1, h, h), np.float32)
    x[:, :, lo:hi, lo:hi] = 1.0
    return x


def _close_rel(out, ref, rel=1e-5):
    ref = np.asarray(ref)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * scale)


@pytest.mark.parametrize("mode", ["sobel", "diff"])
def test_second_order_gradient_matches_reference(mode):
    x = _image(1, 21, 19)
    refs = exact_jit(lambda a: (j_filters.spatial_gradient(a, mode, 2),
                                j_filters.spatial_gradient(a, mode, 2,
                                                           False)), x)
    out = t_filters.spatial_gradient(_t(x), mode, 2)
    assert out.shape == (1, 1, 3, 21, 19)
    np.testing.assert_allclose(out.numpy(), np.asarray(refs[0]), atol=1e-6)
    # unnormalised: the integer taps themselves
    out = t_filters.spatial_gradient(_t(x), mode, 2, False)
    np.testing.assert_allclose(out.numpy(), np.asarray(refs[1]), atol=1e-5)


@pytest.mark.parametrize("name", ["harris_response", "gftt_response",
                                  "hessian_response"])
@pytest.mark.parametrize("image", ["square", "texture", "scaled"])
def test_responses_match_reference(name, image):
    """tests/test_feature.py::TestResponses' inputs and a blurred texture
    through two levels with the detector's sigmas (the σ⁴ scaling)."""
    sigmas = None
    if image == "square":
        x = _square()
    else:
        x = np.concatenate([_image(2, 40, 48), _image(3, 40, 48)])
        if image == "scaled":
            sigmas = np.array([1.6, 2.0159], np.float32)
    out = getattr(t_resp, name)(_t(x), sigmas=None if sigmas is None
                                else _t(sigmas))
    fn = getattr(j_resp, name)
    ref = (exact_jit(lambda a: fn(a, sigmas=None), x, exact=False)
           if sigmas is None else
           exact_jit(lambda a, s: fn(a, sigmas=s), x, sigmas, exact=False))
    _close_rel(out.numpy(), ref)


def test_corner_responses_peak_at_corners():
    """tests/test_feature.py::TestResponses: corners outrespond edges, and
    the Hessian peaks on a blurred dot."""
    x = _t(_square())
    for fn in (t_resp.harris_response, t_resp.gftt_response):
        r = fn(x)
        assert r.shape == x.shape
        assert float(r[0, 0, 4, 4]) > float(r[0, 0, 4, 8])
    dot = torch.zeros((1, 1, 16, 16))
    dot[0, 0, 8, 8] = 1.0
    r = t_resp.hessian_response(t_filters.gaussian_blur2d(dot, 5, 1.5))
    assert int(torch.argmax(r[0, 0])) == 8 * 16 + 8


def test_dog_responses_match_reference():
    x = _image(4, 48, 40)
    out = t_resp.dog_response_single(_t(x))
    ref = jax.jit(j_resp.dog_response_single)(jnp.asarray(x))
    assert out.shape == x.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    stack = np.stack([x, np.asarray(exact_jit(
        lambda a: j_filters.gaussian_blur2d(a, 5, 1.0), x))], axis=1)
    np.testing.assert_array_equal(
        t_resp.dog_response(_t(stack)).numpy(),
        np.asarray(exact_jit(j_resp.dog_response, stack)))


def test_single_scale_detection_matches_reference():
    """tests/test_feature.py::test_single_scale: Harris corners of a square,
    top 16 after NMS, with and without minima."""
    x = np.zeros((1, 1, 32, 32), np.float32)
    x[:, :, 8:24, 8:24] = 1.0
    resp_t = t_resp.harris_response(_t(x))
    resp_j, dets = exact_jit(lambda a: (
        j_resp.harris_response(a),
        [j_det.detect_features_single_scale(j_resp.harris_response(a), 16,
                                            minima_are_also_good=m)
         for m in (False, True)]), x, exact=False)
    for minima, (xy_j, vals_j, valid_j) in zip((False, True), dets):
        xy, vals, valid = t_det.detect_features_single_scale(
            _t(np.asarray(resp_j)), 16, minima_are_also_good=minima)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
        np.testing.assert_array_equal(xy.numpy(), np.asarray(xy_j))
        np.testing.assert_allclose(vals.numpy(), np.asarray(vals_j),
                                   rtol=0, atol=0)
    xy, _, valid = t_det.detect_features_single_scale(resp_t, 16)
    got = xy[0][valid[0]].numpy()
    for c in ([8, 8], [23, 8], [8, 23], [23, 23]):
        assert np.min(np.abs(got - c).sum(-1)) <= 2


@pytest.mark.parametrize("size,side", [(30, "short"), (30, "long"),
                                       (30, "vert"), (30, "horz"),
                                       (100, "short"), ((20, 70), "short")])
def test_resize_int_size_matches_reference(size, side):
    """An int size scales one side and keeps the aspect ratio of a
    non-square image, as the reference does."""
    x = _image(5, 45, 60)
    out = t_warp.resize(_t(x), size, side=side)
    ref = jax.jit(lambda a: j_warp.resize(a, size, side=side))(
        jnp.asarray(x))
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    xt = x.transpose(0, 1, 3, 2)  # the other orientation
    assert t_warp.resize(_t(xt), size, side=side).shape == jax.eval_shape(
        lambda a: j_warp.resize(a, size, side=side), jnp.asarray(xt)).shape


def test_resize_keeps_the_positional_order():
    x = _t(_image(6, 20, 30))
    a = t_warp.resize(x, (10, 15), "bilinear", True)
    b = t_warp.resize(x, (10, 15), align_corners=True)
    assert torch.equal(a, b)
    # nearest and antialiased resizes (refused before the op layer was
    # ported) keep the positional order too, and compute the reference's
    near_j, aa_j = exact_jit(lambda a: (
        j_warp.resize(a, (10, 15), "nearest"),
        j_warp.resize(a, (10, 15), antialias=True)), _image(6, 20, 30))
    np.testing.assert_array_equal(
        t_warp.resize(x, (10, 15), "nearest").numpy(), np.asarray(near_j))
    np.testing.assert_allclose(
        t_warp.resize(x, (10, 15), "bilinear", None, "short", True).numpy(),
        np.asarray(aa_j), atol=1e-5)


def test_upscale_double_and_doubled_pyramid_match_reference():
    x = _image(7, 40, 48)
    np.testing.assert_allclose(
        t_pyr.upscale_double(_t(x)).numpy(),
        np.asarray(jax.jit(j_pyr.upscale_double)(jnp.asarray(x))),
        atol=1e-6)
    pyr_t = t_pyr.ScalePyramid(3, 1.6, 32, double_image=True)
    pyr_j = j_pyr.ScalePyramid(3, 1.6, 32, double_image=True)
    assert pyr_t.n_octaves(40, 48) == pyr_j.n_octaves(40, 48) == 2
    octs, sigs, dists = pyr_t(_t(x))
    j_octs, j_sigs, j_dists = jax.jit(pyr_j)(jnp.asarray(x))
    assert octs[0].shape[-2:] == (80, 96)
    for o, r in zip(octs, j_octs):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=2e-6)
    for a, b in zip(sigs + dists, list(j_sigs) + list(j_dists)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert float(dists[0][0, 0]) == 0.5


@pytest.fixture(scope="module")
def detections():
    """The JAX detectors on one 96x96 texture: GFTT (the default
    response), GFTT with minima, and the doubled-image DoG of
    SIFTFeatureScaleSpace; all of it in one compile."""
    x = _image(8, 96, 96)
    gftt = j_det.ScaleSpaceDetector(num_features=NF)
    gftt_min = j_det.ScaleSpaceDetector(num_features=NF,
                                        minima_are_also_good=True)
    sss = j_int.SIFTFeatureScaleSpace(num_features=NF)

    @jax.jit
    def run(xj):
        return dict(gftt=gftt(xj), gftt_min=gftt_min(xj),
                    sss=sss.detector(xj),
                    sss_desc=sss(xj)[2])

    out = jax.tree_util.tree_map(np.asarray, run(jnp.asarray(x)))
    return dict(x=x, **out)


def _same_detections(out, ref):
    lafs, resp, valid = (o.numpy() for o in out)
    lafs_j, resp_j, valid_j = ref
    np.testing.assert_array_equal(valid, valid_j)
    assert valid.sum() >= 10
    _close_rel(resp[valid], resp_j[valid])
    np.testing.assert_allclose(lafs[valid], lafs_j[valid], atol=1e-3)


@pytest.mark.parametrize("which", ["gftt", "gftt_min"])
def test_gftt_scale_space_detector_matches_reference(detections, which):
    """tests/test_feature.py::test_scale_space_detector: the default
    ScaleSpaceDetector is GFTT on ScalePyramid(3, 1.6, 15)."""
    det = t_det.ScaleSpaceDetector(num_features=NF,
                                   minima_are_also_good=which == "gftt_min")
    assert det.resp is t_resp.gftt_response and det.nms_size == 3
    out = det(_t(detections["x"]))
    assert out[0].shape == (1, NF, 2, 3)
    _same_detections(out, detections[which])
    xy = out[0][..., 2][out[2]]
    assert float(xy.min()) >= 0 and float(xy.max()) <= 95


def test_doubled_image_sift_matches_reference(detections):
    feat = t_int.SIFTFeatureScaleSpace(num_features=NF)
    assert feat.detector.scale_pyr.double_image
    _same_detections(feat.detector(_t(detections["x"])), detections["sss"])
    desc = feat(_t(detections["x"]))[2].numpy()
    v = detections["sss"][2]
    np.testing.assert_allclose(desc[v], detections["sss_desc"][v],
                               atol=1e-4)


def test_presets_follow_the_reference():
    """SIFTFeature passes resp="dog" and double_image through; the GFTT
    preset runs the GFTT response; an angle detector and an affine shape
    module are kept and called."""
    for double in (False, True):
        f = t_int.SIFTFeature(32, True, double)
        assert f.detector.resp == "dog"
        assert f.detector.scale_pyr.double_image is double
        assert f.descriptor.patch_mode is None
    g = t_int.GFTTSIFTFeature(32)
    assert g.detector.resp is t_resp.gftt_response
    assert not g.detector.scale_pyr.double_image
    assert t_int.SIFTFeatureScaleSpace(32, upright=True).orienter is None
    calls = []

    def angle(p):
        calls.append("angle")
        return torch.zeros(p.shape[0])

    def shape(laf, img):
        calls.append("shape")
        return laf

    ori = t_int.LAFOrienter(19, 36, angle)
    assert ori.angle_detector is angle
    f = t_int.LocalFeature(g.detector, g.descriptor, ori, aff_module=shape)
    assert f.aff_module is shape
    f(_t(_image(3, 64, 64)))
    assert calls == ["shape", "angle"]
