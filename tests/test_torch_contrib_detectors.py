"""The port's contrib detectors (kornia_tpu_torch: contrib/detection.py
whole, contrib's SuperResolution, BoxTracker's and BoxMotTracker's default
detector) against the JAX package on the CPU.

The face detector's post-processing (top-k, NMS, the stable front
compaction) runs on planted boxes and scores with equal scores and
overlapping boxes, and the whole detector on a 96x128 image; the object
detector (its head at input_size 64) with BoxFiltering; the edge detector
at image_size 64; SuperResolution with SmallSR on a batch and on a list.
The nets take the JAX package's parameters: YuNet's and DexiNed's from
their own init functions replayed on the host
(``tests/torch_op_parity.py::numpy_random``), YuNet's batch norms and
heads rescaled so that its outputs are O(1) and its scores pass the
threshold (``tests/torch_unit_scale.py``), the flax heads' drawn with
numpy from the port's tables (``flax_variables``). The references come
from two programs compiled side by side with FAST_OPTIONS.

The default route: ``BoxTracker()`` with no detector over three frames
equals the JAX package's ``BoxTracker()``, the port's default
ObjectDetector given the JAX default head's own ``PRNGKey(0)`` init.

Tolerances: net outputs within 1e-4 of their largest |entry|; the kept
rows (NMS keep sets, face rows, track ids) equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu import contrib as j_contrib
from kornia_tpu.contrib import detection as j_det
from kornia_tpu.models import dexined as j_dx
from kornia_tpu.models import small_sr as j_sr
from kornia_tpu.models import yunet as j_yu
from kornia_tpu.tracking import bytetrack as jbt
from kornia_tpu_torch import contrib as t_contrib
from kornia_tpu_torch import convert
from kornia_tpu_torch.contrib import detection as t_det
from kornia_tpu_torch.feature import _nets
from kornia_tpu_torch.models import rrdbnet as t_rr
from kornia_tpu_torch.models import small_sr as t_sr
from kornia_tpu_torch.tracking import bytetrack as tbt
from tests.torch_op_parity import (FAST_OPTIONS, compile_parallel,
                                   flax_variables, numpy_random)
from tests.torch_threads import one_torch_thread  # noqa: F401
from tests.torch_unit_scale import yunet_unit_scale

_RNG = np.random.default_rng(1)


def _smooth(shape, sigma=1.5):
    return gaussian_filter(_RNG.uniform(0, 1, shape),
                           (0,) * (len(shape) - 2) + (sigma, sigma)
                           ).astype(np.float32)


def _flat_init(init, seed):
    with numpy_random():
        p = init(np.asarray(jax.random.PRNGKey(seed)))
    return {k: np.asarray(v, np.float32) for k, v in p.items()}


FACE_IMG = _smooth((1, 3, 96, 128))
OBJ_IMG = _smooth((2, 3, 48, 72))
EDGE_IMG = _smooth((1, 3, 40, 56))
SR_IMG = _smooth((2, 3, 12, 20))
TRACK_FRAMES = [_smooth((1, 3, 120, 160), 3.0) for _ in range(3)]
# planted faces: clusters of overlapping boxes, equal scores, zeros
_N = 300
_c = _RNG.uniform(20, 200, (_N // 10, 2)).repeat(10, 0)
_c += _RNG.normal(0, 4, _c.shape)
_wh = _RNG.uniform(10, 40, (_N, 2))
_b = np.concatenate([_c - _wh / 2, _c + _wh / 2,
                     _RNG.uniform(0, 240, (_N, 10))], 1)
_s = np.round(_RNG.uniform(0, 1, _N), 1)   # many exact ties
_s[_RNG.uniform(0, 1, _N) < 0.2] = 0.0
FACE_BOXES, FACE_SCORES = _b.astype(np.float32), _s.astype(np.float32)
# padded detections for the filter: classes 0-4, scores around 0.3
_d = np.concatenate([_RNG.integers(0, 5, (2, 40, 1)),
                     _RNG.choice([0.1, 0.3, 0.31, 0.9], (2, 40, 1)),
                     _RNG.uniform(0, 100, (2, 40, 4))], -1)
DETS = _d.astype(np.float32)

YUNET = yunet_unit_scale(_flat_init(j_yu.yunet_init_params, 2))
DEXINED = _flat_init(j_dx.dexined_init_params, 3)
HEAD_VARS = flax_variables(t_det._TinyDetHead(80, device="cpu")._rows(3), 4)
SR_VARS = flax_variables(t_sr._SmallSRModule(2, device="cpu")._rows(3), 5)


def _face_post(top_k, keep_top_k):
    fd = object.__new__(j_det.FaceDetector)
    fd.top_k, fd.nms_threshold = top_k, 0.3
    fd.keep_top_k = keep_top_k if keep_top_k is not None else top_k
    return fd


@pytest.fixture(scope="module")
def refs():
    def heads(face_img, obj_img, sr_img, boxes, scores, dets, yunet, head,
              srv):
        faces = j_det.FaceDetector(params=yunet, keep_top_k=40)(face_img)
        return dict(
            post=_face_post(200, 50).postprocess_one(boxes, scores),
            post_all=_face_post(400, None).postprocess_one(boxes, scores),
            faces=[r.data for r in faces],
            obj=j_det.ObjectDetector(input_size=64, params=head)(obj_img),
            filt=j_det.BoxFiltering(0.3, [1, 3])(dets),
            sr=j_contrib.SuperResolution(j_sr.SmallSR(params=srv))(sr_img),
            sr_list=j_contrib.SuperResolution(j_sr.SmallSR(params=srv))(
                [sr_img[0], sr_img[1, :, :8]]))

    def edges(img, p):
        return j_det.EdgeDetector(params=p, image_size=64)(img)

    h_args = [jnp.asarray(a) for a in (FACE_IMG, OBJ_IMG, SR_IMG, FACE_BOXES,
                                       FACE_SCORES, DETS)] + [
        YUNET, HEAD_VARS, SR_VARS]
    e_args = [jnp.asarray(EDGE_IMG), DEXINED]
    hp, ep = compile_parallel([(heads, h_args), (edges, e_args)],
                              FAST_OPTIONS)
    out = dict(**hp(*h_args), edges=ep(*e_args))
    return jax.tree_util.tree_map(np.asarray, out)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, rtol=1e-4):
    """got within rtol of the largest |want| (each output at its own
    scale)."""
    got = got.detach().cpu().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    assert scale > 0, "an all-zero reference holds nothing"
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("which,top_k,keep", [("post", 200, 50),
                                              ("post_all", 400, None)])
def test_face_postprocess_one(which, top_k, keep, refs):
    fd = object.__new__(t_det.FaceDetector)
    fd.top_k, fd.nms_threshold = top_k, 0.3
    fd.keep_top_k = keep if keep is not None else top_k
    got = fd.postprocess_one(_t(FACE_BOXES), _t(FACE_SCORES))
    want = refs[which]
    np.testing.assert_array_equal(got[:, 14].numpy() > 0, want[:, 14] > 0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_face_detector(refs):
    fd = t_det.FaceDetector(params=convert.yunet_from_numpy(
        YUNET, "cpu").params, keep_top_k=40, device="cpu")
    with torch.inference_mode():
        got = fd(_t(FACE_IMG))
    assert len(got) == len(refs["faces"]) == 1
    want = refs["faces"][0]
    np.testing.assert_array_equal(got[0].score.numpy() > 0, want[:, 14] > 0)
    _close(got[0].data, want)
    r = got[0]
    assert r.get_keypoint(t_det.FaceKeypoint.NOSE).shape == (40, 2)
    _close(r.width, want[:, 2] - want[:, 0])


def test_object_detector_with_filtering(refs):
    od = convert.object_detector_from_numpy(HEAD_VARS, "cpu", input_size=64)
    with torch.inference_mode():
        got = od(_t(OBJ_IMG))
    want = refs["obj"]
    np.testing.assert_array_equal(got[..., :2].numpy() != 0,
                                  want[..., :2] != 0)
    np.testing.assert_array_equal(got[..., 0].numpy(), want[..., 0])
    _close(got, want)
    np.testing.assert_array_equal(
        t_det.BoxFiltering(0.3, [1, 3])(_t(DETS)).numpy(), refs["filt"])


def test_edge_detector(refs):
    ed = t_det.EdgeDetector(params=convert.dexined_from_numpy(
        DEXINED, "cpu").params, image_size=64, device="cpu")
    with torch.inference_mode():
        _close(ed(_t(EDGE_IMG)), refs["edges"])


def test_super_resolution(refs):
    params = _nets.from_flax(t_sr._SmallSRModule(2, device="cpu")._rows(3),
                             SR_VARS)
    sr = t_contrib.SuperResolution(t_sr.SmallSR(params=params,
                                                device="cpu"))
    with torch.inference_mode():
        _close(sr(_t(SR_IMG)), refs["sr"])
        got = sr([_t(SR_IMG[0]), _t(SR_IMG[1, :, :8])])
    for g, w in zip(got, refs["sr_list"]):
        _close(g, w)


def test_super_resolution_default_builds_on_the_input_device():
    sr = t_contrib.SuperResolution()
    assert sr.model is None
    out = sr(torch.rand(1, 3, 8, 10))
    assert out.shape == (1, 3, 16, 20)
    assert next(sr.model.module.parameters()).device.type == "cpu"


def test_rrdbnet_builder_clamps():
    sr = t_rr.RRDBNetBuilder.build("RealESRGAN_x2plus", device="cpu")
    with torch.inference_mode():
        out = sr(torch.rand(1, 3, 8, 8))
    assert out.shape == (1, 3, 16, 16)
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0


def test_default_detectors_ask_for_the_card():
    """Every default builds on the card unless the CPU is asked for; the
    lazily drawn heads (ObjectDetector, SuperResolution) hold no tensor
    until their first call."""
    assert t_det.ObjectDetector().module.device == "cuda"
    for cls in (t_det.FaceDetector, t_det.EdgeDetector):
        assert next(cls(device="cpu").model.parameters()).device.type \
            == "cpu"
        if not torch.cuda.is_available():
            with pytest.raises((RuntimeError, AssertionError)):
                cls()
    bm = t_contrib.BoxMotTracker(device="cpu")
    assert isinstance(bm._tracker.detector, t_det.ObjectDetector)
    assert torch.device(bm._tracker.detector.module.device).type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            t_contrib.BoxMotTracker()


def test_boxtracker_default_route_matches_the_reference():
    """The JAX default detector's own init (``ObjectDetector.init``: its
    head from ``PRNGKey(0)`` at input_size²) and its call, each jitted
    (eagerly they cost 10 s apiece here); the port's default detector
    takes that head's parameters."""
    jt = jbt.BoxTracker()
    od = jt.detector
    od._params = jax.jit(od.module.init)(
        od._key, jnp.zeros((1, od.input_size, od.input_size, 3)))
    jt.detector = jax.jit(od.__call__)
    tt = tbt.BoxTracker(device="cpu")
    tt.detector.module.load_params(_nets.from_flax(
        tt.detector.module._rows(3), jax.tree_util.tree_map(np.asarray,
                                                            od._params)))
    with torch.inference_mode():
        for f in TRACK_FRAMES:
            jb, jid, jsc, jcls, jv = (np.asarray(a) for a in
                                      jt.update(jnp.asarray(f)))
            tb, tid, tsc, tcls, tv = tt.update(_t(f))
            np.testing.assert_array_equal(tv.numpy(), jv)
            np.testing.assert_array_equal(tid.numpy()[jv], jid[jv])
            np.testing.assert_allclose(tb.numpy()[jv], jb[jv], rtol=0,
                                       atol=1e-3)
    assert int(jv.sum()) > 0
