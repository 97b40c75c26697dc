"""The port's boxes, lines, image containers, drawing, image utilities,
terminal printing, ``utils/misc`` and the ``core/check`` toggles against
the JAX package on the CPU (kornia_tpu_torch: geometry.{bbox,boxes,line},
image, utils.misc, core.{check,module}); the legs of
tests/test_containers_io.py mirrored.
"""

import importlib
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.geometry import bbox as j_bbox
from kornia_tpu.geometry import boxes as j_boxes
from kornia_tpu.geometry import line as j_line
from kornia_tpu import image as j_image
from kornia_tpu.image import draw as j_draw
from kornia_tpu.image import image_print as j_print
from kornia_tpu.image import utils as j_iutils
from kornia_tpu.utils import misc as j_misc
from kornia_tpu_torch.geometry import bbox as t_bbox
from kornia_tpu_torch.geometry import boxes as t_boxes
from kornia_tpu_torch.geometry import line as t_line
from kornia_tpu_torch import image as t_image
from kornia_tpu_torch.image import draw as t_draw
from kornia_tpu_torch.image import image_print as t_print
from kornia_tpu_torch.image import utils as t_iutils
from kornia_tpu_torch.utils import misc as t_misc
from tests.torch_op_parity import exact_jit
from tests.torch_threads import one_torch_thread  # noqa: F401

# the JAX package's core/__init__ binds the name `check` to the function
j_check = importlib.import_module("kornia_tpu.core.check")
t_check = importlib.import_module("kornia_tpu_torch.core.check")

BOX_RTOL = 1e-6   # boxes: of the largest coordinate
LINE_TOL = 1e-5   # lines and planes


def _t(a):
    """numpy or a list → tensor; float64 becomes float32, as JAX's
    arrays of the same lists are."""
    a = np.array(a)
    return torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64
                            else a)


def _eq(got, want):
    np.testing.assert_array_equal(
        got.numpy() if torch.is_tensor(got) else np.asarray(got),
        np.asarray(want))


def _close(got, want, tol, rel=True):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(initial=0.0), 1.0) if rel else 1.0
    assert np.abs(got - want).max(initial=0.0) <= tol * scale


def _rand_boxes(rng, shape, lo=0.0, hi=100.0):
    xy = rng.uniform(lo, hi, (*shape, 2))
    wh = rng.uniform(1.0, 30.0, (*shape, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _homographies(rng, B):
    M = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
    M[:, :2] += rng.normal(0, 0.05, (B, 2, 3)).astype(np.float32)
    M[:, :2, 2] = rng.uniform(-10, 10, (B, 2))
    M[:, 2, :2] = rng.normal(0, 1e-4, (B, 2))
    return M


# --- geometry/bbox.py --------------------------------------------------------

def test_bbox_generators_and_shapes():
    rng = np.random.default_rng(0)
    x, y, z, w, h, d = (rng.uniform(0, 20, 4).astype(np.float32)
                        for _ in range(6))
    q = t_bbox.bbox_generator(_t(x), _t(y), _t(w), _t(h))
    _eq(q, j_bbox.bbox_generator(x, y, w, h))
    _eq(t_bbox.bbox_generator3d(*map(_t, (x, y, z, w, h, d))),
        j_bbox.bbox_generator3d(x, y, z, w, h, d))
    for got, want in zip(t_bbox.infer_bbox_shape(q),
                         j_bbox.infer_bbox_shape(np.asarray(q))):
        _eq(got, want)
    q3 = t_bbox.bbox_generator3d(*map(_t, (x, y, z, w, h, d)))
    for got, want in zip(t_bbox.infer_bbox_shape3d(q3),
                         j_bbox.infer_bbox_shape3d(np.asarray(q3))):
        _eq(got, want)
    b = t_bbox.bbox_generator(_t([1.0]), _t([2.0]), _t([3.0]), _t([4.0]))
    _eq(b[0], [[1, 2], [3, 2], [3, 5], [1, 5]])
    assert t_bbox.validate_bbox(b) and t_bbox.validate_bbox3d(q3)
    with pytest.raises(ValueError):
        t_bbox.validate_bbox(q3)
    with pytest.raises(ValueError):
        t_bbox.infer_bbox_shape(q3)


def test_bbox_to_mask_and_3d():
    rng = np.random.default_rng(1)
    x, y = rng.uniform(-2, 12, (2, 3)).astype(np.float32)
    w, h = rng.uniform(1, 8, (2, 3)).astype(np.float32)
    q = np.asarray(j_bbox.bbox_generator(x, y, w, h))
    _eq(t_bbox.bbox_to_mask(_t(q), 13, 11), j_bbox.bbox_to_mask(q, 13, 11))
    q3 = np.asarray(j_bbox.bbox_generator3d(x, y, x, w, h, w))
    _eq(t_bbox.bbox_to_mask3d(_t(q3), (9, 11, 13)),
        j_bbox.bbox_to_mask3d(q3, (9, 11, 13)))
    m = t_bbox.bbox_to_mask(t_bbox.bbox_generator(
        _t([1.0]), _t([1.0]), _t([2.0]), _t([2.0])), 5, 5)
    assert float(m.sum()) == 4.0 and float(m[0, 1, 1]) == 1.0


@pytest.mark.parametrize("mode", ["xyxy", "xywh"])
def test_transform_bbox(mode):
    rng = np.random.default_rng(2)
    boxes, M = _rand_boxes(rng, (3, 5)), _homographies(rng, 3)
    _close(t_bbox.transform_bbox(_t(M), _t(boxes), mode),
           j_bbox.transform_bbox(M, boxes, mode), BOX_RTOL)
    M1 = np.eye(3, dtype=np.float32)
    M1[0, 2] = 2.0
    _close(t_bbox.transform_bbox(_t(M1[None]), _t([[[1.0, 1, 3, 3]]])),
           [[[3, 1, 5, 3]]], 1e-5, rel=False)


@pytest.mark.parametrize("seed,thresh,max_output", [
    (0, 0.5, None), (1, 0.3, None), (2, 0.5, 7), (3, 0.1, None)])
def test_nms_exact_indices(seed, thresh, max_output):
    rng = np.random.default_rng(seed)
    boxes = _rand_boxes(rng, (24,), hi=40.0)
    boxes[5] = boxes[4]  # duplicate boxes, and score ties
    scores = rng.choice([0.3, 0.5, 0.5, 0.7, 0.9], 24).astype(np.float32)
    scores[5] = scores[4]
    got = t_bbox.nms(_t(boxes), _t(scores), thresh, max_output)
    _eq(got, j_bbox.nms(boxes, scores, thresh, max_output))
    kept = got.numpy()
    assert (kept >= 0).any() and (kept < 0).any()


def test_nms_mirrored():
    keep = t_bbox.nms(_t([[0.0, 0, 10, 10], [1.0, 1, 11, 11],
                          [20.0, 20, 30, 30]]), _t([0.9, 0.8, 0.7]), 0.5)
    assert set(keep[keep >= 0].tolist()) == {0, 2}


# --- geometry/boxes.py -------------------------------------------------------

@pytest.mark.parametrize("mode", ["xyxy", "xywh", "vertices"])
def test_boxes_against_the_reference(mode):
    rng = np.random.default_rng(3)
    raw = _rand_boxes(rng, (2, 6))
    if mode == "vertices":
        raw = np.asarray(j_boxes.Boxes.from_tensor(raw).to_tensor(
            "vertices"))
    jb = j_boxes.Boxes.from_tensor(raw, mode)
    tb = t_boxes.Boxes.from_tensor(_t(raw), mode)
    for m in ("xyxy", "xywh", "vertices"):
        _close(tb.to_tensor(m), jb.to_tensor(m), BOX_RTOL)
    _eq(tb.valid, jb.valid)
    M = _homographies(rng, 2)
    _close(tb.transform_boxes(_t(M)).data, jb.transform_boxes(M).data,
           BOX_RTOL)
    _close(tb.compute_area(), jb.compute_area(), BOX_RTOL)
    for lo, hi in ((50.0, None), (10.0, 400.0)):
        _eq(tb.filter_boxes_by_area(lo, hi).valid,
            jb.filter_boxes_by_area(lo, hi).valid)
    _close(tb.clamp(60, 80).data, jb.clamp(60, 80).data, BOX_RTOL)
    _eq(tb.to_mask(40, 50), jb.to_mask(40, 50))
    p_t, p_j = tb.pad(3), jb.pad(3)
    _eq(p_t.data, p_j.data)
    _eq(p_t.valid, p_j.valid)


def test_keypoints_and_video_boxes():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-10, 70, (2, 9, 2)).astype(np.float32)
    jk, tk = j_boxes.Keypoints.from_tensor(pts), \
        t_boxes.Keypoints.from_tensor(_t(pts))
    M = _homographies(rng, 2)
    _close(tk.transform_keypoints(_t(M)).data,
           jk.transform_keypoints(M).data, BOX_RTOL)
    _eq(tk.clamp(50, 60).data, jk.clamp(50, 60).data)
    _eq(tk.mark_outside(50, 60).valid, jk.mark_outside(50, 60).valid)
    _eq(tk.pad(2).valid, jk.pad(2).valid)
    _eq(tk.to_tensor(), jk.to_tensor())
    vb = _rand_boxes(rng, (2, 3, 4))
    jv, tv = j_boxes.VideoBoxes.from_tensor(vb), \
        t_boxes.VideoBoxes.from_tensor(_t(vb))
    _eq(tv.to_frame_boxes().data, jv.to_frame_boxes().data)
    for Mv in (_homographies(rng, 2), _homographies(rng, 6).reshape(
            2, 3, 3, 3)):
        _close(tv.transform_boxes(_t(Mv)).data, jv.transform_boxes(Mv).data,
               BOX_RTOL)


def test_boxes_mirrored():
    b = t_boxes.Boxes.from_tensor(_t([[[1.0, 2, 5, 7]]]))
    _eq(b.to_tensor("xywh"), [[[1, 2, 4, 5]]])
    assert tuple(b.to_tensor("vertices").shape) == (1, 1, 4, 2)
    _close(b.compute_area(), [[20.0]], 1e-5, rel=False)
    f = t_boxes.Boxes.from_tensor(
        _t([[[0.0, 0, 2, 2], [0.0, 0, 10, 10]]])).filter_boxes_by_area(20)
    _eq(f.valid, [[False, True]])
    M = np.eye(3, dtype=np.float32)
    M[1, 2] = 5.0
    out = t_boxes.Boxes.from_tensor(_t([[[1.0, 1, 3, 3]]])).transform_boxes(
        _t(M[None]))
    _close(out.data[0, 0], [1, 6, 3, 8], 1e-5, rel=False)
    kp = t_boxes.Keypoints.from_tensor(_t([[[2.0, 3.0], [50.0, 3.0]]]))
    _eq(kp.mark_outside(10, 10).valid, [[True, False]])


# --- geometry/line.py --------------------------------------------------------

def _up_to_sign(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    sign = np.sign((got * want).sum(-1, keepdims=True))
    _close(got * sign, want, tol, rel=False)


def test_fit_line_and_plane_against_the_reference():
    rng = np.random.default_rng(5)
    t = rng.uniform(-2, 2, (3, 30, 1))
    d = rng.normal(0, 1, (3, 1, 3))
    pts = (rng.normal(0, 1, (3, 1, 3)) + t * d
           + rng.normal(0, 0.01, (3, 30, 3))).astype(np.float32)
    w = rng.uniform(0.2, 1.0, (3, 30)).astype(np.float32)
    for weights in (None, w):
        jl = j_line.fit_line(pts, weights)
        tl = t_line.fit_line(_t(pts), None if weights is None else _t(w))
        _close(tl.origin, jl.origin, LINE_TOL)
        _up_to_sign(tl.direction, jl.direction, LINE_TOL)
        q = _t(rng.normal(0, 2, (3, 5, 3)).astype(np.float32))
        line_t = t_line.ParametrizedLine(tl.origin[:, None],
                                         tl.direction[:, None])
        line_j = j_line.ParametrizedLine(jl.origin[:, None],
                                         jl.direction[:, None])
        _close(line_t.distance(q), line_j.distance(q.numpy()), LINE_TOL)
        _close(line_t.squared_distance(q),
               line_j.squared_distance(q.numpy()), LINE_TOL)
    xy = rng.normal(0, 1, (2, 50, 2))
    z = 0.3 * xy[..., :1] - 0.2 * xy[..., 1:] + 1.0 \
        + rng.normal(0, 0.01, (2, 50, 1))
    pp = np.concatenate([xy, z], -1).astype(np.float32)
    jp, tp = j_line.fit_plane(pp), t_line.fit_plane(_t(pp))
    sign = np.sign((tp.normal.numpy() * np.asarray(jp.normal)).sum(-1))
    _up_to_sign(tp.normal, jp.normal, LINE_TOL)
    _close(tp.offset * _t(sign), jp.offset, LINE_TOL)
    plane_t = t_line.Hyperplane(tp.normal[:, None], tp.offset[:, None])
    plane_j = j_line.Hyperplane(jp.normal[:, None], jp.offset[:, None])
    q = rng.normal(0, 2, (2, 7, 3)).astype(np.float32)
    _close(plane_t.signed_distance(_t(q)).abs(),
           np.abs(plane_j.signed_distance(q)), LINE_TOL)
    _close(plane_t.projection(_t(q)), plane_j.projection(q), LINE_TOL)


def test_line_plane_ray_mirrored():
    line = t_line.ParametrizedLine.through(_t([0.0, 0]), _t([2.0, 0]))
    _close(line.point_at(3.0), [3, 0], 1e-6, rel=False)
    assert float(line.distance(_t([1.0, 5.0]))) == pytest.approx(5.0)
    tt = np.linspace(0, 1, 20, dtype=np.float32)[:, None]
    got = t_line.fit_line(_t((np.array([[1.0, 2.0]]) + tt * np.array(
        [[0.6, 0.8]]))[None].astype(np.float32)))
    _close(np.abs(got.direction[0].numpy()), [0.6, 0.8], 1e-4, rel=False)
    xy = np.random.default_rng(6).normal(0, 1, (1, 50, 2))
    pts = np.concatenate([xy, 0.3 * xy[..., :1] - 0.2 * xy[..., 1:] + 1.0],
                         -1).astype(np.float32)
    plane = t_line.fit_plane(_t(pts))
    assert float(plane.signed_distance(_t(pts[0])).abs().max()) < 1e-4
    ray = t_line.Ray.through(_t([0.0, 0, 0]), _t([0.0, 0, 1]))
    hit = ray.intersect_plane(t_line.Hyperplane.from_vector(
        _t([0.0, 0, 1.0]), _t([0.0, 0, 5.0])))
    _close(hit, [0, 0, 5], 1e-5, rel=False)
    jray = j_line.Ray.through(jnp.array([1.0, 2, 0]), jnp.array([0.5, 0, 3]))
    tray = t_line.Ray.through(_t([1.0, 2, 0]), _t([0.5, 0, 3]))
    args = ([0.2, 0.3, 1.0], [0.0, 0.0, 2.0])
    _close(tray.intersect_plane(t_line.Hyperplane.from_vector(
        *map(_t, args))), jray.intersect_plane(
        j_line.Hyperplane.from_vector(*map(jnp.asarray, args))), LINE_TOL)


# --- image/ ------------------------------------------------------------------

def _u8(seed, shape):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.uint8)


@pytest.mark.parametrize("cs", ["RGB", "BGR", "GRAY", "RGBA"])
def test_image_container_against_the_reference(cs):
    C = {"GRAY": 1, "RGBA": 4}.get(cs, 3)
    arr = _u8(7, (2, 8, 6, C))
    ti = t_image.Image.from_numpy(arr, t_image.ColorSpace[cs],
                                  device="cpu")
    ji = j_image.Image.from_numpy(arr, j_image.ColorSpace[cs])
    assert ti.shape == ji.shape and ti.is_batch
    assert (ti.channels, ti.height, ti.width) == (C, 8, 6)
    assert ti.layout.image_size.height == 8 and ti.layout.channels == C
    assert ti.pixel_format.bit_depth == 8
    _eq(ti.to_numpy(), ji.to_numpy())
    for conv in ("to_float", "to_gray", "to_rgb"):
        got, want = getattr(ti, conv)(), getattr(ji, conv)()
        _close(got.data, want.data, 1e-6, rel=False)
        assert got.pixel_format.color_space.name == \
            want.pixel_format.color_space.name
    _eq(ti.to_float().to_uint8().data, ji.to_float().to_uint8().data)
    one = t_image.Image.from_numpy(arr[0, ..., 0], device="cpu")
    assert one.shape == (1, 8, 6)
    chw = t_image.Image.from_numpy(
        np.moveaxis(arr[0], -1, 0), channels_order=t_image.ChannelsOrder
        .CHANNELS_FIRST, device="cpu")
    _eq(chw.data, np.moveaxis(arr[0], -1, 0))
    sixteen = t_image.Image.from_numpy(
        (arr.astype(np.uint16) * 257), device="cpu")
    _close(sixteen.to_float().data, j_image.Image.from_numpy(
        arr.astype(np.uint16) * 257).to_float().data, 1e-6, rel=False)
    _eq(t_image.Image.from_dlpack(torch.utils.dlpack.to_dlpack(
        ti.data)).data, arr.transpose(0, 3, 1, 2))


def test_image_file_roundtrip():
    arr = _u8(0, (8, 6, 3))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.png")
        t_image.Image.from_numpy(arr, device="cpu").write(path)
        back = t_image.Image.from_file(path, device="cpu")
        _eq(back.to_numpy(), np.moveaxis(arr, -1, 0))
        assert back.pixel_format.color_space == t_image.ColorSpace.RGB
        _eq(back.data, j_image.Image.from_file(path).data)


def test_draws_against_the_reference():
    rng = np.random.default_rng(8)
    img = rng.random((2, 3, 24, 32)).astype(np.float32)
    rect = np.concatenate([rng.integers(0, 20, (2, 3, 2)),
                           rng.integers(20, 32, (2, 3, 2))], -1
                          ).astype(np.float32)
    rect[0, 1] = [3.5, 2.25, 17.75, 21.5]  # off the pixel grid
    col = np.array([1.0, 0.5, 0.0], np.float32)
    pts = rng.uniform(-3, 35, (7, 2)).astype(np.float32)
    lines = np.array([[[2.0, 3.0], [29.0, 17.0]], [[5.5, 20.25], [5.5, 2.0]],
                      [[4.0, 4.0], [4.0, 4.0]]], np.float32)
    poly = np.array([[[4.0, 3.0], [25.0, 5.0], [20.0, 20.0], [6.0, 15.0]],
                     [[10.5, 2.0], [30.0, 12.0], [12.0, 22.5],
                      [2.0, 11.0]]], np.float32)
    # the reference's draws from one program (each op rounding as eagerly)
    want = exact_jit(lambda im, r, c, p, ln, pg: dict(
        rect=[j_draw.draw_rectangle(im, r, c, f) for f in (False, True)],
        point=j_draw.draw_point2d(im[0], p, c),
        line=[j_draw.draw_line(im[1], a, b, c) for a, b in ln],
        poly=j_draw.draw_convex_polygon(im, pg, c)),
        img, rect, col, pts, lines, poly)
    for fill, w in zip((False, True), want["rect"]):
        _eq(t_draw.draw_rectangle(_t(img), _t(rect), _t(col), fill), w)
    _eq(t_draw.draw_point2d(_t(img[0]), _t(pts), _t(col)), want["point"])
    for (p1, p2), w in zip(lines, want["line"]):
        _eq(t_draw.draw_line(_t(img[1]), _t(p1), _t(p2), _t(col)), w)
    _eq(t_draw.draw_convex_polygon(_t(img), _t(poly), _t(col)),
        want["poly"])


def test_draw_rectangle_mirrored():
    out = t_draw.draw_rectangle(torch.zeros((1, 3, 10, 10)),
                                _t([[[2.0, 2, 7, 7]]]), _t([1.0, 0, 0]),
                                fill=True)
    assert float(out[0, 0, 4, 4]) == 1.0 and float(out[0, 1, 4, 4]) == 0.0
    assert float(out[0, 0, 0, 0]) == 0.0


def test_image_utils_against_the_reference():
    rng = np.random.default_rng(9)
    ims = [rng.random((6, 5, 3)).astype(np.float32) for _ in range(3)]
    _eq(t_iutils.image_list_to_tensor([_t(i) for i in ims]),
        j_iutils.image_list_to_tensor(ims))
    with pytest.raises(ValueError):
        t_iutils.image_list_to_tensor([])
    batch = rng.random((5, 2, 4, 3)).astype(np.float32)
    for n_row, pad in ((None, 2), (2, 1), (5, 0)):
        _eq(t_iutils.make_grid(_t(batch), n_row, pad),
            j_iutils.make_grid(batch, n_row, pad))

    def fn_t(x):
        return x.flip(-1) * 2.0

    def fn_j(x):
        return jnp.flip(x, -1) * 2.0

    # the shapes the reference takes: it fails on (C, H, W), and on
    # (C, T, H, W) for video
    for shape in ((2, 3, 4, 5), (2, 2, 3, 4, 5)):
        x = rng.random(shape).astype(np.float32)
        _eq(t_iutils.perform_keep_shape_image(fn_t)(_t(x)),
            j_iutils.perform_keep_shape_image(fn_j)(x))
    for shape in ((2, 3, 2, 4, 5), (1, 2, 3, 2, 4, 5)):
        x = rng.random(shape).astype(np.float32)
        _eq(t_iutils.perform_keep_shape_video(fn_t)(_t(x)),
            j_iutils.perform_keep_shape_video(fn_j)(x))


@pytest.mark.parametrize("shape,max_width", [((3, 7, 9), 80), ((1, 6, 5), 80),
                                             ((3, 12, 20), 8)])
def test_image_print_identical_strings(shape, max_width, capsys):
    x = np.random.default_rng(10).random(shape).astype(np.float32)
    want = j_print.image_to_string(x, max_width)
    assert t_print.image_to_string(_t(x), max_width) == want
    assert t_print.image_to_string(_t(x[0]), max_width) == \
        j_print.image_to_string(x[0], max_width)
    u8 = (x * 255).astype(np.uint8)
    assert t_print.image_to_string(_t(u8), max_width) == \
        j_print.image_to_string(u8, max_width)
    t_print.print_image(_t(x), max_width)
    assert capsys.readouterr().out == want + "\n"


# --- utils/misc.py, core/module.py, the image package's exports -------------

def test_utils_misc_against_the_reference():
    rng = np.random.default_rng(11)
    for shape in ((6, 5), (6, 5, 3), (2, 6, 5, 3)):
        a = _u8(int(np.prod(shape)), shape)
        for keepdim in (True, False):
            got = t_misc.image_to_tensor(a, keepdim, device="cpu")
            assert got.dtype == torch.uint8
            _eq(got, j_misc.image_to_tensor(a, keepdim))
    with pytest.raises(ValueError):
        t_misc.image_to_tensor(np.zeros(3), device="cpu")
    for shape in ((3, 6, 5), (1, 6, 5), (1, 3, 6, 5), (2, 1, 6, 5)):
        x = rng.random(shape).astype(np.float32)
        for keepdim in (False, True):
            _eq(t_misc.tensor_to_image(_t(x), keepdim),
                j_misc.tensor_to_image(x, keepdim))
    x = rng.random((21, 3, 4)).astype(np.float32)
    for chunk in (4, 7, 32):
        _close(t_misc.batched_forward(lambda c: c.sum(-1) * 2.0, _t(x),
                                      chunk),
               j_misc.batched_forward(lambda c: c.sum(-1) * 2.0, x, chunk),
               1e-6)


def test_image_to_tensor_module():
    a = _u8(12, (6, 5, 3))
    mod = t_image.ImageToTensor(keepdim=False, device="cpu")
    assert type(mod).__name__ == "ImageToTensor"
    assert repr(mod) == "ImageToTensor(keepdim=False, device='cpu')"
    _eq(mod(a), j_image.ImageToTensor(keepdim=False)(a))
    assert callable(t_image.print_image)


# --- core/check.py -----------------------------------------------------------

def test_check_names_and_toggle():
    img = torch.zeros((2, 3, 4, 5))
    for mod, arr in ((t_check, img), (j_check, jnp.zeros((2, 3, 4, 5)))):
        mod.check_same_shape(arr, arr)
        mod.check_same_dtype(arr, arr)
        mod.check_is_image(arr)
        mod.check_is_color(arr)
    for bad, err in (
            (lambda: t_check.check_same_shape(img, img[0]), ValueError),
            (lambda: t_check.check_same_dtype(img, img.double()), ValueError),
            (lambda: t_check.check_is_image(img[0, 0]), ValueError),
            (lambda: t_check.check_is_image(img.to(torch.uint8)), TypeError),
            (lambda: t_check.check_is_gray(img), ValueError),
            (lambda: t_check.check_is_color(img[:, :1]), ValueError),
            (lambda: t_check.check(False, "x"), ValueError),
            (lambda: t_check.check_shape(img, ["B", "3", "5", "5"]),
             ValueError)):
        with pytest.raises(err):
            bad()
    t_check.check_is_gray(img[:, :1])
    assert t_check.checks_enabled()
    t_check.disable_checks()
    try:
        assert not t_check.checks_enabled()
        t_check.check_is_gray(img)
        t_check.check(False)
        t_check.check_shape(img, ["1"])
        t_check.check_same_shape(img, img[0])
    finally:
        t_check.enable_checks()
    assert t_check.checks_enabled()
    with pytest.raises(ValueError):
        t_check.check_is_gray(img)
