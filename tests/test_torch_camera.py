"""The port's camera models (kornia_tpu_torch.geometry.camera), lens
distortion (geometry/calibration.py), ``remap`` and the pixel-coordinate
normalisers against the JAX package on the CPU.

Inputs are seeded numpy; each JAX function runs jitted. Tolerance: 1e-5
relative to the largest entry of the reference's output (closed forms,
Jacobians included), and 1e-4 px after the iterative inverses (Newton for
Kannala-Brandt, the fixed-point iteration for Brown-Conrady) and for the
remapped images; the round trips hold to 1e-4 px (Kannala-Brandt) and
1e-3 px (Brown-Conrady, whose inverse stops after five steps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.core import grid as j_grid
from kornia_tpu.geometry import calibration as j_cal
from kornia_tpu.geometry import camera as j_cam
from kornia_tpu.ops import warp as j_warp
from kornia_tpu_torch.core import grid as t_grid
from kornia_tpu_torch.geometry import calibration as t_cal
from kornia_tpu_torch.geometry import camera as t_cam
from kornia_tpu_torch.ops import warp as t_warp
from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
PX_TOL = 1e-4


def _rng(seed):
    return np.random.default_rng(seed)


def _f32(a):
    return np.asarray(a, np.float32)


def _close_rel(out, ref, rel=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _K(batch=(), w=160.0, h=120.0):
    K = np.array([[0.8 * w, 0, w / 2 + 1.5], [0, 0.75 * w, h / 2 - 2.0],
                  [0, 0, 1]], np.float32)
    return np.broadcast_to(K, (*batch, 3, 3)).copy()


def _points3d(seed, *shape):
    r = _rng(seed)
    p = r.uniform(-1.0, 1.0, (*shape, 3))
    p[..., 2] = r.uniform(1.0, 4.0, shape)
    return _f32(p)


def _pixels(seed, *shape, w=160, h=120):
    r = _rng(seed)
    return _f32(np.stack([r.uniform(0, w - 1, shape),
                          r.uniform(0, h - 1, shape)], -1))


KB = _f32([[150.0, 140.0, 81.0, 58.0, 0.05, -0.02, 0.006, -0.001]])
AFF = _f32([[150.0, 140.0, 81.0, 58.0]])
# a wide-angle lens's distortion (18 px at the corners of 480x640 with
# f = 0.8 W); the fixed five steps of the inverse then return to 3e-4 px
DIST5 = _f32([[-0.1, 0.02, 1e-3, -5e-4, -0.005]])
DIST14 = _f32([[-0.1, 0.02, 1e-3, -5e-4, -0.005, 0.01, -2e-3, 5e-4, 1e-3,
                -5e-4, 8e-4, -3e-4, 0.0, 0.0]])
ROUND_TRIP_PX = 1e-3


def _cases():
    """name -> (JAX function, port function, numpy arguments)."""
    z1 = _f32(_rng(3).uniform(-0.8, 0.8, (2, 50, 2)))
    cams = dict(
        project_points=(j_cam.project_points, t_cam.project_points,
                        (_points3d(1, 2, 40), _K((2, 1)))),
        unproject_points=(j_cam.unproject_points, t_cam.unproject_points,
                          (_pixels(2, 2, 40), _f32(_rng(2).uniform(
                              1, 5, (2, 40))), _K((2, 1)))),
        unproject_points_normalized=(
            lambda p, d, k: j_cam.unproject_points(p, d, k, True),
            lambda p, d, k: t_cam.unproject_points(p, d, k, True),
            (_pixels(4, 2, 40), _f32(_rng(4).uniform(1, 5, (2, 40, 1))),
             _K((2, 1)))),
        project_points_z1=(j_cam.project_points_z1, t_cam.project_points_z1,
                           (_points3d(5, 3, 20),)),
        unproject_points_z1=(j_cam.unproject_points_z1,
                             t_cam.unproject_points_z1,
                             (z1, _f32(_rng(6).uniform(1, 3, (2, 50))))),
        unproject_points_z1_default=(j_cam.unproject_points_z1,
                                     t_cam.unproject_points_z1, (z1,)),
        project_points_orthographic=(j_cam.project_points_orthographic,
                                     t_cam.project_points_orthographic,
                                     (_points3d(7, 30),)),
        unproject_points_orthographic=(
            j_cam.unproject_points_orthographic,
            t_cam.unproject_points_orthographic,
            (z1, _f32(_rng(8).uniform(1, 3, (2, 50))))),
        distort_points_affine=(j_cam.distort_points_affine,
                               t_cam.distort_points_affine, (z1, AFF)),
        undistort_points_affine=(j_cam.undistort_points_affine,
                                 t_cam.undistort_points_affine,
                                 (_pixels(9, 2, 50), AFF)),
        distort_points_kannala_brandt=(j_cam.distort_points_kannala_brandt,
                                       t_cam.distort_points_kannala_brandt,
                                       (z1, KB)),
        dx_distort_points_affine=(j_cam.dx_distort_points_affine,
                                  t_cam.dx_distort_points_affine, (z1, AFF)),
        dx_distort_points_kannala_brandt=(
            j_cam.dx_distort_points_kannala_brandt,
            t_cam.dx_distort_points_kannala_brandt, (z1, KB)),
        dx_project_points_z1=(j_cam.dx_project_points_z1,
                              t_cam.dx_project_points_z1,
                              (_points3d(10, 2, 25),)),
        dx_project_points_orthographic=(j_cam.dx_project_points_orthographic,
                                        t_cam.dx_project_points_orthographic,
                                        (_points3d(11, 2, 25),)),
        cam2pixel=(j_cam.cam2pixel, t_cam.cam2pixel,
                   (_points3d(12, 2, 6, 8), _f32(np.concatenate([
                       np.concatenate([_K((2,)), np.zeros((2, 3, 1))], -1),
                       np.broadcast_to([[[0, 0, 0, 1]]], (2, 1, 4))], -2)))),
        pixel2cam=(j_cam.pixel2cam, t_cam.pixel2cam,
                   (_f32(_rng(13).uniform(1, 4, (2, 1, 6, 8))),
                    _f32(np.broadcast_to(np.linalg.inv(np.pad(
                        _K(), ((0, 1), (0, 1))) + np.diag([0, 0, 0, 1])),
                        (2, 4, 4))),
                    _pixels(14, 2, 6, 8))),
        distort_points=(j_cal.distort_points, t_cal.distort_points,
                        (_pixels(15, 1, 60), _K((1,)), DIST5)),
        distort_points_14=(j_cal.distort_points, t_cal.distort_points,
                           (_pixels(16, 1, 60), _K((1,)), DIST14,
                            _K((1,), 170.0, 110.0))),
        tilt_projection=(j_cal.tilt_projection, t_cal.tilt_projection,
                         (_f32([0.02, -0.05]), _f32([0.03, 0.01]))),
        tilt_projection_inverse=(
            lambda a, b: j_cal.tilt_projection(a, b, True),
            lambda a, b: t_cal.tilt_projection(a, b, True),
            (_f32(0.04), _f32(-0.02))),
        normalize_pixel_coordinates=(
            lambda p: j_grid.normalize_pixel_coordinates(p, 120, 160),
            lambda p: t_grid.normalize_pixel_coordinates(p, 120, 160),
            (_pixels(17, 2, 30),)),
        denormalize_pixel_coordinates=(
            lambda p: j_grid.denormalize_pixel_coordinates(p, 120, 160),
            lambda p: t_grid.denormalize_pixel_coordinates(p, 120, 160),
            (_f32(_rng(18).uniform(-1, 1, (2, 30, 2))),)),
    )
    return cams


_CASES = _cases()


def _flat(x):
    return [np.asarray(v) for v in (x if isinstance(x, tuple) else (x,))]


@pytest.mark.parametrize("name", sorted(_CASES))
def test_closed_forms_match_reference(name):
    jfn, tfn, args = _CASES[name]
    ref = _flat(jax.jit(jfn)(*[jnp.asarray(a) for a in args]))
    out = _flat(tfn(*[torch.from_numpy(a.copy()) for a in args]))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        _close_rel(o, r)


# ----------------------------------------------------------------------------
# the iterative inverses and their round trips
# ----------------------------------------------------------------------------

def test_undistort_kannala_brandt_matches_reference_and_inverts():
    z1 = _f32(_rng(21).uniform(-0.8, 0.8, (2, 50, 2)))
    px = t_cam.distort_points_kannala_brandt(torch.from_numpy(z1),
                                            torch.from_numpy(KB))
    ref = np.asarray(jax.jit(j_cam.undistort_points_kannala_brandt)(
        jnp.asarray(px.numpy()), jnp.asarray(KB)))
    out = t_cam.undistort_points_kannala_brandt(px, torch.from_numpy(KB))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=PX_TOL)
    # the round trip, in pixels
    back = t_cam.distort_points_kannala_brandt(out, torch.from_numpy(KB))
    np.testing.assert_allclose(back.numpy(), px.numpy(), rtol=0, atol=PX_TOL)


@pytest.mark.parametrize("dist", ["5", "14"])
def test_undistort_points_matches_reference_and_inverts(dist):
    d = {"5": DIST5, "14": DIST14}[dist]
    K = _K((1,))
    pts = _pixels(22, 1, 80, w=160, h=120)
    dist_px = t_cal.distort_points(torch.from_numpy(pts), torch.from_numpy(K),
                                   torch.from_numpy(d))
    ref = np.asarray(jax.jit(j_cal.undistort_points)(
        jnp.asarray(dist_px.numpy()), jnp.asarray(K), jnp.asarray(d)))
    out = t_cal.undistort_points(dist_px, torch.from_numpy(K),
                                 torch.from_numpy(d))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(out.numpy(), pts, rtol=0, atol=ROUND_TRIP_PX)
    new_K = _K((1,), 170.0, 110.0)
    ref2 = np.asarray(jax.jit(j_cal.undistort_points)(
        jnp.asarray(dist_px.numpy()), jnp.asarray(K), jnp.asarray(d),
        jnp.asarray(new_K)))
    out2 = t_cal.undistort_points(dist_px, torch.from_numpy(K),
                                  torch.from_numpy(d),
                                  torch.from_numpy(new_K))
    np.testing.assert_allclose(out2.numpy(), ref2, rtol=0, atol=PX_TOL)


def test_undistort_image_matches_reference():
    r = _rng(23)
    img = _f32(r.random((2, 3, 32, 48)))
    K = _K((2,), 48.0, 32.0)
    d = np.repeat(DIST5, 2, 0)
    ref = np.asarray(jax.jit(j_cal.undistort_image)(
        jnp.asarray(img), jnp.asarray(K), jnp.asarray(d)))
    out = t_cal.undistort_image(torch.from_numpy(img), torch.from_numpy(K),
                                torch.from_numpy(d))
    assert out.shape == img.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=PX_TOL)
    # without distortion it is the identity
    ident = t_cal.undistort_image(torch.from_numpy(img), torch.from_numpy(K),
                                  torch.zeros(2, 5))
    np.testing.assert_allclose(ident.numpy(), img, atol=1e-5)


@pytest.mark.parametrize("normalized", [False, True])
def test_remap_matches_reference(normalized):
    r = _rng(24)
    img = _f32(r.random((2, 2, 20, 30)))
    mx = _f32(r.uniform(-2, 31, (20, 30)))
    my = _f32(r.uniform(-2, 21, (20, 30)))
    if normalized:
        mx, my = 2 * mx / 29 - 1, 2 * my / 19 - 1
    ref = np.asarray(jax.jit(lambda a, b, c: j_warp.remap(
        a, b, c, normalized_coordinates=normalized))(
        jnp.asarray(img), jnp.asarray(mx), jnp.asarray(my)))
    out = t_warp.remap(torch.from_numpy(img), torch.from_numpy(mx),
                       torch.from_numpy(my),
                       normalized_coordinates=normalized)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=PX_TOL)


# ----------------------------------------------------------------------------
# PinholeCamera and StereoCamera
# ----------------------------------------------------------------------------

def _pinhole_args():
    return ([150.0, 160.0], [140.0, 150.0], [80.0, 81.0], [60.0, 59.0],
            120, 160, [0.1, -0.2], None, [0.5, 1.0])


def _jax_pinhole():
    fx, fy, cx, cy, h, w, tx, ty, tz = _pinhole_args()
    return j_cam.PinholeCamera.from_parameters(
        jnp.asarray(fx), jnp.asarray(fy), jnp.asarray(cx), jnp.asarray(cy),
        h, w, jnp.asarray(tx), ty, jnp.asarray(tz))


def _port_pinhole():
    fx, fy, cx, cy, h, w, tx, ty, tz = _pinhole_args()
    return t_cam.PinholeCamera.from_parameters(
        torch.tensor(fx), torch.tensor(fy), torch.tensor(cx),
        torch.tensor(cy), h, w, torch.tensor(tx), ty, torch.tensor(tz))


def test_pinhole_camera_matches_reference():
    jc, tc = _jax_pinhole(), _port_pinhole()
    for f in ("intrinsics", "extrinsics", "height", "width", "fx", "fy", "cx",
              "cy", "tx", "ty", "tz", "camera_matrix", "rotation_matrix",
              "translation_vector"):
        _close_rel(getattr(tc, f).numpy(), getattr(jc, f))
    assert tc.batch_size == jc.batch_size == 2
    _close_rel(tc.intrinsics_inverse().numpy(), jc.intrinsics_inverse())
    pts = _points3d(25, 2, 30)
    proj = jax.jit(lambda c, p: c.project(p))(jc, jnp.asarray(pts))
    _close_rel(tc.project(torch.from_numpy(pts)).numpy(), proj)
    depth = _f32(_rng(26).uniform(1, 4, (2, 30)))
    uv = _pixels(27, 2, 30)
    unp = jax.jit(lambda c, p, d: c.unproject(p, d))(
        jc, jnp.asarray(uv), jnp.asarray(depth))
    _close_rel(tc.unproject(torch.from_numpy(uv),
                            torch.from_numpy(depth)).numpy(), unp)
    js, ts = jc.scale(0.5), tc.scale(0.5)
    for f in ("intrinsics", "extrinsics", "height", "width"):
        _close_rel(getattr(ts, f).numpy(), getattr(js, f))
    # project ∘ unproject is the identity on pixels
    back = tc.project(tc.unproject(torch.from_numpy(uv),
                                   torch.from_numpy(depth)))
    np.testing.assert_allclose(back.numpy(), uv, atol=PX_TOL)


def test_pinhole_camera_from_numbers_takes_device():
    """Built from plain numbers, the camera lies on `device` and equals the
    one built from tensors; given a tensor, it follows that tensor."""
    fx, fy, cx, cy, h, w, tx, ty, tz = _pinhole_args()
    nums = t_cam.PinholeCamera.from_parameters(
        fx[0], fy[0], cx[0], cy[0], h, w, tx[0], ty, tz[0], device="cpu")
    tens = t_cam.PinholeCamera.from_parameters(
        torch.tensor(fx[:1]), fy[0], cx[0], cy[0], h, w, tx[0], ty, tz[0],
        device="meta")
    for f in ("intrinsics", "extrinsics", "height", "width"):
        assert getattr(nums, f).device.type == "cpu"
        assert getattr(tens, f).device.type == "cpu"
        torch.testing.assert_close(getattr(nums, f), getattr(tens, f),
                                   atol=0, rtol=0)
    ref = j_cal.tilt_projection(jnp.float32(0.04), jnp.float32(-0.02))
    out = t_cal.tilt_projection(0.04, -0.02, device="cpu")
    assert out.dtype == torch.float32
    _close_rel(out.numpy(), ref)


def _rig(B=2):
    f, cx, cy, b = 128.0, 80.0, 60.0, 0.12
    left = np.zeros((B, 3, 4), np.float32)
    left[:, 0, 0] = left[:, 1, 1] = f
    left[:, 0, 2], left[:, 1, 2], left[:, 2, 2] = cx, cy, 1.0
    right = left.copy()
    right[:, 0, 2] = cx + 1.5
    right[:, 0, 3] = -f * b
    return left, right


def test_stereo_camera_matches_reference():
    left, right = _rig()
    jc = j_cam.StereoCamera(jnp.asarray(left), jnp.asarray(right))
    tc = t_cam.StereoCamera(torch.from_numpy(left), torch.from_numpy(right))
    for f in ("fx", "fy", "cx_left", "cx_right", "cy", "tx", "Q"):
        _close_rel(getattr(tc, f).numpy(), getattr(jc, f))
    disp = _f32(_rng(28).uniform(2, 30, (2, 1, 12, 16)))
    ref = jax.jit(lambda c, d: c.reproject_disparity_to_3D(d))(
        jc, jnp.asarray(disp))
    out = tc.reproject_disparity_to_3D(torch.from_numpy(disp))
    assert out.shape == (2, 12, 16, 3)
    _close_rel(out.numpy(), ref)
