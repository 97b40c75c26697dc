"""The rest of the port's geometry against the JAX package on the CPU:
``geometry/{linalg,conversions,epipolar,subpix,pose,pointcloud,transform}``
and the package's ``Affine`` and ``AdaptiveQuadInterp3d``.

Each module's JAX references come from one jitted program
(``batch_references``). Tolerances: 1e-5 absolute by default; 1e-4 for the
iterative quadratic fit and the decompositions (QR, determinants of 4x4
row pairs); 1e-5 relative for pixel coordinates and focal lengths
(hundreds of pixels, where one float32 ulp is above 1e-5); 0 for NMS
masks. The canonical projection pair is compared up to the sign of the
epipole, which is LAPACK's choice in both libraries.
PLY files written by either library are read back bit for bit by the
other.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kornia_tpu.geometry as jgeo
import kornia_tpu.geometry.conversions as jc
import kornia_tpu.geometry.epipolar as je
import kornia_tpu.geometry.linalg as jl
import kornia_tpu.geometry.pointcloud as jpc
import kornia_tpu.geometry.subpix as js
import kornia_tpu_torch.geometry as tgeo
import kornia_tpu_torch.geometry.conversions as tc
import kornia_tpu_torch.geometry.epipolar as te
import kornia_tpu_torch.geometry.linalg as tl
import kornia_tpu_torch.geometry.pointcloud as tpc
import kornia_tpu_torch.geometry.subpix as ts
from kornia_tpu.geometry.liegroup import Quaternion as JQ
from kornia_tpu.geometry.liegroup import Se3 as JSe3
from kornia_tpu.geometry.liegroup import So3 as JSo3
from kornia_tpu.geometry.pose import NamedPose as JNamedPose
from kornia_tpu_torch.convert import se3_from_numpy
from kornia_tpu_torch.geometry.pose import NamedPose, check_matrix_shape
from tests.torch_op_parity import (Case, batch_references, check_close, rand,
                                   run_case)
from tests.torch_threads import one_torch_thread  # noqa: F401


def _rodrigues(aa: np.ndarray) -> np.ndarray:
    th = np.linalg.norm(aa, axis=-1)[..., None, None]
    k = aa / np.linalg.norm(aa, axis=-1, keepdims=True)
    Kx = np.zeros(aa.shape[:-1] + (3, 3))
    Kx[..., 0, 1], Kx[..., 0, 2] = -k[..., 2], k[..., 1]
    Kx[..., 1, 0], Kx[..., 1, 2] = k[..., 2], -k[..., 0]
    Kx[..., 2, 0], Kx[..., 2, 1] = -k[..., 1], k[..., 0]
    return (np.eye(3) + np.sin(th) * Kx
            + (1 - np.cos(th)) * Kx @ Kx).astype(np.float32)


AA = rand(4, 3, lo=-1.2, hi=1.2, seed=1)
R = _rodrigues(AA)
T = rand(4, 3, 1, lo=-1.0, hi=1.0, seed=2)
QUAT = rand(4, 4, lo=-1.0, hi=1.0, seed=3)
QUAT /= np.linalg.norm(QUAT, axis=-1, keepdims=True)
PTS = rand(2, 6, 2, lo=-2.0, hi=2.0, seed=4)
PTS3 = rand(2, 6, 3, lo=-2.0, hi=2.0, seed=5)
PTS_H = np.concatenate([PTS, rand(2, 6, 1, lo=0.5, hi=1.5, seed=6)], -1)
PTS_H[0, 0, 2] = 0.0  # the guarded divide at w = 0
AFF = rand(2, 2, 3, lo=-1.0, hi=1.0, seed=7)
AFF3 = rand(2, 3, 4, lo=-1.0, hi=1.0, seed=8)
M44 = np.concatenate([np.concatenate([R, T], -1),
                      np.tile(np.array([[[0, 0, 0, 1]]], np.float32),
                              (4, 1, 1))], -2)
H44 = (np.eye(4, dtype=np.float32) + 0.05 * rand(1, 4, 4, seed=9))
KMAT = np.tile(np.array([[[520.0, 0.0, 320.0], [0.0, 510.0, 240.0],
                          [0.0, 0.0, 1.0]]], np.float32), (2, 1, 1))
KMAT[1, 0, 1] = 1.5  # a skew
ANGLES = rand(3, 2, lo=-180.0, hi=180.0, seed=10)

CONVERSIONS = {
    "rad2deg": Case("rad2deg", (AA,)),
    "deg2rad": Case("deg2rad", (ANGLES,)),
    "pol2cart": Case("pol2cart", (AA[:, 0], AA[:, 1])),
    "cart2pol": Case("cart2pol", (AA[:, 0], AA[:, 1])),
    "convert_points_from_homogeneous": Case(
        "convert_points_from_homogeneous", (PTS_H,)),
    "convert_points_to_homogeneous": Case("convert_points_to_homogeneous",
                                          (PTS,)),
    "convert_affinematrix_to_homography": Case(
        "convert_affinematrix_to_homography", (AFF,)),
    "convert_affinematrix_to_homography3d": Case(
        "convert_affinematrix_to_homography3d", (AFF3,)),
    "rotation_matrix_to_angle_axis": Case("rotation_matrix_to_angle_axis",
                                          (R,)),
    "rotation_matrix_to_axis_angle": Case("rotation_matrix_to_axis_angle",
                                          (R,)),
    "axis_angle_to_quaternion": Case("axis_angle_to_quaternion", (AA,)),
    "quaternion_to_axis_angle": Case("quaternion_to_axis_angle", (QUAT,)),
    "quaternion_log_to_exp": Case("quaternion_log_to_exp", (AA,)),
    "quaternion_exp_to_log": Case("quaternion_exp_to_log", (QUAT,)),
    "euler_from_quaternion": Case("euler_from_quaternion",
                                  tuple(QUAT[:, i] for i in range(4))),
    "quaternion_from_euler": Case("quaternion_from_euler",
                                  (AA[:, 0], AA[:, 1], AA[:, 2])),
    "normalize_homography3d": Case("normalize_homography3d",
                                   (H44, (4, 5, 6), (3, 7, 5))),
    "normal_transform_pixel3d": Case("normal_transform_pixel3d", (4, 5, 6)),
    "denormalize_points_with_intrinsics": Case(
        "denormalize_points_with_intrinsics", (PTS, KMAT), rtol=1e-5),
    "Rt_to_matrix4x4": Case("Rt_to_matrix4x4", (R, T)),
    "matrix4x4_to_Rt": Case("matrix4x4_to_Rt", (M44,)),
    "camtoworld_to_worldtocam_Rt": Case("camtoworld_to_worldtocam_Rt",
                                        (R, T)),
    "worldtocam_to_camtoworld_Rt": Case("worldtocam_to_camtoworld_Rt",
                                        (R, T)),
    "camtoworld_graphics_to_vision_4x4": Case(
        "camtoworld_graphics_to_vision_4x4", (M44,)),
    "camtoworld_vision_to_graphics_4x4": Case(
        "camtoworld_vision_to_graphics_4x4", (M44,)),
    "camtoworld_graphics_to_vision_Rt": Case(
        "camtoworld_graphics_to_vision_Rt", (R, T)),
    "camtoworld_vision_to_graphics_Rt": Case(
        "camtoworld_vision_to_graphics_Rt", (R, T)),
    "ARKitQTVecs_to_ColmapQTVecs": Case("ARKitQTVecs_to_ColmapQTVecs",
                                        (QUAT, T[..., 0])),
    "angle_to_rotation_matrix": Case("angle_to_rotation_matrix", (ANGLES,)),
}

LINES = rand(2, 6, 3, lo=-1.0, hi=1.0, seed=11)
LINALG = {
    "point_line_distance": Case("point_line_distance", (PTS_H, LINES)),
    "squared_norm": Case("squared_norm", (PTS3,)),
    "squared_norm_keepdim": Case("squared_norm", (PTS3, True)),
    "batched_dot_product": Case("batched_dot_product", (PTS3, PTS3[::-1])),
    "euclidean_distance": Case("euclidean_distance", (PTS3, PTS3[::-1])),
    "batched_squared_norm": Case("batched_squared_norm", (PTS3, True)),
}

# two cameras looking at the same points: E = [t]x R, F = K2^-T E K1^-1
E_TRUE = np.stack([np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                             [-t[1], t[0], 0]], np.float32) @ r
                   for r, t in zip(R[:2], T[:2, :, 0])])
E_TRUE /= np.linalg.norm(E_TRUE, axis=(-2, -1), keepdims=True)
F_MAT = (np.linalg.inv(KMAT).transpose(0, 2, 1) @ E_TRUE
         @ np.linalg.inv(KMAT)).astype(np.float32)
P1 = (KMAT @ np.concatenate([R[:2], T[:2]], -1)).astype(np.float32)
P2 = (KMAT @ np.concatenate([R[2:], T[2:]], -1)).astype(np.float32)
IMG = rand(2, 3, 8, 10, seed=12)
XW = rand(2, 6, 3, lo=-1.0, hi=1.0, seed=13) + np.array([0, 0, 4],
                                                          np.float32)
EPIPOLAR = {
    "essential_from_fundamental": Case("essential_from_fundamental",
                                       (F_MAT, KMAT, KMAT)),
    "KRt_from_projection": Case("KRt_from_projection", (P1,), atol=1e-4,
                                rtol=1e-5),
    "fundamental_from_projections": Case(
        "fundamental_from_projections", (P1 / 500.0, P2 / 500.0),
        atol=1e-4),
    "cross_product_matrix": Case("cross_product_matrix", (AA,)),
    "intrinsics_like": Case("intrinsics_like", (500.0, IMG)),
    "scale_intrinsics": Case("scale_intrinsics", (KMAT, 0.5)),
    "scale_intrinsics_batch": Case("scale_intrinsics",
                                   (KMAT, np.array([0.5, 2.0], np.float32))),
    "projection_from_Rt": Case("projection_from_Rt", (R, T)),
    "depth_from_point": Case("depth_from_point", (R[:2], T[:2], XW)),
    "get_perpendicular": Case("get_perpendicular", (LINES, PTS)),
    "get_closest_point_on_epipolar_line": Case(
        "get_closest_point_on_epipolar_line", (PTS * 100 + 300,
                                               PTS[::-1] * 100 + 300, F_MAT),
        atol=1e-3),
    "matrix_cofactor_tensor": Case("matrix_cofactor_tensor", (R,)),
    "decompose_essential_matrix_no_svd": Case(
        "decompose_essential_matrix_no_svd", (E_TRUE,)),
}


def _smooth(v: np.ndarray) -> np.ndarray:
    """Three passes of a 3-tap mean along H and W: a response with
    isolated extrema."""
    for _ in range(3):
        v = (np.roll(v, 1, -1) + v + np.roll(v, -1, -1)) / 3
        v = (np.roll(v, 1, -2) + v + np.roll(v, -1, -2)) / 3
    return v.astype(np.float32)


HEAT = rand(2, 3, 7, 9, seed=14, lo=-2.0, hi=2.0)
VOL = _smooth(rand(1, 2, 5, 12, 12, seed=15))
NMS_VOL = js.nms3d(jnp.asarray(VOL), (3, 3, 3), True)
MEANS = rand(2, 3, 2, lo=-0.8, hi=0.8, seed=16)
STDS = rand(2, 3, 2, lo=0.2, hi=0.5, seed=17)


def _adaptive(mod, mode):
    return lambda v: mod.AdaptiveQuadInterp3d(mode)(v)


def _affine(mod):
    return lambda x, a, t, s, sh: mod.Affine(a, t, s, sh)(x)


SUBPIX = {
    "spatial_softmax2d": Case("spatial_softmax2d", (HEAT, 2.0)),
    "spatial_expectation2d": Case("spatial_expectation2d",
                                  (HEAT * 0 + 1 / 63.0,)),
    "spatial_soft_argmax2d": Case("spatial_soft_argmax2d", (HEAT,)),
    "spatial_soft_argmax2d_pixels": Case("spatial_soft_argmax2d",
                                         (HEAT, 3.0, False)),
    "render_gaussian2d": Case("render_gaussian2d", (MEANS, STDS, (8, 10))),
    "conv_soft_argmax2d": Case("conv_soft_argmax2d", (HEAT,)),
    "conv_soft_argmax2d_value": Case(
        "conv_soft_argmax2d", (HEAT, (3, 3), (2, 2), (1, 1), 0.5, False,
                               True)),
    "conv_soft_argmax3d": Case("conv_soft_argmax3d", (VOL,)),
    "conv_soft_argmax3d_norm": Case(
        "conv_soft_argmax3d", (VOL, (3, 3, 3), (1, 2, 2), (1, 1, 1), 2.0,
                               True, False)),
    "conv_quad_interp3d": Case("conv_quad_interp3d", (VOL,)),
    "conv_quad_interp3d_planes": Case("conv_quad_interp3d_planes",
                                      (VOL, 0.0)),
    "nms3d_minmax": Case("nms3d_minmax", (VOL,), atol=0),
    "iterative_quad_interp3d": Case("iterative_quad_interp3d", (VOL,),
                                    atol=1e-4),
    "iterative_quad_interp3d_fixed_scale": Case(
        "iterative_quad_interp3d", (VOL, 3, 5.0, 0.6, False,
                                    np.asarray(NMS_VOL)), atol=1e-4),
    "adaptive_patch": Case("", (VOL,), atol=1e-4,
                           jax_fn=_adaptive(jgeo, "patch"),
                           torch_fn=_adaptive(tgeo, "patch")),
    "adaptive_auto": Case("", (VOL,), jax_fn=_adaptive(jgeo, "auto"),
                          torch_fn=_adaptive(tgeo, "auto")),
    "affine": Case("", (IMG, np.array([30.0, -15.0], np.float32),
                        np.array([[1.5, -2.0], [0.0, 1.0]], np.float32),
                        np.array([[1.2, 0.9], [1.0, 1.0]], np.float32),
                        np.array([[0.1, 0.0], [0.0, -0.2]], np.float32)),
                   jax_fn=_affine(jgeo), torch_fn=_affine(tgeo)),
}

MODULES = {"conversions": (CONVERSIONS, jc, tc), "linalg": (LINALG, jl, tl),
           "epipolar": (EPIPOLAR, je, te), "subpix": (SUBPIX, js, ts)}


@pytest.fixture(scope="module")
def refs():
    """Every module's references, one program a module."""
    return {m: batch_references(cases, jmod)
            for m, (cases, jmod, _) in MODULES.items()}


@pytest.mark.parametrize("module,name", [(m, n) for m, (cases, _, _) in
                                         MODULES.items() for n in cases])
def test_geometry_matches_reference(module, name, refs):
    cases, _, tmod = MODULES[module]
    run_case(cases[name], tmod, refs[module][name])


def test_canonical_projections_match_up_to_the_epipole_sign():
    # E as a fundamental matrix of unit cameras: FᵀF well scaled for the
    # float32 eigensolvers of both libraries
    P1j, P2j = je.projections_from_fundamental(jnp.asarray(E_TRUE))
    P1t, P2t = te.projections_from_fundamental(torch.from_numpy(E_TRUE))
    check_close(P1t, np.asarray(P1j), 0)
    P2j = np.asarray(P2j)
    sign = np.sign((P2t.numpy() * P2j).sum((-2, -1)))[:, None, None]
    check_close(P2t * torch.from_numpy(sign), P2j, 1e-5)
    # and P2 is a valid pair for F: F ~ fundamental_from_projections
    Ft = te.fundamental_from_projections(P1t, P2t)
    Ft = Ft / torch.linalg.matrix_norm(Ft)[:, None, None]
    Fn = E_TRUE
    cos = np.abs((Ft.numpy() * Fn).sum((-2, -1)))
    np.testing.assert_allclose(cos, 1.0, atol=1e-4)


def test_krt_from_projection_recovers_the_camera():
    K, Rm, t = te.KRt_from_projection(torch.from_numpy(P1))
    np.testing.assert_allclose(K.numpy(), KMAT, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(Rm.numpy(), R[:2], atol=1e-4)
    np.testing.assert_allclose(t.numpy(), T[:2], atol=1e-4)


def test_find_essential_is_the_five_point_solver():
    p1 = torch.from_numpy(rand(1, 8, 2, lo=-0.5, hi=0.5, seed=18))
    p2 = p1 + 0.01 * torch.from_numpy(rand(1, 8, 2, seed=19))
    assert torch.equal(te.find_essential(p1, p2), te.run_5point(p1, p2))


def test_random_intrinsics_draws_in_range():
    g = torch.Generator().manual_seed(3)
    K = te.random_intrinsics(100.0, 200.0, g)
    assert K.shape == (1, 3, 3)
    vals = K[0, [0, 1, 0, 1], [0, 1, 2, 2]]
    assert bool(((vals >= 100.0) & (vals < 200.0)).all())
    assert K[0, 2, 2] == 1 and K[0, 0, 1] == 0
    K2 = te.random_intrinsics(100.0, 200.0,
                              torch.Generator().manual_seed(3))
    assert torch.equal(K, K2)


def _named(se3_cls, so3_cls, q_cls, arr):
    def build(q, t, src, dst):
        return (se3_cls(so3_cls(q_cls(arr(q))), arr(t)), src, dst)
    return build


def test_named_pose_matches_reference():
    q = QUAT[:2]
    pts = PTS3[0]
    ja = JNamedPose(JSe3(JSo3(JQ(jnp.asarray(q[0]))),
                         jnp.asarray(T[0, :, 0])), "a", "b")
    jb = JNamedPose(JSe3(JSo3(JQ(jnp.asarray(q[1]))),
                         jnp.asarray(T[1, :, 0])), "b", "c")
    ta = NamedPose(se3_from_numpy(q[0], T[0, :, 0], "cpu"), "a", "b")
    tb = NamedPose(se3_from_numpy(q[1], T[1, :, 0], "cpu"), "b", "c")
    jab, tab = ja * jb, ta * tb
    assert (tab.frame_src, tab.frame_dst) == (jab.frame_src, jab.frame_dst)
    check_close(tab.matrix(), np.asarray(jab.matrix()), 1e-5)
    check_close(tab.transform(torch.from_numpy(pts)),
                np.asarray(jab.transform(jnp.asarray(pts))), 1e-5)
    inv_t, inv_j = tab.inverse(), jab.inverse()
    assert (inv_t.frame_src, inv_t.frame_dst) == ("c", "a")
    check_close(inv_t.matrix(), np.asarray(inv_j.matrix()), 1e-5)
    check_close(NamedPose.from_rt(ta.rotation, ta.translation).matrix(),
                np.asarray(ja.matrix()), 1e-6)
    with pytest.raises(ValueError):
        ta * ta


@pytest.mark.parametrize("shape,kind,ok", [
    ((3, 3), "R", True), ((5, 2, 2), "R", True), ((4, 4), "R", False),
    ((4, 4), "RT", True), ((2, 3, 3), "RT", True), ((1, 2, 3, 3), "R", False),
    ((3,), "R", False)])
def test_check_matrix_shape_follows_reference(shape, kind, ok):
    from kornia_tpu.geometry.pose import check_matrix_shape as jcheck
    for fn, arr in ((jcheck, jnp.zeros(shape)),
                    (check_matrix_shape, torch.zeros(shape))):
        if ok:
            fn(arr, kind)
        else:
            with pytest.raises(ValueError):
                fn(arr, kind)


def test_ply_files_cross_bit_for_bit(tmp_path):
    pts = rand(30, 3, lo=-5.0, hi=5.0, seed=20)
    pts[3, 1] = np.nan  # dropped by both writers
    pts[7] = [1e-7, -2.5e8, 3.0]
    fj, ft = tmp_path / "jax.ply", tmp_path / "torch.ply"
    jpc.save_pointcloud_ply(str(fj), jnp.asarray(pts))
    tpc.save_pointcloud_ply(str(ft), torch.from_numpy(pts))
    assert fj.read_bytes() == ft.read_bytes()
    from_jax = tpc.load_pointcloud_ply(str(fj), device="cpu")
    from_torch = np.asarray(jpc.load_pointcloud_ply(str(ft)))
    want = pts[np.isfinite(pts).all(1)]
    np.testing.assert_array_equal(from_jax.numpy(), want)
    np.testing.assert_array_equal(from_torch, want)


@pytest.mark.parametrize("pkg", ["geometry", "geometry.transform", "losses",
                                 "metrics", "contrib"])
def test_package_exports_mirror_the_reference(pkg):
    """Every public name the JAX package exports resolves in the port,
    except the detectors and the model-backed task (not ported yet)."""
    import importlib
    ref = importlib.import_module("kornia_tpu." + pkg)
    port = importlib.import_module("kornia_tpu_torch." + pkg)
    waiting = {"BoxFiltering", "EdgeDetector", "FaceDetector",
               "FaceDetectorResult", "FaceKeypoint", "ObjectDetector",
               "SuperResolution"}
    missing = sorted(n for n in dir(ref) if not n.startswith("_")
                     and n not in dir(port) and n not in waiting
                     and not isinstance(getattr(ref, n), type(math)))
    assert missing == []
