"""The port's box blur, block-matching stereo (contrib/stereo.py) and depth
geometry (geometry/depth.py) against the JAX package on the CPU.

Inputs are seeded numpy; each JAX function runs jitted. Tolerances: the
box blur within 1e-6 (a [0, 1] image); disparities within 1e-4 px and the
same left-right valid mask (the soft-argmin at temperature 50 multiplies
the cost's rounding by 50 before its exponent); depth, points, normals and
warped images within 1e-5 of the largest entry of the reference's output.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.contrib import stereo as j_st
from kornia_tpu.geometry import camera as j_cam
from kornia_tpu.geometry import depth as j_depth
from kornia_tpu.ops import filters as j_filters
from kornia_tpu_torch.contrib import stereo as t_st
from kornia_tpu_torch.geometry import camera as t_cam
from kornia_tpu_torch.geometry import depth as t_depth
from kornia_tpu_torch.ops import filters as t_filters
from tests.torch_threads import one_torch_thread  # noqa: F401

RTOL = 1e-5
DISP_PX = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _close_rel(out, ref, rel=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(out), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _image(seed, *shape, sigma=1.0):
    rng = np.random.default_rng(seed)
    sig = (0,) * (len(shape) - 2) + (sigma, sigma)
    return gaussian_filter(rng.random(shape), sig).astype(np.float32)


@pytest.mark.parametrize("ks,border", [(9, "reflect"), ((3, 5), "replicate"),
                                       (4, "constant")])
@pytest.mark.parametrize("separable", [True, False])
def test_box_blur_matches_reference(ks, border, separable):
    x = _image(0, 2, 3, 24, 32)
    ref = np.asarray(jax.jit(lambda a: j_filters.box_blur(
        a, ks, border, separable))(jnp.asarray(x)))
    out = t_filters.box_blur(_t(x), ks, border, separable)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


def test_box_kernels_match_reference():
    np.testing.assert_array_equal(t_filters.get_box_kernel1d(7).numpy(),
                                  np.asarray(j_filters.get_box_kernel1d(7)))
    np.testing.assert_array_equal(
        t_filters.get_box_kernel2d((3, 5)).numpy(),
        np.asarray(j_filters.get_box_kernel2d((3, 5))))


# ----------------------------------------------------------------------------
# stereo
# ----------------------------------------------------------------------------

D = 8


def _pair(seed=1, h=32, w=48, c=1):
    """A textured left view and its right view: the left content moved left
    by a smooth disparity field of 1-5 px (so that d = 0..7 spans it)."""
    rng = np.random.default_rng(seed)
    big = gaussian_filter(rng.random((1, c, h, w + 8)), (0, 0, 1.0, 1.0))
    disp = 1.0 + 4.0 * (np.arange(w) / (w - 1))[None, :].repeat(h, 0)
    xs = np.arange(w)[None, :] + 4
    left = big[..., 4:w + 4]
    # right(x) = left(x + d): sample the wide image at x + 4 - d
    src = xs - disp
    x0 = np.floor(src).astype(int)
    a = src - x0
    right = big[..., np.arange(h)[:, None], x0] * (1 - a) \
        + big[..., np.arange(h)[:, None], x0 + 1] * a
    return left.astype(np.float32), right.astype(np.float32)


@pytest.fixture(scope="module")
def stereo_refs():
    left, right = _pair(c=3)
    ref = {}
    for soft in (True, False):
        for th in (1.5, None):
            fn = jax.jit(lambda a, b, s=soft, t=th: j_st.stereo_matching(
                a, b, D, 5, s, 50.0, t))
            ref[soft, th] = [np.asarray(v) for v in fn(jnp.asarray(left),
                                                        jnp.asarray(right))]
    return left, right, ref


@pytest.mark.parametrize("soft", [True, False])
@pytest.mark.parametrize("lr_check_th", [1.5, None])
def test_stereo_matching_matches_reference(stereo_refs, soft, lr_check_th):
    left, right, refs = stereo_refs
    rd, rv = refs[soft, lr_check_th]
    disp, valid = t_st.stereo_matching(_t(left), _t(right), D, 5, soft, 50.0,
                                       lr_check_th)
    assert disp.shape == valid.shape == (1, 1, 32, 48)
    assert valid.dtype == torch.bool
    np.testing.assert_allclose(disp.numpy(), rd, rtol=0, atol=DISP_PX)
    np.testing.assert_array_equal(valid.numpy(), rv)
    if lr_check_th is not None:
        assert 0.3 < rv.mean() < 1.0


def test_stereo_matching_default_window_recovers_the_shift():
    """The defaults (window 9, soft, LR check) on a pure 3 px shift: the
    reference's disparity; away from the borders the winner is 3 px, and
    the soft-argmin (a softmax of -50 x costs of about 0.01-0.1, so the
    neighbours keep some weight) within 0.25 px of it where the check
    passes."""
    rng = np.random.default_rng(2)
    big = gaussian_filter(rng.random((1, 1, 32, 60)), (0, 0, 1.0, 1.0))
    left = _t(big[..., 3:51].astype(np.float32))
    right = _t(big[..., 6:54].astype(np.float32))
    rd, rv = (np.asarray(v) for v in jax.jit(
        lambda a, b: j_st.stereo_matching(a, b, D))(
        jnp.asarray(left.numpy()), jnp.asarray(right.numpy())))
    disp, valid = t_st.stereo_matching(left, right, D)
    np.testing.assert_allclose(disp.numpy(), rd, rtol=0, atol=DISP_PX)
    np.testing.assert_array_equal(valid.numpy(), rv)
    inner = valid.numpy()[..., 8:-8, 12:-8]
    assert inner.mean() > 0.9
    np.testing.assert_allclose(disp.numpy()[..., 8:-8, 12:-8][inner], 3.0,
                               atol=0.25)
    wta, _ = t_st.stereo_matching(left, right, D, soft=False)
    np.testing.assert_array_equal(wta.numpy()[..., 8:-8, 12:-8], 3.0)


def test_disparity_to_depth_matches_reference():
    d = np.random.default_rng(3).uniform(0, 20, (2, 1, 6, 7)).astype(
        np.float32)
    d[0, 0, 0, :3] = [0.0, -1.0, 1e-7]
    ref = np.asarray(jax.jit(lambda x: j_st.disparity_to_depth(
        x, 120.0, 0.12))(jnp.asarray(d)))
    _close_rel(t_st.disparity_to_depth(_t(d), 120.0, 0.12).numpy(), ref)


# ----------------------------------------------------------------------------
# depth
# ----------------------------------------------------------------------------

def _K(batch=(2,), w=24.0, h=16.0):
    K = np.array([[0.8 * w, 0, w / 2 - 0.5], [0, 0.85 * w, h / 2 + 0.3],
                  [0, 0, 1]], np.float32)
    return np.broadcast_to(K, (*batch, 3, 3)).copy()


def _depth(seed=4, B=2, h=16, w=24):
    return (1.5 + _image(seed, B, 1, h, w, sigma=2.0)).astype(np.float32)


def _pose(B=2):
    """dst → src poses: a small rotation about y and a shift."""
    T = np.tile(np.eye(4, dtype=np.float32), (B, 1, 1))
    for b in range(B):
        a = 0.02 * (b + 1)
        T[b, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                        [-np.sin(a), 0, np.cos(a)]]
        T[b, :3, 3] = [0.05 * (b + 1), -0.01, 0.02]
    return T


def _depth_cases():
    depth, K = _depth(), _K()
    uv = np.random.default_rng(5).uniform(0, 23, (2, 10, 2)).astype(
        np.float32)
    normals = np.array([[0.1, -0.2, 1.0], [0.0, 0.3, 0.9]], np.float32)
    return {
        "unproject_meshgrid": (
            lambda k: j_depth.unproject_meshgrid(16, 24, k),
            lambda k: t_depth.unproject_meshgrid(16, 24, k), (K,)),
        "unproject_meshgrid_one_K": (
            lambda k: j_depth.unproject_meshgrid(16, 24, k),
            lambda k: t_depth.unproject_meshgrid(16, 24, k), (K[0],)),
        "depth_to_3d": (j_depth.depth_to_3d, t_depth.depth_to_3d,
                        (depth, K)),
        "depth_to_3d_normalized": (
            lambda d, k: j_depth.depth_to_3d(d, k, True),
            lambda d, k: t_depth.depth_to_3d(d, k, True), (depth, K)),
        "depth_to_3d_v2": (j_depth.depth_to_3d_v2, t_depth.depth_to_3d_v2,
                           (depth[:, 0], K)),
        "depth_to_normals": (j_depth.depth_to_normals,
                             t_depth.depth_to_normals, (depth, K)),
        "depth_from_disparity": (
            lambda d: j_depth.depth_from_disparity(d, 0.12, 120.0),
            lambda d: t_depth.depth_from_disparity(d, 0.12, 120.0),
            (depth * 3.0 - 4.5,)),
        "depth_from_plane_equation": (
            j_depth.depth_from_plane_equation,
            t_depth.depth_from_plane_equation,
            (normals, np.array([[2.0], [3.0]], np.float32), uv, K)),
        "warp_frame_depth": (
            j_depth.warp_frame_depth, t_depth.warp_frame_depth,
            (_image(6, 2, 3, 16, 24), depth, _pose(), K)),
    }


_DEPTH = _depth_cases()


@pytest.mark.parametrize("name", sorted(_DEPTH))
def test_depth_matches_reference(name):
    jfn, tfn, args = _DEPTH[name]
    ref = np.asarray(jax.jit(jfn)(*[jnp.asarray(a) for a in args]))
    out = tfn(*[_t(a) for a in args]).numpy()
    assert out.shape == ref.shape
    _close_rel(out, ref)


def _pinholes(pkg, B=2):
    f = np.array([20.0, 21.0], np.float32)
    kw = dict(tx=np.array([0.0, 0.05], np.float32),
              tz=np.array([0.1, 0.0], np.float32))
    if pkg is j_cam:
        f = jnp.asarray(f)
        kw = {k: jnp.asarray(v) for k, v in kw.items()}
        dst = pkg.PinholeCamera.from_parameters(f, f, 12.0, 8.0, 16, 24)
    else:
        f = _t(f)
        kw = {k: _t(v) for k, v in kw.items()}
        dst = pkg.PinholeCamera.from_parameters(f, f, 12.0, 8.0, 16, 24)
    src = pkg.PinholeCamera.from_parameters(f, f, 12.0, 8.0, 16, 24, **kw)
    return dst, src


def test_depth_warper_matches_reference():
    depth = _depth(7)
    patch = _image(8, 2, 2, 16, 24)
    jd, js = _pinholes(j_cam)
    td, ts = _pinholes(t_cam)
    ref_grid, ref, ref_step = (np.asarray(v) for v in jax.jit(
        lambda a, b, c, d: (
            j_depth.DepthWarper(a, 16, 24).compute_projection_matrix(b)
            .warp_grid(c),
            j_depth.depth_warp(a, b, c, d, 16, 24),
            j_depth.DepthWarper(a, 16, 24).compute_projection_matrix(b)
            .compute_subpixel_step()))(
        jd, js, jnp.asarray(depth), jnp.asarray(patch)))
    warper = t_depth.DepthWarper(td, 16, 24).compute_projection_matrix(ts)
    _close_rel(warper.warp_grid(_t(depth)).numpy(), ref_grid)
    _close_rel(warper(_t(depth), _t(patch)).numpy(), ref)
    _close_rel(t_depth.depth_warp(td, ts, _t(depth), _t(patch), 16,
                                  24).numpy(), ref)
    _close_rel(warper.compute_subpixel_step().numpy(), ref_step)
    with pytest.raises(ValueError):
        t_depth.DepthWarper(td, 16, 24).warp_grid(_t(depth))
