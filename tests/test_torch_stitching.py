"""The port's image stitcher (contrib/image_stitching.py) against the JAX
package on the CPU.

The composition (the warp of the right image, its mask, the left image on
the wider canvas) and both blends are compared with the same homography
given to both sides: within 1e-5 of the largest entry. The homography
itself is the port's own estimate on a pair cut from one image 40 px apart
(no JAX RANSAC is compiled: one takes about 40 s here): the shift
recovered within 0.5 px at the corners.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.contrib import image_stitching as j_st
from kornia_tpu_torch.contrib import image_stitching as t_st
from kornia_tpu_torch.geometry.ransac import _gumbel
from kornia_tpu_torch.ops.warp import transform_points
from tests.torch_threads import one_torch_thread  # noqa: F401

H_, W_, SHIFT = 120, 160, 40


def _views(c=1, seed=0):
    """Left and right views cut from one textured image, the right one
    SHIFT px further right: right → left is x + SHIFT."""
    rng = np.random.default_rng(seed)
    full = gaussian_filter(rng.random((1, c, H_, W_ + SHIFT)),
                           (0, 0, 1.5, 1.5)).astype(np.float32)
    full = (full - full.min()) / (full.max() - full.min())
    return full, full[..., :W_].copy(), full[..., SHIFT:SHIFT + W_].copy()


def _homography(dx=SHIFT + 0.37, dy=-0.21, a=0.004):
    c, s = np.cos(a), np.sin(a)
    return np.array([[[c, -s, dx], [s, c, dy], [1e-5, -2e-5, 1.0]]],
                    np.float32)


@pytest.mark.parametrize("blending", ["naive", "feather"])
@pytest.mark.parametrize("c", [1, 3])
def test_stitch_composition_matches_reference(blending, c):
    _, left, right = _views(c)
    Hm = _homography()
    jst = j_st.ImageStitcher(blending_method=blending)
    jst.estimate_homography = lambda *a, **k: jnp.asarray(Hm)
    ref = np.asarray(jax.jit(lambda a, b: jst(a, b))(jnp.asarray(left),
                                                     jnp.asarray(right)))
    tst = t_st.ImageStitcher(blending_method=blending)
    tst.estimate_homography = lambda *a, **k: torch.from_numpy(Hm)
    out = tst(torch.from_numpy(left), torch.from_numpy(right)).numpy()
    assert out.shape == ref.shape == (1, c, H_, 2 * W_)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    # the left view stays where it lies
    np.testing.assert_array_equal(out[..., :W_], left)


def test_blend_image_matches_reference():
    rng = np.random.default_rng(1)
    src, dst = (rng.random((1, 2, 8, 9)).astype(np.float32) for _ in "ab")
    mask = rng.random((1, 1, 8, 9)).astype(np.float32)
    for blending in ("naive", "feather"):
        ref = np.asarray(j_st.ImageStitcher(blending_method=blending)
                         .blend_image(src, dst, mask))
        out = t_st.ImageStitcher(blending_method=blending).blend_image(
            torch.from_numpy(src), torch.from_numpy(dst),
            torch.from_numpy(mask)).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-7)


@pytest.fixture(scope="module")
def estimate():
    full, left, right = _views(seed=2)
    st = t_st.ImageStitcher()
    l_, r_ = torch.from_numpy(left), torch.from_numpy(right)
    Hm = st.estimate_homography(l_, r_)
    return full, left, st, l_, r_, Hm


def test_estimate_homography_recovers_the_shift(estimate):
    _, _, _, _, _, Hm = estimate
    assert Hm.shape == (1, 3, 3)
    corners = torch.tensor([[[0.0, 0.0], [W_ - 1.0, 0.0], [0.0, H_ - 1.0],
                             [W_ - 1.0, H_ - 1.0]]])
    got = transform_points(Hm, corners)
    want = corners + torch.tensor([SHIFT, 0.0])
    assert float((got - want).abs().max()) <= 0.5


def test_stitcher_default_noise_is_seeded(estimate):
    """Without a generator the RANSAC noise comes from one seeded with 0;
    injected noise of that generator gives the same homography, and the
    stitched canvas shows the source image where the right view lands."""
    full, left, st, l_, r_, Hm = estimate
    again = st.estimate_homography(l_, r_)
    torch.testing.assert_close(again, Hm, rtol=0, atol=0)
    g = torch.Generator().manual_seed(0)
    nf = st.matcher.local_feature.detector.num_features
    noise = torch.stack([_gumbel((512, nf), g, "cpu") for _ in range(8)])
    injected = st.estimate_homography(l_, r_, gumbel=noise)
    torch.testing.assert_close(injected, Hm, rtol=0, atol=0)
    out = st(l_, r_).numpy()
    np.testing.assert_array_equal(out[..., :W_], left)
    seen = out[..., W_ + 8:W_ + SHIFT - 8]
    np.testing.assert_allclose(seen, full[..., W_ + 8:W_ + SHIFT - 8],
                               atol=0.02)
