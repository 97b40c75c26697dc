"""The port's scene renderer and its helpers (kornia_tpu_torch.utils.render,
contrib.ops.diamond_square, ops.filters.get_motion_kernel2d / motion_blur)
against the JAX package's on the CPU.

The JAX room (tex_size 64) is carried across with
``convert.plane_scene_from_numpy`` and both packages render the same poses
at 60x80. Random draws are the reference's, replayed into the port.
Tolerances: trajectories exactly; images 1e-5 on at least 99.5% of the
pixels (at a plane's edge the nearest-hit argmin may pick the other plane)
and depth 1e-4 relative; the plasma, textures and degraded frames 1e-5;
motion kernels and motion blur 1e-6.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.ops.filters import get_motion_kernel2d as j_motion_kernel
from kornia_tpu.ops.filters import motion_blur as j_motion_blur
from kornia_tpu.utils import render as jr
from kornia_tpu_torch.contrib.ops import diamond_square
from kornia_tpu_torch.convert import plane_scene_from_numpy
from kornia_tpu_torch.ops.filters import get_motion_kernel2d, motion_blur
from kornia_tpu_torch.utils import render as tr
from tests.torch_threads import one_torch_thread  # noqa: F401

H, W = 60, 80
TEX = 64
K = np.array([[0.8 * W, 0.0, W / 2], [0.0, 0.8 * W, H / 2],
              [0.0, 0.0, 1.0]], np.float32)
IMG_ATOL, IMG_SHARE, DEPTH_RTOL = 1e-5, 0.995, 1e-4
DRAW_ATOL = 1e-5
KERNEL_ATOL = 1e-6


def _plasma_draws(key, shape):
    """The reference diamond_square's uniform draws, in order."""
    return [np.asarray(d) for d in _plasma_draws_jit(key, shape)]


@functools.partial(jax.jit, static_argnums=1)
def _plasma_draws_jit(key, shape):
    B, C, h, w = shape
    levels = max(1, math.ceil(math.log2(max(h, w) - 1)))
    out = [jax.random.uniform(key, (B, C, 2, 2))]
    size = 2
    for _ in range(levels):
        key, sub = jax.random.split(key)
        size = min(2 * size - 1, max(h, w))
        out.append(jax.random.uniform(sub, (B, C, size, size)))
    return out


def _room_draws(key, tex_size, planes):
    """make_room_scene's texture draws, plane by plane."""
    def one(k):
        k1, k2 = jax.random.split(k)
        return (_plasma_draws_jit(k1, (1, 1, tex_size, tex_size)),
                jax.random.uniform(k2, (8, 8)))

    plasma, blocks = jax.jit(jax.vmap(one))(jax.random.split(key, planes))
    return [([np.asarray(d[p]) for d in plasma], np.asarray(blocks[p]))
            for p in range(planes)]


@functools.partial(jax.jit, static_argnums=(1, 2))
def _degrade_draws(key, n, shape):
    k_gain, k_noise, k_blur, k_ang = jax.random.split(key, 4)
    return dict(
        gain=jax.random.normal(k_gain, (n,)),
        blur=jax.random.uniform(k_blur, (n,)),
        angle=jax.random.uniform(k_ang, (n,), minval=0.0, maxval=180.0),
        noise=jnp.stack([jax.random.normal(jax.random.fold_in(k_noise, i),
                                           shape) for i in range(n)]))


def _reference_room(tex_size):
    """The reference's make_room_scene(tex_size=...) at its default key,
    assembled from its parts for a quarter of the compile time: the
    geometry of make_room_scene itself (its textures stubbed), and the
    textures of one vmapped, jitted _fractal_texture over the keys
    make_room_scene splits (bit-equal to its own per-plane loop)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jr, "_fractal_texture",
                   lambda key, size, contrast=1.0: jnp.zeros((size, size)))
        geom = jr.make_room_scene(tex_size=1)
    keys = jax.random.split(jax.random.PRNGKey(7), geom.origins.shape[0])
    tex = jax.jit(jax.vmap(lambda k: jr._fractal_texture(k, tex_size)))(keys)
    return jr.PlaneScene(geom.origins, geom.edge_u, geom.edge_v, tex)


@pytest.fixture(scope="module")
def scenes():
    js = _reference_room(TEX)
    ts = plane_scene_from_numpy(np.asarray(js.origins), np.asarray(js.edge_u),
                                np.asarray(js.edge_v),
                                np.asarray(js.textures), device="cpu")
    return js, ts


@pytest.mark.parametrize("name,args", [
    ("walk_trajectory", (9,)), ("walk_trajectory", (5, 6.0, 0.5, 0.2, 0.1)),
    ("orbit_trajectory", (7,)), ("orbit_trajectory", (4, 1.5, 5.0, 1.2)),
    ("loop_trajectory", (12,)), ("loop_trajectory", (6, 1.2, 2.4)),
])
def test_trajectories_equal_the_reference(name, args):
    np.testing.assert_array_equal(getattr(tr, name)(*args),
                                  getattr(jr, name)(*args))


def test_look_rotation_equals_the_reference():
    for yaw, pitch in ((0.0, 0.0), (0.3, -0.1), (-2.0, 0.04)):
        np.testing.assert_array_equal(tr._look_rotation(yaw, pitch),
                                      jr._look_rotation(yaw, pitch))


def test_room_scene_with_replayed_draws(scenes):
    js, _ = scenes
    P = js.textures.shape[0]
    ts = tr.make_room_scene(tex_size=TEX, draws=_room_draws(
        jax.random.PRNGKey(7), TEX, P), device="cpu")
    for a, b in ((js.origins, ts.origins), (js.edge_u, ts.edge_u),
                 (js.edge_v, ts.edge_v)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(ts.textures.numpy(), np.asarray(js.textures),
                               atol=DRAW_ATOL, rtol=0)


def test_room_scene_from_a_generator():
    gen = torch.Generator().manual_seed(3)
    s = tr.make_room_scene(gen, tex_size=32, device="cpu")
    assert s.textures.shape == (11, 32, 32)
    assert float(s.textures.min()) >= np.float32(0.02)
    assert float(s.textures.max()) <= np.float32(0.98)
    again = tr.make_room_scene(torch.Generator().manual_seed(3), tex_size=32,
                               device="cpu")
    assert torch.equal(s.textures, again.textures)


@pytest.mark.parametrize("traj", ["walk", "orbit", "loop"])
def test_render_matches_the_reference(scenes, traj):
    js, ts = scenes
    poses = {"walk": jr.walk_trajectory(5), "orbit": jr.orbit_trajectory(4),
             "loop": jr.loop_trajectory(6, rx=1.2, rz=2.4)}[traj]
    jf, jd = jr.render_sequence(js, jnp.asarray(K), poses, H, W)
    tf, td = tr.render_sequence(ts, torch.from_numpy(K), poses, H, W)
    for a, b, da, db in zip(jf, tf, jd, td):
        assert b.shape == (1, 1, H, W) and db.shape == (H, W)
        err = np.abs(b.numpy() - np.asarray(a))
        assert (err <= IMG_ATOL).mean() >= IMG_SHARE, err.max()
        da = np.asarray(da)
        np.testing.assert_allclose(db.numpy(), da, rtol=DEPTH_RTOL,
                                   atol=0)


def test_diamond_square_batches_its_draws():
    """A batch of maps with several channels takes each map's slice of
    the injected draws, and normalises each map on its own (the textures
    hold the (1, 1, 64, 64) plasma against the reference)."""
    gen = torch.Generator().manual_seed(11)
    draws = [torch.rand((2, 3, n, n), generator=gen) for n in (2, 3, 5, 9)]
    both = diamond_square((2, 3, 9, 6), 0.7, 2.0, None, (-1.0, 1.0),
                          draws=draws, device="cpu")
    for b in range(2):
        for c in range(3):
            one = diamond_square((1, 1, 9, 6), 0.7, 2.0, None, (-1.0, 1.0),
                                 draws=[d[b:b + 1, c:c + 1] for d in draws],
                                 device="cpu")
            torch.testing.assert_close(both[b:b + 1, c:c + 1], one,
                                       atol=0, rtol=0)
    assert float(both.amin()) == -1.0 and float(both.amax()) == 1.0


def test_diamond_square_rejects_a_misshapen_draw():
    gen = torch.Generator().manual_seed(0)
    draws = [torch.rand((1, 1, n, n), generator=gen) for n in (2, 3, 5, 8)]
    draws[1] = draws[1][..., :2]
    with pytest.raises(ValueError):
        diamond_square((1, 1, 8, 8), draws=draws, device="cpu")


def test_degrade_sequence_with_replayed_draws(scenes):
    js, _ = scenes
    n = 6
    jf, _ = jr.render_sequence(js, jnp.asarray(K), jr.walk_trajectory(n),
                               H, W)
    key = jax.random.PRNGKey(5)
    want = jr.degrade_sequence(jf, key)
    draws = {k: np.asarray(v) for k, v in
             _degrade_draws(key, n, (1, 1, H, W)).items()}
    assert (draws["blur"] < 0.3).any()  # the motion blur branch is taken
    got = tr.degrade_sequence([torch.from_numpy(np.asarray(f)) for f in jf],
                              None, draws=draws)
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a),
                                   atol=DRAW_ATOL, rtol=0)


def test_degrade_sequence_from_a_generator():
    frames = [torch.full((1, 1, 16, 20), 0.5) for _ in range(5)]
    out = tr.degrade_sequence(frames, torch.Generator().manual_seed(0),
                              blur_frac=1.0)
    assert len(out) == 5
    for f in out:
        assert f.shape == (1, 1, 16, 20)
        assert float(f.min()) >= 0.0 and float(f.max()) <= 1.0


_j_motion_kernel = jax.jit(j_motion_kernel, static_argnums=(0, 3, 4))


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
@pytest.mark.parametrize("angle", [0.0, 30.0, 90.0, 135.0])
def test_motion_kernel_matches_the_reference(mode, angle):
    for k, direction in ((5, 0.5), (9, -1.0)):
        want = _j_motion_kernel(k, angle, direction, jnp.float32, mode)
        got = get_motion_kernel2d(k, angle, direction, mode=mode)
        assert got.shape == (1, k, k)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=KERNEL_ATOL, rtol=0)


def test_motion_kernel_batch_of_angles():
    angles = np.array([0.0, 30.0, 90.0, 135.0], np.float32)
    want = _j_motion_kernel(5, jnp.asarray(angles), 0.25, jnp.float32,
                            "nearest")
    got = get_motion_kernel2d(5, torch.from_numpy(angles), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_ATOL, rtol=0)


@pytest.mark.parametrize("border", ["constant", "reflect"])
def test_motion_blur_matches_the_reference(border):
    rng = np.random.default_rng(0)
    x = rng.random((2, 1, 24, 32)).astype(np.float32)
    angles = np.array([30.0, 135.0], np.float32)
    blur = jax.jit(j_motion_blur, static_argnums=(1, 4, 5))
    for mode in ("nearest", "bilinear"):
        want = blur(jnp.asarray(x), 5, jnp.asarray(angles), 0.0, border, mode)
        got = motion_blur(torch.from_numpy(x), 5, torch.from_numpy(angles),
                          0.0, border, mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=KERNEL_ATOL, rtol=0)
