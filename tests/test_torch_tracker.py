"""The port's planar homography tracker (kornia_tpu_torch.tracking) against
the JAX package's on the CPU: GFTT corners + RootSIFT, the SMNN matcher and
homography RANSAC on a 96x96 target and two warped frames, with the
reference's per-frame RANSAC noise (``fold_in(PRNGKey(7), frame)``)
replayed into the port. The second frame is chained through the first
frame's homography, so its matches pass the 30 px gate.

The JAX tracker runs as written, with its matcher jitted (one compile
serves both frames). Tolerances: features as the detector legs hold them
(1e-3 px), so the same matches survive and RANSAC draws the same samples;
the homographies, normalised by H[2, 2], map the target's corners within
1e-2 px of the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.tracking.planar_tracker import \
    HomographyTracker as JHomographyTracker
from kornia_tpu_torch.geometry.homography import oneway_transfer_error
from kornia_tpu_torch.ops.warp import warp_perspective
from kornia_tpu_torch.tracking import planar_tracker as t_track
from tests.torch_threads import one_torch_thread  # noqa: F401

S_IMG, NF = 96, 128
T, S = 8, 512  # the tracker's RANSAC rounds and batch
CORNERS = np.array([[0, 0], [S_IMG - 1, 0], [S_IMG - 1, S_IMG - 1],
                    [0, S_IMG - 1]], np.float64)


def _h(deg, scale, tx, ty):
    c = S_IMG / 2
    a = np.deg2rad(deg)
    A = scale * np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
    H = np.eye(3)
    H[:2, :2] = A
    H[:2, 2] = [c + tx, c + ty] - A @ [c, c]
    return H.astype(np.float32)


def _frames():
    rng = np.random.default_rng(0)
    target = gaussian_filter(rng.random((S_IMG, S_IMG)), 1.0).astype(
        np.float32)[None, None]
    Hs = [_h(3.0, 1.02, 2.0, -1.5), _h(5.0, 0.98, 4.0, -3.0)]
    frames = [warp_perspective(torch.from_numpy(target),
                               torch.from_numpy(H[None]),
                               (S_IMG, S_IMG)).numpy() for H in Hs]
    return target, frames, Hs


def _replay_gumbel(frame_idx):
    """The reference tracker's RANSAC noise for one frame."""
    key = jax.random.fold_in(jax.random.PRNGKey(7), frame_idx)
    draws = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(sub, (S, NF))))
    return torch.from_numpy(np.stack(draws))


def _map(H, p):
    H = np.asarray(H, np.float64).reshape(3, 3)
    ph = np.concatenate([p, np.ones((len(p), 1))], -1) @ H.T
    return ph[:, :2] / ph[:, 2:]


@pytest.fixture(scope="module")
def runs():
    target, frames, Hs = _frames()
    ref = JHomographyTracker(num_features=NF)
    matcher = ref.matcher
    run = jax.jit(lambda a, b: matcher({"image0": a, "image1": b}))
    ref.matcher = lambda d: run(d["image0"], d["image1"])
    ref.set_target(jnp.asarray(target))
    port = t_track.HomographyTracker(num_features=NF, device="cpu")
    port.set_target(target)
    out = []
    for i, frame in enumerate(frames):
        prev = port.previous_homography
        H_j, ok_j = ref(jnp.asarray(frame))
        H_t, ok_t = port(frame, gumbel=_replay_gumbel(i))
        out.append(dict(H_j=np.asarray(H_j), ok_j=bool(ok_j), H_t=H_t,
                        ok_t=bool(ok_t), prev=prev))
    return dict(target=target, frames=frames, Hs=Hs, out=out, port=port)


@pytest.mark.parametrize("frame", [0, 1])
def test_tracker_matches_reference(runs, frame):
    o = runs["out"][frame]
    assert o["ok_j"] and o["ok_t"]
    np.testing.assert_allclose(_map(o["H_t"].numpy(), CORNERS),
                               _map(o["H_j"], CORNERS), atol=1e-2)
    # and the truth, within a pixel
    np.testing.assert_allclose(_map(o["H_t"].numpy(), CORNERS),
                               _map(runs["Hs"][frame], CORNERS), atol=1.0)


def test_second_frame_is_chained_through_the_gate(runs):
    """Frame 1 is matched with frame 0's homography as the prediction, and
    the 30 px gate drops matches that the prediction rules out."""
    first, second = runs["out"]
    assert first["prev"] is None
    assert torch.equal(second["prev"], first["H_t"])
    port = runs["port"]
    out = port.matcher({"image0": torch.from_numpy(runs["target"]),
                        "image1": torch.from_numpy(runs["frames"][1])})
    kp0, kp1 = out["keypoints0"][0], out["keypoints1"][0]
    valid = out["valid"][0]
    err = oneway_transfer_error(kp0[None], kp1[None], second["prev"],
                                False)[0]
    gated = valid & (err < 30.0)
    assert 15 <= int(gated.sum()) < int(valid.sum())


def test_tracker_runs_with_a_generator_and_resets():
    target, frames, Hs = _frames()
    tr = t_track.HomographyTracker(num_features=NF, device="cpu")
    with pytest.raises(RuntimeError):
        tr(frames[0])
    tr.set_target(target)
    H, ok = tr(frames[0])  # the default: a generator seeded by the frame
    assert bool(ok) and tr.previous_homography is not None
    np.testing.assert_allclose(_map(H.numpy(), CORNERS),
                               _map(Hs[0], CORNERS), atol=1.0)
    H2, _ = tr(frames[0], torch.Generator().manual_seed(3))
    np.testing.assert_allclose(_map(H2.numpy(), CORNERS),
                               _map(Hs[0], CORNERS), atol=1.0)
    tr.set_target(target)
    assert tr.previous_homography is None and tr._frame_idx == 0


def test_tracker_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    target, _, _ = _frames()
    tr = t_track.HomographyTracker(num_features=NF)
    assert tr.device.type == "cuda"
    with pytest.raises((AssertionError, RuntimeError)):
        tr.set_target(target)
