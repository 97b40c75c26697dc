"""The port's ByteTrack (kornia_tpu_torch/tracking/bytetrack.py) against
the JAX package on the CPU: the Kalman steps, the IoU matrix and the
greedy association (with exact ties), a seeded 40-frame stream, a resume
from a carried-across state, and the JAX tracking tests' legs mirrored.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.tracking import bytetrack as jbt
from kornia_tpu_torch import convert
from kornia_tpu_torch.tracking import bytetrack as tbt
from tests.torch_threads import one_torch_thread  # noqa: F401

KF_RTOL = 1e-5     # Kalman steps, IoU: of the largest entry
MEAN_RTOL = 1e-4   # track means after a stream: of the largest coordinate
CAP, N_DET, FRAMES = 16, 16, 40
BUFFER = 5  # short, so that tracks die and their slots are reused


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(initial=0.0), 1e-30)
    err = np.abs(got - want).max(initial=0.0)
    assert err <= rtol * scale, err / scale


def _stream(seed, frames=FRAMES, n=N_DET, targets=10):
    """Seeded detections (frames, n, 6) of `targets` boxes at constant
    velocity with 1 px of jitter, each seen from its first to its last
    frame: 10% missed a frame, 15% scored low (the second round's
    traffic), two false positives a frame, rows shuffled and padded with
    score-0 rows."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(20, 200, (targets, 2))
    vel = rng.uniform(-3, 3, (targets, 2))
    hs = rng.uniform(20, 60, targets)
    first = rng.integers(0, frames // 2, targets)
    last = first + rng.integers(frames // 4, frames, targets)
    out = np.zeros((frames, n, 6), np.float32)
    for f in range(frames):
        rows = []
        for k in range(targets):
            if not first[k] <= f <= last[k] or rng.random() < 0.1:
                continue
            x, y = pos[k] + f * vel[k] + rng.normal(0, 1, 2)
            s = rng.uniform(0.15, 0.5) if rng.random() < 0.15 \
                else rng.uniform(0.6, 1.0)
            rows.append((k % 3, s, x, y, 0.41 * hs[k], hs[k]))
        for _ in range(2):
            rows.append((0, rng.uniform(0.1, 0.45), *rng.uniform(0, 240, 2),
                         *rng.uniform(10, 40, 2)))
        rng.shuffle(rows)
        out[f, :len(rows)] = np.asarray(rows[:n], np.float32)
    return out


@pytest.fixture(scope="module")
def jax_tracker():
    return jbt.ByteTracker(capacity=CAP, track_buffer=BUFFER)


def _state_np(s):
    return [np.asarray(getattr(s, f)) for f in
            ("mean", "cov", "score", "cls", "track_id", "alive", "misses",
             "next_id")]


def _same_state(t_state, j_state):
    got = {f: getattr(t_state, f).numpy() for f in
           ("track_id", "alive", "misses", "next_id")}
    for f, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(j_state, f)),
                                      err_msg=f)
    alive = np.asarray(j_state.alive)
    _close(t_state.mean.numpy()[alive], np.asarray(j_state.mean)[alive],
           MEAN_RTOL)


def _kf_inputs(seed, T=12):
    rng = np.random.default_rng(seed)
    mean = np.concatenate([rng.uniform(0, 300, (T, 2)),
                           rng.uniform(0.3, 0.6, (T, 1)),
                           rng.uniform(20, 200, (T, 1)),
                           rng.normal(0, 2, (T, 4))], -1).astype(np.float32)
    A = rng.normal(0, 1, (T, 8, 8))
    cov = (A @ A.transpose(0, 2, 1) + 8 * np.eye(8)).astype(np.float32)
    meas = (mean[:, :4] + rng.normal(0, 1, (T, 4))).astype(np.float32)
    return mean, cov, meas


@pytest.mark.parametrize("seed", [0, 1])
def test_kf_predict_and_update(seed):
    mean, cov, meas = _kf_inputs(seed)
    jm, jc = jax.jit(jbt._kf_predict)(mean, cov)
    tm, tc = tbt._kf_predict(_t(mean), _t(cov))
    _close(tm, jm, KF_RTOL)
    _close(tc, jc, KF_RTOL)
    jm, jc = jax.jit(jbt._kf_update)(mean, cov, meas)
    tm, tc = tbt._kf_update(_t(mean), _t(cov), _t(meas))
    _close(tm, jm, KF_RTOL)
    _close(tc, jc, KF_RTOL)


def _boxes(rng, n):
    xy = rng.uniform(0, 100, (n, 2))
    wh = rng.uniform(5, 40, (n, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_iou_matrix():
    rng = np.random.default_rng(2)
    a, b = _boxes(rng, 10), _boxes(rng, 14)
    b[3] = a[2]  # an exact overlap
    b[5, 2:] = b[5, :2]  # an empty box
    _close(tbt._iou_matrix(_t(a), _t(b)),
           jax.jit(jbt._iou_matrix)(a, b), KF_RTOL)


def _greedy_inputs(seed, T, D):
    rng = np.random.default_rng(seed)
    iou = rng.choice([0.0, 0.2, 0.35, 0.6, 0.6, 0.8, 0.8, 0.95],
                     (T, D)).astype(np.float32)  # many exact ties
    if seed % 2:
        iou = np.round(rng.random((T, D)), 2).astype(np.float32)
    return iou, rng.random(T) < 0.8, rng.random(D) < 0.8


@pytest.mark.parametrize("seed,T,D,thresh", [
    (0, 8, 8, 0.3), (1, 8, 12, 0.3), (2, 12, 5, 0.5), (3, 16, 16, 0.5),
    (4, 6, 9, -2.0)])
def test_greedy_match(seed, T, D, thresh):
    iou, row_ok, col_ok = _greedy_inputs(seed, T, D)
    j = jax.jit(jbt._greedy_match, static_argnums=3)(iou, row_ok, col_ok,
                                                     thresh)
    t = tbt._greedy_match(_t(iou), _t(row_ok), _t(col_ok), thresh)
    np.testing.assert_array_equal(t[0].numpy(), np.asarray(j[0]))
    np.testing.assert_array_equal(t[1].numpy(), np.asarray(j[1]))


def test_stream_against_the_reference(jax_tracker):
    dets = _stream(0)
    tr = tbt.ByteTracker(capacity=CAP, track_buffer=BUFFER, device="cpu")
    js, ts = jax_tracker.init_state(), tr.init_state()
    deaths = 0
    for f in range(FRAMES):
        js = jax_tracker.update(js, jnp.asarray(dets[f]))
        alive = ts.alive.clone()
        ts = tr.update(ts, _t(dets[f]))
        _same_state(ts, js)
        deaths += int((alive & ~ts.alive).sum())
    # every branch ran: births after the first frame, deaths
    assert int(ts.next_id) > 10 and deaths > 0
    jt = jax_tracker.current_tracks(js)
    tt = tr.current_tracks(ts)
    valid = np.asarray(jt[4])
    np.testing.assert_array_equal(tt[4].numpy(), valid)
    _close(tt[0].numpy()[valid], np.asarray(jt[0])[valid], MEAN_RTOL)


def test_resume_from_a_carried_state(jax_tracker):
    dets = _stream(1)
    js = jax_tracker.init_state()
    for f in range(20):
        js = jax_tracker.update(js, jnp.asarray(dets[f]))
    ts = convert.track_state_from_numpy(*_state_np(js), device="cpu")
    assert ts.track_id.dtype == torch.int32 and ts.alive.dtype == torch.bool
    tr = tbt.ByteTracker(capacity=CAP, track_buffer=BUFFER, device="cpu")
    for f in range(20, FRAMES):
        js = jax_tracker.update(js, jnp.asarray(dets[f]))
        ts = tr.update(ts, _t(dets[f]))
        _same_state(ts, js)


# the JAX package's tracking legs (tests/test_bytetrack_defmo.py:23-96)

def _det(rows, n=8):
    d = np.zeros((n, 6), np.float32)
    for i, r in enumerate(rows):
        d[i] = r  # (class, score, x, y, w, h)
    return _t(d)


def test_bytetrack_two_objects_id_persistence():
    tr = tbt.ByteTracker(capacity=16, device="cpu")
    s = tr.init_state()
    for t in range(6):
        s = tr.update(s, _det([(0, 0.9, 10 + 2 * t, 10, 8, 8),
                               (1, 0.8, 50 + 2 * t, 40, 10, 12)]))
    boxes, ids, sc, cls, valid = tr.current_tracks(s)
    v = valid.numpy()
    assert v.sum() == 2
    assert sorted(ids.numpy()[v].tolist()) == [1, 2]
    b = boxes.numpy()[v]  # the Kalman mean follows the 2 px/frame motion
    assert abs(b[0, 0] - 20) < 1.0 and abs(b[1, 0] - 60) < 1.0


def test_bytetrack_occlusion_recovery():
    tr = tbt.ByteTracker(capacity=16, device="cpu")
    s = tr.init_state()
    for t in range(6):
        s = tr.update(s, _det([(0, 0.9, 10 + 2 * t, 10, 8, 8),
                               (1, 0.8, 50 + 2 * t, 40, 10, 12)]))
    for t in range(6, 9):  # object 0 occluded
        s = tr.update(s, _det([(1, 0.8, 50 + 2 * t, 40, 10, 12)]))
    for t in range(9, 11):
        s = tr.update(s, _det([(0, 0.9, 10 + 2 * t, 10, 8, 8),
                               (1, 0.8, 50 + 2 * t, 40, 10, 12)]))
    _, ids, _, _, valid = tr.current_tracks(s)
    assert sorted(ids.numpy()[valid.numpy()].tolist()) == [1, 2]


def test_bytetrack_low_score_second_round():
    tr = tbt.ByteTracker(capacity=16, device="cpu")
    s = tr.init_state()
    for t in range(4):
        s = tr.update(s, _det([(0, 0.9, 20 + t, 20, 10, 10)]))
    s = tr.update(s, _det([(0, 0.3, 24.5, 20, 10, 10)]))  # below high
    _, ids, _, _, valid = tr.current_tracks(s)
    assert int(valid.sum()) == 1
    assert ids.numpy()[valid.numpy()][0] == 1


def test_bytetrack_track_death():
    tr = tbt.ByteTracker(capacity=8, track_buffer=2, device="cpu")
    s = tr.init_state()
    for t in range(3):
        s = tr.update(s, _det([(0, 0.9, 20, 20, 10, 10)]))
    for _ in range(4):  # gone longer than the buffer
        s = tr.update(s, _det([]))
    assert int(s.alive.sum()) == 0
    s = tr.update(s, _det([(0, 0.9, 20, 20, 10, 10)]))  # a NEW id
    _, ids, _, _, valid = tr.current_tracks(s)
    assert ids.numpy()[valid.numpy()][0] == 2


def test_bytetrack_update_keeps_tensors_on_the_device():
    tr = tbt.ByteTracker(capacity=8, device="cpu")
    s = tr.init_state()
    s2 = tr.update(s, _det([(0, 0.9, 5, 5, 4, 4)]).numpy())
    assert type(s2) is type(s)
    for f in ("mean", "cov", "score", "cls", "track_id", "alive", "misses",
              "next_id"):
        v = getattr(s2, f)
        assert torch.is_tensor(v) and v.device.type == "cpu"
        assert v.dtype == getattr(s, f).dtype


def test_boxtracker_facade():
    dets = _stream(2, frames=3)
    calls = iter(dets)
    bt = tbt.BoxTracker(lambda img: _t(next(calls))[None],
                        tbt.ByteTracker(capacity=CAP, device="cpu"))
    img = torch.zeros((1, 3, 64, 64))
    boxes, ids, sc, cls, valid = bt.update(img)
    assert boxes.shape == (CAP, 4) and ids.shape == valid.shape
    bt.update(img)
    out = bt.visualize(torch.rand((1, 3, 240, 240)))
    assert out.shape == (1, 3, 240, 240)
    bt.reset()
    assert bt.frame_count == 0 and int(bt.state.alive.sum()) == 0


def test_boxtracker_default_detector_is_object_detector():
    """The default detector is contrib's ObjectDetector on
    the tracker's device: the card unless the CPU is asked for (with no
    card, torch raises)."""
    from kornia_tpu_torch.contrib.detection import ObjectDetector
    bt = tbt.BoxTracker(device="cpu")
    assert isinstance(bt.detector, ObjectDetector)
    assert bt.tracker.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tbt.BoxTracker()


def test_boxtracker_visualize_matches_the_reference():
    """Track boxes drawn by both packages after the same frames (the JAX
    facade given the same detector, through its own draw_rectangle)."""
    dets = _stream(3, frames=5)
    img = np.random.default_rng(4).random((1, 3, 96, 128)).astype(np.float32)
    jt = object.__new__(jbt.BoxTracker)
    jt.tracker, jt.frame_count = jbt.ByteTracker(capacity=CAP), 0
    jt.state, jt.detector = jt.tracker.init_state(), None
    it_j, it_t = iter(dets), iter(dets)
    jt.detector = lambda im: jnp.asarray(next(it_j))[None]
    tt = tbt.BoxTracker(lambda im: _t(next(it_t))[None],
                        tbt.ByteTracker(capacity=CAP, device="cpu"))
    for _ in range(5):
        jt.update(jnp.asarray(img))
        tt.update(_t(img))
    np.testing.assert_array_equal(tt.visualize(_t(img)).numpy(),
                                  np.asarray(jt.visualize(jnp.asarray(img))))
