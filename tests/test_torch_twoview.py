"""``two_view_pose`` of the port (kornia_tpu_torch) against the JAX
package's, end to end on the CPU, with the reference's RANSAC noise
injected; plus the port's import guard and its state conversion.

The JAX pipeline compiles once for the module (about a minute on the CPU).
"""

import math
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from kornia_tpu.slam.twoview import two_view_pose as jax_two_view_pose
from kornia_tpu_torch.convert import state_from_numpy
from kornia_tpu_torch.slam.twoview import two_view_pose
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
H = W = 128
NF = 128
T, S = 32, 256  # two_view_pose's RANSAC rounds and batch


def _pair():
    """A blurred random image and its 4 px shift (bench.py's input)."""
    rng = np.random.default_rng(0)
    img0 = gaussian_filter(rng.random((H, W)), 1.0).astype(np.float32)
    img1 = np.zeros_like(img0)
    img1[:, :-4] = img0[:, 4:]
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]],
                 np.float32)
    return img0[None, None], img1[None, None], K


def _replay_gumbel(key):
    draws = []
    for _ in range(T):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(sub, (S, NF))))
    return torch.from_numpy(np.stack(draws))


def _angle(a, b):
    c = float(np.dot(a, b) / (np.linalg.norm(a) * np.linalg.norm(b)))
    return math.acos(max(-1.0, min(1.0, c)))


@pytest.fixture(scope="module")
def both():
    img0, img1, K = _pair()
    key = jax.random.PRNGKey(1)
    ref = jax_two_view_pose(jnp.asarray(img0), jnp.asarray(img1),
                            jnp.asarray(K), key, num_features=NF)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    out = two_view_pose(img0, img1, K, num_features=NF, device="cpu",
                        gumbel=_replay_gumbel(key))
    return ref, out


def test_two_view_pose_matches_reference(both):
    ref, out = both
    assert int(ref.num_inliers) >= 20
    # the same matches survive RANSAC: inlier sets equal, keypoints of the
    # inliers within 1e-2 px — the quadratic subpixel fit divides f32
    # differences of DoG levels (which agree to ~1e-7) by the local
    # Hessian, and weak extrema amplify that to ~3e-3 px
    np.testing.assert_array_equal(out.inliers.numpy(), ref.inliers)
    assert int(out.num_inliers) == int(ref.num_inliers)
    inl = ref.inliers
    np.testing.assert_allclose(out.keypoints0.numpy()[inl],
                               ref.keypoints0[inl], atol=1e-2)
    np.testing.assert_allclose(out.keypoints1.numpy()[inl],
                               ref.keypoints1[inl], atol=1e-2)
    # rotation within 1e-3 rad, translation direction within 1e-2 rad
    dR = ref.R.T @ out.R.numpy()
    assert math.acos(max(-1.0, min(1.0, (np.trace(dR) - 1) / 2))) <= 1e-3
    assert _angle(out.t.numpy().ravel(), ref.t.ravel()) <= 1e-2


def test_two_view_pose_recovers_the_shift(both):
    _, out = both
    dR = out.R.numpy()
    assert math.degrees(math.acos(min(1.0, (np.trace(dR) - 1) / 2))) < 1.0
    assert abs(float(out.t[0, 0])) > 0.9


def test_two_view_pose_with_a_generator():
    img0, img1, K = _pair()
    gen = torch.Generator().manual_seed(0)
    out = two_view_pose(img0, img1, K, num_features=NF, device="cpu",
                        generator=gen)
    assert out.R.shape == (3, 3) and out.t.shape == (3, 1)
    assert abs(float(out.t[0, 0])) > 0.9
    assert int(out.num_inliers) >= 20


def test_two_view_pose_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    img0, img1, K = _pair()
    with pytest.raises((AssertionError, RuntimeError)):
        two_view_pose(img0, img1, K, num_features=NF)


def test_state_from_numpy():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.array([1, 2], np.int32)},
            "d": [np.ones(2, np.float64), np.zeros(1, bool)]}
    out = state_from_numpy(tree, "cpu")
    assert out["a"].dtype == torch.float32 and out["a"].shape == (2, 3)
    assert out["b"]["c"].dtype == torch.int32
    assert out["d"][0].dtype == torch.float64 and out["d"][1].dtype == torch.bool
    np.testing.assert_array_equal(out["a"].numpy(), tree["a"])
    tree["a"][0, 0] = 7.0  # the tensors own their memory
    assert float(out["a"][0, 0]) == 0.0
    with pytest.raises(TypeError):
        state_from_numpy({"x": object()}, "cpu")


def test_port_imports_no_jax():
    """Every module of the port imports with JAX and kornia_tpu blocked, and
    no source line imports either."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['kornia_tpu'] = None\n"
        "import kornia_tpu_torch\n"
        "for m in pkgutil.walk_packages(kornia_tpu_torch.__path__,"
        " 'kornia_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'kornia_tpu.'))"
        " for k, v in sys.modules.items() if v is not None)\n"
        "assert 'kornia_tpu_torch.tracking.planar_tracker' in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|kornia_tpu)(\.|\s|$)")
    sources = list((REPO / "kornia_tpu_torch").rglob("*.py"))
    sources.append(REPO / "chip_smoke.py")
    for path in sources:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not pattern.match(line), f"{path}:{n}: {line}"
