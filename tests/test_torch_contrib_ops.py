"""The port's contrib operators against the JAX package on the CPU
(``contrib/ops.py``): connected components, the distance transform,
tensor patches, histogram matching, interpolation and k-means.

The JAX references come from one jitted program (``batch_references``).
k-means starts from the reference's own initial draw
(``jax.random.choice`` under its key), injected into the port as
``draws``. Tolerances: 0 for labels, patches and assignments; 1e-5
absolute for values in [0, 1]; 1e-5 relative for distances (up to the
image size); 1e-4 for the k-means centres (20 Lloyd iterations of sums
over every point).
"""

import jax
import numpy as np
import pytest
import torch

import kornia_tpu.contrib as jcontrib
import kornia_tpu.contrib.ops as jo
import kornia_tpu_torch.contrib as tcontrib
import kornia_tpu_torch.contrib.ops as to
from kornia_tpu_torch.convert import kmeans_from_numpy
from tests.torch_op_parity import (Case, batch_references, check_close, rand,
                                   run_case)
from tests.torch_threads import one_torch_thread  # noqa: F401

BLOBS = np.zeros((2, 1, 14, 16), np.float32)
BLOBS[0, 0, 1:4, 1:5] = 1.0
BLOBS[0, 0, 6:12, 8:10] = 1.0
BLOBS[0, 0, 9:11, 2:9] = 0.8
BLOBS[1, 0, 2:13, 12] = 1.0
BLOBS[1, 0, 5, 3:13] = 1.0
POINTS = np.zeros((1, 2, 13, 17), np.float32)
POINTS[0, 0, 4, 5] = POINTS[0, 0, 10, 14] = 1.0
POINTS[0, 1, 0, 0] = POINTS[0, 1, 12, 3] = 1.0
IMG = rand(2, 3, 9, 12, seed=1)
SRC = rand(1, 2, 10, 10, seed=2)
SRC[0, 0, :2, :2] = 0.5  # ties: the stable ranks
TMPL = (rand(1, 2, 12, 9, seed=3) ** 2 * 3.0 + 1.0).astype(np.float32)
XP = np.sort(rand(8, hi=10.0, seed=4))
XP[3] = XP[4]  # a zero step
FP = rand(8, lo=-1.0, hi=1.0, seed=5)
XQ = rand(20, lo=-2.0, hi=12.0, seed=6)
XQ[:2] = XP[[0, 3]]


def _clusters(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centres = np.array([[3.0, 0.0], [-3.0, 1.0], [0.0, 4.0]], np.float32)
    return (centres[rng.integers(0, 3, 90)]
            + rng.normal(0.0, 0.7, (90, 2))).astype(np.float32)


PTS = _clusters(7)
QUERY = _clusters(8)
KEY = jax.random.PRNGKey(3)
DRAW = np.array(jax.random.choice(KEY, PTS.shape[0], (3,), replace=False))


def _kmeans_jax(x):
    return jo.kmeans(x, 3, KEY, 20)


def _kmeans_fit(x, q):
    """The reference's KMeans(3, max_iterations=20, seed=5): fit, then
    predict `q`."""
    km = jo.KMeans(3, max_iterations=20, seed=5)
    km.fit(x)
    return km.cluster_centers, km.predict(q)


def _kmeans_torch(x):
    return to.kmeans(x, 3, None, 20, draws=torch.from_numpy(DRAW))


CASES = {
    "connected_components": Case("connected_components", (BLOBS, 30),
                                 atol=0),
    "connected_components_short": Case("connected_components", (BLOBS, 3),
                                       atol=0),
    "distance_transform": Case("distance_transform", (POINTS,), rtol=1e-5),
    "distance_transform_k5": Case("distance_transform", (POINTS, 5, 0.5),
                                  rtol=1e-5),
    "extract_tensor_patches": Case("extract_tensor_patches", (IMG, 4, 2),
                                   atol=0),
    "extract_tensor_patches_pad": Case("extract_tensor_patches",
                                       (IMG, (3, 5), (2, 3), 1), atol=0),
    "combine_tensor_patches": Case(
        "", (IMG,), jax_fn=lambda x: jo.combine_tensor_patches(
            jo.extract_tensor_patches(x, (3, 4), (2, 3)), (9, 12), (3, 4),
            (2, 3)),
        torch_fn=lambda x: to.combine_tensor_patches(
            to.extract_tensor_patches(x, (3, 4), (2, 3)), (9, 12), (3, 4),
            (2, 3))),
    "histogram_matching": Case("histogram_matching", (SRC, TMPL)),
    "interp": Case("interp", (XQ, XP, FP)),
    "kmeans": Case("", (PTS,), atol=1e-4, jax_fn=_kmeans_jax,
                   torch_fn=_kmeans_torch),
    # KMeans(3, seed=5).fit's computation, and the class API below
    "kmeans_seed5": Case("", (PTS, QUERY), jax_fn=lambda x, q: _kmeans_fit(
        x, q)),
    # the reference's class API over the functionals
    "ExtractTensorPatches": Case(
        "", (IMG,), atol=0,
        jax_fn=lambda x: jcontrib.ExtractTensorPatches(4, 2)(x),
        torch_fn=lambda x: tcontrib.ExtractTensorPatches(4, 2)(x)),
    "DistanceTransform": Case(
        "", (POINTS,), rtol=1e-5,
        jax_fn=lambda x: jcontrib.DistanceTransform()(x),
        torch_fn=lambda x: tcontrib.DistanceTransform()(x)),
}


@pytest.fixture(scope="module")
def refs():
    return batch_references(CASES, jo)


@pytest.mark.parametrize("name", [n for n in CASES if n != "kmeans_seed5"])
def test_contrib_ops_match_reference(name, refs):
    case = CASES[name]
    if name == "kmeans":
        (c_t, a_t), (c_j, a_j) = case.torch_fn(torch.from_numpy(PTS)), \
            refs[name]
        check_close(c_t, np.asarray(c_j), 1e-4)
        check_close(a_t, np.asarray(a_j), 0)
        return
    run_case(case, to, refs[name])


def test_kmeans_class_from_an_injected_draw_and_from_numpy(refs):
    centers_j, want = (np.asarray(a) for a in refs["kmeans_seed5"])
    draw = np.array(jax.random.choice(jax.random.PRNGKey(5), PTS.shape[0],
                                        (3,), replace=False))
    tk = to.KMeans(3, max_iterations=20, seed=5)
    tk.fit(torch.from_numpy(PTS), draws=torch.from_numpy(draw))
    check_close(tk.cluster_centers, centers_j, 1e-4)
    check_close(tk.predict(torch.from_numpy(QUERY)), want, 0)
    carried = kmeans_from_numpy(centers_j, device="cpu")
    check_close(carried.predict(torch.from_numpy(QUERY)), want, 0)


def test_kmeans_generator_draws_distinct_seeded_centres():
    x = torch.from_numpy(PTS)
    c1, a1 = to.kmeans(x, 3, torch.Generator().manual_seed(1))
    c2, a2 = to.kmeans(x, 3, torch.Generator().manual_seed(1))
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    assert len(torch.unique(a1)) == 3
    km = to.KMeans(3, seed=1)
    km.fit(x)
    assert torch.equal(km.cluster_centers, c1)


@pytest.mark.parametrize("args", [(10, 4, None), ((9, 14), (3, 4), (2, 5)),
                                  (8, 4, 4), ((7, 7), 3, (2, 3))])
def test_compute_padding_follows_reference(args):
    assert to.compute_padding(*args) == jo.compute_padding(*args)


def test_lambda_wraps_a_callable():
    assert to.Lambda(lambda a, b=1: a + b)(2, b=3) == 5
    assert jo.Lambda(lambda a, b=1: a + b)(2, b=3) == 5
