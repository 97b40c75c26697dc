"""LoFTR's context-parallel coarse stage (kornia_tpu_torch.feature.loftr.
loftr_coarse_context_parallel) against the JAX package's on the CPU.

As ``tests/test_loftr_context_parallel.py``: 2 layer pairs at the published
width (256 channels, 8 heads), L = 128 tokens a view. The port runs as D = 4
gloo ranks on the CPU (32 tokens each), the JAX package ``shard_map`` over
4 virtual CPU devices, jitted. Weights are drawn with numpy (the transformer
only: Linear weights at 1/sqrt(fan-in), layer norms near 1 and 0). Outputs
within atol 2e-5 / rtol 1e-5 of the JAX package's and of the port's own
single-device ``_transformer``; a one-rank mesh (no process group) gives
``_transformer``'s result exactly; one all_reduce per attention.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.feature import loftr as j_loftr
from kornia_tpu.parallel.mesh import make_mesh as j_make_mesh
from kornia_tpu_torch.feature import loftr as t_loftr
from kornia_tpu_torch.parallel import mesh as t_mesh
from kornia_tpu_torch.parallel import spmd
from tests import torch_dist_workers as W
from tests.torch_threads import one_torch_thread  # noqa: F401

D = 4
CFG = dict(num_coarse_layers=2)
L = 128


@pytest.fixture(scope="module")
def inputs():
    params, f0, f1 = W.loftr_coarse_arrays(CFG, L)
    return t_loftr.LoFTRConfig(**CFG), params, f0, f1


@pytest.fixture(scope="module")
def port(inputs):
    _, params, f0, f1 = inputs
    return spmd.spawn(W.loftr_worker, D, "gloo", "cpu", params, CFG, f0, f1)


@pytest.fixture(scope="module")
def ref(inputs):
    _, params, f0, f1 = inputs
    cfg = j_loftr.LoFTRConfig(**CFG)
    mesh = j_make_mesh((D, 1), devices=jax.devices()[:D])
    run = jax.jit(lambda p, a, b: j_loftr.loftr_coarse_context_parallel(
        p, cfg, a, b, mesh))
    o0, o1 = run({k: jnp.asarray(v) for k, v in params.items()},
                 jnp.asarray(f0), jnp.asarray(f1))
    return np.asarray(o0), np.asarray(o1)


def _single(inputs):
    cfg, params, f0, f1 = inputs
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    with torch.no_grad():
        return t_loftr._transformer(p, "loftr_coarse", cfg.num_coarse_layers,
                                    cfg.num_heads, torch.from_numpy(f0),
                                    torch.from_numpy(f1))


@pytest.mark.parametrize("view", [0, 1])
def test_context_parallel_matches_the_reference(port, ref, view):
    np.testing.assert_allclose(port[f"out{view}"], ref[view], atol=2e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("view", [0, 1])
def test_context_parallel_matches_the_single_device_transformer(
        inputs, port, view):
    np.testing.assert_allclose(port[f"out{view}"],
                               _single(inputs)[view].numpy(), atol=2e-5,
                               rtol=1e-5)


def test_ranks_agree_and_reduce_once_per_attention(port):
    assert port["ranks_agree"]
    assert port["all_reduces"] == 4 * CFG["num_coarse_layers"]
    assert port["jax_imported"] is False


def test_one_rank_mesh_is_the_single_device_transformer(inputs):
    cfg, params, f0, f1 = inputs
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    o0, o1 = t_loftr.loftr_coarse_context_parallel(
        p, cfg, torch.from_numpy(f0), torch.from_numpy(f1),
        t_mesh.make_mesh(devices=["cpu"]))
    s0, s1 = _single(inputs)
    assert torch.equal(o0, s0) and torch.equal(o1, s1)


def test_tokens_must_split_over_the_ranks(inputs):
    cfg, params, f0, _ = inputs
    mesh = t_mesh.make_mesh(devices=["cpu"])
    mesh.shape["data"] = 3  # a mesh of 3 ranks, seen from rank 0
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="does not split over 3 ranks"):
        t_loftr.loftr_coarse_context_parallel(
            p, cfg, torch.from_numpy(f0), torch.from_numpy(f0), mesh)
