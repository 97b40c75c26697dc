"""The port's distributed bundle adjustment and its mesh runtime
(kornia_tpu_torch.parallel: mesh, spmd, dist_ba) against the JAX package's
sharded functions on the CPU.

The port runs as D = 4 gloo ranks on the CPU (``spmd.spawn``, one world
for the whole module, one intra-op thread each); the JAX package runs
``shard_map`` over 4 of its 8 virtual CPU devices (``tests/conftest.py``),
jitted, once for the module. Both start from the same numpy problems
(``tests/torch_dist_workers.py``). Tolerances:

- ``build_sharded_point_tables``: exact (host numpy in both);
- one LM iteration from the same start (dense and sparse) at λ = 0.1
  (``torch_dist_workers.ONE_STEP_LAMBDA`` says why not the default):
  poses and points within 1e-4 of the largest entry of each, the cost
  at rtol 5e-4;
- dense, full run (``tests/test_slam.py::TestDistributedBA`` at D = 4,
  C = 4, 8 points a shard, 8 iterations): RMS reprojection error within
  0.05 px of the JAX run's, and below 0.5 px;
- sparse, full run (``tests/test_dist_ba_sparse.py``'s first test at
  D = 4: C = 10, P = 256, point_chunk 16, 10 iterations): final cost at
  rtol 2e-3 and points within 0.1, costs falling to a quarter;
- every rank's final state bitwise rank 0's; no rank imported JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.geometry.liegroup import Quaternion as JQuaternion
from kornia_tpu.geometry.liegroup import Se3 as JSe3
from kornia_tpu.geometry.liegroup import So3 as JSo3
from kornia_tpu.parallel import dist_ba as j_dba
from kornia_tpu.parallel.mesh import make_mesh as j_make_mesh
from kornia_tpu.slam.ba import BAState as JBAState
from kornia_tpu_torch import convert
from kornia_tpu_torch.parallel import dist_ba as t_dba
from kornia_tpu_torch.parallel import mesh as t_mesh
from kornia_tpu_torch.parallel import spmd
from kornia_tpu_torch.slam.ba import reprojection_residuals
from tests import torch_dist_workers as W
from tests.torch_threads import one_torch_thread  # noqa: F401

D = 4
SPARSE_KW = dict(num_iters=10, point_chunk=16)


@pytest.fixture(scope="module")
def problems():
    dense = W.dense_ba_arrays(D, 8, 4, seed=0)
    sparse = W.sparse_ba_arrays(10, 256, seed=7)
    return dense, sparse


@pytest.fixture(scope="module")
def port(problems):
    dense, sparse = problems
    tables = t_dba.build_sharded_point_tables(
        sparse["cam_idx"], sparse["pt_idx"], sparse["uv"], sparse["valid"],
        sparse["P"])
    return spmd.spawn(W.ba_worker, D, "gloo", "cpu", dense, sparse, tables,
                      SPARSE_KW)


def _j_state(a):
    return JBAState(JSe3(JSo3(JQuaternion(jnp.asarray(a["wxyz"]))),
                         jnp.asarray(a["t"])), jnp.asarray(a["points"]))


def _np_state(st, costs):
    return dict(wxyz=np.asarray(st.poses.r.q.data),
                t=np.asarray(st.poses.t), points=np.asarray(st.points),
                costs=np.asarray(costs))


@pytest.fixture(scope="module")
def ref(problems):
    dense, sparse = problems
    mesh = j_make_mesh((D, 1), devices=jax.devices()[:D])
    out = {}
    d_args = [jnp.asarray(dense[k])
              for k in ("cam_idx", "pt_idx", "uv", "valid", "K")]
    for n, lam in ((1, W.ONE_STEP_LAMBDA), (8, 1e-3)):
        fn = jax.jit(lambda s, *a, n=n, lam=lam:
                     j_dba.distributed_bundle_adjust(
                         mesh, s, *a, dense["C"], num_iters=n,
                         init_lambda=lam))
        out[f"dense_{n}"] = _np_state(*fn(_j_state(dense), *d_args))
    tables = j_dba.build_sharded_point_tables(
        sparse["cam_idx"], sparse["pt_idx"], sparse["uv"], sparse["valid"],
        sparse["P"])
    out["tables"] = tables
    s_args = [jnp.asarray(a) for a in tables] + [jnp.asarray(sparse["K"])]
    for n in (1, SPARSE_KW["num_iters"]):
        kw = dict(SPARSE_KW, num_iters=n)
        if n == 1:
            kw["init_lambda"] = W.ONE_STEP_LAMBDA
        fn = jax.jit(lambda s, *a, kw=kw:
                     j_dba.distributed_bundle_adjust_sparse(
                         mesh, s, *a, sparse["C"], **kw))
        out[f"sparse_{n}"] = _np_state(*fn(_j_state(sparse), *s_args))
    return out


def _rel_close(actual, expected, rtol):
    expected = np.asarray(expected)
    np.testing.assert_allclose(np.asarray(actual), expected,
                               atol=rtol * np.abs(expected).max(), rtol=0)


def _rms(state: dict, a: dict, pt_idx) -> float:
    s = convert.ba_state_from_numpy(state["wxyz"], state["t"],
                                    state["points"], "cpu")
    prob = convert.ba_problem_from_numpy(a["cam_idx"], pt_idx, a["uv"],
                                         a["valid"], a["K"], "cpu")
    r = reprojection_residuals(s, prob)
    return float(r.pow(2).sum(-1).mean().sqrt())


def test_point_tables_equal_the_reference(problems, ref):
    _, sparse = problems
    got = t_dba.build_sharded_point_tables(
        sparse["cam_idx"], sparse["pt_idx"], sparse["uv"], sparse["valid"],
        sparse["P"])
    for g, w in zip(got, ref["tables"]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_point_tables_keep_max_track_and_drop_invalid():
    cam = np.array([0, 1, 2, 3, 1])
    pt = np.array([1, 1, 1, 0, 0])
    valid = np.array([True, True, True, True, False])
    uv = np.arange(10, dtype=np.float32).reshape(5, 2)
    cams, uv_t, mask = t_dba.build_sharded_point_tables(cam, pt, uv, valid,
                                                        2, max_track=2)
    j = j_dba.build_sharded_point_tables(cam, pt, uv, valid, 2, max_track=2)
    for g, w in zip((cams, uv_t, mask), j):
        np.testing.assert_array_equal(g, w)
    assert mask.tolist() == [[True, False], [True, True]]


@pytest.mark.parametrize("path", ["dense", "sparse"])
def test_one_iteration_matches_the_reference(port, ref, path):
    got, want = port[f"{path}_1"], ref[f"{path}_1"]
    for k in ("wxyz", "t", "points"):
        _rel_close(got[k], want[k], 1e-4)
    # the JAX package's own first costs at 4 and 8 shards and on one
    # device spread by 2e-4 at this λ
    np.testing.assert_allclose(got["costs"], want["costs"], rtol=5e-4)


def test_dense_run_matches_the_reference(problems, port, ref):
    dense, _ = problems
    rms_t = _rms(port["dense_8"], dense, dense["pt_global"])
    rms_j = _rms(ref["dense_8"], dense, dense["pt_global"])
    assert abs(rms_t - rms_j) < 0.05
    assert rms_t < 0.5
    assert np.all(np.isfinite(port["dense_8"]["costs"]))


def test_sparse_run_matches_the_reference(port, ref):
    n = SPARSE_KW["num_iters"]
    got, want = port[f"sparse_{n}"], ref[f"sparse_{n}"]
    costs = got["costs"]
    assert np.all(np.isfinite(costs)) and costs[-1] < 0.25 * costs[0]
    np.testing.assert_allclose(costs[-1], want["costs"][-1], rtol=2e-3)
    np.testing.assert_allclose(got["points"], want["points"], atol=1e-1)


@pytest.mark.parametrize("key", ["dense_1", "dense_8", "sparse_1",
                                 f"sparse_{SPARSE_KW['num_iters']}"])
def test_every_rank_returns_rank_zeros_state(port, key):
    assert port[f"{key}_ranks_agree"]


def test_ranks_import_no_jax(port):
    assert port["jax_imported"] is False


def test_grid_mesh_sums_along_each_axis(port):
    """Rank 0 of a 2 x 2 mesh of 4 ranks: its data slice is ranks {0, 2},
    its model slice {0, 1}."""
    assert port["grid"] == {"coords": (0, 0), "data": 2.0, "model": 1.0}


def test_dense_refuses_a_coupling_block_past_512_mb():
    """The reference's guard: C * P_local * 18 floats a shard."""
    mesh = t_mesh.make_mesh(devices=["cpu"])
    C, P = 100, 80_000  # 576 MB
    state = convert.ba_state_from_numpy(
        np.tile([[1.0, 0, 0, 0]], (C, 1)), np.zeros((C, 3)),
        np.zeros((P, 3)), "cpu")
    obs = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="coupling block"):
        t_dba.distributed_bundle_adjust(
            mesh, state, obs, obs, torch.zeros(1, 2),
            torch.ones(1, dtype=torch.bool), torch.eye(3), C)


# --- the mesh runtime in one process --------------------------------------------

def test_one_rank_mesh_has_identity_collectives():
    mesh = t_mesh.make_mesh(devices=["cpu"])
    assert dict(mesh.shape) == {"data": 1, "model": 1}
    assert mesh.axis_names == ("data", "model")
    assert mesh.rank("data") == 0 and mesh.device == torch.device("cpu")
    x = torch.arange(6.0)
    assert mesh.all_reduce(x) is x
    assert torch.equal(mesh.all_gather(x), x)
    assert mesh.counts["all_reduce"] == 0


def test_make_mesh_checks_its_shape():
    with pytest.raises(ValueError, match="holds 2 ranks"):
        t_mesh.make_mesh((2, 1), devices=["cpu"])
    with pytest.raises(ValueError, match="does not name its axes"):
        t_mesh.make_mesh((1,), devices=["cpu"])


def test_shard_batch_takes_the_ranks_block():
    mesh = t_mesh.make_mesh(devices=["cpu"])
    x = torch.arange(12.0).view(4, 3)
    assert torch.equal(t_mesh.shard_batch(x, mesh), x)
    sh = t_mesh.data_sharding(mesh, 2, axis=1)
    assert sh.spec == t_mesh.P(None, "data")
    assert t_mesh.replicated(mesh).spec == t_mesh.P()
    with t_mesh.use_mesh(mesh):
        assert t_mesh.local_mesh() is mesh
        assert torch.equal(t_mesh.shard_batch(x), x)


def test_spawn_refuses_a_backend_it_cannot_run():
    with pytest.raises(ValueError, match="backend"):
        spmd.spawn(W.ba_worker, 2, "mpi", "cpu")
    with pytest.raises(ValueError, match="nccl runs on CUDA"):
        spmd.spawn(W.ba_worker, 2, "nccl", "cpu")
