"""The port's distributed pose graphs (kornia_tpu_torch.parallel.
dist_posegraph) against the JAX package's sharded functions on the CPU.

The port runs as D = 4 gloo ranks on the CPU (one world for the module);
the JAX package runs ``shard_map`` over 4 virtual CPU devices, jitted, once
for the module. Graphs are ``tests/test_dist_posegraph.py``'s 48-pose loop
and ``benchmarks/scaling_bench.py``'s circuit, drawn with numpy
(``tests/torch_dist_workers.py``). Tolerances:

- ``partition_pose_graph``: exact (host numpy in both);
- one LM iteration of the dense path from the same start: poses within
  1e-4 of the largest entry of each array;
- 12 iterations of the dense path (``tests/test_dist_posegraph.py:56-70``):
  translations within 1e-4 of the JAX run's, |q·q'| within 1e-5 of 1, the
  final cost below 1e-9;
- the streaming path against the port's and the JAX package's dense
  path (``tests/test_dist_posegraph.py:82-98``): translations within 1e-3,
  |q·q'| within 1e-5 of 1;
- the dense path refuses a graph past ``max_separators``;
- every rank's result bitwise rank 0's; no rank imported JAX.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.geometry.liegroup import Quaternion as JQuaternion
from kornia_tpu.geometry.liegroup import Se3 as JSe3
from kornia_tpu.geometry.liegroup import So3 as JSo3
from kornia_tpu.parallel import dist_posegraph as j_dpg
from kornia_tpu.parallel.mesh import make_mesh as j_make_mesh
from kornia_tpu.slam.posegraph import PoseGraph as JPoseGraph
from kornia_tpu_torch.parallel import dist_posegraph as t_dpg
from kornia_tpu_torch.parallel import mesh as t_mesh
from kornia_tpu_torch.parallel import spmd
from tests import torch_dist_workers as W
from tests.torch_threads import one_torch_thread  # noqa: F401

D = 4
RUNS = {"loop": (("dense", 1, {}), ("dense", 12, {}),
                 ("streaming", 12, {}))}
JAX_RUNS = RUNS["loop"][:2]
PART_FIELDS = ("sep_ids", "int_ids", "int_valid", "src", "dst", "edge_id",
               "edge_w", "num_separators", "num_internal")


@pytest.fixture(scope="module")
def graphs():
    return {"loop": W.loop_graph_arrays(),
            "circuit": W.circuit_graph_arrays(256, 64)}


@pytest.fixture(scope="module")
def parts(graphs):
    return {k: t_dpg.partition_pose_graph(g["src"], g["dst"], g["valid"],
                                          g["N"], D)
            for k, g in graphs.items()}


@pytest.fixture(scope="module")
def port(graphs, parts):
    return spmd.spawn(W.posegraph_worker, D, "gloo", "cpu",
                      {"loop": graphs["loop"]}, {"loop": parts["loop"]},
                      RUNS)


def _j_graph(g):
    se3 = lambda q, t: JSe3(JSo3(JQuaternion(jnp.asarray(q))),
                            jnp.asarray(t))
    return (se3(g["wxyz"], g["t"]),
            JPoseGraph(jnp.asarray(g["src"]), jnp.asarray(g["dst"]),
                       se3(g["meas_wxyz"], g["meas_t"]),
                       jnp.asarray(g["weight"]), jnp.asarray(g["valid"])))


@pytest.fixture(scope="module")
def ref(graphs):
    mesh = j_make_mesh((D,), ("data",), devices=jax.devices()[:D])
    g = graphs["loop"]
    part = j_dpg.partition_pose_graph(g["src"], g["dst"], g["valid"], g["N"],
                                      D)
    out = {"parts": {k: j_dpg.partition_pose_graph(
        a["src"], a["dst"], a["valid"], a["N"], D)
        for k, a in graphs.items()}}
    poses, graph = _j_graph(g)
    for path, n, kw in JAX_RUNS:
        run = jax.jit(lambda p, gr, n=n, kw=kw: j_dpg.distributed_pose_graph(
            mesh, p, gr, part, num_iters=n, **kw))
        p, costs = run(poses, graph)
        out[f"loop_{path}_{n}"] = dict(wxyz=np.asarray(p.r.q.data),
                                       t=np.asarray(p.t),
                                       costs=np.asarray(costs))
    return out


@pytest.mark.parametrize("name", ["loop", "circuit"])
def test_partition_equals_the_reference(parts, ref, name):
    got, want = parts[name], ref["parts"][name]
    for f in PART_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        np.testing.assert_array_equal(g, w)
        assert np.asarray(g).dtype == np.asarray(w).dtype


def _dots(a, b):
    return np.abs(np.sum(a * b, -1))


def test_one_dense_iteration_matches_the_reference(port, ref):
    got, want = port["loop_dense_1"], ref["loop_dense_1"]
    for k in ("wxyz", "t"):
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max())


def test_dense_run_matches_the_reference(port, ref):
    got, want = port["loop_dense_12"], ref["loop_dense_12"]
    assert float(got["costs"][-1]) < 1e-9
    assert np.abs(got["t"] - want["t"]).max() < 1e-4
    np.testing.assert_allclose(_dots(got["wxyz"], want["wxyz"]), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("against", ["port_dense", "jax_dense"])
def test_streaming_run_matches_the_dense_path(port, ref, against):
    got = port["loop_streaming_12"]
    want = (port if against == "port_dense" else ref)["loop_dense_12"]
    assert float(got["costs"][-1]) < 1e-9
    assert np.abs(got["t"] - want["t"]).max() < 1e-3
    np.testing.assert_allclose(_dots(got["wxyz"], want["wxyz"]), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("key", ["loop_dense_1", "loop_dense_12",
                                 "loop_streaming_12"])
def test_every_rank_returns_rank_zeros_poses(port, key):
    assert port[f"{key}_ranks_agree"]


def test_ranks_import_no_jax(port):
    assert port["jax_imported"] is False


def test_dense_refuses_past_max_separators():
    """``tests/test_dist_posegraph.py``'s 1,024-pose circuit with 520 long
    edges over 8 shards: 512 or more separators, past the 384 bound."""
    g = W.circuit_graph_arrays(1024, 520, seed=0)
    part = t_dpg.partition_pose_graph(g["src"], g["dst"], g["valid"],
                                      g["N"], 8)
    assert part.num_separators > 384
    poses, graph = W.graph_on(g, "cpu")
    with pytest.raises(ValueError, match="max_separators"):
        t_dpg.distributed_pose_graph(t_mesh.make_mesh(devices=["cpu"]),
                                     poses, graph, part, num_iters=2)


def test_one_rank_mesh_matches_the_single_device_solver():
    """With no process group the mesh is one rank: the dense path, all
    poses internal but pose 0, agrees with optimize_pose_graph."""
    from kornia_tpu_torch.slam.posegraph import optimize_pose_graph
    g = W.loop_graph_arrays(seed=2)
    part = t_dpg.partition_pose_graph(g["src"], g["dst"], g["valid"],
                                      g["N"], 1)
    poses, graph = W.graph_on(g, "cpu")
    pd, cd = t_dpg.distributed_pose_graph(t_mesh.make_mesh(devices=["cpu"]),
                                          poses, graph, part, num_iters=6)
    ps, cs = optimize_pose_graph(poses, graph, num_iters=6)
    assert float(cd[-1]) < 1e-6 * float(cd[0])
    assert float((pd.t - ps.t).abs().max()) < 1e-4
    dots = (pd.r.q.data * ps.r.q.data).sum(-1).abs()
    torch.testing.assert_close(dots, torch.ones_like(dots), atol=1e-5,
                               rtol=0)
