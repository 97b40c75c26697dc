"""The port's pose-graph optimisers (kornia_tpu_torch.slam.posegraph:
``optimize_pose_graph`` over Se3, ``optimize_pose_graph_sim3``) against the
JAX package on the CPU, on the 10-pose loop of
``tests/test_slam.py::TestPoseGraph`` (a chain with one loop-closure edge,
0.1 rad / 0.2 noise on the initial poses). The graph and the initial poses
are exported from JAX through ``kornia_tpu_torch.convert``.

Tolerances: per-iteration costs 1e-4 relative for Se3 and 1e-3 for Sim3
(its log-scales are observed only through the translations and a prior of
weight 0.05, and its steps differ by up to 3e-4), plus 1e-9 of the initial
cost absolute (the last costs are about 1e-13, float32 rounding of the
residuals at the optimum); final translations, quaternions and Sim3 scales
1e-5 absolute; the loop's relative poses are recovered to 1e-3, as the
reference's test holds JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.geometry.liegroup import Se3, So3
from kornia_tpu.slam import posegraph as j_pg
from kornia_tpu_torch import convert
from kornia_tpu_torch.geometry import liegroup as tl
from kornia_tpu_torch.slam import posegraph as t_pg
from tests.torch_threads import one_torch_thread  # noqa: F401

N = 10


@jax.jit
def _j_loop(key):
    """The test's loop, built under jit (eagerly it dispatches op by op)."""
    ks = jax.random.split(key, 3)
    poses_gt = Se3.exp(jax.random.normal(ks[0], (N, 6)) * 0.3)
    src = np.concatenate([np.arange(N - 1), [0]])
    dst = np.concatenate([np.arange(1, N), [N - 1]])
    Ti = Se3(So3.from_wxyz(poses_gt.r.q.data[src]), poses_gt.t[src])
    Tj = Se3(So3.from_wxyz(poses_gt.r.q.data[dst]), poses_gt.t[dst])
    init = Se3(Se3.exp(0.1 * jax.random.normal(ks[1], (N, 6))).r
               * poses_gt.r,
               poses_gt.t + 0.2 * jax.random.normal(ks[2], (N, 3)))
    return Ti.inverse() * Tj, init


@pytest.fixture(scope="module")
def loop():
    meas, init = _j_loop(jax.random.PRNGKey(0))
    src = np.concatenate([np.arange(N - 1), [0]])
    dst = np.concatenate([np.arange(1, N), [N - 1]])
    E = src.shape[0]
    graph = j_pg.PoseGraph(jnp.asarray(src), jnp.asarray(dst), meas,
                           jnp.ones(E), jnp.ones(E, bool))
    t_graph = convert.pose_graph_from_numpy(src, dst, meas.r.q.data, meas.t,
                                            graph.weight, graph.valid, "cpu")
    t_init = convert.se3_from_numpy(init.r.q.data, init.t, "cpu")
    return dict(graph=graph, init=init, t_graph=t_graph, t_init=t_init,
                meas=meas, src=src, dst=dst)


def _costs_close(ct, cj, rtol):
    cj = np.asarray(cj)
    np.testing.assert_allclose(ct.numpy(), cj, rtol=rtol, atol=1e-9 * cj[0])


def _loop_recovered(poses, loop):
    """Every edge's relative pose reproduces its measurement to 1e-3."""
    for e, (i, j) in enumerate(zip(loop["src"], loop["dst"])):
        Ti = tl.Se3(tl.So3.from_wxyz(poses.r.q.data[i]), poses.t[i])
        Tj = tl.Se3(tl.So3.from_wxyz(poses.r.q.data[j]), poses.t[j])
        rel = (Ti.inverse() * Tj).matrix().numpy()
        meas = np.asarray(Se3(So3.from_wxyz(loop["meas"].r.q.data[e]),
                              loop["meas"].t[e]).matrix())
        assert np.abs(rel - meas).max() < 1e-3


def test_optimize_pose_graph_matches(loop):
    pj, cj = j_pg.optimize_pose_graph(loop["init"], loop["graph"],
                                      num_iters=8)
    pt, ct = t_pg.optimize_pose_graph(loop["t_init"], loop["t_graph"],
                                      num_iters=8)
    _costs_close(ct, cj, 1e-4)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pt.r.q.data.numpy(), np.asarray(pj.r.q.data),
                               atol=1e-5, rtol=0)
    _loop_recovered(pt, loop)


def test_optimize_pose_graph_sim3_matches(loop):
    pj, sj, cj = j_pg.optimize_pose_graph_sim3(loop["init"], loop["graph"])
    pt, st, ct = t_pg.optimize_pose_graph_sim3(loop["t_init"],
                                               loop["t_graph"])
    _costs_close(ct, cj, 1e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pt.r.q.data.numpy(), np.asarray(pj.r.q.data),
                               atol=1e-5, rtol=0)
    assert ct[-1] < 1e-6 * ct[0]


def test_pose_graph_edge_jacobians_match(loop):
    """The per-edge 6×12 and 7×14 Jacobians at zero tangents, finite and
    equal to jax.jacfwd's (1e-5 of the largest entry)."""
    from torch.func import jacfwd, vmap
    g, p = loop["graph"], loop["init"]
    q, t = p.r.q.data, p.t
    args = (q[g.src], t[g.src], q[g.dst], t[g.dst], g.meas.r.q.data,
            g.meas.t)
    J_j = jax.jit(jax.vmap(jax.jacfwd(
        lambda d, *a: j_pg._edge_residual(d[:6], d[6:], *a)),
        in_axes=(None,) + (0,) * 6))(jnp.zeros(12), *args)
    J_t = vmap(jacfwd(lambda d, *a: t_pg._edge_residual(d[:6], d[6:], *a)),
               in_dims=(None,) + (0,) * 6)(
        torch.zeros(12), *(torch.from_numpy(np.array(a)) for a in args))
    assert torch.isfinite(J_t).all()
    np.testing.assert_allclose(J_t.numpy(), np.asarray(J_j),
                               atol=1e-5 * np.abs(np.asarray(J_j)).max())
    ls = jnp.zeros(N)
    s_args = (q[g.src], t[g.src], ls[g.src], q[g.dst], t[g.dst], ls[g.dst],
              g.meas.r.q.data, g.meas.t)
    S_j = jax.jit(jax.vmap(jax.jacfwd(
        lambda d, *a: j_pg._sim3_edge_residual(d[:7], d[7:], *a)),
        in_axes=(None,) + (0,) * 8))(jnp.zeros(14), *s_args)
    S_t = vmap(jacfwd(
        lambda d, *a: t_pg._sim3_edge_residual(d[:7], d[7:], *a)),
        in_dims=(None,) + (0,) * 8)(
        torch.zeros(14), *(torch.from_numpy(np.array(a)) for a in s_args))
    assert torch.isfinite(S_t).all()
    np.testing.assert_allclose(S_t.numpy(), np.asarray(S_j),
                               atol=1e-5 * np.abs(np.asarray(S_j)).max())
