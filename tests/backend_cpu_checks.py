"""CPU checks of the port's SLAM back end that need no card, run from the
repository's root:

    python3 -m tests.backend_cpu_checks ops  # operations per LM iteration
    python3 -m tests.backend_cpu_checks sfm  # incremental_sfm, JAX vs port

Not a test module (pytest does not collect it): ``sfm`` takes minutes.

``ops`` profiles one and three iterations of each optimiser on the CPU at
chip_smoke.py's configurations (dense and sparse BA at bench.py's problem,
the pose graphs on a 64-pose ring) and prints half their difference in
top-level ``aten`` operations: what one LM iteration dispatches, each a
kernel launch or more on the card.

``sfm`` runs chip_smoke.py's ``incremental_sfm`` input (12 views x 2,000
points, 480 x 640 intrinsics, 0.3 px noise, the same numpy draws) through the
JAX package and through the port on the CPU and prints each one's final
RMS, Sim3-aligned camera-centre ATE and seconds: whether the JAX package
meets ``tests/test_sfm.py``'s bounds (RMS < 0.8 px, ATE < 0.05) at this
size. The JAX run takes minutes.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

import chip_smoke as cs

V, N = 12, 2000


def count_ops() -> None:
    from torch.profiler import ProfilerActivity, profile

    from kornia_tpu_torch.slam.ba import bundle_adjust
    from kornia_tpu_torch.slam.ba_sparse import (build_point_tables,
                                                 bundle_adjust_sparse)
    from kornia_tpu_torch.slam.posegraph import (optimize_pose_graph,
                                                 optimize_pose_graph_sim3)

    def top_level_ops(fn) -> int:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
        return sum(1 for e in prof.events() if e.name.startswith("aten::")
                   and (e.cpu_parent is None
                        or not e.cpu_parent.name.startswith("aten::")))

    C, P, arrs = cs.bench_ba_arrays()
    state, prob = cs.ba_on(arrs, "cpu")
    oi, om = (torch.from_numpy(a) for a in build_point_tables(
        arrs["cam_idx"], arrs["pt_idx"], arrs["valid"], P))
    poses, graph = cs.pose_graph_on(cs.ring_arrays(64), "cpu")
    runs = {
        "bundle_adjust": lambda n: bundle_adjust(state, prob, C, P,
                                                 num_iters=n),
        "bundle_adjust_sparse": lambda n: bundle_adjust_sparse(
            state, prob, oi, om, C, P, num_iters=n),
        "optimize_pose_graph": lambda n: optimize_pose_graph(
            poses, graph, num_iters=n),
        "optimize_pose_graph_sim3": lambda n: optimize_pose_graph_sim3(
            poses, graph, num_iters=n),
    }
    for name, run in runs.items():
        one = top_level_ops(lambda: run(1))
        three = top_level_ops(lambda: run(3))
        print(f"{name}: {(three - one) / 2:.0f} top-level aten ops an LM "
              f"iteration")


def sfm_input():
    """chip_smoke.py's backend_sfm draws."""
    rng = np.random.default_rng(0)
    draws = {"aa": rng.standard_normal((V, 3)),
             "t": rng.standard_normal((V, 3, 1)),
             "X": rng.standard_normal((N, 3))}
    noise = 0.3 * rng.standard_normal((V, N, 2))
    return draws, noise


def centres(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return np.einsum("vji,vj->vi", R, -t)


def sfm_port() -> None:
    from kornia_tpu_torch.geometry.scene import generate_scene
    from kornia_tpu_torch.metrics.metrics import ate_rmse
    from kornia_tpu_torch.slam.sfm import incremental_sfm
    draws, noise = sfm_input()
    s = generate_scene(V, N, image_size=(480.0, 640.0), rotation_scale=0.15,
                       translation_scale=0.4,
                       draws={k: torch.from_numpy(v) for k, v in
                              draws.items()}, device="cpu")
    obs = (s["points2d"].numpy() + noise).astype(np.float32)
    t0 = time.perf_counter()
    r = incremental_sfm(obs, np.ones((V, N), bool), s["K"][0], ba_iters=10,
                        device="cpu")
    dt = time.perf_counter() - t0
    C = centres(r.poses.r.matrix().numpy(), r.poses.t.numpy())
    C_gt = centres(s["R"].numpy(), s["t"].numpy()[..., 0])
    ate = float(ate_rmse(torch.from_numpy(C), torch.from_numpy(C_gt),
                         with_scale=True))
    print(f"port (CPU): final RMS {r.final_rms:.6f} px, Sim3 ATE {ate:.4e}, "
          f"{dt:.2f} s")


def sfm_jax() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from kornia_tpu.geometry.conversions import axis_angle_to_rotation_matrix
    from kornia_tpu.geometry.epipolar import projection_from_KRt
    from kornia_tpu.metrics import ate_rmse
    from kornia_tpu.slam.sfm import incremental_sfm
    draws, noise = sfm_input()
    # kornia_tpu.geometry.scene.generate_scene with the same normal draws
    h, w = 480.0, 640.0
    f = 0.8 * max(h, w)
    K = jnp.broadcast_to(jnp.array([[f, 0.0, w / 2], [0.0, f, h / 2],
                                    [0.0, 0.0, 1.0]]), (V, 3, 3))
    aa = jnp.asarray(draws["aa"], jnp.float32) * 0.15
    R = axis_angle_to_rotation_matrix(aa).at[0].set(jnp.eye(3))
    t = (jnp.asarray(draws["t"], jnp.float32) * 0.4).at[0].set(0.0)
    X = jnp.asarray(draws["X"], jnp.float32) * 1.5 + jnp.array([0.0, 0, 6])
    x_h = jnp.einsum("vij,nj->vni", projection_from_KRt(K, R, t),
                     jnp.concatenate([X, jnp.ones((N, 1))], -1))
    obs = np.asarray(x_h[..., :2] / x_h[..., 2:]) + noise
    t0 = time.perf_counter()
    r = incremental_sfm(jnp.asarray(obs, jnp.float32),
                        jnp.ones((V, N), bool), K[0], ba_iters=10)
    dt = time.perf_counter() - t0
    C = centres(np.asarray(r.poses.r.matrix()), np.asarray(r.poses.t))
    C_gt = centres(np.asarray(R), np.asarray(t)[..., 0])
    ate = float(ate_rmse(jnp.asarray(C), jnp.asarray(C_gt), with_scale=True))
    print(f"JAX package (CPU): final RMS {r.final_rms:.6f} px, Sim3 ATE "
          f"{ate:.4e}, {dt:.2f} s")


def main() -> int:
    what = sys.argv[1] if len(sys.argv) > 1 else ""
    if what == "ops":
        count_ops()
    elif what == "sfm":
        sfm_port()
        sfm_jax()
    else:
        print(__doc__)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
