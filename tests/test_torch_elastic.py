"""Checkpoints, restartable jobs and SPMD rank failures
(kornia_tpu_torch.utils.{checkpoint,elastic}, parallel.spmd) on the CPU.

- ``run_restartable`` resumes as the JAX package's does
  (``tests/test_debug_elastic.py:46-58``): the same step function run
  through both from the same start gives the same states and the same
  ``step_<n>`` checkpoints; a run stopped at step 5 of 6 resumes from
  ``step_4``.
- In a world of 2 gloo ranks, ``run_restartable`` drives 6 LM iterations
  of the dense distributed BA (state and λ checkpointed every 2): a run
  stopped at step 5 resumes from ``step_4`` and ends bitwise where an
  uninterrupted run ends, which is where ``distributed_bundle_adjust``
  with 6 iterations ends.
- A checkpoint's round trip is bitwise; with a target it lands on the
  target's dtypes, without one on the requested device; it names no class
  outside the port.
- A rank that raises fails ``spawn``, naming the rank.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.utils import elastic as j_elastic
from kornia_tpu_torch import convert
from kornia_tpu_torch.parallel import spmd
from kornia_tpu_torch.utils import checkpoint as t_ckpt
from kornia_tpu_torch.utils import elastic as t_elastic
from tests import torch_dist_workers as W
from tests.torch_threads import one_torch_thread  # noqa: F401


class _Stop(Exception):
    pass


def _affine(x):
    return {"x": x["x"] * 0.5 + 1.0, "n": x["n"] + 1}


def _stopping(step_fn, at):
    calls = []

    def fn(s):
        calls.append(1)
        if len(calls) == at:
            raise _Stop(at)
        return step_fn(s)
    return fn, calls


def _run_pair(run, init, d):
    """A run stopped at step 5 of 6, then resumed: (state, steps of the
    resumed run, newest checkpoint after the stop)."""
    fn, _ = _stopping(_affine, 5)
    with pytest.raises(_Stop):
        run(fn, init, 6, d, checkpoint_every=2)
    newest = j_elastic.latest_checkpoint(d)
    fn, calls = _stopping(_affine, 0)
    return run(fn, init, 6, d, checkpoint_every=2), len(calls), newest


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("jax") / "run")
    init = {"x": jnp.asarray(0.0), "n": jnp.asarray(0)}
    out, steps, newest = _run_pair(j_elastic.run_restartable, init, d)
    return dict(x=float(out["x"]), n=int(out["n"]), steps=steps,
                newest=newest[0], listing=sorted(os.listdir(d)))


def test_resume_matches_the_reference(ref, tmp_path):
    d = str(tmp_path / "run")
    init = {"x": torch.tensor(0.0), "n": torch.tensor(0)}
    out, steps, newest = _run_pair(t_elastic.run_restartable, init, d)
    assert newest[0] == ref["newest"] == 4
    assert steps == ref["steps"] == 2
    assert float(out["x"]) == ref["x"] and int(out["n"]) == ref["n"] == 6
    assert sorted(os.listdir(d)) == ref["listing"]
    assert t_elastic.latest_checkpoint(d) == j_elastic.latest_checkpoint(d)


def test_resume_from_checkpoint(tmp_path):
    """``tests/test_debug_elastic.py:46-58`` on the port."""
    calls = []

    def step(state):
        calls.append(1)
        return {"x": state["x"] + 1.0}

    ck = str(tmp_path / "run")
    out = t_elastic.run_restartable(step, {"x": torch.tensor(0.0)}, 5, ck,
                                    checkpoint_every=2)
    assert float(out["x"]) == 5.0
    assert t_elastic.latest_checkpoint(ck)[0] == 5
    calls.clear()
    out2 = t_elastic.run_restartable(step, {"x": torch.tensor(0.0)}, 5, ck,
                                     checkpoint_every=2)
    assert float(out2["x"]) == 5.0 and not calls
    out3 = t_elastic.run_restartable(step, {"x": torch.tensor(0.0)}, 8, ck,
                                     checkpoint_every=2)
    assert float(out3["x"]) == 8.0 and len(calls) == 3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    dense = W.dense_ba_arrays(2, 8, 4, seed=3)
    root = str(tmp_path_factory.mktemp("ranks"))
    return spmd.spawn(W.restart_worker, 2, "gloo", "cpu", dense, root, 6, 5)


def test_distributed_restart_resumes_from_step_4(world):
    assert world["stopped_at"] == 5
    assert world["newest_step"] == 4
    assert world["resumed_steps"] == 2
    assert world["listing"] == ["step_2", "step_4", "step_6"]
    assert world["jax_imported"] is False


@pytest.mark.parametrize("other", ["whole", "direct"])
def test_distributed_restart_ends_where_an_uninterrupted_run_ends(
        world, other):
    for k in ("wxyz", "t", "points"):
        np.testing.assert_array_equal(world["resumed"][k], world[other][k])
    assert world["whole_cost"] == world["direct_costs"][-1]


def _tree():
    dense = W.dense_ba_arrays(1, 4, 3)
    return {"state": convert.ba_state_from_numpy(
        dense["wxyz"], dense["t"], dense["points"], "cpu"),
        "lam": torch.tensor(1e-3), "step": 3, "hist": [torch.arange(3), 2.5],
        "name": "ba"}


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    tree = _tree()
    path = str(tmp_path / "ck" / "step_3")
    t_ckpt.save_checkpoint(path, tree)
    assert os.listdir(tmp_path / "ck") == ["step_3"]
    for back in (t_ckpt.load_checkpoint(path, device="cpu"),
                 t_ckpt.load_checkpoint(path, tree)):
        s, s0 = back["state"], tree["state"]
        assert type(s) is type(s0) and type(s.poses) is type(s0.poses)
        for a, b in ((s.poses.r.q.data, s0.poses.r.q.data),
                     (s.poses.t, s0.poses.t), (s.points, s0.points),
                     (back["lam"], tree["lam"]),
                     (back["hist"][0], tree["hist"][0])):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert back["step"] == 3 and back["hist"][1] == 2.5
        assert back["name"] == "ba"


def test_checkpoint_restores_onto_the_targets_dtype(tmp_path):
    path = str(tmp_path / "step_1")
    t_ckpt.save_checkpoint(path, {"x": torch.arange(4, dtype=torch.float32)})
    back = t_ckpt.load_checkpoint(path, {"x": torch.zeros(4,
                                                          dtype=torch.float64)})
    assert back["x"].dtype == torch.float64
    assert back["x"].tolist() == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(ValueError, match="other keys"):
        t_ckpt.load_checkpoint(path, {"y": torch.zeros(4)})
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.load_checkpoint(path, {"x": torch.zeros(5)})


def test_checkpoint_names_no_class_outside_the_port(tmp_path):
    path = str(tmp_path / "step_1")
    torch.save({"__dataclass__": "collections:OrderedDict"}, path)
    with pytest.raises(ValueError, match="outside"):
        t_ckpt.load_checkpoint(path, device="cpu")


def test_a_failed_save_leaves_no_checkpoint(tmp_path):
    path = str(tmp_path / "step_2")
    with pytest.raises(Exception):
        t_ckpt.save_checkpoint(path, {"f": lambda x: x})
    assert os.listdir(tmp_path) == []
    assert t_elastic.latest_checkpoint(str(tmp_path)) is None


def test_a_failing_rank_fails_spawn_naming_it():
    with pytest.raises(RuntimeError, match=r"spmd rank 1 of 2 failed"
                       r"(.|\n)*rank 1 fails"):
        spmd.spawn(W.failing_worker, 2, "gloo", "cpu", 1)
