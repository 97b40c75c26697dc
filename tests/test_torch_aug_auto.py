"""Parity of the port's auto-augmentation policies
(``kornia_tpu_torch/augmentation/auto.py``) with the JAX package.

The JAX policies draw inside their call: the test draws as each JAX
policy does (the same key splits) and runs the policy on the same key, in
one program (XLA's default passes: for these inputs they leave
posterize's and equalize's integer bins where the exact program puts
them); the port takes those draws injected (``draws=``) and must give
the JAX output. Sizes 2 × 3 × 32 × 32. Tolerances: 1e-5 for the policies
(every op's output lies in [0, 1]); 1e-4 of the largest for the
magnitude gradients of ``Operation``. Mirrors the non-reference legs of
tests/test_autoaugment_policies.py.
"""

import numpy as np
import pytest
import torch

import kornia_tpu.augmentation.auto as JX
import kornia_tpu_torch.augmentation.auto as TX
from tests.torch_op_parity import (FAST_OPTIONS, check_close, exact_jit,
                                   rand)
from tests.torch_threads import one_torch_thread  # noqa: F401

X = rand(2, 3, 32, 32, seed=11)
B = X.shape[0]
POLICIES = ("imagenet", "cifar10", "svhn")
# held against the JAX package's outputs: one policy runs the code of
# them all (the tables are held entry for entry below, and each policy
# runs on the generator)
PARITY_POLICIES = ("imagenet",)


def _rand_augment_draws(key, n, m):
    import jax
    import jax.numpy as jnp
    draws = []
    for _ in range(n):
        key, k1, k2 = jax.random.split(key, 3)
        draws.append({
            "op_idx": jax.random.randint(k1, (B,), 0, len(JX._OPS)),
            "signs": jnp.where(jax.random.bernoulli(k2, 0.5, (B,)), 1.0,
                               -1.0)})
    return draws


def _trivial_draws(key):
    import jax
    import jax.numpy as jnp
    k1, k2, k3 = jax.random.split(key, 3)
    return {"op_idx": jax.random.randint(k1, (B,), 0, len(JX._OPS)),
            "mag01": jax.random.uniform(k2, (B,)),
            "signs": jnp.where(jax.random.bernoulli(k3, 0.5, (B,)), 1.0,
                               -1.0)}


def _auto_draws(aa, key):
    import jax
    key, ksel = jax.random.split(key)
    sub = jax.random.randint(ksel, (B,), 0, len(aa.policy))
    steps = []
    for _, prob_t, _, _ in aa._tables:
        key, kp, km = jax.random.split(key, 3)
        steps.append({"u": jax.random.uniform(km, (B,)),
                      "gate": jax.random.uniform(kp, (B,)) < prob_t[sub]})
    return {"sub_idx": sub, "steps": steps}


@pytest.fixture(scope="module")
def refs():
    import jax

    def program(x):
        out = {}
        k = jax.random.PRNGKey(3)
        # one step: a second repeats the first's code on its output
        out["RandAugment"] = (_rand_augment_draws(k, 1, 10),
                              JX.RandAugment(1, 10)(x, k))
        out["TrivialAugment"] = (_trivial_draws(k), JX.TrivialAugment()(x, k))
        for i, name in enumerate(PARITY_POLICIES):
            aa = JX.AutoAugment(name)
            k = jax.random.PRNGKey(10 + i)
            out[name] = (_auto_draws(aa, k), aa(x, k))
        return out

    # the default passes: within 1e-5 of the exact program here, in a
    # fifth of its compile time
    got = exact_jit(program, X, exact=False, options=FAST_OPTIONS)
    return jax.tree_util.tree_map(np.asarray, got)


def _draws(tree):
    if isinstance(tree, dict):
        return {k: _draws(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_draws(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def test_rand_augment(refs):
    draws, want = refs["RandAugment"]
    got = TX.RandAugment(1, 10)(torch.from_numpy(X), draws=_draws(draws))
    check_close(got, want, 1e-5)


def test_trivial_augment(refs):
    draws, want = refs["TrivialAugment"]
    got = TX.TrivialAugment()(torch.from_numpy(X), draws=_draws(draws))
    check_close(got, want, 1e-5)


@pytest.mark.parametrize("policy", PARITY_POLICIES)
def test_auto_augment(refs, policy):
    draws, want = refs[policy]
    got = TX.AutoAugment(policy)(torch.from_numpy(X), draws=_draws(draws))
    check_close(got, want, 1e-5)


@pytest.mark.parametrize("name", ["IMAGENET_POLICY", "CIFAR10_POLICY",
                                  "SVHN_POLICY"])
def test_policy_tables_match_the_jax_package(name):
    ours, ref = getattr(TX, name), getattr(JX, name)
    assert len(ours) == len(ref) == 25
    assert [[tuple(op) for op in sp] for sp in ours] == \
        [[tuple(op) for op in sp] for sp in ref]


def test_op_tables_match_the_jax_package():
    assert [(n, r, s) for n, _, r, s in TX._OPS] == \
        [(n, r, s) for n, _, r, s in JX._OPS]
    assert list(TX._AA_FNS) == list(JX._AA_FNS)
    assert TX._AA_BINS == JX._AA_BINS
    for policy in POLICIES:
        ours, ref = TX.AutoAugment(policy), JX.AutoAugment(policy)
        for (o1, p1, l1, h1), (o2, p2, l2, h2) in zip(ours._tables,
                                                       ref._tables):
            for a, b in ((o1, o2), (p1, p2), (l1, l2), (h1, h2)):
                np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("policy", POLICIES)
def test_auto_augment_draws_on_the_generator(policy):
    x = torch.from_numpy(X)
    aa = TX.AutoAugment(policy)
    y = aa(x, torch.Generator().manual_seed(1))
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert torch.equal(y, aa(x, torch.Generator().manual_seed(1)))


def test_policies_draw_in_range():
    x = torch.from_numpy(X)[:1].expand(64, 3, 32, 32)
    g = torch.Generator().manual_seed(0)
    for pol in (TX.RandAugment(), TX.TrivialAugment()):
        y = pol(x, g)
        assert y.shape == x.shape and bool(torch.isfinite(y).all())
    ops = TX._draw_op_idx(g, 4096, len(TX._OPS))
    assert set(ops.tolist()) == set(range(len(TX._OPS)))
    signs = TX._signs(g, 4096)
    assert set(signs.tolist()) == {-1.0, 1.0}
    assert abs(signs.mean().item()) < 4 / 64


# -- Operation: gradients through the magnitude ---------------------------------

GRAD_OPS = [("rotate", 10.0), ("brightness", 1.2), ("contrast", 0.8),
            ("shear_x", 20.0), ("color", 1.3)]
GX = rand(2, 3, 12, 12, lo=0.1, hi=0.9, seed=12)


@pytest.fixture(scope="module")
def grad_refs():
    import jax
    import jax.numpy as jnp

    def program(x):
        out = {}
        for name, mag in GRAD_OPS:
            op = JX.Operation(name, JX._AA_FNS[name], probability=1.0)
            out[name] = jax.grad(lambda m: jnp.sum(
                op(x, jax.random.PRNGKey(4), magnitude=m) ** 2))(
                    jnp.asarray(mag))
        return out

    return {k: float(v) for k, v in exact_jit(
        program, GX, exact=False, options=FAST_OPTIONS).items()}


@pytest.mark.parametrize("name,mag", GRAD_OPS)
def test_operation_gradient_through_magnitude(name, mag, grad_refs):
    op = TX.Operation(name, TX._AA_FNS[name], probability=1.0)
    m = torch.tensor(mag, requires_grad=True)
    out = op(torch.from_numpy(GX), None, magnitude=m,
             draws={"gate": torch.ones(2, dtype=torch.bool)})
    (g,) = torch.autograd.grad((out ** 2).sum(), m)
    want = grad_refs[name]
    assert np.isfinite(g.item()) and abs(g.item()) > 0.0
    assert abs(g.item() - want) <= 1e-4 * abs(want), (g.item(), want)


def test_operation_gate_is_straight_through():
    x = torch.from_numpy(GX)
    op = TX.Operation("invert", TX._AA_FNS["invert"], probability=0.5)
    gate = torch.tensor([True, False])
    out = op(x, None, draws={"gate": gate})
    assert torch.equal(out[1], x[1])
    torch.testing.assert_close(out[0], 1.0 - x[0], atol=1e-6, rtol=0)
    drawn = op(x[:1].expand(4096, 3, 12, 12),
               torch.Generator().manual_seed(0))
    share = (drawn != x[:1]).flatten(1).any(1).float().mean().item()
    assert abs(share - 0.5) < 4 * (0.25 / 4096) ** 0.5


def test_policy_tables_on_a_device_follow_their_policy():
    """A policy's tables on a device are its own, however many policies
    came and went before it (each policy keeps its own per-device copies,
    so a freed policy's host arrays cannot lend them to the next)."""
    from kornia_tpu_torch.augmentation.base import device_table
    for _ in range(3):
        for name in POLICIES:
            aa = TX.AutoAugment(name)
            for col, table in enumerate(aa._tables[0]):
                np.testing.assert_array_equal(
                    device_table(aa, (col, 0), table, "cpu").numpy(),
                    table.astype(np.float32))
            del aa  # its tables' memory (and ids) go to the next policy
