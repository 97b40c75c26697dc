"""Shared harness of the augmentation parity tests
(``tests/test_torch_aug_*.py``).

A case names how to build one augmentation from either package (the same
arguments: the port keeps the JAX signatures), which seeded numpy inputs
it takes and how it is called. ``references`` runs every case's JAX
``generate_parameters`` and its call on those params in ONE program
compiled with EXACT_OPTIONS (module-scoped in each test file); the port
then replays each case's JAX params, carried across by
``convert.aug_params_from_numpy``, and must give the JAX output within the
case's tolerance (``atol=0``: bit for bit).
"""

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

import kornia_tpu.augmentation as JA
import kornia_tpu_torch.augmentation as TA
from kornia_tpu_torch.convert import aug_params_from_numpy
from tests.torch_op_parity import FAST_OPTIONS, check_close, exact_jit


def default_call(aug, ins, params):
    return aug(ins[0], params=params)


@dataclasses.dataclass
class AugCase:
    make: Callable                  # module → augmentation
    inputs: Sequence[str] = ("img",)
    atol: Union[float, Tuple[float, ...]] = 1e-5
    call: Callable = default_call   # (aug, inputs, params) → output
    # the reference from the program compiled with EXACT_OPTIONS (integer
    # bins and floors, which XLA's rewriting moves); the others share a
    # program compiled with the default passes
    exact: bool = False
    # the JAX class reads a constant on the host while it draws (the
    # plasma fractal's roughness, ``float(jnp.mean(jnp.asarray(r)))``):
    # its draw runs with that read on numpy (``host_constants``)
    host_draw: bool = False
    # (aug, key, input shape) → params, where the class draws otherwise
    # than by generate_parameters (VideoSequential's one set a clip)
    draw: Optional[Callable] = None


def to_numpy(tree):
    """A JAX pytree of dicts, lists and arrays → the same of numpy."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    return np.asarray(tree)


class _HostConstants:
    """``jnp`` with ``asarray`` and ``mean`` of plain Python numbers done
    by numpy in float32 (as jnp does them), so that a class which reads
    such a constant with ``float()`` while it draws traces under jit; every
    other name is jnp's."""

    def __init__(self, jnp):
        self._jnp = jnp

    def __getattr__(self, name):
        return getattr(self._jnp, name)

    def asarray(self, a, *args, **kw):
        if isinstance(a, (tuple, list)) and all(
                isinstance(v, (int, float)) for v in a):
            return np.asarray(a, np.float32)
        return self._jnp.asarray(a, *args, **kw)

    def mean(self, a, *args, **kw):
        if isinstance(a, np.ndarray):
            return np.mean(a, *args, dtype=np.float32, **kw)
        return self._jnp.mean(a, *args, **kw)


def _draw(aug, key, shape, host_draw: bool):
    if not host_draw:
        return aug.generate_parameters(key, shape)
    import sys
    mod = sys.modules[type(aug).__module__]
    saved = mod.jnp
    mod.jnp = _HostConstants(saved)
    try:
        return aug.generate_parameters(key, shape)
    finally:
        mod.jnp = saved


def references(cases: Dict[str, AugCase],
               arrays: Dict[str, np.ndarray]) -> Dict:
    """Every case's (JAX params, JAX output): one compiled program for
    the exact cases and one for the others; case i draws from
    PRNGKey(i); the keys enter traced."""
    import jax
    import jax.numpy as jnp
    names = list(cases)
    augs = {n: cases[n].make(JA) for n in names}
    arr_names = sorted(arrays)
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(len(names))])
    out = {}
    for exact in (True, False):
        group = [(i, n) for i, n in enumerate(names)
                 if cases[n].exact == exact]
        if not group:
            continue

        def program(keys, *arrs, group=group):
            env = dict(zip(arr_names, arrs))
            res = {}
            for i, n in group:
                c = cases[n]
                ins = [env[k] for k in c.inputs]
                if c.draw is not None:
                    p = c.draw(augs[n], keys[i], ins[0].shape)
                else:
                    p = _draw(augs[n], keys[i], ins[0].shape, c.host_draw)
                res[n] = (p, c.call(augs[n], ins, p))
            return res

        got = exact_jit(program, keys, *[arrays[k] for k in arr_names],
                        exact=exact, options=None if exact else FAST_OPTIONS)
        out.update({n: (to_numpy(p), to_numpy(o))
                    for n, (p, o) in got.items()})
    return out


def torch_inputs(case: AugCase, arrays: Dict[str, np.ndarray]):
    return [torch.from_numpy(arrays[k].copy()) for k in case.inputs]


def check_case(name: str, case: AugCase, refs: Dict,
               arrays: Dict[str, np.ndarray]) -> None:
    """The port's call on the JAX params against the JAX output."""
    p_j, want = refs[name]
    params = aug_params_from_numpy(p_j, "cpu")
    got = case.call(case.make(TA), torch_inputs(case, arrays), params)
    if isinstance(case.atol, tuple):  # one tolerance an output
        assert len(got) == len(want) == len(case.atol), name
        for i, (g, w, tol) in enumerate(zip(got, want, case.atol)):
            check_close(g, w, tol, what=f"{name}[{i}]")
    else:
        check_close(got, want, case.atol, what=name)


_DTYPES = {torch.float32: "float32", torch.bool: "bool",
           torch.int32: "int32", torch.int64: "int64"}


def check_layout(name: str, case: AugCase, refs: Dict,
                 arrays: Dict[str, np.ndarray]) -> None:
    """The port's own generate_parameters: the JAX params' keys, shapes
    and dtypes."""
    p_j, _ = refs[name]
    shape = arrays[case.inputs[0]].shape
    got = case.make(TA).generate_parameters(
        torch.Generator().manual_seed(0), shape)
    assert sorted(got) == sorted(p_j), (name, sorted(got), sorted(p_j))
    for k, v in got.items():
        assert tuple(v.shape) == p_j[k].shape, (name, k, v.shape)
        assert _DTYPES[v.dtype] == str(p_j[k].dtype), (name, k, v.dtype)
