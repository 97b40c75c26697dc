"""Shared harness of the op-layer parity tests (``tests/test_torch_{color,
filters_ops,warp_ops,enhance_morph,volume_jpeg_dcn}.py``).

A case names one function of a JAX module and its twin in the port, the
inputs as numpy arrays (made from a seed) or plain values, and the
tolerance. The same inputs go through both on the CPU (the JAX references
of a module's cases from one or two jitted programs, `batch_references`);
outputs
(arrays, or tuples and lists of them) are compared entry by entry:
``atol=0`` means bit for bit, ``circle=True`` compares angles in radians
on the circle.
"""

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np
import torch

SEED = 0
# Case.exact: XLA's passes that rewrite or fuse a jitted program's ops, off.
# The simplifier folds x · 255 · (256 / 255) into one product and moves an
# integer bin (floor(x · 255)) by one, and the fused cube root of Luv moves
# L by 1.3e-4; without them each op is computed on its own, as the eager
# reference computes it
EXACT_OPTIONS = {"xla_disable_hlo_passes":
                 "algsimp,fusion,cpu-instruction-fusion"}
# LLVM's backend optimisation off: a fifth less compile time for the large
# one-shot reference programs of the augmentation tests, whose tolerances
# do not depend on how the machine code is scheduled
FAST_OPTIONS = {"xla_backend_optimization_level": 0}


def rand(*shape, lo=0.0, hi=1.0, seed=SEED):
    """Uniform float32 numpy array from a seeded generator."""
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(
        np.float32)


@dataclasses.dataclass
class Case:
    fn: str                      # the function's name in both modules
    args: Tuple = ()
    kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    atol: float = 1e-5
    rtol: float = 0.0
    circle: bool = False         # compare in radians on the circle
    device: bool = False         # the port's twin takes device="cpu"
    # the reference from the program compiled with EXACT_OPTIONS
    exact: bool = False
    # other callables than the module functions (a pipeline of two ops)
    jax_fn: Optional[Callable] = None
    torch_fn: Optional[Callable] = None


def to_torch(v):
    if isinstance(v, np.ndarray):
        return torch.from_numpy(v.copy())
    if isinstance(v, (tuple, list)) and v and isinstance(v[0], np.ndarray):
        return type(v)(to_torch(a) for a in v)
    return v


def leaves(out):
    """The arrays of an output as float64 or integer numpy arrays."""
    if isinstance(out, (tuple, list)):
        return [a for o in out for a in leaves(o)]
    if isinstance(out, torch.Tensor):
        return [out.detach().cpu().numpy()]
    return [np.asarray(out)]


def batch_references(cases: Dict[str, Case], jax_mod) -> Dict[str, Any]:
    """The JAX outputs of every case of a module from ONE compile: a
    program that takes each distinct input array once and returns every
    case's output (one XLA compile in the place of one a case, or of one
    a primitive eagerly; a second with EXACT_OPTIONS for the exact
    cases)."""
    import jax
    arrays, slots = [], {}

    def plan(v):
        if isinstance(v, np.ndarray):
            if id(v) not in slots:
                slots[id(v)] = len(arrays)
                arrays.append(jnp.asarray(v))
            return ("array", slots[id(v)])
        if isinstance(v, (tuple, list)) and v and isinstance(v[0],
                                                             np.ndarray):
            return ("arrays", type(v), [plan(a) for a in v])
        return ("value", v)

    def fill(p, arrs):
        if p[0] == "array":
            return arrs[p[1]]
        if p[0] == "arrays":
            return p[1](fill(q, arrs) for q in p[2])
        return p[1]

    def program(plans):
        def every_case(*arrs):
            return {name: fn(*[fill(p, arrs) for p in args],
                             **{k: fill(p, arrs) for k, p in kwargs.items()})
                    for name, (fn, args, kwargs) in plans.items()}
        return every_case

    groups = {}
    for name, case in cases.items():
        groups.setdefault(case.exact, {})[name] = (
            case.jax_fn or getattr(jax_mod, case.fn),
            [plan(a) for a in case.args],
            {k: plan(v) for k, v in case.kwargs.items()})
    out = {}
    for exact, plans in groups.items():
        out.update(jax.jit(program(plans)).lower(*arrays).compile(
            compiler_options=EXACT_OPTIONS if exact else {})(*arrays))
    return out


_EXACT_PROGRAMS = {}


def exact_jit(fn, *args, exact: bool = True, options=None):
    """fn(*args) through one jitted program, compiled with EXACT_OPTIONS
    (unless `exact` is False), so that each op rounds as it does eagerly:
    one compile in the place of one an eager op. Array arguments are
    traced; fix the others in `fn`. The program is kept per code object,
    closure values, options and argument shapes, so a parametrised test
    that calls the same function on other values compiles once. `options`:
    more compiler options (FAST_OPTIONS)."""
    import jax
    args = tuple(jnp.asarray(a) for a in args)
    try:
        key = (fn.__code__, tuple(c.cell_contents for c in
                                  fn.__closure__ or ()),
               tuple((a.shape, str(a.dtype)) for a in args), exact,
               tuple(sorted((options or {}).items())))
        hash(key)
    except (AttributeError, TypeError):
        key = None
    program = _EXACT_PROGRAMS.get(key) if key is not None else None
    if program is None:
        program = jax.jit(fn).lower(*args).compile(
            compiler_options=dict(EXACT_OPTIONS if exact else {},
                                  **(options or {})))
        if key is not None:
            _EXACT_PROGRAMS[key] = program
    return program(*args)


def run_case(case: Case, torch_mod, want):
    """`case` through the port, against `want` (from `batch_references`)."""
    tf = case.torch_fn or getattr(torch_mod, case.fn)
    kw_t = dict(case.kwargs, **({"device": "cpu"} if case.device else {}))
    got = tf(*[to_torch(a) for a in case.args],
             **{k: to_torch(v) for k, v in kw_t.items()})
    check_close(got, want, case.atol, case.rtol, case.circle, case.fn)


def check_close(got, want, atol: float, rtol: float = 0.0,
                circle: bool = False, what: str = ""):
    g_all, w_all = leaves(got), leaves(want)
    assert len(g_all) == len(w_all), what
    for g, w in zip(g_all, w_all):
        assert g.shape == w.shape, (what, g.shape, w.shape)
        if atol == 0 and rtol == 0:
            np.testing.assert_array_equal(g, w, err_msg=what)
            continue
        g64, w64 = g.astype(np.float64), w.astype(np.float64)
        if circle:
            d = np.abs(np.angle(np.exp(1j * (g64 - w64))))
            assert d.max() <= atol, (what, d.max())
            continue
        np.testing.assert_allclose(g64, w64, atol=atol, rtol=rtol,
                                   err_msg=what)


def grad_pair(jax_fn, torch_fn, x: np.ndarray, w: Optional[np.ndarray] = None):
    """The gradients of Σ w · f(x) in both libraries (w seeded if None)."""
    import jax
    out = np.asarray(jax.jit(jax_fn)(jnp.asarray(x)))
    if w is None:
        w = rand(*out.shape, lo=-1.0, hi=1.0, seed=SEED + 1)
    gj = jax.jit(jax.grad(lambda a: jnp.sum(jax_fn(a) * w)))(jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_(True)
    yt = torch_fn(xt)
    if not yt.requires_grad:
        gt = torch.zeros_like(xt)
    else:
        (gt,) = torch.autograd.grad((yt * torch.from_numpy(w)).sum(), xt)
    return gt.numpy(), np.asarray(gj)


def check_grad(jax_fn, torch_fn, x: np.ndarray, rtol: float = 1e-4):
    """Gradients agree within rtol of the largest |gradient|."""
    gt, gj = grad_pair(jax_fn, torch_fn, x)
    scale = max(float(np.abs(gj).max()), 1e-30)
    assert np.isfinite(gt).all()
    assert float(np.abs(gt - gj).max()) <= rtol * scale, \
        (float(np.abs(gt - gj).max()), scale)
