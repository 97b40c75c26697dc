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


def batch_references(cases: Dict[str, Case], jax_mod,
                     options=None) -> Dict[str, Any]:
    """The JAX outputs of every case of a module from ONE compile: a
    program that takes each distinct input array once and returns every
    case's output (one XLA compile in the place of one a case, or of one
    a primitive eagerly; a second with EXACT_OPTIONS for the exact
    cases). `options`: the compiler options of the other program
    (FAST_OPTIONS)."""
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
            compiler_options=EXACT_OPTIONS if exact else (options or {}))(
                *arrays))
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


def flax_variables(rows, seed: int) -> Dict[str, Any]:
    """Flax variables ({"params": ..., "batch_stats": ...}) for a port
    module's parameter table (``kornia_tpu_torch/feature/_nets.py``),
    drawn with numpy in the torch layout and written at each row's flax
    path in flax's layout: weights normal with variance 1 / fan-in, batch
    norm scales near 1, biases and running means small, running variances
    near 1. A wrong path or shape fails the JAX module's apply."""
    rng = np.random.default_rng(seed)
    tree: Dict[str, Any] = {}
    for name, shape, path, kind in rows:
        leaf = name.rsplit(".", 1)[-1]
        if kind == "token":
            v = rng.normal(0, 0.02, shape)
        elif kind == "vec":
            if leaf == "running_var":
                v = rng.uniform(0.5, 1.5, shape)
            elif leaf in ("weight", "gamma"):
                v = rng.uniform(0.8, 1.2, shape)
            else:
                v = rng.normal(0, 0.05, shape)
        else:
            v = rng.normal(0, 1 / np.sqrt(np.prod(shape[1:])), shape)
        v = v.astype(np.float32)
        if kind == "conv":
            v = v.transpose(2, 3, 1, 0)
        elif kind == "dense":
            v = v.T
        elif kind == "dense1x1":
            v = v[:, :, 0, 0].T
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(v)
    return tree


def compile_parallel(programs, options=None):
    """Compile jitted programs side by side: each entry of `programs` is
    (fn, args) or (fn, args, options), args arrays or
    ``jax.ShapeDtypeStruct`` trees (a program that consumes another's
    output is lowered from that output's shapes). They are traced one
    after the other and compiled in threads (XLA's compiler releases the
    GIL), so a module's references cost about its costliest compile; the
    caller runs the executables in order. `options`: the compiler options
    of the entries without their own (FAST_OPTIONS)."""
    import jax
    from concurrent.futures import ThreadPoolExecutor
    lowered = [(jax.jit(p[0]).lower(*p[1]), p[2] if len(p) > 2 else options)
               for p in programs]
    with ThreadPoolExecutor(len(lowered)) as pool:
        return list(pool.map(lambda lo: lo[0].compile(lo[1] or {}),
                             lowered))


def _threefry2x32(key, x0, x1):
    """JAX's threefry2x32 block on one pair of uint32 words, in numpy."""
    def rotl(x, r):
        return np.uint32((x << np.uint32(r)) | (x >> np.uint32(32 - r)))

    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = [k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA))]
    rot = [(13, 15, 26, 6), (17, 29, 16, 24)]
    with np.errstate(over="ignore"):
        x = [np.uint32(np.uint32(x0) + ks[0]),
             np.uint32(np.uint32(x1) + ks[1])]
        for i in range(5):
            for r in rot[i % 2]:
                x[0] = np.uint32(x[0] + x[1])
                x[1] = np.uint32(x[0] ^ rotl(x[1], r))
            x[0] = np.uint32(x[0] + ks[(i + 1) % 3])
            x[1] = np.uint32(x[1] + ks[(i + 2) % 3] + np.uint32(i + 1))
    return np.array(x, np.uint32)


def _threefry_blocks(key, n: int):
    """threefry2x32 of `key` on the counters (0, i), i < n: the two output
    words, in place on cache-sized chunks."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = [k0, k1, np.uint32(k0 ^ k1 ^ np.uint32(0x1BD11BDA))]
    rot = [(13, 15, 26, 6), (17, 29, 16, 24)]
    out0, out1 = np.empty(n, np.uint32), np.empty(n, np.uint32)
    step = 1 << 15
    tmp = np.empty(step, np.uint32)
    for s0 in range(0, n, step):
        a = np.full(min(step, n - s0), ks[0], np.uint32)
        b = np.arange(s0, s0 + a.size, dtype=np.uint32)
        b += ks[1]
        t = tmp[:a.size]
        for i in range(5):
            for r in rot[i % 2]:
                a += b
                np.left_shift(b, np.uint32(r), out=t)
                b >>= np.uint32(32 - r)
                b |= t
                b ^= a
            a += ks[(i + 1) % 3]
            b += np.uint32(ks[(i + 2) % 3] + np.uint32(i + 1))
        out0[s0:s0 + a.size], out1[s0:s0 + a.size] = a, b
    return out0, out1


def _np_bits(key, shape) -> np.ndarray:
    """``jax.random.bits(key, shape)`` (uint32, threefry with the
    partitionable counters, JAX's default) in numpy."""
    b0, b1 = _threefry_blocks(np.asarray(key),
                              int(np.prod(shape, dtype=np.int64)))
    b0 ^= b1
    return b0.reshape(shape)


def _np_split(key, num: int = 2) -> np.ndarray:
    b = _threefry2x32(np.asarray(key), np.zeros(num, np.uint32),
                      np.arange(num, dtype=np.uint32))
    return np.stack([b[0], b[1]], -1)


def _np_uniform(key, shape=(), dtype=np.float32, minval=0.0, maxval=1.0):
    dt = np.dtype(dtype)
    lo, hi = dt.type(minval), dt.type(maxval)
    bits = (_np_bits(key, tuple(shape)) >> np.uint32(9)) \
        | np.array(1.0, np.float32).view(np.uint32)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, floats * (hi - lo) + lo).astype(dt)


def _np_normal(key, shape=(), dtype=np.float32):
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = _np_uniform(key, shape, np.float32, lo, 1.0)
    e = torch.erfinv(torch.from_numpy(u)).numpy()
    return (np.float32(np.sqrt(2)) * e).astype(np.dtype(dtype))


class numpy_random:
    """Within the block, ``jax.random.split``, ``normal`` and ``uniform``
    are numpy replays of JAX's (threefry2x32 with the partitionable
    counters; float32 uniforms from the top 23 bits; the normal's erfinv
    torch's, a few ulps from XLA's). A reference init that
    draws with them (``rtdetr_init_params``, ...) runs on the host with no
    compile; ``check()`` holds the replay to ``jax.random`` on small
    draws."""

    NAMES = ("split", "normal", "uniform")

    def __enter__(self):
        import jax
        self._saved = {n: getattr(jax.random, n) for n in self.NAMES}
        jax.random.split = _np_split
        jax.random.normal = _np_normal
        jax.random.uniform = _np_uniform
        return self

    def __exit__(self, *exc):
        import jax
        for n, f in self._saved.items():
            setattr(jax.random, n, f)

    @staticmethod
    def check() -> None:
        import jax
        assert jax.config.jax_threefry_partitionable
        key = jax.random.PRNGKey(3)
        np.testing.assert_array_equal(_np_split(np.asarray(key)),
                                      np.asarray(jax.random.split(key)))
        # XLA fuses the uniform's scale and shift (one rounding, not two)
        np.testing.assert_allclose(
            _np_uniform(np.asarray(key), (5, 7), np.float32, -0.3, 0.3),
            np.asarray(jax.random.uniform(key, (5, 7), jnp.float32, -0.3,
                                          0.3)), rtol=0, atol=6e-8)
        np.testing.assert_allclose(
            _np_normal(np.asarray(key), (5, 7)),
            np.asarray(jax.random.normal(key, (5, 7))), rtol=1e-6,
            atol=1e-6)


def _check_flax_internals() -> None:
    """flax_init_program patches flax.core.scope's Scope.param,
    Scope.variable, random.fold_in and jnp, and computes the fold-ins with
    _threefry2x32: fail loudly, not with other values, where a flax or JAX
    release changed any of them."""
    import inspect

    import jax
    from flax.core import scope as flax_scope

    def names(fn):
        return list(inspect.signature(fn).parameters)

    assert names(flax_scope.Scope.param) == [
        "self", "name", "init_fn", "init_args", "unbox", "init_kwargs"]
    assert names(flax_scope.Scope.variable)[:5] == [
        "self", "col", "name", "init_fn", "init_args"]
    assert flax_scope.random is jax.random
    assert "random.fold_in(rng, jnp.uint32(hash_int))" in inspect.getsource(
        flax_scope._fold_in_static)
    key = jax.random.PRNGKey(7)
    np.testing.assert_array_equal(
        _threefry2x32(np.asarray(key), 0, 123456789),
        np.asarray(jax.random.fold_in(key, np.uint32(123456789))))


class _FoldedKey:
    """A stand-in for the key ``jax.random.fold_in(root, data)``."""

    def __init__(self, data):
        self.data = int(data)


def flax_init_program(init, key):
    """A flax init, `init(key)`, as a program that compiles in a fraction
    of the time: (fn, args, finish, avals); fn(*args) is compiled (with
    FAST_OPTIONS) and run, ``finish(fn(*args))`` gives the init's
    variables, and `avals` their shapes (for lowering a program that
    takes them).

    A jitted init compiles one threefry fold-in and one draw a parameter
    (SOLD2Net's about 400: 10 s). Here the init is only traced
    (``jax.eval_shape``) with flax's fold-ins and initializer calls
    recorded; each parameter's key, ``fold_in(key, hash of its path)``, is
    computed in numpy (``_threefry2x32``), and fn draws the parameters that
    share an initializer and its arguments by one ``jax.vmap`` over their
    keys, which gives each key the values of its own draw. The other
    collections (batch statistics) come from their constant initializers.
    Compiled with XLA's default options the values are the init's bit for
    bit; FAST_OPTIONS' LLVM O0 rounds the truncated normal's erfinv a few
    ulps apart, far inside the golden tests' 1e-4."""
    import jax
    from flax.core import scope as flax_scope

    _check_flax_internals()
    params, others = [], []
    orig_param, orig_variable = (flax_scope.Scope.param,
                                 flax_scope.Scope.variable)
    orig_fold, orig_jnp = flax_scope.random.fold_in, flax_scope.jnp

    def param(self, name, init_fn, *init_args, unbox=True, **init_kwargs):
        def record(rng, *args, **kwargs):
            params.append(((*self.path, name), init_fn, args,
                           tuple(sorted(kwargs.items())), rng))
            shape = args[0] if args and isinstance(args[0], tuple) else \
                jax.eval_shape(lambda: init_fn(jax.random.PRNGKey(0), *args,
                                               **kwargs)).shape
            return jnp.zeros(shape)
        return orig_param(self, name, record, *init_args, unbox=unbox,
                          **init_kwargs)

    def variable(self, col, name, init_fn=None, *init_args, **kwargs):
        if init_fn is not None and col != "params":
            others.append((col, (*self.path, name), init_fn, init_args))
        return orig_variable(self, col, name, init_fn, *init_args, **kwargs)

    class _Jnp:
        """flax's ``jnp.uint32(hash)`` as a host number."""
        uint32 = np.uint32

        def __getattr__(self, name):
            return getattr(jnp, name)

    flax_scope.Scope.param = param
    flax_scope.Scope.variable = variable
    flax_scope.random.fold_in = lambda rng, data: _FoldedKey(data)
    flax_scope.jnp = _Jnp()
    try:
        # a fresh function: eval_shape keeps the trace in jit's cache, and
        # this trace, with its recorded draws, must serve no later call
        jax.eval_shape(lambda k: init(k), key)
    finally:
        flax_scope.Scope.param = orig_param
        flax_scope.Scope.variable = orig_variable
        flax_scope.random.fold_in = orig_fold
        flax_scope.jnp = orig_jnp
    root = np.asarray(key)
    keys = [jnp.asarray(_threefry2x32(root, 0, r.data)
                        if isinstance(r, _FoldedKey) else root)
            for *_, r in params]
    groups = {}
    for i, (_, fn, args, kwargs, _) in enumerate(params):
        groups.setdefault((id(fn), repr(args), repr(kwargs)), []).append(i)

    def draw(keys):
        out = {}
        for idx in groups.values():
            _, fn, args, kwargs, _ = params[idx[0]]
            vals = jax.vmap(lambda k: fn(k, *args, **dict(kwargs)))(
                jnp.stack([keys[i] for i in idx]))
            out.update({i: vals[j] for j, i in enumerate(idx)})
        return [out[i] for i in range(len(params))]

    def build(leaves, other):
        variables: Dict[str, Any] = {}

        def put(col, path, v):
            node = variables.setdefault(col, {})
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = v

        for (path, *_), v in zip(params, leaves):
            put("params", path, v)
        for (col, path, _, _), v in zip(others, other):
            put(col, path, v)
        return variables

    other = [np.asarray(fn(*args)) for _, _, fn, args in others]
    shapes = jax.eval_shape(draw, keys)
    return (draw, [keys], lambda drawn: build(drawn, other),
            build(shapes, [jax.ShapeDtypeStruct(v.shape, v.dtype)
                           for v in other]))
