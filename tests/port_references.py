"""Recorded JAX references of the port's heaviest parity tests.

Six port tests compare against a whole JAX pipeline (the VO pair step and
global BA, ``two_view_pose`` twice, ``incremental_sfm``, the 5-point
solver, RANSAC), whose compile alone took 35-94 s a test in the tier-1
run. Their JAX outputs are written once, in full, by
``tests/write_port_references.py`` into ``tests/golden/port_references/
<name>.npz``, together with a digest of the numpy inputs the test builds
(and of the random draws the port replays). The tier-1 test rebuilds its
inputs, checks the digest and compares the port against the record; the
``slow`` cases of ``tests/test_torch_port_references.py`` recompute each
record from the JAX package and hold it to the file.

The inputs are held two ways. Those that numpy builds are held exactly,
by a SHA-256 digest. Those that the JAX package makes (rendered frames,
``jax.random`` draws, the JAX scene generator's points) are held by a
fingerprint (sums, extremes and 16 strided values of each array) to 1e-6
relative: XLA's CPU code differs between host CPUs in the last bits, and
an exact digest of them would fail on a machine that is not the one the
record was written on, while the port's comparisons do not depend on
those bits.

A record is a nested structure of dicts, lists and tuples whose leaves
are numpy arrays or numbers; it is stored flat, each leaf under its path
("steps/3/out/2").
"""

import hashlib
import os

import numpy as np

DIR = os.path.join(os.path.dirname(__file__), "golden", "port_references")
NAMES = ("vo", "twoview", "config2", "sfm", "five_point", "ransac")


def digest(*arrays) -> str:
    """SHA-256 of the arrays' dtypes, shapes and bytes, in order."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def fingerprint(*arrays) -> np.ndarray:
    """(len(arrays), 22) float64: each array's size, sum, sum of |x|, sum
    of squares, max, min and 16 strided values."""
    rows = []
    for a in arrays:
        f = np.asarray(a, np.float64).ravel()
        idx = np.linspace(0, f.size - 1, 16).astype(np.int64)
        rows.append(np.concatenate([[f.size, f.sum(), np.abs(f).sum(),
                                     (f * f).sum(), f.max(), f.min()],
                                    f[idx]]))
    return np.stack(rows) if rows else np.zeros((0, 22))


def inputs(numpy_made=(), jax_made=()) -> dict:
    """The key of a record's inputs: the digest of those numpy builds and
    the fingerprint of those the JAX package makes."""
    return {"digest": digest(*numpy_made),
            "fingerprint": fingerprint(*jax_made)}


def _check_inputs(name, stored, key) -> None:
    hint = (f"the inputs of {name} differ from the record's: rewrite it "
            "with python tests/write_port_references.py")
    assert str(stored["digest"]) == key["digest"], hint
    want, got = stored["fingerprint"], key["fingerprint"]
    assert want.shape == got.shape, hint
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * max(np.abs(want).max(initial=0),
                                               1e-30), err_msg=hint)


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        out[f"{prefix}#dict"] = np.array(list(tree), dtype=str)
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        out[f"{prefix}#{type(tree).__name__}"] = np.array(len(tree))
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = np.asarray(tree)


def _unflatten(flat, prefix):
    if f"{prefix}#dict" in flat:
        return {str(k): _unflatten(flat, f"{prefix}/{k}")
                for k in flat[f"{prefix}#dict"]}
    for kind, typ in (("list", list), ("tuple", tuple)):
        if f"{prefix}#{kind}" in flat:
            n = int(flat[f"{prefix}#{kind}"])
            return typ(_unflatten(flat, f"{prefix}/{i}") for i in range(n))
    return flat[prefix]


def path(name: str) -> str:
    return os.path.join(DIR, f"{name}.npz")


def save(name: str, key: dict, record) -> None:
    flat = {"digest": np.array(key["digest"]),
            "fingerprint": key["fingerprint"]}
    _flatten(record, "r", flat)
    os.makedirs(DIR, exist_ok=True)
    np.savez_compressed(path(name), **flat)


def load(name: str, key=None):
    """The record `name`; with `key` (``inputs(...)``), first check that
    the test built the inputs the record was written from."""
    with np.load(path(name), allow_pickle=False) as f:
        flat = {k: f[k] for k in f.files}
    if key is not None:
        _check_inputs(name, flat, key)
    return _unflatten(flat, "r")


def stored_inputs(name: str) -> dict:
    """The record's own input key."""
    with np.load(path(name), allow_pickle=False) as f:
        return {"digest": str(f["digest"]), "fingerprint": f["fingerprint"]}


def leaves(tree, prefix="r"):
    """(path, array) for each leaf of a record."""
    flat = {}
    _flatten(tree, prefix, flat)
    return {k: v for k, v in flat.items() if "#" not in k}


def assert_matches_record(got, want) -> None:
    """Integers, masks and strings equal; floats within 1e-6 of the
    largest |value| of each array."""
    g, w = leaves(got), leaves(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (k, a.dtype,
                                                           b.dtype)
        if np.issubdtype(b.dtype, np.floating):
            tol = 1e-6 * max(float(np.nanmax(np.abs(b))) if b.size else 0.0,
                             1e-30)
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=k)
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)
