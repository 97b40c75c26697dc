"""The port's matchers (kornia_tpu_torch/feature/matching.py) and the
streaming kernel's plain version against the JAX package: its dense
matchers, and its streaming Pallas kernel in interpret mode.

Integer-valued descriptors make every distance exact in f32 on both sides,
so ties are real and the tie rules (first index wins; an equal second
minimum counts as the second smallest) are held exactly.
``tests/test_torch_cuda.py`` holds the CUDA kernel to its plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.feature import matching as j_match
from kornia_tpu.ops import pallas_kernels as pk
from kornia_tpu_torch.feature import matching as t_match
from kornia_tpu_torch.ops import kernels as K
from tests.torch_threads import one_torch_thread  # noqa: F401


def _int_descs(seed, n, m, d):
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 4, (n, d)).astype(np.float32)
    d2 = rng.integers(0, 4, (m, d)).astype(np.float32)
    d2[7] = d2[3]  # an exact duplicate: its rows' min2 equals min1
    return d1, d2


def _float_descs(seed, n, m, d=32):
    rng = np.random.default_rng(seed)
    d1 = rng.standard_normal((n, d)).astype(np.float32)
    # d2 holds noisy copies of some of d1's rows, so that matches exist
    d2 = rng.standard_normal((m, d)).astype(np.float32)
    k = min(n, m) // 2
    d2[:k] = d1[rng.permutation(n)[:k]] + 0.2 * rng.standard_normal((k, d))
    return d1, d2


@pytest.mark.parametrize("n,m,d,tile_n", [(256, 256, 48, 256),
                                          (128, 512, 32, 128),
                                          (300, 256, 40, 300)])
def test_streaming_min2_plain_matches_pallas(n, m, d, tile_n):
    """Square, rectangular (two d2 tiles merged) and ragged N: exactly
    equal on exact distances."""
    d1, d2 = _int_descs(0, n, m, d)
    ref = pk.streaming_min2(jnp.asarray(d1), jnp.asarray(d2), tile_n=tile_n,
                            interpret=True)
    out = K.streaming_min2(torch.from_numpy(d1), torch.from_numpy(d2))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))


def test_streaming_min2_ties():
    """The first index keeps the minimum; a duplicate of it is min2."""
    d1 = torch.tensor([[0.0, 0.0], [3.0, 0.0]])
    d2 = torch.tensor([[1.0, 0.0], [2.0, 0.0], [1.0, 0.0], [5.0, 0.0]])
    m1, m2, idx = K.streaming_min2(d1, d2)
    np.testing.assert_array_equal(m1.numpy(), [1.0, 1.0])
    np.testing.assert_array_equal(m2.numpy(), [1.0, 4.0])
    np.testing.assert_array_equal(idx.numpy(), [0, 1])
    _, m2, _ = K.streaming_min2(d1, d2[:1])
    np.testing.assert_array_equal(m2.numpy(), [1e9, 1e9])


def _assert_same_matches(out, ref, atol=5e-5, rtol=0):
    """Same valid mask and matches; distances and ratios to 5e-5: the
    matmul identity n1 + n2 - 2·d1·d2 of rows with squared norms near 32
    keeps about 32·2⁻²³·4 of absolute f32 error, summed in another order
    on each side."""
    dist, matches, valid = out
    rd, rm, rv = (np.asarray(r) for r in ref)
    np.testing.assert_array_equal(valid.numpy(), rv)
    np.testing.assert_array_equal(matches.numpy(), rm)
    np.testing.assert_allclose(dist.numpy(), rd, atol=atol, rtol=rtol)


@pytest.mark.parametrize("mode", ["nn", "mnn", "snn", "smnn"])
@pytest.mark.parametrize("masked", [False, True])
def test_match_modes_match_jax(mode, masked):
    d1, d2 = _float_descs(1, 96, 80)
    rng = np.random.default_rng(2)
    m1 = rng.random(96) > 0.2 if masked else None
    m2 = rng.random(80) > 0.2 if masked else None
    th = 0.9
    ref = j_match.DescriptorMatcher(mode, th)(
        jnp.asarray(d1), jnp.asarray(d2),
        None if m1 is None else jnp.asarray(m1),
        None if m2 is None else jnp.asarray(m2))
    out = t_match.DescriptorMatcher(mode, th)(
        torch.from_numpy(d1), torch.from_numpy(d2),
        None if m1 is None else torch.from_numpy(m1),
        None if m2 is None else torch.from_numpy(m2))
    assert out[2].any()
    _assert_same_matches(out, ref)


@pytest.mark.parametrize("mutual", [False, True])
def test_match_fginn_matches_jax(mutual):
    d1, d2 = _float_descs(3, 64, 72)
    rng = np.random.default_rng(4)
    lafs = [np.concatenate([np.tile(np.eye(2, dtype=np.float32), (1, n, 1, 1)),
                            rng.uniform(0, 60, (1, n, 2, 1)).astype(np.float32)],
                           axis=-1) for n in (64, 72)]
    ref = j_match.match_fginn(jnp.asarray(d1), jnp.asarray(d2),
                              jnp.asarray(lafs[0]), jnp.asarray(lafs[1]),
                              0.85, 8.0, mutual)
    out = t_match.match_fginn(torch.from_numpy(d1), torch.from_numpy(d2),
                              torch.from_numpy(lafs[0]),
                              torch.from_numpy(lafs[1]), 0.85, 8.0, mutual)
    assert out[2].any()
    _assert_same_matches(out, ref)


def test_streaming_matchers_match_pallas():
    """match_nn_streaming / match_smnn_streaming against the JAX package's
    streaming matchers (interpret mode), and DescriptorMatcher's routing:
    unmasked nn/smnn through the kernel, masked calls through the dense
    matrix, with the same results here."""
    d1, d2 = _float_descs(5, 256, 256)
    j1, j2 = jnp.asarray(d1), jnp.asarray(d2)
    t1, t2 = torch.from_numpy(d1), torch.from_numpy(d2)
    rd, rm = pk.match_nn_pallas(j1, j2, interpret=True)
    dist, matches, valid = t_match.match_nn_streaming(t1, t2)
    assert valid.all()
    np.testing.assert_array_equal(matches.numpy(), np.asarray(rm))
    np.testing.assert_allclose(dist.numpy(), np.asarray(rd), atol=5e-5)
    ref = pk.match_smnn_pallas(j1, j2, 0.95, interpret=True)
    out = t_match.match_smnn_streaming(t1, t2, 0.95)
    assert out[2].any()
    _assert_same_matches(out, ref)
    ones = torch.ones(256, dtype=torch.bool)
    for mode in ("nn", "smnn"):
        streamed = t_match.DescriptorMatcher(mode, 0.95, streaming=True)
        dense = t_match.DescriptorMatcher(mode, 0.95)
        _assert_same_matches(streamed(t1, t2),
                             [r.numpy() for r in dense(t1, t2)])
        _assert_same_matches(streamed(t1, t2, ones, ones),
                             [r.numpy() for r in dense(t1, t2, ones, ones)],
                             atol=0, rtol=0)


def test_matcher_rejects_unknown_mode():
    with pytest.raises(ValueError, match="unknown match mode"):
        t_match.DescriptorMatcher("fginn")
