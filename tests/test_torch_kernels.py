"""The port's kernels (kornia_tpu_torch/ops/kernels.py) against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

On the CPU each wrapper computes its plain PyTorch version; these tests
hold that version to the Pallas kernel, and hold the tap and band tables
that the CUDA kernels consume to the dense operators they stand for.
``tests/test_torch_cuda.py`` compares the CUDA kernels with their plain
versions on a card (``python3 chip_smoke.py`` does the same at the paths'
shapes).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kornia_tpu.ops import pallas_kernels as pk
from kornia_tpu.ops.filters import get_gaussian_kernel1d as jax_gauss1d
from kornia_tpu_torch.convert import state_from_numpy
from kornia_tpu_torch.ops import kernels as K
from tests.torch_op_parity import exact_jit
from tests.torch_threads import one_torch_thread  # noqa: F401

BORDERS = ["reflect", "replicate", "circular", "constant"]
# [0, 1] images: f32 products summed in another order than the reference
ATOL = 1e-5


def _kernels_1d(sizes_sigmas):
    return [np.asarray(jax_gauss1d(k, s))[0] for k, s in sizes_sigmas]


@pytest.mark.parametrize("border", BORDERS)
def test_fused_blur_plain_matches_pallas(border):
    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 40, 56), dtype=np.float32)
    ky, kx = _kernels_1d([(7, 1.3), (5, 0.9)])
    # jitted: eager dispatch of the interpreted kernel costs seconds
    ref = jax.jit(lambda a, v, h: pk.fused_separable_blur2d(
        a, v, h, border, interpret=True))(
        jnp.asarray(x), jnp.asarray(ky), jnp.asarray(kx))
    out = K.fused_separable_blur2d(torch.from_numpy(x), torch.from_numpy(ky),
                                   torch.from_numpy(kx), border)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("border", ["replicate", "reflect"])
def test_multi_level_blur_plain_matches_pallas(border):
    rng = np.random.default_rng(1)
    x = rng.random((2, 1, 48, 64), dtype=np.float32)
    sigmas = [0.8, 1.1, 1.4, 1.8, 2.3]
    kers = _kernels_1d([(2 * int(np.ceil(4 * s)) + 1, s) for s in sigmas])
    jk = [jnp.asarray(k) for k in kers]
    ref = jax.jit(lambda a, k: pk.multi_level_blur(
        a, k, k, border, interpret=True))(jnp.asarray(x), jk)
    tk = [torch.from_numpy(k) for k in kers]
    out = K.multi_level_blur(torch.from_numpy(x), tk, tk, border)
    assert out.shape == (5, 2, 1, 48, 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("atlas_hw,ps", [((300, 400), 41), ((260, 300), 19)])
def test_patch_sample_plain_matches_pallas(atlas_hw, ps):
    """Inside the TPU kernel's window budget (extent <= 118 px in y,
    126 px in x) the Pallas kernel is exact bilinear ('split' mode rounds to
    about 4e-6 on [0, 1] atlases)."""
    rng = np.random.default_rng(2)
    Ha, Wa = atlas_hw
    atlas = rng.random((Ha, Wa), dtype=np.float32)
    N, S = 9, ps * ps
    centers = rng.uniform([60, 60], [Wa - 60, Ha - 60], (N, 2))
    off = rng.uniform(-55, 55, (N, S, 2))
    px = (centers[:, None, 0] + off[..., 0]).astype(np.float32)
    py = (centers[:, None, 1] + off[..., 1]).astype(np.float32)
    ref = exact_jit(lambda a, x, y: pk.patch_sample_mxu(
        a, x, y, interpret=True), atlas, px, py, exact=False)
    out = K.patch_sample(torch.from_numpy(atlas), torch.from_numpy(px),
                         torch.from_numpy(py))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_patch_sample_border_rule():
    """Coordinates at and past the last row/column take the border value
    (grid_sample 'border', align_corners=True) — the rule the kernel
    applies where the TPU kernel would clamp to its window instead."""
    atlas = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    px = torch.tensor([[3.0, 5.0, -1.0, 1.5]])
    py = torch.tensor([[2.0, 0.0, 1.0, 2.0]])
    out = K.patch_sample(atlas, px, py)
    np.testing.assert_allclose(out.numpy(), [[11.0, 3.0, 4.0, 9.5]])


@pytest.mark.parametrize("border", BORDERS)
def test_band_matrix_matches_reference(border):
    k = np.asarray(jax_gauss1d(9, 1.7))[0]
    ref = state_from_numpy({"S": np.asarray(exact_jit(
        lambda a: pk._band_matrix(a, 23, border), k))}, "cpu")
    out = K.band_matrix(torch.from_numpy(k), 23, border)
    torch.testing.assert_close(out, ref["S"], atol=1e-7, rtol=0)


def test_cumulative_operators_match_reference():
    sigmas = [1.23, 1.55, 1.95, 2.45, 3.09]
    kers = _kernels_1d([(2 * int(np.ceil(4 * s)) + 1, s) for s in sigmas])
    def chain(*ks):
        cum, out = jnp.eye(64, dtype=jnp.float32), []
        for k in ks:
            cum = pk._cum_op(pk._band_matrix(k, 64, "replicate"), cum)
            out.append(cum)
        return out

    ref = [np.asarray(c) for c in exact_jit(chain, *kers)]
    state = state_from_numpy({"ops": np.stack(ref), "kernels": kers}, "cpu")
    out = K.cumulative_operators(state["kernels"], 64, "replicate")
    # f32 matrix products summed in another order
    torch.testing.assert_close(out, state["ops"], atol=1e-6, rtol=0)


@pytest.mark.parametrize("border", BORDERS)
def test_fold_taps_reassemble_band_matrix(border):
    """The fused kernel's tap table sums to the dense operator."""
    k = torch.from_numpy(_kernels_1d([(11, 2.0)])[0])
    idx, w = K._fold_taps(k, 17, border)
    dense = torch.zeros((17, 17))
    rows = torch.arange(17)[None].expand_as(idx)
    dense.index_put_((rows.reshape(-1), idx.reshape(-1)), w.reshape(-1),
                     accumulate=True)
    torch.testing.assert_close(dense, K.band_matrix(k, 17, border))


@pytest.mark.parametrize("border,size", [("replicate", 80), ("reflect", 80),
                                         ("replicate", 30)])
def test_band_taps_cover_cumulative_operators(border, size):
    """The multi-level kernel's bands (start + K_l consecutive taps per row
    of level l, K_l = 2·R_l + 1) hold every nonzero of the cumulative
    operators: the dense operators rebuilt from the bands are equal, bit
    for bit, and the weights past K_l are zero."""
    sigmas = [1.23, 1.55, 1.95, 2.45, 3.09]
    kers = [torch.from_numpy(k) for k in _kernels_1d(
        [(2 * int(np.ceil(4 * s)) + 1, s) for s in sigmas])]
    ops = K.cumulative_operators(kers, size, border)
    start, w, taps = K._band_taps(
        ops, K._half_widths([k.numel() for k in kers], size, border))
    radii = np.cumsum([k.numel() // 2 for k in kers])
    assert taps == tuple(min(2 * int(r) + 1, size) for r in radii)
    assert w.shape == (5, max(taps), size)
    dense = torch.zeros_like(ops)
    for lvl, K_l in enumerate(taps):
        assert not w[lvl, K_l:].any()
        idx = start[lvl].long()[:, None] + torch.arange(K_l)[None, :]
        dense[lvl].scatter_(1, idx, w[lvl, :K_l].T)
    assert torch.equal(dense, ops)


def test_cpu_wrappers_launch_nothing():
    K.reset_launches()
    x = torch.rand(1, 1, 32, 32)
    k = torch.ones(3) / 3
    K.fused_separable_blur2d(x, k, k, "reflect")
    K.multi_level_blur(x, [k, k], [k, k])
    K.patch_sample(x[0, 0], torch.zeros(2, 4), torch.zeros(2, 4))
    assert sum(K.launches.values()) == 0


def test_wrappers_refuse_devices_without_a_kernel():
    x = torch.empty((1, 1, 8, 8), device="meta")
    k = torch.empty(3, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.fused_separable_blur2d(x, k, k)
    with pytest.raises(ValueError, match="no kernel"):
        K.patch_sample(x[0, 0], x[0, 0], x[0, 0])


# --- patch_sample's plan: head, pairs, tail ------------------------------------

@pytest.mark.parametrize("total", [0, 1, 2, 3, 4, 5, 15, 361, 1023, 1024,
                                   1681, 35_017, 1_719_663, 1_721_344])
def test_patch_plan_covers_the_stream_once(total):
    """Every sample is taken once, by the two-a-thread body or by the
    one-a-thread head and tail; the body's 8-byte loads and stores start on
    8-byte boundaries of px, py and out (the output is allocated on px's
    parity); streams on different parities go one a thread."""
    for ox in range(4):
        for oy in range(4):
            for oo in range(4):
                px, py, out = 512 + 4 * ox, 1024 + 4 * oy, 2048 + 4 * oo
                head, pairs = K._patch_plan(total, px, py, out)
                body_end = head + 2 * pairs
                assert 0 <= head <= 1 and body_end <= total
                assert total - body_end <= (1 if pairs else total)
                if total <= 2048:
                    covered = (list(range(head))
                               + list(range(body_end, total))
                               + [i for g in range(pairs)
                                  for i in (head + 2 * g, head + 2 * g + 1)])
                    assert sorted(covered) == list(range(total))
                if pairs:
                    for p in (px, py, out):
                        assert (p + 4 * head) % 8 == 0
                same = ox % 2 == oy % 2 == oo % 2
                assert pairs == (0 if not same else (total - head) // 2)


def test_patch_plan_refuses_unaligned_floats():
    with pytest.raises(ValueError, match="4-byte"):
        K._patch_plan(100, 514, 1024, 2048)


# --- the adjoints' operators --------------------------------------------------

def _dyadic_taps(k, seed):
    """Taps that are multiples of 1/16: any sum of them is exact in f32."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(1, 16, k).astype(np.float32) / 16)


@pytest.mark.parametrize("border", ["constant", "circular"])
@pytest.mark.parametrize("k,size", [(5, 17), (4, 9), (11, 6), (30, 9)])
def test_flipped_taps_are_the_transposed_operator(border, k, size):
    """The fused adjoint of a constant or circular blur runs the blur kernel
    with flipped taps anchored at K - 1 - K // 2: that operator is Svᵀ."""
    taps = _dyadic_taps(k, k + size)
    flipped = K.band_matrix(taps.flip(0), size, border, anchor=k - 1 - k // 2)
    assert torch.equal(flipped, K.band_matrix(taps, size, border).T)


def _rebuild(start, w, taps, shape):
    dense = torch.zeros(shape)
    for lvl, K_l in enumerate(taps):
        assert not w[lvl, K_l:].any()
        idx = start[lvl].long()[:, None] + torch.arange(K_l)[None, :]
        dense[lvl].scatter_(1, idx, w[lvl, :K_l].T)
    return dense


@pytest.mark.parametrize("border", ["reflect", "replicate", "constant"])
@pytest.mark.parametrize("k,size", [(11, 64), (4, 9), (15, 6), (31, 9)])
def test_adjoint_bands_rebuild_transposed_operator(border, k, size):
    """The fused adjoint's bands of Svᵀ (reflect, replicate; the first and
    last columns collect the folded taps) rebuild it bit for bit, kernels
    wider than the image included."""
    taps = torch.rand(k, generator=torch.Generator().manual_seed(k + size))
    start, w, K_l = K._adjoint_band_tables_cached(
        (tuple(taps.tolist()),), size, border, "cpu")
    dense = _rebuild(start, w, K_l, (1, size, size))
    assert torch.equal(dense[0], K.band_matrix(taps, size, border).T)


@pytest.mark.parametrize("border,size", [("replicate", 80), ("reflect", 80),
                                         ("replicate", 30)])
def test_adjoint_bands_rebuild_transposed_cumulative_operators(border, size):
    """The multi-level adjoint's bands of SV_lᵀ rebuild every transposed
    cumulative operator bit for bit."""
    sigmas = [1.23, 1.55, 1.95, 2.45, 3.09]
    kers = _kernels_1d([(2 * int(np.ceil(4 * s)) + 1, s) for s in sigmas])
    values = tuple(tuple(float(v) for v in k) for k in kers)
    ops = K.cumulative_operators([torch.tensor(k) for k in kers], size,
                                 border)
    start, w, taps = K._adjoint_band_tables_cached(values, size, border, "cpu")
    assert torch.equal(_rebuild(start, w, taps, ops.shape),
                       ops.transpose(1, 2))


# --- bf16 patch mode ------------------------------------------------------------

def _jax_bf16_sample(atlas, px, py):
    """The TPU kernel's bf16 mode on the whole atlas as its window: the 2-hot
    y weights and the atlas cast to bf16 explicitly (as the matrix unit
    rounds them), one product with f32 sums, then the 2-hot x pass in f32."""
    H, W = atlas.shape
    x = jnp.clip(px, 0.0, W - 1.0)
    y = jnp.clip(py, 0.0, H - 1.0)
    x0, y0 = jnp.floor(x), jnp.floor(y)
    tx, ty = x - x0, y - y0
    y0i = y0.astype(jnp.int32)[..., None]
    y1i = jnp.minimum(y0i + 1, H - 1)
    x0i = x0.astype(jnp.int32)[..., None]
    x1i = jnp.minimum(x0i + 1, W - 1)
    rows = jnp.arange(H)
    cols = jnp.arange(W)
    wy = (jnp.where(rows == y0i, 1.0 - ty[..., None], 0.0)
          + jnp.where(rows == y1i, ty[..., None], 0.0))
    P = jnp.einsum("nsh,hw->nsw", wy.astype(jnp.bfloat16),
                   atlas.astype(jnp.bfloat16),
                   preferred_element_type=jnp.float32)
    wx = (jnp.where(cols == x0i, 1.0 - tx[..., None], 0.0)
          + jnp.where(cols == x1i, tx[..., None], 0.0))
    return jnp.sum(P * wx, axis=-1)


def _patch_inputs(seed, Ha=300, Wa=400, N=9, S=19 * 19):
    rng = np.random.default_rng(seed)
    atlas = rng.random((Ha, Wa), dtype=np.float32)
    centers = rng.uniform([60, 60], [Wa - 60, Ha - 60], (N, 2))
    off = rng.uniform(-55, 55, (N, S, 2))
    px = (centers[:, None, 0] + off[..., 0]).astype(np.float32)
    py = (centers[:, None, 1] + off[..., 1]).astype(np.float32)
    return atlas, px, py


def test_patch_sample_bf16_plain_matches_jax_formula():
    """1e-6 against the bf16 formula written with explicit jnp.bfloat16
    casts, and 4e-3 against the exact 'split' Pallas kernel (bf16 keeps 8
    bits: weights and texels each round by up to 2⁻⁹ relative)."""
    atlas, px, py = _patch_inputs(3)
    out = K.patch_sample(torch.from_numpy(atlas), torch.from_numpy(px),
                         torch.from_numpy(py), mode="bf16")
    ref = jax.jit(_jax_bf16_sample)(jnp.asarray(atlas), jnp.asarray(px),
                                    jnp.asarray(py))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
    split = exact_jit(lambda a, x, y: pk.patch_sample_mxu(
        a, x, y, interpret=True, mode="split"), atlas, px, py, exact=False)
    np.testing.assert_allclose(out.numpy(), np.asarray(split), atol=4e-3)
    assert not np.array_equal(out.numpy(), np.asarray(split))


def test_patch_sample_modes():
    atlas, px, py = (torch.from_numpy(a) for a in _patch_inputs(4, N=2))
    exact = K.patch_sample(atlas, px, py)
    torch.testing.assert_close(K.patch_sample(atlas, px, py, "highest"),
                               exact, atol=0, rtol=0)
    with pytest.raises(ValueError, match="mode"):
        K.patch_sample(atlas, px, py, "fp8")


def test_new_cpu_wrappers_launch_nothing_and_refuse_meta():
    K.reset_launches()
    g = torch.rand(1, 1, 16, 16)
    k = torch.ones(3) / 3
    K.fused_separable_blur2d_adjoint(g, k, k, "reflect")
    K.multi_level_blur_adjoint(g[None].expand(2, -1, -1, -1, -1), [k, k],
                               [k, k])
    K.patch_sample(g[0, 0], torch.zeros(2, 4), torch.zeros(2, 4), "bf16")
    K.streaming_min2(torch.rand(5, 8), torch.rand(7, 8))
    assert sum(K.launches.values()) == 0
    meta = torch.empty((1, 1, 8, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.fused_separable_blur2d_adjoint(meta, k, k)
    with pytest.raises(ValueError, match="no kernel"):
        K.streaming_min2(meta[0, 0], meta[0, 0])


# --- the tiled blur kernels' shared-memory windows -----------------------------
# csrc/banded_blur.cu stages, per output tile, the input rows (columns) its
# outputs read and a dense window of the operator over them; a tile is
# kTileH = 32 rows by kTileW = 64 columns, columns staged from a 16-byte
# aligned start. These tests rebuild those windows as the kernel does.

_TILES = ((32, False), (64, True))  # (tile, aligned start): rows, columns


def _tiles(size, tile):
    for r0 in range(0, size, tile):
        yield r0, min(tile, size - r0)


def _band_window(start, w, K_l, r0, n, aligned):
    """A tile's staged window of one banded level: first staged index, the
    count staged and vt[s, i], the weight of staged index s in output i."""
    first = int(start[r0])
    lo = first & ~3 if aligned else first
    count = int(start[r0 + n - 1]) + K_l - lo
    k = lo + torch.arange(count)[:, None] - start[r0:r0 + n].long()[None, :]
    ok = (k >= 0) & (k < K_l)
    cols = torch.arange(r0, r0 + n)[None, :].expand_as(k)
    vt = torch.where(ok, w[k.clamp(0, K_l - 1), cols], 0.0)
    return lo, count, vt


@pytest.mark.parametrize("border", ["replicate", "reflect"])
@pytest.mark.parametrize("size", [20, 37, 60, 80, 200])
def test_tile_windows_hold_cumulative_operators(border, size):
    """Each tile's window of the multi-level bands holds every nonzero of
    its rows of the cumulative operators, bit for bit, inside the staged
    span (at most tile + K_l - 1 indices, + 3 for the aligned column
    start), which lies inside the image."""
    sigmas = [1.23, 1.55, 1.95, 2.45, 3.09]
    kers = [torch.from_numpy(k) for k in _kernels_1d(
        [(2 * int(np.ceil(4 * s)) + 1, s) for s in sigmas])]
    ops = K.cumulative_operators(kers, size, border)
    start, w, taps = K._band_taps(
        ops, K._half_widths([k.numel() for k in kers], size, border))
    for tile, aligned in _TILES:
        for lvl, K_l in enumerate(taps):
            for r0, n in _tiles(size, tile):
                lo, count, vt = _band_window(start[lvl], w[lvl], K_l, r0, n,
                                             aligned)
                assert 0 <= lo and lo + count <= size + (3 if aligned else 0)
                assert count <= tile + K_l - 1 + (3 if aligned else 0)
                span = slice(lo, min(lo + count, size))
                rows = ops[lvl, r0:r0 + n]
                assert torch.equal(vt[:span.stop - lo].T, rows[:, span])
                assert not rows[:, :lo].any() and not rows[:, span.stop:].any()


def _border_index(t, size, border):
    """csrc/banded_blur.cu::border_index: the source of index t under the
    border rule, -1 where the rule drops it."""
    if border == "reflect":
        period = max(2 * (size - 1), 1)
        i = torch.remainder(t, period)
        return torch.where(i >= size, period - i, i)
    if border == "replicate":
        return t.clamp(0, size - 1)
    if border == "circular":
        return torch.remainder(t, size)
    return torch.where((t >= 0) & (t < size), t, -1)


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("k,size", [(5, 37), (4, 9), (15, 70), (31, 9),
                                    (11, 6)])
@pytest.mark.parametrize("flipped", [False, True])
def test_staged_taps_rebuild_band_matrix(border, k, size, flipped):
    """The single blur stages, per tile, the virtual indices r0 - anchor ..
    r0 + n - 1 - anchor + K - 1 folded by the border rule (dropped ones
    staged as zero) and weighs them with the taps; summed over the tiles
    that is the dense operator, bit for bit (dyadic taps: every sum exact),
    for the blur's anchor K // 2 and the flipped adjoint's K - 1 - K // 2."""
    taps = _dyadic_taps(k, k * size)
    anchor = k - 1 - k // 2 if flipped else k // 2
    for tile, aligned in _TILES:
        dense = torch.zeros((size, size))
        for r0, n in _tiles(size, tile):
            first = r0 - anchor
            lo = first & ~3 if aligned else first
            count = n - 1 + k + first - lo
            assert count <= tile + k - 1 + (3 if aligned else 0)
            src = _border_index(lo + torch.arange(count), size, border)
            keep = src >= 0
            s = torch.arange(count)[:, None]
            tap = s - (first - lo) - torch.arange(n)[None, :]
            vt = torch.where((tap >= 0) & (tap < k),
                             taps[tap.clamp(0, k - 1)], 0.0)
            for i in range(n):
                dense[r0 + i].index_put_((src[keep],), vt[keep, i],
                                         accumulate=True)
        assert torch.equal(dense, K.band_matrix(taps, size, border, anchor))


# --- the tiled band adjoint: one block per tile, the levels in turn ----------
# csrc/banded_blur.cu::tile_band_adjoint runs, for each level l of its tile,
# the forward's staging on the bands of the TRANSPOSED operators: rows of
# SV_lᵀ down the tile (32 rows, unaligned start), columns of SH_lᵀ along it
# (64 columns, 16-byte aligned start), then adds the level's passes into its
# registers.

def _ssim_taps():
    return (tuple(float(v) for v in _kernels_1d([(11, 1.5)])[0]),)


def _pyramid_taps():
    sigmas = [1.23, 1.55, 1.95, 2.45, 3.09]
    return tuple(tuple(float(v) for v in k) for k in _kernels_1d(
        [(2 * int(np.ceil(4 * s)) + 1, s) for s in sigmas]))


@pytest.mark.parametrize("which,border,size", [
    # the multi-level adjoint at each side of the 480x640 pyramid's octaves,
    # and ragged sizes below a tile and below the widest band
    *[("pyramid", "replicate", n) for n in (480, 640, 240, 320, 120, 160,
                                            60, 80, 37, 53)],
    ("pyramid", "reflect", 83),
    # the SSIM loss's single blur (L = 1), and a ragged size
    ("ssim", "reflect", 480), ("ssim", "reflect", 640),
    ("ssim", "replicate", 640), ("ssim", "reflect", 61)])
def test_tiled_adjoint_windows_hold_transposed_operators(which, border, size):
    """For every level of the adjoint's loop and every tile, the window the
    kernel stages from _adjoint_band_tables_cached holds the tile's rows of
    the transposed operator bit for bit, inside a span that lies in the
    image and fits the shared memory laid out for the widest level."""
    values = _pyramid_taps() if which == "pyramid" else _ssim_taps()
    start, w, taps = K._adjoint_band_tables_cached(values, size, border,
                                                   "cpu")
    ops = K.cumulative_operators([torch.tensor(v) for v in values], size,
                                 border).transpose(1, 2)
    kmax = w.shape[1]
    assert kmax == max(taps)
    for tile, aligned in _TILES:
        for lvl, K_l in enumerate(taps):
            for r0, n in _tiles(size, tile):
                lo, count, vt = _band_window(start[lvl], w[lvl], K_l, r0, n,
                                             aligned)
                assert 0 <= lo and lo + count <= size + (3 if aligned else 0)
                assert count <= tile + kmax - 1 + (3 if aligned else 0)
                span = slice(lo, min(lo + count, size))
                rows = ops[lvl, r0:r0 + n]
                assert torch.equal(vt[:span.stop - lo].T, rows[:, span])
                assert not rows[:, :lo].any() and not rows[:, span.stop:].any()


def test_band_route_is_chosen_before_launch(monkeypatch):
    """The route of a band launch follows from the grid's fill and from
    whether the bands fit a block's shared memory, and nothing else: the
    adjoint's grid counts images, the forward's images x levels."""
    fill = {}
    monkeypatch.setattr(K, "_blocks_per_sm",
                        lambda depth, H, W, device: fill[depth])
    fits = {"ok": True}
    monkeypatch.setattr(K, "_tiled_fits", lambda *a: fits["ok"])
    monkeypatch.setattr(K, "_ADJOINT_TILED_FILL", 1.0)
    fill.update({1: 0.9, 5: 4.5, 2: 1.8, 10: 9.0})
    # forward: a block per tile and level
    assert K._band_route(False, 5, 1, 480, 640, 87, 87, "cpu") == K._TILED
    # adjoint: a block per tile; 0.9 blocks per SM is below its threshold
    assert K._band_route(True, 5, 1, 480, 640, 87, 87, "cpu") == K._PASSES
    assert K._band_route(True, 5, 2, 480, 640, 87, 87, "cpu") == K._TILED
    assert K._band_route(True, 1, 2, 480, 640, 11, 11, "cpu") == K._TILED
    fits["ok"] = False
    assert K._band_route(False, 5, 2, 480, 640, 640, 640, "cpu") == K._PASSES
    assert K._band_route(True, 5, 2, 480, 640, 640, 640, "cpu") == K._PASSES


def test_launch_counters_count_each_route():
    K.reset_launches()
    K._check_launch("blur", 0, K._TILED)
    K._check_launch("blur", 0, K._TILED_SMALL)
    K._check_launch("blur", 0, K._PASSES)
    K._check_launch("patch", 0)
    assert dict(K.launches) == {"blur": 3, "blur:tiled": 2,
                                "blur:passes": 1, "patch": 1}
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        K._check_launch("blur", 1, K._TILED)
    assert K.launches["blur"] == 3 and K.launches["blur:tiled"] == 2
    K.reset_launches()


# --- streaming_min2's 3xTF32 split -------------------------------------------
# csrc/streaming_min2.cu splits each f32 value a into a_hi = tf32(a) and
# a_lo = tf32(a - a_hi) (cvt.rna: to nearest, ties away from zero, 10
# mantissa bits) and sums a_lo·b_hi + a_hi·b_lo + a_hi·b_hi in f32.

def _tf32(x):
    """Round f32 to TF32 as cvt.rna does: add half of the 13 dropped bits'
    unit to the magnitude's bits, then drop them (ties away from zero)."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_dists(a, b, terms=3):
    """n1 + n2 - 2·dot, dot from the TF32 split in f32, clamped at 0."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    dot = ah @ bh.T
    if terms == 3:
        dot = (al @ bh.T + ah @ bl.T) + dot
    n1 = (a * a).sum(-1, dtype=np.float32)
    n2 = (b * b).sum(-1, dtype=np.float32)
    return np.maximum(n1[:, None] + n2[None, :] - np.float32(2) * dot, 0)


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's unit in the last place at 1
    x = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                  one + 3 * ulp / 4, np.float32(3.0)], dtype=np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.array([one + ulp, -(one + ulp), one, one + ulp, 3.0],
                           dtype=np.float32))


def test_3xtf32_split_holds_f32_accuracy():
    """At 512 x 512 x 128: exact on integer descriptors (the lo parts are
    zero); within 1e-5 (chip_smoke.py's MATCH_ATOL) of the float64
    distances on unit rows, where a single TF32 product is not."""
    rng = np.random.default_rng(30)
    a = rng.integers(0, 4, (512, 128)).astype(np.float32)
    b = rng.integers(0, 4, (512, 128)).astype(np.float32)
    assert not _tf32(a - _tf32(a)).any()
    exact = ((a.astype(np.float64)[:, None] - b[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(_split_dists(a, b), exact)
    a, b = (rng.standard_normal((512, 128)).astype(np.float32)
            for _ in range(2))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    b /= np.linalg.norm(b, axis=1, keepdims=True)
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    ref = ((a64[:, None] - b64[None]) ** 2).sum(-1)
    err3 = np.abs(_split_dists(a, b) - ref).max()
    err1 = np.abs(_split_dists(a, b, terms=1) - ref).max()
    assert err3 <= 1e-5 < err1
