"""The port's CUDA kernels against their plain PyTorch versions, the
card's gradients against the CPU's, and the SLAM back end and the learned
features (which have no kernel of their own) on the card against the CPU
port. Every test here needs a CUDA card and skips without one. The file imports nothing of the JAX package
(``kornia_tpu``), so it also runs where that package's own dependencies
are missing:

    python -m pytest -m cuda tests/test_torch_cuda.py -q

(``python3 chip_smoke.py`` makes the same comparisons at the paths'
shapes.)
"""

import time

import numpy as np
import pytest
import torch

from kornia_tpu_torch import convert
from kornia_tpu_torch.feature import matching as t_match
from kornia_tpu_torch.losses import losses as t_losses
from kornia_tpu_torch.ops import filters as t_filters
from kornia_tpu_torch.ops import kernels as K
from kornia_tpu_torch.ops import pyramid as t_pyr
from tests.torch_unit_scale import rrdbnet_unit_scale, yunet_unit_scale

pytestmark = pytest.mark.cuda

BORDERS = ["reflect", "replicate", "circular", "constant"]
# [0, 1] images: f32 products summed in another order than the plain version
ATOL = 1e-5
SIGMAS = [1.23, 1.55, 1.95, 2.45, 3.09]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _gauss(k, sigma, device="cpu"):
    return t_filters.get_gaussian_kernel1d(k, sigma, device=device)[0]


def _level_kernels(n=5):
    return [_gauss(2 * int(np.ceil(4 * s)) + 1, s) for s in SIGMAS[:n]]


# --- forward kernels -------------------------------------------------------------

@pytest.mark.parametrize("border", BORDERS)
def test_cuda_fused_blur_matches_plain(cuda_device, border):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((2, 3, 120, 160), device=cuda_device, generator=gen)
    k = _gauss(15, 1.52, cuda_device)
    before = K.launches["fused_separable_blur2d"]
    out = K.fused_separable_blur2d(x, k, k, border)
    assert K.launches["fused_separable_blur2d"] == before + 1
    ref = K.fused_separable_blur2d_plain(x, k, k, border)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


def test_cuda_multi_level_blur_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.rand((1, 1, 240, 320), device=cuda_device, generator=gen)
    kers = [k.to(cuda_device) for k in _level_kernels()]
    out = K.multi_level_blur(x, kers, kers)
    ref = K.multi_level_blur_plain(x, kers, kers)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


# shapes for the tiled kernels (32 x 64 output tiles, halos up to 43): the
# pair's four octaves, ragged sizes, sizes below a tile and below the
# widest band (87 taps), and six images at once
ML_SHAPES = [(1, 1, 480, 640), (1, 1, 240, 320), (1, 1, 120, 160),
             (1, 1, 60, 80), (1, 1, 37, 53), (1, 1, 33, 200), (1, 1, 20, 30),
             (2, 3, 61, 83)]


@pytest.mark.parametrize("route", ["tiled", "by_fill"])
@pytest.mark.parametrize("border", ["replicate", "reflect"])
@pytest.mark.parametrize("shape", ML_SHAPES)
def test_cuda_tiled_multi_level_blur_matches_plain(cuda_device, border,
                                                   shape, route, monkeypatch):
    """'tiled' takes the tiled kernel at every shape; 'by_fill' lets the
    wrapper choose (the two passes where the tiled grid would not fill the
    card)."""
    if route == "tiled":
        monkeypatch.setattr(K, "_BAND_TILED_FILL", 0.0)
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    x = torch.rand(shape, device=cuda_device, generator=gen)
    kers = _level_kernels()
    before = K.launches["multi_level_blur"]
    out = K.multi_level_blur(x, kers, kers, border)
    assert K.launches["multi_level_blur"] == before + 1
    ref = K.multi_level_blur_plain(x, kers, kers, border)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


def test_cuda_multi_level_blur_circular_matches_plain(cuda_device):
    """A circular border's bands span the whole axis; too wide to stage at
    640 columns, they run the two passes instead."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    kers = _level_kernels(3)
    for shape in ((1, 1, 48, 64), (1, 1, 120, 640)):
        x = torch.rand(shape, device=cuda_device, generator=gen)
        out = K.multi_level_blur(x, kers, kers, "circular")
        ref = K.multi_level_blur_plain(x, kers, kers, "circular")
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("border", BORDERS)
@pytest.mark.parametrize("k", [2, 5, 11, 16, 31])
def test_cuda_tiled_fused_blur_matches_plain(cuda_device, border, k):
    """Odd and even taps (the anchor K // 2 leans right for even K), at
    sizes below a tile and below the halo, ragged sizes and several
    images; the flipped-tap adjoint of constant and circular borders runs
    the same kernel."""
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    kx = torch.rand(k, device=cuda_device, generator=gen) / k
    ky = torch.rand(k, device=cuda_device, generator=gen) / k
    # (4, 40, 37, 53) fills the card with 32 x 64 tiles, the others take
    # 16 x 32 tiles
    for shape in ((1, 1, 7, 9), (1, 1, 20, 30), (2, 3, 37, 53),
                  (1, 2, 97, 200), (4, 40, 37, 53)):
        x = torch.rand(shape, device=cuda_device, generator=gen)
        out = K.fused_separable_blur2d(x, ky, kx, border)
        ref = K.fused_separable_blur2d_plain(x, ky, kx, border)
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
        if border in ("constant", "circular"):
            out = K.fused_separable_blur2d_adjoint(x, ky, kx, border)
            ref = K.fused_separable_blur2d_adjoint_plain(x, ky, kx, border)
            torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


def test_cuda_tiled_fused_blur_ssim_shape(cuda_device):
    """The SSIM loss's blur and its flipped-tap adjoints at (8, 3, 480,
    640), 11 taps."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.rand((8, 3, 480, 640), device=cuda_device, generator=gen)
    k = _gauss(11, 1.5, cuda_device)
    torch.testing.assert_close(
        K.fused_separable_blur2d(x, k, k, "reflect"),
        K.fused_separable_blur2d_plain(x, k, k, "reflect"), atol=ATOL, rtol=0)
    for border in ("constant", "circular"):
        torch.testing.assert_close(
            K.fused_separable_blur2d_adjoint(x, k, k, border),
            K.fused_separable_blur2d_adjoint_plain(x, k, k, border),
            atol=ATOL, rtol=0)


def test_cuda_patch_sample_matches_plain(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    atlas = torch.rand((900, 640), device=cuda_device, generator=gen)
    px = torch.rand((64, 1681), device=cuda_device, generator=gen) * 700 - 30
    py = torch.rand((64, 1681), device=cuda_device, generator=gen) * 950 - 25
    out = K.patch_sample(atlas, px, py)
    ref = K.patch_sample_plain(atlas, px, py)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


def test_cuda_patch_sample_bf16_matches_plain(cuda_device):
    """1e-6 against the plain bf16 version (the same roundings); 4e-3
    against the exact kernel (bf16 keeps 8 bits)."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    atlas = torch.rand((900, 640), device=cuda_device, generator=gen)
    px = torch.rand((64, 1681), device=cuda_device, generator=gen) * 700 - 30
    py = torch.rand((64, 1681), device=cuda_device, generator=gen) * 950 - 25
    before = K.launches["patch_sample[bf16]"]
    out = K.patch_sample(atlas, px, py, "bf16")
    assert K.launches["patch_sample[bf16]"] == before + 1
    torch.testing.assert_close(
        out, K.patch_sample_plain(atlas, px, py, "bf16"), atol=1e-6, rtol=0)
    torch.testing.assert_close(out, K.patch_sample(atlas, px, py),
                               atol=4e-3, rtol=0)


def test_cuda_patch_sample_refuses_grad(cuda_device):
    atlas = torch.rand((64, 64), device=cuda_device, requires_grad=True)
    px = torch.rand((2, 9), device=cuda_device) * 60
    with pytest.raises(RuntimeError, match="no backward"):
        K.patch_sample(atlas, px, px)
    with torch.no_grad():
        assert K.patch_sample(atlas, px, px).shape == (2, 9)


# patch_sample's grid-stride kernel (csrc/patch_sample.cu: two samples a
# thread through 8-byte loads, the head and tail one a thread): streams that
# are ragged, at 4-byte offsets, empty or one sample long; less work than
# the grid has threads and several grid-strides of it; coordinates far
# outside the atlas; a footprint wider than the TPU kernel's 128 x 256
# window. A kernel that never ends would hang the suite, so each launch is
# waited for against a deadline.
PATCH_WAIT_S = 30.0
PATCH_TOL = {"split": ATOL, "bf16": 1e-6}
PATCH_GRID_THREADS = 16 * 128  # kBlocksPerSm x kThreads an SM


def _wait_or_fail(what, seconds=PATCH_WAIT_S):
    done = torch.cuda.Event()
    done.record()
    deadline = time.monotonic() + seconds
    while not done.query():
        if time.monotonic() > deadline:
            pytest.fail(f"{what} did not finish within {seconds} s")
        time.sleep(1e-3)


def _patch_grid_samples(device, factor):
    """`factor` times the samples one pass of the grid takes (two a
    thread)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, int(factor * sms * PATCH_GRID_THREADS * 2))


def _patch_case(case, device):
    """(atlas, px, py) of one case; coordinates over the atlas and 10 px
    beyond it unless the case says otherwise."""
    gen = torch.Generator(device=device).manual_seed(11)
    rand = lambda *shape: torch.rand(shape, device=device,  # noqa: E731
                                     generator=gen)
    atlas = rand(900, 640)
    H, W = atlas.shape

    def coords(n, s):
        return rand(n, s) * (W + 20) - 10, rand(n, s) * (H + 20) - 10

    def at_offset(t, k):
        """t's values in a contiguous view k floats into a larger buffer."""
        flat = torch.empty(t.numel() + 8, device=device)
        view = flat[k:k + t.numel()].view(t.shape)
        view.copy_(t)
        return view

    if case == "ragged":  # N·S odd: neither a multiple of 4 nor of a tile
        return (atlas, *coords(1023, 1681))
    if case == "small_ragged":
        return (atlas, *coords(3, 5))
    if case == "empty":
        return (atlas, *coords(0, 361))
    if case == "one":
        return (atlas, *coords(1, 1))
    if case.startswith("offset"):  # px, py k floats past a 16-byte boundary
        kx, ky = int(case[-2]), int(case[-1])
        px, py = coords(1024, 361)
        return atlas, at_offset(px, kx), at_offset(py, ky)
    if case == "row_views":  # laf.py's px[b] rows of an odd-sized batch
        px, py = coords(3 * 97, 361)
        return atlas, px.view(3, 97, 361)[1], py.view(3, 97, 361)[2]
    if case == "sliced":
        px, py = coords(64, 1682)
        return atlas, px[:, 1:].contiguous(), py[:, :-1].contiguous()
    if case.startswith("grid"):  # below, at and above one grid pass
        factor = {"grid_below": 0.1, "grid_at": 1.0, "grid_above": 7.3}[case]
        n = _patch_grid_samples(device, factor) // 1681 + 1
        return (atlas, *coords(n, 1681))
    if case == "far_outside":
        px = (rand(256, 361) - 0.5) * 2e6
        py = (rand(256, 361) - 0.5) * 2e6
        px[0, :4] = torch.tensor([float("inf"), -float("inf"), 1e30, -1e30])
        py[1, :4] = torch.tensor([float("inf"), -float("inf"), 1e30, -1e30])
        return atlas, px, py
    if case == "wide_footprint":  # each patch spans the whole atlas
        t = torch.linspace(0.0, 1.0, 41, device=device)
        gy, gx = torch.meshgrid(t, t, indexing="ij")
        jitter = rand(128, 1, 1)
        px = (gx[None] * (W - 1) * (0.5 + 0.5 * jitter)).reshape(128, -1)
        py = (gy[None] * (H - 1) * (0.5 + 0.5 * jitter)).reshape(128, -1)
        return atlas, px.contiguous(), py.contiguous()
    raise ValueError(case)


PATCH_CASES = (["ragged", "small_ragged", "empty", "one", "row_views",
                "sliced", "grid_below", "grid_at", "grid_above",
                "far_outside", "wide_footprint"]
               + [f"offset{kx}{ky}" for kx, ky in
                  [(1, 0), (0, 2), (3, 3), (1, 2), (2, 3)]])


@pytest.mark.parametrize("mode", ["split", "bf16"])
@pytest.mark.parametrize("case", PATCH_CASES)
def test_cuda_patch_sample_stream_cases(cuda_device, case, mode):
    atlas, px, py = _patch_case(case, cuda_device)
    name = "patch_sample[bf16]" if mode == "bf16" else "patch_sample"
    before = K.launches[name]
    out = K.patch_sample(atlas, px, py, mode)
    _wait_or_fail(f"{name} on case {case}")
    assert K.launches[name] == before + (1 if px.numel() else 0)
    assert out.shape == px.shape
    torch.testing.assert_close(out, K.patch_sample_plain(atlas, px, py, mode),
                               atol=PATCH_TOL[mode], rtol=0)


# --- adjoints and gradients ------------------------------------------------------

@pytest.mark.parametrize("border", BORDERS)
def test_cuda_adjoint_kernels_match_plain(cuda_device, border):
    """Both adjoints on [0, 1] data; an even kernel checks the flipped
    taps' anchor."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    g = torch.rand((2, 3, 120, 160), device=cuda_device, generator=gen)
    for k in (_gauss(11, 1.5, cuda_device),
              torch.rand(6, device=cuda_device, generator=gen) / 3):
        before = K.launches["fused_separable_blur2d_adjoint"]
        out = K.fused_separable_blur2d_adjoint(g, k, k, border)
        assert K.launches["fused_separable_blur2d_adjoint"] == before + 1
        ref = K.fused_separable_blur2d_adjoint_plain(g, k, k, border)
        torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)
    kers = _level_kernels(3)
    gl = torch.rand((3, 1, 2, 96, 128), device=cuda_device, generator=gen)
    before = K.launches["multi_level_blur_adjoint"]
    out = K.multi_level_blur_adjoint(gl, kers, kers, border)
    assert K.launches["multi_level_blur_adjoint"] == before + 1
    ref = K.multi_level_blur_adjoint_plain(gl, kers, kers, border)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


# the band adjoint's routes, forced by the wrapper's threshold: the tiled
# kernel (a block per tile, the levels summed in it) or the two passes
ADJOINT_ROUTES = {"tiled": 0.0, "passes": float("inf")}


def _force_adjoint_route(monkeypatch, route):
    monkeypatch.setattr(K, "_ADJOINT_TILED_FILL", ADJOINT_ROUTES[route])
    return route


def _counted(name, route, fn):
    """fn's result; asserts it counted one launch of `name` on `route`."""
    before = (K.launches[name], K.launches[f"{name}:{route}"])
    out = fn()
    assert (K.launches[name], K.launches[f"{name}:{route}"]) == (
        before[0] + 1, before[1] + 1)
    return out


@pytest.mark.parametrize("border", ["reflect", "replicate"])
def test_cuda_band_adjoint_ssim_shape(cuda_device, border):
    """The SSIM loss's adjoint at (8, 3, 480, 640), 11 taps, on the route
    the wrapper chooses (tiled, no (L, N, H, W) intermediate)."""
    gen = torch.Generator(device=cuda_device).manual_seed(41)
    g = torch.rand((8, 3, 480, 640), device=cuda_device, generator=gen)
    k = _gauss(11, 1.5, cuda_device)
    out = _counted("fused_separable_blur2d_adjoint", "tiled",
                   lambda: K.fused_separable_blur2d_adjoint(g, k, k, border))
    ref = K.fused_separable_blur2d_adjoint_plain(g, k, k, border)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


# the 480x640 pyramid's octaves with two images, ragged sizes, sizes below
# a tile and below the widest band, six images
ADJ_SHAPES = [(5, 1, 2, 480, 640), (5, 1, 2, 240, 320), (5, 1, 2, 120, 160),
              (5, 1, 2, 60, 80), (5, 1, 1, 37, 53), (5, 1, 1, 20, 30),
              (5, 2, 3, 61, 83), (2, 1, 1, 33, 200)]


@pytest.mark.parametrize("route", list(ADJOINT_ROUTES))
@pytest.mark.parametrize("border", ["replicate", "reflect"])
@pytest.mark.parametrize("shape", ADJ_SHAPES)
def test_cuda_multi_level_adjoint_routes_match_plain(cuda_device, border,
                                                     shape, route,
                                                     monkeypatch):
    counted = _force_adjoint_route(monkeypatch, route)
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape))
    g = torch.rand(shape, device=cuda_device, generator=gen)
    kers = _level_kernels(shape[0])
    out = _counted("multi_level_blur_adjoint", counted,
                   lambda: K.multi_level_blur_adjoint(g, kers, kers, border))
    ref = K.multi_level_blur_adjoint_plain(g, kers, kers, border)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("route", list(ADJOINT_ROUTES))
@pytest.mark.parametrize("border", ["reflect", "replicate"])
def test_cuda_fused_band_adjoint_routes_match_plain(cuda_device, border,
                                                    route, monkeypatch):
    """L = 1 bands, odd and even taps, at ragged and below-halo sizes."""
    counted = _force_adjoint_route(monkeypatch, route)
    gen = torch.Generator(device=cuda_device).manual_seed(43)
    for k in (_gauss(11, 1.5, cuda_device),
              torch.rand(6, device=cuda_device, generator=gen) / 3):
        for shape in ((1, 1, 7, 9), (2, 3, 37, 53), (1, 2, 97, 200)):
            g = torch.rand(shape, device=cuda_device, generator=gen)
            out = _counted(
                "fused_separable_blur2d_adjoint", counted,
                lambda: K.fused_separable_blur2d_adjoint(g, k, k, border))
            ref = K.fused_separable_blur2d_adjoint_plain(g, k, k, border)
            torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


def test_cuda_tiled_launch_error_raises(cuda_device, monkeypatch):
    """Bands too wide to stage take the passes, counted as such; forced onto
    the tiled route they raise and count nothing (no silent passes)."""
    gen = torch.Generator(device=cuda_device).manual_seed(44)
    x = torch.rand((1, 1, 120, 640), device=cuda_device, generator=gen)
    kers = _level_kernels(3)
    out = _counted("multi_level_blur", "passes",
                   lambda: K.multi_level_blur(x, kers, kers, "circular"))
    torch.testing.assert_close(
        out, K.multi_level_blur_plain(x, kers, kers, "circular"), atol=ATOL,
        rtol=0)
    # three 201-tap kernels: bands of 601 columns, too wide to stage; the
    # replicate edges collect hundreds of taps (values up to about 150), so
    # the tolerance is ATOL of the largest value
    wide = [_gauss(201, 30.0) for _ in range(3)]
    g = torch.rand((3, 1, 1, 64, 640), device=cuda_device, generator=gen)
    out = _counted("multi_level_blur_adjoint", "passes",
                   lambda: K.multi_level_blur_adjoint(g, wide, wide))
    ref = K.multi_level_blur_adjoint_plain(g, wide, wide)
    torch.testing.assert_close(out, ref, atol=ATOL * ref.abs().max().item(),
                               rtol=0)
    k301 = _gauss(301, 40.0, cuda_device)
    out = _counted("fused_separable_blur2d", "passes",
                   lambda: K.fused_separable_blur2d(x, k301, k301,
                                                    "circular"))
    torch.testing.assert_close(
        out, K.fused_separable_blur2d_plain(x, k301, k301, "circular"),
        atol=ATOL, rtol=0)
    # forced: the bands and taps "fit", and every grid fills the card
    monkeypatch.setattr(K, "_tiled_fits", lambda *a: True)
    monkeypatch.setattr(K, "_BAND_TILED_FILL", 0.0)
    monkeypatch.setattr(K, "_ADJOINT_TILED_FILL", 0.0)
    before = dict(K.launches)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        K.multi_level_blur(x, kers, kers, "circular")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        K.multi_level_blur_adjoint(g, wide, wide)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        K.fused_separable_blur2d(x, k301, k301, "circular")
    assert dict(K.launches) == before


@pytest.mark.parametrize("border", BORDERS)
def test_cuda_fused_blur_grads_match_cpu(cuda_device, border):
    """The card's gradients (adjoint kernel, tap grads) equal the CPU's:
    x to 1e-5, taps to 1e-5 relative (each a sum of 32,400 products near
    1, summed in another order); even taps along x."""
    rng = np.random.default_rng(20)
    x = rng.random((2, 3, 60, 90), dtype=np.float32)
    ky = _gauss(11, 1.5).numpy()
    kx = rng.random(6, dtype=np.float32) / 3
    grads = []
    for dev in ("cpu", cuda_device):
        tx, tky, tkx = (torch.tensor(a, device=dev, requires_grad=True)
                        for a in (x, ky, kx))
        out = K.fused_separable_blur2d(tx, tky, tkx, border)
        assert out.grad_fn is not None
        (out ** 2).sum().backward()
        grads.append([t.grad.cpu() for t in (tx, tky, tkx)])
    torch.testing.assert_close(grads[1][0], grads[0][0], atol=ATOL, rtol=0)
    for a, b in zip(grads[1][1:], grads[0][1:]):
        torch.testing.assert_close(a, b, atol=0, rtol=1e-5)


def test_cuda_ssim_and_pyramid_grads_match_cpu(cuda_device):
    """SSIM loss plus the squared DoG levels of ScalePyramid: card and CPU
    gradients to 1e-5 of the largest."""
    rng = np.random.default_rng(22)
    target = rng.random((2, 3, 64, 64), dtype=np.float32)
    pred = (target + 0.1 * rng.standard_normal(target.shape)).astype(
        np.float32)
    grads = []
    for dev in ("cpu", cuda_device):
        tp = torch.tensor(pred, device=dev, requires_grad=True)
        loss = t_losses.ssim_loss(tp, torch.tensor(target, device=dev))
        octaves = t_pyr.ScalePyramid(3, 1.6, 32)(tp)[0]
        dog = sum(((o[:, 1:] - o[:, :-1]) ** 2).sum() for o in octaves)
        (loss + dog).backward()
        grads.append(tp.grad.cpu())
    scale = grads[0].abs().max()
    torch.testing.assert_close(grads[1], grads[0], atol=1e-5 * scale, rtol=0)


def test_cuda_filters_carry_grad_fn(cuda_device):
    x = torch.rand((1, 1, 40, 48), device=cuda_device, requires_grad=True)
    k = _gauss(5, 1.0, cuda_device)
    assert t_filters.gaussian_blur2d(x, 5, 1.0).grad_fn is not None
    assert t_filters.filter2d_separable(x, k, k).grad_fn is not None
    assert t_pyr.pyrdown(x).grad_fn is not None
    kers = _level_kernels(3)
    assert K.multi_level_blur(x, kers, kers).grad_fn is not None


# --- streaming matcher -----------------------------------------------------------

def _int_descs(seed, n, m, d):
    """Integer entries: every distance is exact, so ties are real."""
    rng = np.random.default_rng(seed)
    d1 = rng.integers(0, 4, (n, d)).astype(np.float32)
    d2 = rng.integers(0, 4, (m, d)).astype(np.float32)
    d2[7] = d2[3]
    return d1, d2


@pytest.mark.parametrize("n,m", [(1000, 777), (64, 64), (5, 3000)])
def test_cuda_streaming_min2_matches_plain(cuda_device, n, m):
    """Ragged sizes; exact distances, so exactly equal (ties included)."""
    a, b = (torch.tensor(v, device=cuda_device)
            for v in _int_descs(6, n, m, 72))
    before = K.launches["streaming_min2"]
    out = K.streaming_min2(a, b)
    assert K.launches["streaming_min2"] == before + 1
    for o, r in zip(out, K.streaming_min2_plain(a, b)):
        torch.testing.assert_close(o, r, atol=0, rtol=0)


def test_cuda_streaming_matcher_stores_no_distance_matrix(cuda_device):
    """Peak memory growth of the streaming SMNN matcher at 4096 x 4096
    stays below a quarter of the distance matrix's 64 MiB; its valid mask
    equals the dense matcher's on all but near-tie rows (0.1%)."""
    rng = np.random.default_rng(7)
    d1 = rng.standard_normal((4096, 128)).astype(np.float32)
    d2 = d1[rng.permutation(4096)] + 0.2 * rng.standard_normal(d1.shape)
    a = torch.tensor(d1, device=cuda_device)
    b = torch.tensor(d2.astype(np.float32), device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_device)
    base = torch.cuda.memory_allocated(cuda_device)
    out = t_match.DescriptorMatcher("smnn", 0.95, streaming=True)(a, b)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda_device) - base < 4096 ** 2
    ref = t_match.match_smnn(a, b, 0.95)
    assert (out[2] == ref[2]).float().mean() > 0.999


# distances of rows of norm at most 1 (at most 4) from the 3xTF32 product:
# about 1e-6 off the true f32 ones
MATCH_ATOL = 1e-5
# rows whose two nearest lie this close may swap them (f32 rounds the
# distances of either version by about 1e-7)
TIE_ATOL = 1e-5


def _check_min2(a, b):
    """streaming_min2 against its plain (true f32) version: distances to
    MATCH_ATOL, the argmin equal outside near ties. Returns the share of
    near-tie rows."""
    before = K.launches["streaming_min2"]
    m1, m2, idx = K.streaming_min2(a, b)
    assert K.launches["streaming_min2"] == before + 1
    r1, r2, ridx = K.streaming_min2_plain(a, b)
    torch.testing.assert_close(m1, r1, atol=MATCH_ATOL, rtol=0)
    torch.testing.assert_close(m2, r2, atol=MATCH_ATOL, rtol=0)
    tie = (r2 - r1) <= TIE_ATOL
    assert not ((idx != ridx) & ~tie).any()
    return tie.float().mean().item()


def test_cuda_streaming_min2_unit_rows(cuda_device):
    """4096 x 4096 x 128 unit rows, as SIFT descriptors are; near ties are
    rare there."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    a, b = (torch.nn.functional.normalize(torch.randn(
        (4096, 128), device=cuda_device, generator=gen), dim=-1)
        for _ in range(2))
    assert _check_min2(a, b) < 0.01


@pytest.mark.parametrize("d", [1, 7, 100])
@pytest.mark.parametrize("n,m", [(300, 257), (129, 1000), (5, 3)])
def test_cuda_streaming_min2_ragged(cuda_device, n, m, d):
    """D not a multiple of the 32-dimension chunk (nor of 4: 4-byte copies),
    N and M not multiples of the 128-row tiles; rows of norm below 1."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + m + d)
    a, b = (torch.rand((r, d), device=cuda_device, generator=gen) / d ** 0.5
            for r in (n, m))
    _check_min2(a, b)


# --- the SLAM back end: card against the CPU port ---------------------------------
# Card and CPU sum in other orders (index_add_ with atomics, cuBLAS and
# cuSOLVER against LAPACK). With two cameras fixed the BA has no gauge
# freedom and its path is held tightly; with camera 0 alone the scale is
# free and only the final cost and the residuals are held.

def _ba_arrays(seed=0, C=5, P=40, noise=0.3):
    """tests/test_slam.py::make_ba_problem's layout with numpy draws:
    cameras on a 0.6 rad arc, every camera sees every point."""
    from kornia_tpu_torch.geometry.liegroup import Se3
    from kornia_tpu_torch.slam.ba import _project
    rng = np.random.default_rng(seed)
    z = torch.zeros(C)
    gt = Se3.exp(torch.stack([z, z, z, z, torch.linspace(-0.3, 0.3, C), z],
                             -1))
    gt = Se3(gt.r, gt.t + torch.stack([torch.linspace(-1, 1, C), z, z], -1))
    X = (rng.standard_normal((P, 3)) * 1.5 + [0.0, 0.0, 6.0]).astype(
        np.float32)
    K_ = np.array([[200.0, 0, 128], [0, 200, 96], [0, 0, 1]], np.float32)
    cam = np.repeat(np.arange(C), P)
    pt = np.tile(np.arange(P), C)
    ci, pi = torch.from_numpy(cam), torch.from_numpy(pt)
    uv = _project(gt.r.q.data[ci], gt.t[ci], torch.from_numpy(X)[pi],
                  torch.from_numpy(K_)).numpy()
    uv = (uv + noise * rng.standard_normal(uv.shape)).astype(np.float32)
    r0 = Se3.exp(torch.from_numpy(
        0.03 * rng.standard_normal((C, 6))).float()).r * gt.r
    t0 = gt.t.numpy() + 0.1 * rng.standard_normal((C, 3))
    X0 = X + 0.2 * rng.standard_normal((P, 3))
    return C, P, dict(wxyz=r0.q.data.numpy(), t=t0.astype(np.float32),
                      points=X0.astype(np.float32), cam=cam, pt=pt, uv=uv,
                      valid=np.ones(C * P, bool), K=K_)


def _ba_on(a, device):
    return (convert.ba_state_from_numpy(a["wxyz"], a["t"], a["points"],
                                        device),
            convert.ba_problem_from_numpy(a["cam"], a["pt"], a["uv"],
                                          a["valid"], a["K"], device))


def _tables(a, P, device):
    from kornia_tpu_torch.slam.ba_sparse import build_point_tables
    oi, om = build_point_tables(a["cam"], a["pt"], a["valid"], P)
    return torch.from_numpy(oi).to(device), torch.from_numpy(om).to(device)


def _loop_arrays(N=10, seed=0):
    """tests/test_slam.py::TestPoseGraph's loop with numpy draws: a chain
    of N poses and one loop-closure edge, initial poses perturbed."""
    from kornia_tpu_torch.geometry.liegroup import Se3, So3
    rng = np.random.default_rng(seed)
    gt = Se3.exp(torch.from_numpy(0.3 * rng.standard_normal((N, 6))).float())
    src = np.concatenate([np.arange(N - 1), [0]])
    dst = np.concatenate([np.arange(1, N), [N - 1]])
    meas = Se3(So3.from_wxyz(gt.r.q.data[src]), gt.t[src]).inverse() * \
        Se3(So3.from_wxyz(gt.r.q.data[dst]), gt.t[dst])
    r0 = Se3.exp(torch.from_numpy(
        0.1 * rng.standard_normal((N, 6))).float()).r * gt.r
    t0 = gt.t + torch.from_numpy(0.2 * rng.standard_normal((N, 3))).float()
    return dict(src=src, dst=dst, mq=meas.r.q.data.numpy(),
                mt=meas.t.numpy(), wxyz=r0.q.data.numpy(), t=t0.numpy())


def _loop_on(a, device):
    E = a["src"].shape[0]
    return (convert.se3_from_numpy(a["wxyz"], a["t"], device),
            convert.pose_graph_from_numpy(a["src"], a["dst"], a["mq"],
                                          a["mt"], np.ones(E, np.float32),
                                          np.ones(E, bool), device))


def test_cuda_bundle_adjust_matches_cpu(cuda_device):
    from kornia_tpu_torch.slam import ba as t_ba
    C, P, a = _ba_arrays()
    outs = [t_ba.bundle_adjust(*_ba_on(a, d), C, P, num_iters=8,
                               fix_first_cam=2)
            for d in (cuda_device, "cpu")]
    (sg, cg), (sc, cc) = outs
    np.testing.assert_allclose(cg.cpu().numpy(), cc.numpy(), rtol=1e-3)
    torch.testing.assert_close(sg.points.cpu(), sc.points, atol=5e-4,
                               rtol=0)
    torch.testing.assert_close(sg.poses.t.cpu(), sc.poses.t, atol=5e-4,
                               rtol=0)
    torch.testing.assert_close(sg.poses.r.q.data.cpu(), sc.poses.r.q.data,
                               atol=5e-5, rtol=0)


@pytest.mark.parametrize("gnc", [0, 4])
def test_cuda_bundle_adjust_sparse_matches_cpu(cuda_device, gnc):
    from kornia_tpu_torch.slam import ba as t_ba
    from kornia_tpu_torch.slam import ba_sparse as t_bas
    C, P, a = _ba_arrays(noise=0.1 if gnc else 0.3)
    kw = dict(num_iters=12, robust="tukey" if gnc else "huber",
              robust_delta=2.0 if gnc else 3.0, gnc_stages=gnc)
    res = []
    for d in (cuda_device, "cpu"):
        state, prob = _ba_on(a, d)
        s, c = t_bas.bundle_adjust_sparse(state, prob, *_tables(a, P, d), C,
                                          P, **kw)
        res.append((c.cpu().numpy(),
                    t_ba.reprojection_residuals(s, prob).cpu()))
    (cg, rg), (cc, rc) = res
    np.testing.assert_allclose(cg[-1], cc[-1], rtol=1e-4)
    torch.testing.assert_close(rg, rc, atol=1e-3, rtol=0)


@pytest.mark.parametrize("group", ["se3", "sim3"])
def test_cuda_pose_graph_matches_cpu(cuda_device, group):
    from kornia_tpu_torch.slam import posegraph as t_pg
    a = _loop_arrays()
    res = []
    for d in (cuda_device, "cpu"):
        poses, graph = _loop_on(a, d)
        if group == "se3":
            p, c = t_pg.optimize_pose_graph(poses, graph, num_iters=8)
        else:
            p, _, c = t_pg.optimize_pose_graph_sim3(poses, graph)
        res.append((p, c.cpu().numpy()))
    (pg, cg), (pc, cc) = res
    np.testing.assert_allclose(cg, cc, rtol=1e-3, atol=1e-9 * cc[0])
    torch.testing.assert_close(pg.t.cpu(), pc.t, atol=1e-5, rtol=0)
    torch.testing.assert_close(pg.r.q.data.cpu(), pc.r.q.data, atol=1e-5,
                               rtol=0)


def test_cuda_pnp_ransac_matches_cpu(cuda_device):
    from kornia_tpu_torch.geometry.calibration import pnp_ransac
    rng = np.random.default_rng(3)
    n, n_out = 128, 25
    X = (rng.standard_normal((n, 3)) + [0.0, 0.0, 5.0]).astype(np.float32)
    a = np.array([0.05, -0.1, 0.03])
    Kx = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    th = np.linalg.norm(a)
    R = (np.eye(3) + np.sin(th) / th * Kx
         + (1 - np.cos(th)) / th ** 2 * Kx @ Kx).astype(np.float32)
    Xc = X @ R.T + np.float32([0.2, 0.1, -0.3])
    uv = Xc[:, :2] / Xc[:, 2:]
    uv[:n_out] += 0.5 * rng.standard_normal((n_out, 2))
    g = -np.log(-np.log(np.maximum(rng.random((256, n)), 1e-30)))
    out = [pnp_ransac(torch.from_numpy(X).to(d),
                      torch.from_numpy(uv.astype(np.float32)).to(d), None,
                      5e-3, batch_size=256, gumbel=torch.from_numpy(g).float())
           for d in (cuda_device, "cpu")]
    (Rg, tg, ig, _), (Rc, tc, ic, _) = out
    assert torch.equal(ig.cpu(), ic)
    assert int(ic.sum()) >= n - n_out - 5
    torch.testing.assert_close(Rg.cpu(), Rc, atol=1e-5, rtol=0)
    torch.testing.assert_close(tg.cpu(), tc, atol=1e-5, rtol=0)


def test_cuda_incremental_sfm_matches_cpu(cuda_device):
    from kornia_tpu_torch.geometry.scene import generate_scene
    from kornia_tpu_torch.slam.sfm import incremental_sfm
    # (the scene of seed 0 is one the algorithm fails on, in the JAX
    # package too: final RMS 1.76 px in both)
    s = generate_scene(num_views=4, num_points=48, rotation_scale=0.15,
                       translation_scale=0.4,
                       generator=torch.Generator().manual_seed(1),
                       device="cpu")
    obs = (s["points2d"] + 0.3 * torch.randn(
        s["points2d"].shape, generator=torch.Generator().manual_seed(101)))
    vis = np.ones((4, 48), bool)
    card, cpu = (incremental_sfm(obs.numpy(), vis, s["K"][0], ba_iters=10,
                                 device=d) for d in (cuda_device, "cpu"))
    assert np.array_equal(card.point_valid, cpu.point_valid)
    assert abs(card.final_rms - cpu.final_rms) <= 1e-3
    assert card.final_rms < 0.8


def _lm_loops(device):
    """The LM loops of the back end at test size, each a callable."""
    from kornia_tpu_torch.slam import ba as t_ba
    from kornia_tpu_torch.slam import ba_sparse as t_bas
    from kornia_tpu_torch.slam import posegraph as t_pg
    C, P, a = _ba_arrays()
    state, prob = _ba_on(a, device)
    oi, om = _tables(a, P, device)
    poses, graph = _loop_on(_loop_arrays(), device)
    return {
        "bundle_adjust": lambda: t_ba.bundle_adjust(state, prob, C, P,
                                                    num_iters=4),
        "bundle_adjust_sparse": lambda: t_bas.bundle_adjust_sparse(
            state, prob, oi, om, C, P, num_iters=4),
        "bundle_adjust_sparse_gnc": lambda: t_bas.bundle_adjust_sparse(
            state, prob, oi, om, C, P, num_iters=4, robust="tukey",
            gnc_stages=2),
        "optimize_pose_graph": lambda: t_pg.optimize_pose_graph(
            poses, graph, num_iters=4),
        "optimize_pose_graph_sim3": lambda: t_pg.optimize_pose_graph_sim3(
            poses, graph, num_iters=4),
    }


@pytest.mark.parametrize("loop", ["bundle_adjust", "bundle_adjust_sparse",
                                  "bundle_adjust_sparse_gnc",
                                  "optimize_pose_graph",
                                  "optimize_pose_graph_sim3"])
def test_cuda_lm_loops_make_no_host_sync(cuda_device, loop):
    """After a warm-up call, a whole LM call runs with every synchronising
    CUDA operation raising: state, λ and the accept/reject stay on the
    device."""
    fn = _lm_loops(cuda_device)[loop]
    fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out[-1]).all()


def test_cuda_non_spd_step_is_rejected(cuda_device):
    """An indefinite reduced system (λ = -1e3): cholesky_ex reports it on
    the device, the step is NaN and rejected, nothing raises, and LM goes
    on from λ = 1e-8."""
    from kornia_tpu_torch.slam import ba as t_ba
    S = torch.diag(torch.tensor([1.0, -1.0, 2.0], device=cuda_device))
    assert torch.isnan(t_ba._cholesky_solve(
        S, torch.ones(3, device=cuda_device))).all()
    C, P, a = _ba_arrays()
    state, prob = _ba_on(a, cuda_device)
    cost0 = t_ba._cost(state, prob, t_ba._robust_kernels(3.0)["huber"])
    _, c = t_ba.bundle_adjust(state, prob, C, P, num_iters=6,
                              fix_first_cam=2, init_lambda=-1e3)
    c = c.cpu()
    assert c[0].item() == pytest.approx(cost0.item(), rel=1e-6)
    assert c[-1].item() < 0.5 * c[0].item()


# --- the planar front end: GFTT blurs, the doubled octave, the tracker -----

# the tracker's octaves (GFTTSIFTFeature on ScalePyramid(3, 1.6, 32) at
# 480x640); the structure tensor blurs every level of an octave at once
GFTT_OCTAVES = [(480, 640), (240, 320), (120, 160), (60, 80)]


@pytest.mark.parametrize("shape", GFTT_OCTAVES)
def test_cuda_structure_tensor_blur_matches_plain(cuda_device, shape):
    """gaussian_blur2d(·, 7, 1.0, "reflect") over six levels, as
    feature/responses.py::_structure_tensor calls it: one tiled launch."""
    gen = torch.Generator(device=cuda_device).manual_seed(20)
    x = torch.rand((6, 1) + shape, device=cuda_device, generator=gen)
    out = _counted("fused_separable_blur2d", "tiled",
                   lambda: t_filters.gaussian_blur2d(x, 7, 1.0, "reflect"))
    k = _gauss(7, 1.0, cuda_device)
    ref = K.fused_separable_blur2d_plain(x, k, k, "reflect")
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


def test_cuda_doubled_octave_matches_plain(cuda_device):
    """SIFTFeatureScaleSpace's first octave at 960x1280: one tiled
    multi-level launch within 2e-6 of the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    x = torch.rand((1, 1, 960, 1280), device=cuda_device, generator=gen)
    pyr = t_pyr.ScalePyramid(3, 1.6, 32, double_image=True)
    kers, _ = pyr._level_kernels(1.6)
    out = _counted("multi_level_blur", "tiled",
                   lambda: K.multi_level_blur(x, kers, kers, "replicate"))
    ref = K.multi_level_blur_plain(x, kers, kers, "replicate")
    torch.testing.assert_close(out, ref, atol=2e-6, rtol=0)


def test_cuda_homography_tracker_matches_cpu(cuda_device):
    """HomographyTracker on one warped frame, card against the CPU port
    with the same injected RANSAC noise: corners within 0.5 px, and within
    1 px of the true homography."""
    from kornia_tpu_torch.ops.warp import warp_perspective
    from kornia_tpu_torch.tracking.planar_tracker import HomographyTracker
    gen = torch.Generator().manual_seed(22)
    target = t_filters.gaussian_blur2d(torch.rand((1, 1, 240, 320),
                                                  generator=gen), 3, 1.0)
    a = np.deg2rad(4.0)
    Ht = torch.tensor([[0.97 * np.cos(a), -0.97 * np.sin(a), 12.0],
                       [0.97 * np.sin(a), 0.97 * np.cos(a), -6.0],
                       [1e-5, 0.0, 1.0]], dtype=torch.float32)
    frame = warp_perspective(target, Ht[None], (240, 320))
    u = torch.rand((8, 512, 256), generator=gen).clamp_min(1e-38)
    gumbel = -torch.log(-torch.log(u))
    corners = torch.tensor([[0.0, 0, 1], [319, 0, 1], [319, 239, 1],
                            [0, 239, 1]], dtype=torch.float64)

    def mapped(Hm):
        q = corners @ Hm.reshape(3, 3).cpu().double().T
        return q[:, :2] / q[:, 2:]

    out = []
    for d in (cuda_device, "cpu"):
        tr = HomographyTracker(num_features=256, device=d)
        tr.set_target(target)
        Hm, ok = tr(frame, gumbel=gumbel.to(d))
        assert bool(ok)
        out.append(mapped(Hm))
    assert (out[0] - out[1]).norm(dim=-1).max() <= 0.5
    assert (out[0] - mapped(Ht)).norm(dim=-1).max() <= 1.0


def _room():
    """A room (tex_size 128) on the CPU and K at 120x160 (f = 0.8 W)."""
    from kornia_tpu_torch.utils.render import make_room_scene
    return make_room_scene(torch.Generator().manual_seed(7), tex_size=128,
                           device="cpu"), torch.tensor(
        [[128.0, 0.0, 80.0], [0.0, 128.0, 60.0], [0.0, 0.0, 1.0]])


def test_cuda_render_scene_matches_cpu(cuda_device):
    """render_scene at 120x160 on the card against the CPU port, the same
    room: image 1e-5 on at least 99.5% of the pixels (a plane's edge may
    go to the other plane), depth 1e-4 relative."""
    from dataclasses import replace

    from kornia_tpu_torch.utils.render import render_scene, walk_trajectory
    scene, Kt = _room()
    card = replace(scene, **{f: getattr(scene, f).to(cuda_device) for f in
                             ("origins", "edge_u", "edge_v", "textures")})
    for T in walk_trajectory(4):
        img_c, z_c = render_scene(card, Kt, T, 120, 160)
        img, z = render_scene(scene, Kt, T, 120, 160)
        assert img_c.is_cuda
        err = (img_c.cpu() - img).abs()
        assert float((err <= 1e-5).float().mean()) >= 0.995
        torch.testing.assert_close(z_c.cpu(), z, rtol=1e-4, atol=0)


def test_cuda_vo_pair_step_matches_cpu(cuda_device):
    """One VisualOdometry pair step (keyframe 0 → frame 1, then frame 1 →
    frame 2 against the first step's map) on the card against the CPU port,
    the same features and injected noise: the same matches and branch
    choices, rotations 1e-4, translations 1e-3, inlier counts within 2%."""
    from kornia_tpu_torch.slam.vo import VisualOdometry
    from kornia_tpu_torch.utils.render import render_sequence, walk_trajectory
    scene, Kt = _room()
    frames, _ = render_sequence(scene, Kt, walk_trajectory(12)[:3], 120, 160)
    gen = torch.Generator().manual_seed(3)

    def gumbel(shape):
        u = torch.rand(shape, generator=gen).clamp_min(1e-38)
        return -torch.log(-torch.log(u))

    draws = [(gumbel((8, 128, 128)), gumbel((8, 128, 128)),
              gumbel((64, 128))) for _ in range(2)]
    cpu = VisualOdometry(Kt, num_features=128, ransac_iters=8,
                         ransac_batch=128, device="cpu")
    feats = [cpu._detect_fn()(f) for f in frames]
    inl_th = float(np.float32(cpu.inl_th_px / cpu._focal))
    outs = {}
    for d in (cuda_device, "cpu"):
        vo = VisualOdometry(Kt, num_features=128, ransac_iters=8,
                            ransac_batch=128, device=d)
        pair = vo._pair_fn()
        state = (torch.zeros(128, device=d), torch.tensor(False, device=d),
                 torch.eye(3, device=d), torch.zeros(3, device=d))
        steps = []
        for i in (1, 2):
            f0 = [x.to(d) for x in feats[i - 1]]
            f1 = [x.to(d) for x in feats[i]]
            out = pair(*f0, *f1, vo.K, None, inl_th, *state,
                       tuple(g.to(d) for g in draws[i - 1]))
            steps.append([o.cpu() for o in out])
            state = (out[4], torch.tensor(True, device=d), out[0], out[1])
        outs[str(d)] = steps
    for c, x in zip(outs[str(cuda_device)], outs["cpu"]):
        R, t, inl, n, depth, idx, track, diag = c
        assert torch.equal(idx, x[5])
        assert torch.equal(diag[[2, 6, 7]], x[7][[2, 6, 7]])
        torch.testing.assert_close(R, x[0], atol=1e-4, rtol=0)
        torch.testing.assert_close(t, x[1], atol=1e-3, rtol=0)
        assert abs(int(n) - int(x[3])) <= 0.02 * max(int(n), int(x[3]))


# --- learned features and LoFTR (no kernels of their own) -----------------------

def _smooth(shape, seed, device):
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand(shape, generator=gen)
    return t_filters.gaussian_blur2d(x, 5, 1.2).to(device)


def _net_pair(name, device):
    """The same seeded net on the CPU and on `device`."""
    from kornia_tpu_torch.feature import affnet, hardnet
    cls = {"hardnet": hardnet.HardNet, "orinet": affnet.OriNet,
           "affnet": affnet.AffNet}[name]
    cpu = cls(device="cpu")
    return cpu, cls({k: v for k, v in cpu.params.items()}, device=device)


@pytest.mark.parametrize("name", ["hardnet", "orinet", "affnet"])
def test_cuda_learned_patch_nets_match_cpu(cuda_device, name):
    cpu, card = _net_pair(name, cuda_device)
    x = _smooth((256, 1, 32, 32), 7, "cpu")
    out = card(x.to(cuda_device)).cpu()
    ref = cpu(x)
    if name == "orinet":  # angles: compare on the circle
        d = torch.remainder(out - ref + np.pi, 2 * np.pi) - np.pi
        assert float(d.abs().max()) <= 1e-5
    else:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def test_cuda_affnet_shape_estimator_matches_cpu(cuda_device):
    """AffNet's shapes on 32² patches sampled by the patch kernel."""
    from kornia_tpu_torch.feature.affnet import LAFAffNetShapeEstimator
    from kornia_tpu_torch.feature.laf import laf_from_center_scale_ori
    gen = torch.Generator().manual_seed(8)
    img = _smooth((1, 1, 240, 320), 9, "cpu")
    xy = torch.rand((1, 200, 2), generator=gen) * torch.tensor([280.0,
                                                                200.0]) + 20
    lafs = laf_from_center_scale_ori(
        xy, 2 + 10 * torch.rand((1, 200, 1, 1), generator=gen),
        360 * torch.rand((1, 200, 1), generator=gen))
    cpu = LAFAffNetShapeEstimator(device="cpu")
    card = LAFAffNetShapeEstimator(cpu.net.params, device=cuda_device)
    before = K.launches["patch_sample"]
    out = card(lafs.to(cuda_device), img.to(cuda_device)).cpu()
    assert K.launches["patch_sample"] == before + 1
    ref = cpu(lafs, img)
    scale = ref[..., :2].abs().max()
    torch.testing.assert_close(out, ref, atol=1e-4 * float(scale), rtol=0)


def test_cuda_gftt_affnet_hardnet_runs_with_grad_enabled(cuda_device):
    """The preset on a card tensor with autograd on: the frozen weights
    give coordinates that do not require grad, so the patch kernel (which
    refuses inputs that do) runs for AffNet, the orienter and HardNet."""
    from kornia_tpu_torch.feature.integrated import GFTTAffNetHardNet
    assert torch.is_grad_enabled()
    img = _smooth((1, 1, 240, 320), 10, cuda_device)
    feat = GFTTAffNetHardNet(256, device=cuda_device)
    before = K.launches["patch_sample"]
    lafs, resps, descs, valid = feat(img)
    assert K.launches["patch_sample"] == before + 3
    assert descs.shape == (1, 256, 128) and int(valid.sum()) > 100
    assert not descs.requires_grad
    assert torch.isfinite(lafs).all() and torch.isfinite(descs).all()


def test_cuda_loftr_matches_cpu(cuda_device):
    """The small LoFTR on a 64x96 pair: backbone maps, tokens and the
    confidence matrix within 1e-4 of their largest entry, the same coarse
    matches, fine keypoints within 1e-3 px (the fine stage fed the CPU's
    matches)."""
    from kornia_tpu_torch.feature import loftr
    cfg = loftr.LoFTRConfig(coarse_dim=64, fine_dim=32, num_coarse_layers=1,
                            num_heads=4, top_k=32, border_rm=0)
    cpu = loftr.LoFTR(cfg, device="cpu")
    card = loftr.LoFTR(cfg, cpu.params, device=cuda_device)
    x = _smooth((1, 1, 64, 104), 11, "cpu")
    a, b = x[..., 8:].contiguous(), x[..., :-8].contiguous()
    st_c = cpu.coarse_stage(a, b)
    st_g = card.coarse_stage(a.to(cuda_device), b.to(cuda_device))
    for k in ("c0", "f0", "c1", "f1", "t0", "t1", "conf"):
        ref = st_c[k]
        torch.testing.assert_close(st_g[k].cpu(), ref, rtol=0,
                                   atol=1e-4 * float(ref.abs().max()))
    i, j, s, v = loftr._coarse_match(cfg, st_c["conf"], st_c["hw0"],
                                     st_c["hw1"], 32)
    kp_c = cpu.fine_stage(st_c, i, j)
    kp_g = card.fine_stage(st_g, i.to(cuda_device), j.to(cuda_device))
    for g, c in zip(kp_g, kp_c):
        torch.testing.assert_close(g.cpu()[v], c[v], atol=1e-3, rtol=0)
    pairs = lambda i, j, v: {(int(p), int(q)) for p, q, ok in  # noqa: E731
                             zip(i[0].tolist(), j[0].tolist(), v[0].tolist())
                             if ok}
    i_g, j_g, _, v_g = loftr._coarse_match(cfg, st_g["conf"], st_g["hw0"],
                                           st_g["hw1"], 32)
    assert pairs(i_g, j_g, v_g) == pairs(i, j, v) and int(v.sum()) > 0
    out = card({"image0": a.to(cuda_device), "image1": b.to(cuda_device)})
    assert int(out["valid"].sum()) == int(v.sum())


# --- the KeyNet presets, stereo depth and the stitcher (step 11's shapes) ------

@pytest.mark.parametrize("factor", [1.2, float(np.sqrt(2.0))])
def test_cuda_keynet_pyrdown_matches_plain(cuda_device, factor, monkeypatch):
    """pyrdown by Key.Net's 1.2 and the detector's sqrt 2 at the 678x905
    upscaled level: one blur launch, the result within 1e-5 of the same
    pyrdown through the plain blur."""
    x = _smooth((1, 1, 678, 905), 12, cuda_device)
    before = K.launches["fused_separable_blur2d"]
    out = t_pyr.pyrdown(x, factor=factor)
    assert K.launches["fused_separable_blur2d"] == before + 1
    assert out.shape[-2:] == (int(678 / factor), int(905 / factor))
    monkeypatch.setattr(K, "fused_separable_blur2d",
                        K.fused_separable_blur2d_plain)
    ref = t_pyr.pyrdown(x, factor=factor)
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


def test_cuda_stereo_box_blur_matches_plain(cuda_device):
    """The stereo cost aggregation: a k = 9 reflect box blur of 64 cost maps
    at 480x640 in one launch, within 1e-5 of the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    x = torch.rand((1, 64, 480, 640), device=cuda_device, generator=gen)
    before = K.launches["fused_separable_blur2d"]
    out = t_filters.box_blur(x, 9)
    assert K.launches["fused_separable_blur2d"] == before + 1
    k = t_filters.get_box_kernel1d(9, device=cuda_device)
    ref = K.fused_separable_blur2d_plain(x, k, k, "reflect")
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=0)


def test_cuda_keynet_matches_cpu(cuda_device):
    """Key.Net's response on the card within 1e-4 of the CPU's largest
    entry, and the detector's keypoints equal at 96x128."""
    from kornia_tpu_torch.feature.multires_detector import KeyNetDetector
    cpu = KeyNetDetector(num_features=64, device="cpu")
    card = KeyNetDetector(num_features=64, device=cuda_device)
    x = _smooth((1, 1, 96, 128), 14, "cpu")
    ref = cpu.model(x)
    torch.testing.assert_close(card.model(x.to(cuda_device)).cpu(), ref,
                               rtol=0, atol=1e-4 * float(ref.abs().max()))
    (sc, lc, vc), (sg, lg, vg) = cpu.detect(x), card.detect(
        x.to(cuda_device))
    assert torch.equal(vg.cpu(), vc) and int(vc.sum()) > 32
    assert torch.equal(lg.cpu()[vc][..., 2], lc[vc][..., 2])


def test_cuda_stereo_matching_matches_cpu(cuda_device):
    """stereo_matching (soft, LR check) at 48x64, D = 16: disparities within
    1e-4 px and the same LR-valid mask on the card and on the CPU."""
    from kornia_tpu_torch.contrib.stereo import stereo_matching
    x = _smooth((1, 1, 48, 80), 15, "cpu")
    left, right = x[..., 8:72].contiguous(), x[..., 5:69].contiguous()
    dc, vc = stereo_matching(left, right, 16)
    dg, vg = stereo_matching(left.to(cuda_device), right.to(cuda_device), 16)
    torch.testing.assert_close(dg.cpu(), dc, atol=1e-4, rtol=0)
    assert torch.equal(vg.cpu(), vc)


def test_cuda_camera_from_numbers_defaults_to_the_card(cuda_device):
    """A PinholeCamera and a tilt projection built from plain numbers lie on
    the card by default, and agree with the CPU's."""
    from kornia_tpu_torch.geometry.calibration import tilt_projection
    from kornia_tpu_torch.geometry.camera import PinholeCamera
    args = (500.0, 510.0, 320.0, 240.0, 480, 640, 0.1, None, 0.5)
    card = PinholeCamera.from_parameters(*args)
    cpu = PinholeCamera.from_parameters(*args, device="cpu")
    for f in ("intrinsics", "extrinsics", "height", "width"):
        assert getattr(card, f).device.type == "cuda"
        torch.testing.assert_close(getattr(card, f).cpu(), getattr(cpu, f),
                                   atol=0, rtol=0)
    tilt = tilt_projection(0.04, -0.02)
    assert tilt.device.type == "cuda"
    torch.testing.assert_close(tilt.cpu(),
                               tilt_projection(0.04, -0.02, device="cpu"),
                               atol=1e-6, rtol=0)


# --- the communication runtime: SPMD ranks on the card ---------------------------
# One NCCL rank, and two gloo ranks sharing cuda:0 (NCCL refuses two ranks on
# one card), against the single-device calls on the card.

CP_CFG = dict(num_coarse_layers=2)


def _dist_inputs(world):
    from tests import torch_dist_workers as W
    return (W.dense_ba_arrays(world, 8, 4, seed=0),
            *W.loftr_coarse_arrays(CP_CFG, 128))


@pytest.mark.parametrize("backend,world", [("nccl", 1), ("gloo", 2)])
def test_cuda_spmd_world_matches_single_device(cuda_device, backend, world):
    from kornia_tpu_torch.feature import loftr as t_loftr
    from kornia_tpu_torch.parallel import spmd
    from kornia_tpu_torch.parallel.mesh import make_mesh
    from kornia_tpu_torch.slam import ba as t_ba
    from tests import torch_dist_workers as W
    dense, params, f0, f1 = _dist_inputs(world)
    got = spmd.spawn(W.card_worker, world, backend, "cuda", dense, params,
                     CP_CFG, f0, f1)
    assert got["device"] == "cuda:0" and got["jax_imported"] is False
    assert got["ranks_agree"] and got["ba_ranks_agree"]
    assert got["all_reduces"] == 4 * CP_CFG["num_coarse_layers"]
    # LoFTR's coarse stage: within 1e-4 of the largest entry
    p = {k: torch.from_numpy(v).to(cuda_device) for k, v in params.items()}
    with torch.no_grad():
        ref = t_loftr.loftr_coarse_context_parallel(
            p, t_loftr.LoFTRConfig(**CP_CFG),
            torch.from_numpy(f0).to(cuda_device),
            torch.from_numpy(f1).to(cuda_device),
            make_mesh(devices=[cuda_device]))
    single = t_loftr._transformer(
        p, "loftr_coarse", CP_CFG["num_coarse_layers"], 8,
        torch.from_numpy(f0).to(cuda_device),
        torch.from_numpy(f1).to(cuda_device))
    for v in (0, 1):
        want = single[v].cpu().numpy()
        np.testing.assert_allclose(got[f"out{v}"], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
        np.testing.assert_allclose(ref[v].cpu().numpy(), want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())
    # dense BA: RMS within 0.05 px of the single-device run's
    C, P = dense["C"], dense["points"].shape[0]
    prob = convert.ba_problem_from_numpy(dense["cam_idx"], dense["pt_global"],
                                         dense["uv"], dense["valid"],
                                         dense["K"], cuda_device)
    s0 = convert.ba_state_from_numpy(dense["wxyz"], dense["t"],
                                     dense["points"], cuda_device)
    ss, _ = t_ba.bundle_adjust(s0, prob, C, P, num_iters=8)
    sd = convert.ba_state_from_numpy(got["ba"]["wxyz"], got["ba"]["t"],
                                     got["ba"]["points"], cuda_device)

    def rms(s):
        r = t_ba.reprojection_residuals(s, prob)
        return float(r.pow(2).sum(-1).mean().sqrt())

    assert abs(rms(sd) - rms(ss)) < 0.05 and rms(sd) < 0.5


def test_cuda_nccl_refuses_more_ranks_than_cards(cuda_device):
    from kornia_tpu_torch.parallel import spmd
    from tests import torch_dist_workers as W
    with pytest.raises(RuntimeError, match="NCCL refuses two ranks"):
        spmd.spawn(W.failing_worker, torch.cuda.device_count() + 1, "nccl",
                   "cuda", 0)


# --- tracking, boxes, image containers and IO (no kernel of their own) ------

def _track_stream(frames=12, n=24, targets=8):
    """Seeded detections (frames, n, 6): targets at constant velocity with
    1 px of jitter, some scored low, two false positives a frame."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(50, 400, (targets, 2))
    vel = rng.uniform(-3, 3, (targets, 2))
    hs = rng.uniform(40, 120, targets)
    out = np.zeros((frames, n, 6), np.float32)
    for f in range(frames):
        rows = [(0, rng.uniform(0.15, 0.5) if rng.random() < 0.15
                 else rng.uniform(0.6, 1.0), *(pos[k] + f * vel[k]
                                              + rng.normal(0, 1, 2)),
                 0.41 * hs[k], hs[k])
                for k in range(targets) if rng.random() > 0.1]
        rows += [(0, rng.uniform(0.1, 0.45), *rng.uniform(0, 480, 2),
                  *rng.uniform(10, 60, 2)) for _ in range(2)]
        rng.shuffle(rows)
        out[f, :len(rows)] = np.asarray(rows, np.float32)
    return out


def test_cuda_bytetrack_defaults_to_the_card_and_matches_the_cpu(cuda_device):
    """ByteTracker() and TrackState.empty() land on the card; a frame's
    update makes no host sync; ids and validity equal the CPU port's,
    boxes within 1e-3 of the largest coordinate."""
    from kornia_tpu_torch.tracking.bytetrack import ByteTracker, TrackState
    assert TrackState.empty(4).mean.device.type == "cuda"
    tc, tp = ByteTracker(capacity=32), ByteTracker(capacity=32, device="cpu")
    sc, sp = tc.init_state(), tp.init_state()
    assert all(getattr(sc, f).is_cuda for f in ("mean", "track_id",
                                                "next_id"))
    dets = _track_stream()
    sc = tc.update(sc, torch.from_numpy(dets[0]).to(cuda_device))
    sp = tp.update(sp, torch.from_numpy(dets[0]))
    for d in dets[1:]:
        dc = torch.from_numpy(d).to(cuda_device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            sc = tc.update(sc, dc)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        sp = tp.update(sp, torch.from_numpy(d))
        for f in ("track_id", "alive", "misses", "next_id"):
            assert torch.equal(getattr(sc, f).cpu(), getattr(sp, f)), f
        bc, bp = tc.current_tracks(sc)[0].cpu(), tp.current_tracks(sp)[0]
        v = sp.alive
        assert (bc[v] - bp[v]).abs().max() <= 1e-3 * bp[v].abs().max()


def test_cuda_load_image_and_containers_default_to_the_card(cuda_device,
                                                            tmp_path):
    from kornia_tpu_torch.image import Image
    from kornia_tpu_torch.io import ImageLoadType, load_image, write_image
    from kornia_tpu_torch.utils.misc import image_to_tensor
    arr = (np.random.default_rng(1).random((12, 10, 3)) * 255).astype(
        np.uint8)
    p = str(tmp_path / "a.png")
    write_image(p, torch.from_numpy(arr).permute(2, 0, 1).cuda())
    for typ in ImageLoadType:
        got = load_image(p, typ)
        assert got.is_cuda
        assert torch.equal(got.cpu(), load_image(p, typ, device="cpu"))
    assert Image.from_numpy(arr).data.is_cuda
    assert image_to_tensor(arr).is_cuda


def test_cuda_draws_and_masks_equal_the_cpu(cuda_device):
    from kornia_tpu_torch.geometry.bbox import nms
    from kornia_tpu_torch.geometry.boxes import Boxes
    from kornia_tpu_torch.image import draw
    rng = np.random.default_rng(2)
    img = torch.from_numpy(rng.random((2, 3, 40, 56)).astype(np.float32))
    xy = rng.uniform(0, 40, (2, 5, 2))
    rect = torch.from_numpy(np.concatenate(
        [xy, xy + rng.uniform(2, 20, (2, 5, 2))], -1).astype(np.float32))
    col = torch.tensor([1.0, 0.5, 0.0])
    poly = torch.tensor([[[4.0, 3.0], [25.0, 5.0], [20.0, 20.0],
                          [6.0, 15.0]]] * 2)
    pts = torch.from_numpy(rng.uniform(-3, 60, (9, 2)).astype(np.float32))
    calls = [
        lambda d: draw.draw_rectangle(img.to(d), rect.to(d), col.to(d)),
        lambda d: draw.draw_rectangle(img.to(d), rect.to(d), col.to(d),
                                      fill=True),
        lambda d: draw.draw_point2d(img[0].to(d), pts.to(d), col.to(d)),
        lambda d: draw.draw_line(img[1].to(d), torch.tensor([2.0, 3.0]),
                                 torch.tensor([50.0, 31.5]), col.to(d)),
        lambda d: draw.draw_convex_polygon(img.to(d), poly.to(d), col.to(d)),
        lambda d: Boxes.from_tensor(rect.to(d)).to_mask(40, 56),
        lambda d: nms(rect[0].to(d), torch.tensor(
            [0.9, 0.5, 0.5, 0.7, 0.2]).to(d), 0.3)]
    for fn in calls:
        got = fn(cuda_device)
        assert got.is_cuda and torch.equal(got.cpu(), fn("cpu"))


# --- the image-op layer -----------------------------------------------------------

def _image_ops(device):
    """A handful of the op layer's functions, each of one image batch."""
    from kornia_tpu_torch.ops import color, enhance, morphology, warp
    from kornia_tpu_torch.ops.deform_conv import deform_conv2d
    from kornia_tpu_torch.ops.jpeg import jpeg_codec_differentiable
    se = torch.linspace(0.0, 0.1, 9, device=device).reshape(3, 3)
    off = torch.linspace(-2.0, 2.0, 18 * 24 * 32, device=device).reshape(
        1, 18, 24, 32)
    w = torch.linspace(-0.2, 0.2, 8 * 3 * 9, device=device).reshape(8, 3, 3, 3)
    return {
        "rgb_to_lab": (color.rgb_to_lab, 1e-4),
        # the integer LUTs: bit for bit, as on the CPU
        "equalize": (enhance.equalize, 0.0),
        "equalize_clahe": (lambda x: enhance.equalize_clahe(x, 4.0, (4, 4)),
                           0.0),
        "posterize": (lambda x: enhance.posterize(x, 4), 0.0),
        "median_blur": (lambda x: t_filters.median_blur(x, 3), 0.0),
        "bilateral_blur": (lambda x: t_filters.bilateral_blur(
            x, 5, 0.1, (1.5, 1.5)), ATOL),
        "canny_edges": (lambda x: t_filters.canny(x)[1], 0.0),
        "dilation_nonflat": (lambda x: morphology.dilation(
            x, torch.ones_like(se), se), 0.0),
        "resize_antialias": (lambda x: warp.resize(x, (13, 21),
                                                   antialias=True), ATOL),
        "resize_nearest": (lambda x: warp.resize(x, (37, 50), "nearest"),
                           0.0),
        "grid_sample_bicubic_reflection": (lambda x: warp.grid_sample(
            x, torch.linspace(-1.2, 1.2, 24 * 32 * 2, device=x.device
                              ).reshape(1, 24, 32, 2).expand(
                x.shape[0], 24, 32, 2), "bicubic", "reflection"), ATOL),
        "jpeg": (lambda x: jpeg_codec_differentiable(
            x, torch.tensor(80.0, device=x.device)), 1e-4),
        "deform_conv2d": (lambda x: deform_conv2d(
            x[:1], off.to(x.device), w.to(x.device), padding=1), 1e-4),
    }


@pytest.mark.parametrize("name", list(_image_ops("cpu")))
def test_cuda_image_ops_match_cpu(cuda_device, name):
    gen = torch.Generator().manual_seed(3)
    x = torch.rand((2, 3, 24, 32), generator=gen)
    fn, tol = _image_ops(cuda_device)[name]
    card = fn(x.to(cuda_device)).cpu()
    fn_cpu, _ = _image_ops("cpu")[name]
    torch.testing.assert_close(card, fn_cpu(x), atol=tol, rtol=0)


def test_cuda_elastic_blur_is_the_tiled_fused_kernel(cuda_device):
    """elastic_transform2d's 63-tap smoothing of (1, 2, 1080, 1920) noise is
    one tiled launch of the fused blur and agrees with its plain version."""
    from kornia_tpu_torch.ops import warp
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    noise = torch.rand((1, 2, 1080, 1920), device=cuda_device, generator=gen)
    frame = torch.rand((1, 3, 1080, 1920), device=cuda_device, generator=gen)
    calls = []
    real = K.fused_separable_blur2d

    def spy(*args):
        calls.append(args)
        return real(*args)

    K.fused_separable_blur2d = spy
    before = K.launches["fused_separable_blur2d:tiled"]
    try:
        warp.elastic_transform2d(frame, noise)
    finally:
        K.fused_separable_blur2d = real
    assert K.launches["fused_separable_blur2d:tiled"] == before + 1
    (x, ky, kx, border), = calls
    assert ky.numel() == kx.numel() == 63 and border == "constant"
    torch.testing.assert_close(real(x, ky, kx, border),
                               K.fused_separable_blur2d_plain(x, ky, kx,
                                                              border),
                               atol=ATOL, rtol=0)


# --- registration, MS-SSIM, metrics and contrib ops (the slice of step 15) ---

def test_cuda_ms_ssim_grad_matches_cpu(cuda_device):
    """MS-SSIM's gradient (five scales of the fused blur and its band
    adjoint, the last at 4x4 where the 11 taps reflect twice): card and
    CPU within 1e-4 of the largest."""
    rng = np.random.default_rng(23)
    target = rng.random((2, 3, 64, 64), dtype=np.float32)
    pred = np.clip(target + 0.2 * rng.standard_normal(target.shape), 0,
                   1).astype(np.float32)
    grads = []
    for dev in ("cpu", cuda_device):
        tp = torch.tensor(pred, device=dev, requires_grad=True)
        t_losses.ms_ssim_loss(tp, torch.tensor(target, device=dev)).backward()
        grads.append(tp.grad.cpu())
    scale = grads[0].abs().max()
    torch.testing.assert_close(grads[1], grads[0], atol=1e-4 * scale, rtol=0)


def test_cuda_distance_transform_matches_cpu(cuda_device):
    from kornia_tpu_torch.contrib.ops import distance_transform
    img = torch.zeros((1, 2, 40, 56))
    img[0, 0, 5, 7] = img[0, 0, 30, 40] = img[0, 1, 0, 55] = 1.0
    cpu = distance_transform(img)
    card = distance_transform(img.to(cuda_device)).cpu()
    torch.testing.assert_close(card, cpu, atol=0, rtol=1e-5)


def test_cuda_mean_iou_matches_cpu_bit_for_bit(cuda_device):
    from kornia_tpu_torch.metrics.metrics import confusion_matrix, mean_iou
    gen = torch.Generator().manual_seed(3)
    pred = torch.randint(0, 19, (2, 128, 256), generator=gen)
    true = torch.where(torch.rand(pred.shape, generator=gen) < 0.7, pred,
                       torch.randint(0, 19, pred.shape, generator=gen))
    for fn in (confusion_matrix, mean_iou):
        cpu = fn(pred, true, 19)
        card = fn(pred.to(cuda_device), true.to(cuda_device), 19).cpu()
        assert torch.equal(card, cpu), fn.__name__


def test_cuda_registration_graph_replays_the_eager_steps(cuda_device):
    """A level's Adam steps replayed as one CUDA graph equal the same steps
    launched one by one, bit for bit, and the CPU port's within 1e-4."""
    from kornia_tpu_torch.geometry.registration import ImageRegistrator
    gen = torch.Generator().manual_seed(5)
    src = torch.nn.functional.avg_pool2d(
        torch.rand((1, 3, 64, 80), generator=gen), 5, 1, 2)
    dst = torch.roll(src, (1, 2), (-2, -1))
    reg = ImageRegistrator("homography", 12, 1e-2, 1)
    p0 = reg.model.init_params("cpu")
    outs = [reg.run_level(p0.to(cuda_device), src.to(cuda_device),
                          dst.to(cuda_device), cuda_graph=g) for g in
            (True, False)]
    (p_g, s_g), (p_e, s_e) = outs
    for a, b in zip((p_g, *s_g), (p_e, *s_e)):
        assert torch.equal(a, b)
    cpu, _ = reg.run_level(p0, src, dst)
    torch.testing.assert_close(outs[0][0].cpu(), cpu, atol=1e-4, rtol=0)


# --- the augmentation layer (the slice of step 16) ----------------------------

def _spy_blurs(fn):
    """fn() with every call of the fused blur and its band adjoint
    recorded: {name: [args, ...]} and the route counters' moves."""
    calls = {"fused_separable_blur2d": [],
             "fused_separable_blur2d_adjoint": []}
    saved = {n: getattr(K, n) for n in calls}

    def spy(name):
        def call(*args):
            calls[name].append(tuple(a.clone() if torch.is_tensor(a) else a
                                     for a in args))
            return saved[name](*args)
        return call

    before = dict(K.launches)
    try:
        for n in calls:
            setattr(K, n, spy(n))
        fn()
        torch.cuda.synchronize()
    finally:
        for n, f in saved.items():
            setattr(K, n, f)
    moved = {k: v - before.get(k, 0) for k, v in K.launches.items()
             if v != before.get(k, 0)}
    return calls, moved


def _held_to_plain(name, args):
    kern = getattr(K, name)
    plain = getattr(K, name + "_plain")
    torch.testing.assert_close(kern(*args), plain(*args), atol=ATOL, rtol=0)


def test_cuda_box_blur_augmentation_is_the_fused_kernel(cuda_device):
    """RandomBoxBlur((5, 5)) at step 16 (b)'s 512x512: one tiled launch of
    the fused blur over every plane, equal to its plain version."""
    import kornia_tpu_torch.augmentation as TA
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.rand((4, 3, 512, 512), device=cuda_device, generator=gen)
    aug = TA.RandomBoxBlur((5, 5), p=1.0)
    calls, moved = _spy_blurs(lambda: aug(x, gen))
    (args,) = calls["fused_separable_blur2d"]
    assert moved.get("fused_separable_blur2d:tiled") == 1
    assert args[1].numel() == args[2].numel() == 5 and args[3] == "reflect"
    _held_to_plain("fused_separable_blur2d", args)


def test_cuda_elastic_augmentation_blur_is_the_fused_kernel(cuda_device):
    """RandomElasticTransform's 63-tap smoothing of (B, 2, 512, 512)
    noise: one tiled launch (constant border), equal to its plain
    version, and the warp equal to the CPU port's on the same params."""
    import kornia_tpu_torch.augmentation as TA
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.rand((2, 3, 512, 512), device=cuda_device, generator=gen)
    aug = TA.RandomElasticTransform(p=1.0)
    params = aug.generate_parameters(gen, x.shape)
    calls, moved = _spy_blurs(lambda: aug(x, params=params))
    (args,) = calls["fused_separable_blur2d"]
    assert moved.get("fused_separable_blur2d:tiled") == 1
    assert args[0].shape == (2, 2, 512, 512) and args[3] == "constant"
    assert args[1].numel() == 63
    _held_to_plain("fused_separable_blur2d", args)


def test_cuda_augmentation_backward_launches_the_band_adjoint(cuda_device):
    """Step 16 (f)'s differentiable pipeline: the backward of the box blur
    and of JPEG's chroma blur are tiled band adjoints, each equal to its
    plain version, and each op's image gradient is the CPU port's on the
    same input (1e-4 of the largest; through the whole chain a warp's ulps
    can move a later clamp or JPEG rounding, which the per-op comparison
    leaves out)."""
    import kornia_tpu_torch.augmentation as TA
    gen = torch.Generator().manual_seed(8)
    # 8 images: JPEG's one-plane chroma adjoints fill the card (2 blocks
    # an SM), so every adjoint takes the tiled route
    x = torch.rand((8, 3, 256, 256), generator=gen)
    pipe = TA.ImageSequential(TA.RandomBoxBlur((5, 5)), TA.ColorJiggle(p=1.0),
                              TA.RandomAffine(10.0, p=1.0),
                              TA.RandomJPEG((50.0, 90.0), p=1.0))
    params = pipe.generate_parameters(gen, x.shape)
    grads = []

    def step(d):
        xr = x.to(d).clone().requires_grad_()
        p = [{k: v.to(d) for k, v in q.items()} for q in params]
        pipe(xr, params=p).square().sum().backward()
        grads.append(xr.grad)

    calls, moved = _spy_blurs(lambda: step(cuda_device))
    adj = calls["fused_separable_blur2d_adjoint"]
    assert len(adj) == 3  # the box blur's, and JPEG's for Cb and Cr
    assert moved.get("fused_separable_blur2d_adjoint:tiled") == 3
    for args in adj:
        _held_to_plain("fused_separable_blur2d_adjoint", args)
    w = torch.rand(x.shape, generator=gen)
    x_in = x
    for op, q in zip(pipe.augs, params):
        g = []
        for d in (cuda_device, "cpu"):
            xr = x_in.to(d).clone().requires_grad_()
            out = op(xr, params={k: v.to(d) for k, v in q.items()})
            (out * w.to(d)).sum().backward()
            g.append(xr.grad.cpu())
        assert (g[0] - g[1]).abs().max() <= 1e-4 * g[1].abs().max(), op
        x_in = op(x_in, params=q)


def test_cuda_augmentation_forward_makes_no_host_sync(cuda_device):
    """Step 16 (a) and (b): after one warm-up call, a forward of the
    SimCLR view and of the detection pipeline, sampling included, makes
    no synchronising CUDA call."""
    import kornia_tpu_torch.augmentation as TA
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.rand((4, 3, 128, 128), device=cuda_device, generator=gen)
    view = TA.ImageSequential(
        TA.RandomResizedCrop((112, 112)), TA.RandomHorizontalFlip(),
        TA.ColorJiggle(0.8, 0.8, 0.8, 0.2, p=0.8), TA.RandomGrayscale(p=0.2),
        TA.RandomGaussianBlur((23, 23), (0.1, 2.0), p=0.5),
        TA.RandomSolarize(p=0.2),
        TA.Normalize([0.485, 0.456, 0.406], [0.229, 0.224, 0.225]))
    det = TA.AugmentationSequential(
        TA.RandomHorizontalFlip(), TA.RandomAffine(15.0, (0.1, 0.1),
                                                   (0.8, 1.2), 5.0),
        TA.RandomPerspective(0.3), TA.RandomElasticTransform(p=0.5),
        TA.RandomBoxBlur((5, 5)), TA.RandomJPEG((50.0, 90.0)),
        data_keys=["input", "mask", "bbox_xyxy", "keypoints"])
    mask = (x[:, :1] > 0.5).float()
    boxes = torch.rand((4, 3, 4), device=cuda_device, generator=gen) * 100
    kp = torch.rand((4, 5, 2), device=cuda_device, generator=gen) * 127

    def run():
        view(x, gen)
        det(x, mask, boxes, kp, generator=gen)

    run()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


# --- borders wider than the image, and degenerate inputs --------------------

def _pad_cases():
    from kornia_tpu_torch import augmentation as TA
    from kornia_tpu_torch.ops import enhance as t_enh
    g = torch.Generator().manual_seed(20)
    small = torch.rand((1, 2, 3, 4), generator=g)
    return {
        "filter2d_reflect_7x7": (lambda x, k: t_filters.filter2d(
            x, k, "reflect"), (small, torch.rand((1, 7, 7), generator=g))),
        "filter2d_circular_11x11": (lambda x, k: t_filters.filter2d(
            x, k, "circular"), (small, torch.rand((1, 11, 11), generator=g))),
        "laplacian_7": (lambda x: t_filters.laplacian(x, 7), (small,)),
        "bilateral_blur_7x7": (lambda x: t_filters.bilateral_blur(
            x, (7, 7), 0.1, (1.5, 1.5)), (small,)),
        "filter3d_reflect": (lambda v, k: t_filters.filter3d(v, k, "reflect"),
                             (torch.rand((1, 1, 2, 3, 4), generator=g),
                              torch.rand((1, 5, 5, 5), generator=g))),
        **{f"clahe_{h}x{w}": (t_enh.equalize_clahe,
                              (torch.rand((1, 2, h, w), generator=g),))
           for h, w in ((8, 8), (8, 9), (1, 5))},
        "random_clahe_1x5": (lambda x: TA.RandomCLAHE(p=1.0).apply(x, {}),
                             (torch.rand((1, 2, 1, 5), generator=g),)),
        **{f"pad_to_{m}": (lambda x, m=m: TA.PadTo((10, 12), pad_mode=m)(x),
                           (small,)) for m in ("reflect", "circular")},
        "max_blur_pool2d_one_row": (t_filters.max_blur_pool2d,
                                    (torch.rand((1, 2, 1, 5), generator=g),)),
        "zca_whiten_one_sample": (t_enh.zca_whiten,
                                  (torch.rand((1, 3), generator=g),)),
    }


@pytest.mark.parametrize("name", sorted(_pad_cases()))
def test_cuda_wide_borders_and_degenerate_inputs_match_cpu(cuda_device,
                                                           name):
    fn, args = _pad_cases()[name]
    cpu = fn(*args)
    card = fn(*[a.to(cuda_device) for a in args])
    assert card.device.type == "cuda" and card.shape == cpu.shape
    torch.testing.assert_close(card.cpu(), cpu, atol=ATOL, rtol=1e-6,
                               equal_nan=True)


# --- patch descriptors and matchers -----------------------------------------

def _desc_nets(device):
    from kornia_tpu_torch.feature import descriptors as D
    from kornia_tpu_torch.feature.extras import HardNet8
    from kornia_tpu_torch.feature.mkd import MKDDescriptor, SimpleKD
    from kornia_tpu_torch.feature.siftdesc import SIFTDescriptor
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.normal(size=(175, 175)))
    model = {"pca": {"mean": np.zeros(175, np.float32),
                     "eigvecs": q.astype(np.float32),
                     "eigvals": np.linspace(2.0, 0.1, 175).astype(
                         np.float32)}}
    return {"HardNet8": HardNet8(device=device),
            "TFeat": D.TFeat(device=device), "SOSNet": D.SOSNet(device=device),
            "HyNet": D.HyNet(device=device),
            "MKDGradientDescriptor": D.MKDGradientDescriptor(),
            "MKD": MKDDescriptor(), "SimpleKD_pcawt": SimpleKD(
                whitening_model=model),
            "SIFT32": SIFTDescriptor(32)}


@pytest.mark.parametrize("name", ["HardNet8", "TFeat", "SOSNet", "HyNet",
                                  "MKDGradientDescriptor", "MKD",
                                  "SimpleKD_pcawt", "SIFT32"])
def test_cuda_patch_descriptor_matches_cpu(cuda_device, name):
    g = torch.Generator().manual_seed(21)
    x = torch.rand((64, 1, 32, 32), generator=g)
    cpu = _desc_nets("cpu")[name](x)
    card = _desc_nets(cuda_device)[name](x.to(cuda_device))
    torch.testing.assert_close(card.cpu(), cpu, atol=1e-4, rtol=0)


def _lafs(n, h, w, g):
    ang = torch.rand(n, generator=g) * 6.28
    s = 3.0 + 8.0 * torch.rand(n, generator=g)
    c, sn = torch.cos(ang) * s, torch.sin(ang) * s
    A = torch.stack([torch.stack([c, sn], -1), torch.stack([-sn, c], -1)], -2)
    ctr = torch.stack([12 + (w - 24) * torch.rand(n, generator=g),
                       12 + (h - 24) * torch.rand(n, generator=g)], -1)
    return torch.cat([A, ctr[..., None]], -1)[None]


def test_cuda_laf_descriptors_shape_estimator_dense_sift(cuda_device):
    """get_laf_descriptors (patch_sample and the atlas blur on the card),
    LAFAffineShapeEstimator and DenseSIFTDescriptor, card vs CPU."""
    from kornia_tpu_torch.feature.descriptors import LAFAffineShapeEstimator
    from kornia_tpu_torch.feature.extras import HardNet8, get_laf_descriptors
    from kornia_tpu_torch.feature.siftdesc import DenseSIFTDescriptor
    g = torch.Generator().manual_seed(22)
    img = t_filters.gaussian_blur2d(torch.rand((1, 3, 96, 128), generator=g),
                                    5, 1.2)
    lafs = _lafs(40, 96, 128, g)
    K.reset_launches()
    out = [get_laf_descriptors(img.to(d), lafs.to(d), HardNet8(device=d))
           for d in (cuda_device, "cpu")]
    assert K.launches["patch_sample"] >= 1
    torch.testing.assert_close(out[0].cpu(), out[1], atol=1e-4, rtol=0)
    est = LAFAffineShapeEstimator(32)
    a, b = est(lafs.to(cuda_device), img.to(cuda_device)).cpu(), est(lafs,
                                                                      img)
    torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()),
                               rtol=0)
    grey = img[:, :1]
    dense = DenseSIFTDescriptor()
    torch.testing.assert_close(dense(grey.to(cuda_device)).cpu(),
                               dense(grey), atol=1e-4, rtol=0)


def test_cuda_adalam_and_geometry_aware_matchers(cuda_device):
    from kornia_tpu_torch.feature.adalam import adalam_filter
    from kornia_tpu_torch.feature.extras import GeometryAwareDescriptorMatcher
    g = torch.Generator().manual_seed(23)
    kp0 = torch.rand((200, 2), generator=g) * 300
    kp1 = kp0 * 1.05 + 4.0
    kp1[::5] = torch.rand((40, 2), generator=g) * 300
    valid = torch.rand(200, generator=g) > 0.05
    keep = [adalam_filter(kp0.to(d), kp1.to(d), valid.to(d)).cpu()
            for d in (cuda_device, "cpu")]
    assert torch.equal(keep[0], keep[1]) and 0 < int(keep[1].sum()) < 200
    d0 = torch.nn.functional.normalize(torch.randn((200, 64), generator=g),
                                       dim=-1)
    d1 = torch.nn.functional.normalize(
        d0 + 0.2 * torch.randn((200, 64), generator=g), dim=-1)
    eye = torch.eye(2).expand(200, 2, 2) * 4
    l0 = torch.cat([eye, kp0[..., None]], -1)[None]
    l1 = torch.cat([eye, kp1[..., None]], -1)[None]
    for mode in ("adalam", "fginn"):
        m = GeometryAwareDescriptorMatcher(mode)
        dg, ig = m(*(t.to(cuda_device) for t in (d0, d1, l0, l1)))
        dc, ic = m(d0, d1, l0, l1)
        assert torch.equal(ig.cpu(), ic), mode
        torch.testing.assert_close(dg.cpu(), dc, atol=1e-5, rtol=0)


def test_cuda_lightglue_matches_cpu(cuda_device):
    """The 'doghardnet' preset (input projection, scales and orientations)
    at two layers, card vs CPU, the same seeded weights."""
    from kornia_tpu_torch.feature.lightglue import LightGlue, LightGlueConfig
    cfg = LightGlueConfig("doghardnet", n_layers=2)
    g = torch.Generator().manual_seed(24)
    data = {f"image{i}": {
        "keypoints": torch.rand((1, 300, 2), generator=g) * 400,
        "descriptors": torch.nn.functional.normalize(
            torch.randn((1, 300, 128), generator=g), dim=-1),
        "image_size": [400.0, 400.0],
        "scales": 1 + 5 * torch.rand((1, 300), generator=g),
        "oris": torch.rand((1, 300), generator=g) * 6.28} for i in (0, 1)}
    cpu = LightGlue(cfg, device="cpu")(data)
    card = LightGlue(cfg, device=cuda_device)(
        {k: {kk: vv.to(cuda_device) if torch.is_tensor(vv) else vv
             for kk, vv in v.items()} for k, v in data.items()})
    la = cpu["log_assignment"]
    torch.testing.assert_close(card["log_assignment"].cpu(), la,
                               atol=1e-3 * float(la.abs().max()), rtol=0)
    agree = (card["matches0"].cpu() == cpu["matches0"]).float().mean()
    assert float(agree) >= 0.99


def test_cuda_disk_matches_cpu(cuda_device):
    from kornia_tpu_torch.feature.disk import DISK
    g = torch.Generator().manual_seed(25)
    x = t_filters.gaussian_blur2d(torch.rand((1, 3, 64, 80), generator=g),
                                  5, 1.5)
    hc, dc = DISK(device="cpu").heatmap_and_dense_descriptors(x)
    hg, dg = DISK(device=cuda_device).heatmap_and_dense_descriptors(
        x.to(cuda_device))
    torch.testing.assert_close(hg.cpu(), hc, atol=1e-4 * max(
        1.0, float(hc.abs().max())), rtol=0)
    torch.testing.assert_close(dg.cpu(), dc, atol=1e-4 * max(
        1.0, float(dc.abs().max())), rtol=0)
    fc = DISK(device="cpu")(x, 64)
    fg = DISK(device=cuda_device)(x.to(cuda_device), 64)
    assert torch.equal(fg.valid.cpu(), fc.valid)
    v = fc.valid
    sg = {tuple(p) for p in fg.keypoints.cpu()[v].tolist()}
    assert sg == {tuple(p) for p in fc.keypoints[v].tolist()}


# --- the learned families: XFeat, ALIKED, DeDoDe with DINOv2, SOLD2, DeFMO --

def _smooth_rand(seed, shape):
    g = torch.Generator().manual_seed(seed)
    return t_filters.gaussian_blur2d(torch.rand(shape, generator=g), 5, 1.5)


def _close(card, cpu, rtol=1e-4):
    """card within rtol of max(1, the largest |cpu|)."""
    torch.testing.assert_close(card.detach().cpu(), cpu, rtol=0,
                               atol=rtol * max(1.0, float(cpu.abs().max())))


def test_cuda_xfeat_matches_cpu(cuda_device):
    from kornia_tpu_torch.feature.xfeat import XFeat, xfeat_model
    x0 = _smooth_rand(30, (1, 1, 64, 96))
    x1 = torch.roll(x0, 3, -1)
    xc, xg = XFeat(top_k=256, device="cpu"), XFeat(top_k=256,
                                                   device=cuda_device)
    for g, c in zip(xfeat_model(xg.params, x0.to(cuda_device)),
                    xfeat_model(xc.params, x0)):
        _close(g, c)
    fc = xc.detectAndCompute(x0)
    fg = xg.detectAndCompute(x0.to(cuda_device))
    assert torch.equal(fg["valid"].cpu(), fc["valid"])
    v = fc["valid"]
    kc, kg = fc["keypoints"][v], fg["keypoints"].cpu()[v]
    sc = fc["scores"][v]
    _close(fg["scores"].cpu()[v], sc, 1e-5)
    # the same keypoints in the same slots, but two slots whose scores are
    # a near tie may swap (the devices sum in other orders)
    assert sorted(map(tuple, kg.tolist())) == sorted(map(tuple, kc.tolist()))
    slot = {tuple(k): i for i, k in enumerate(kc.tolist())}
    for i in (kc != kg).any(-1).nonzero()[:, 0].tolist():
        j = slot[tuple(kg[i].tolist())]
        assert abs(float(sc[i] - sc[j])) <= 1e-5 * float(sc.abs().max())

    def pairs(m):
        k0, k1, ok = (t.cpu() for t in m)
        return sorted(map(tuple, torch.cat([k0, k1], -1)[ok].tolist()))

    mc = xc.match_xfeat(x0, x1)
    mg = xg.match_xfeat(x0.to(cuda_device), x1.to(cuda_device))
    assert pairs(mg) == pairs(mc)
    assert pairs(mc)


def test_cuda_aliked_matches_cpu(cuda_device):
    from kornia_tpu_torch.feature.aliked import ALIKED, _net_forward
    x = _smooth_rand(31, (1, 3, 64, 64))
    ac = ALIKED("aliked-t16", num_keypoints=64, device="cpu")
    ag = ALIKED("aliked-t16", num_keypoints=64, device=cuda_device)
    assert ag.params["desc_head.agg_weights"].device == cuda_device
    for g, c in zip(_net_forward(ag.params, x.to(cuda_device)),
                    _net_forward(ac.params, x)):
        _close(g, c)
    kc, sc, dc, vc = ac(x)
    kg, sg, dg, vg = ag(x.to(cuda_device))
    assert torch.equal(vg.cpu(), vc)
    torch.testing.assert_close(kg.cpu()[vc], kc[vc], atol=1e-3, rtol=0)
    torch.testing.assert_close(dg.cpu()[vc], dc[vc], atol=1e-4, rtol=0)


def test_cuda_dedode_matches_cpu(cuda_device):
    """Detector L and descriptor B at 64x64, G on a DINOv2 of 2 layers at
    56x56 (1e-3: attention sums in another order on the card)."""
    from kornia_tpu_torch.feature.dedode import DeDoDe
    x = _smooth_rand(32, (1, 3, 64, 64))
    bc = DeDoDe(num_keypoints=128, device="cpu")
    bg = DeDoDe(num_keypoints=128, device=cuda_device)
    xc, xg = bc._prep(x), bg._prep(x.to(cuda_device))
    _close(bg.detector(xg), bc.detector(xc))
    _close(bg.descriptor(xg), bc.descriptor(xc))
    kc, _, _ = bc(x)
    kg, _, _ = bg(x.to(cuda_device))
    same = torch.isclose(kg.cpu(), kc, rtol=0, atol=1e-4).all(-1)
    assert float(same.float().mean()) >= 0.99
    vit = dict(embed_dim=64, depth=2, num_heads=2, pos_grid=5)
    xs = x[..., :56, :56].contiguous()
    gc = DeDoDe(descriptor="G", vit_cfg=vit, device="cpu")
    gg = DeDoDe(descriptor="G", vit_cfg=vit, device=cuda_device)
    _close(gg.describe(xs.to(cuda_device)), gc.describe(xs), 1e-3)


def test_cuda_dedode_density_is_the_fused_kernel(cuda_device):
    """sample_keypoints' 51-tap coverage density launches the fused blur
    (constant border), which matches its plain version on the pair's
    480x640 score maps."""
    from kornia_tpu_torch.core.grid import linspace
    from kornia_tpu_torch.feature.dedode import sample_keypoints
    g = torch.Generator().manual_seed(33)
    logits = torch.randn((2, 480 * 640), generator=g)
    score = torch.softmax(logits, -1).reshape(2, 480, 640)
    before = K.launches["fused_separable_blur2d"]
    kg, sg = sample_keypoints(score.to(cuda_device), 2048)
    torch.cuda.synchronize()
    assert K.launches["fused_separable_blur2d"] == before + 1
    kc, sc = sample_keypoints(score, 2048)
    same = torch.isclose(kg.cpu(), kc, rtol=0, atol=1e-6).all(-1)
    assert float(same.float().mean()) >= 0.99
    w = torch.exp(-linspace(-2.0, 2.0, 51, cuda_device) ** 2)
    x = torch.rand((2, 1, 480, 640), generator=g).to(cuda_device)
    out = K.fused_separable_blur2d(x, w, w, "constant")
    ref = K.fused_separable_blur2d_plain(x, w, w, "constant")
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=1e-6 * float(ref.abs().max()))


def test_cuda_sold2_matches_cpu(cuda_device):
    from kornia_tpu_torch.feature import sold2 as S
    x = _smooth_rand(34, (1, 1, 64, 64))
    sc, sg = S.SOLD2(device="cpu"), S.SOLD2(device=cuda_device)
    oc, og = sc.net(x), sg.net(x.to(cuda_device))
    for k in oc:
        _close(og[k], oc[k])
    heat = torch.zeros((64, 80))
    heat[20, 10:51] = 1.0
    heat[10:41, 40] = 1.0
    heat = (t_filters.gaussian_blur2d(heat[None, None], 5, 0.7)[0, 0] * 2.5
            ).clamp(0, 1)
    junc = torch.tensor([[20.0, 10.0], [20.0, 50.0], [10.0, 40.0],
                         [40.0, 40.0], [20.0, 30.0], [5.0, 5.0]])
    valid = torch.ones(6, dtype=torch.bool)
    for sampling in ("local_max", "bilinear"):
        for mode in ("global", "local"):
            ac, scc = S.detect_line_segments(junc, valid, heat,
                                             sampling=sampling,
                                             heatmap_refine_mode=mode)
            ag, scg = S.detect_line_segments(
                junc.to(cuda_device), valid.to(cuda_device),
                heat.to(cuda_device), sampling=sampling,
                heatmap_refine_mode=mode)
            assert torch.equal(ag.cpu(), ac), (sampling, mode)
            torch.testing.assert_close(scg.cpu(), scc, atol=1e-5, rtol=0)
    segs, mask = S.adjacency_to_segments(junc, ac, scc, 8)
    rc = S.refine_segments_perturb(segs, mask, heat)
    rg = S.refine_segments_perturb(segs.to(cuda_device),
                                   mask.to(cuda_device),
                                   heat.to(cuda_device))
    torch.testing.assert_close(rg.cpu(), rc, atol=1e-3, rtol=0)
    d = torch.nn.functional.normalize(torch.randn((6, 5, 16), generator=(
        torch.Generator().manual_seed(35))), dim=-1)
    v = torch.ones(6, dtype=torch.bool)
    assert torch.equal(S.match_lines_nw(d.to(cuda_device), d.flip(1).to(
        cuda_device), v.to(cuda_device), v.to(cuda_device)).cpu(),
        S.match_lines_nw(d, d.flip(1), v, v))


def test_cuda_defmo_matches_cpu(cuda_device):
    from kornia_tpu_torch.feature.defmo import DeFMO
    x = torch.rand((1, 6, 32, 48), generator=torch.Generator().manual_seed(
        36))
    _close(DeFMO(4, device=cuda_device)(x.to(cuda_device)),
           DeFMO(4, device="cpu")(x))


# --- detection and dense-prediction models, contrib's detectors ------------------

def test_cuda_default_detectors_build_with_no_arguments(cuda_device):
    from kornia_tpu_torch.contrib import BoxMotTracker, SuperResolution
    from kornia_tpu_torch.contrib.detection import (EdgeDetector,
                                                    FaceDetector,
                                                    ObjectDetector)
    from kornia_tpu_torch.tracking.bytetrack import BoxTracker
    for tracker in (BoxTracker(), BoxMotTracker()._tracker):
        assert isinstance(tracker.detector, ObjectDetector)
        assert tracker.state.alive.device.type == "cuda"
    for det in (FaceDetector(), EdgeDetector()):
        assert next(det.model.parameters()).device.type == "cuda"
    img = torch.rand((1, 3, 48, 64), device=cuda_device)
    assert ObjectDetector()(img).device.type == "cuda"
    assert SuperResolution()(img).shape == (1, 3, 96, 128)
    out = BoxTracker().update(img)
    assert out[0].device.type == "cuda"


def _models_inputs(seed, shape):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed))


def _close_own(card, cpu, rtol=1e-4):
    """card within rtol of the largest |cpu| (the output's own scale)."""
    scale = float(cpu.abs().max())
    assert scale > 0, "an all-zero reference holds nothing"
    torch.testing.assert_close(card.detach().cpu(), cpu, rtol=0,
                               atol=rtol * scale)


def test_cuda_rtdetr_matches_cpu(cuda_device):
    """The encoder's class maxima within 1e-4; the query sets equal but at
    near ties (seeded weights put many near the cut); the CPU decoder run
    from the card's queries gives the card's logits and boxes within 1e-4;
    the CPU post-processor on the card's outputs gives the card's rows,
    but two swapped at a score tie."""
    from kornia_tpu_torch.models import rt_detr as R
    stages = (R.HGNetStageConfig(16, 16, 32, 1, False, False, 3, 2),
              R.HGNetStageConfig(32, 16, 48, 1, True, False, 3, 2),
              R.HGNetStageConfig(48, 24, 64, 2, True, True, 5, 2),
              R.HGNetStageConfig(64, 32, 96, 1, True, True, 5, 2))
    x = _models_inputs(40, (2, 3, 96, 128))
    for cfg in (R.RTDETRConfig(input_size=128),
                R.RTDETRConfig("hgnetv2_l", hgnet_stem=[3, 8, 16],
                               hgnet_stages=stages, input_size=96)):
        mc, mg = R.RTDETR(cfg, device="cpu"), R.RTDETR(cfg,
                                                       device=cuda_device)
        with torch.inference_mode():
            lg, bg, sg, qg = R._forward(mg.params, cfg, x.to(cuda_device))
            lc, bc, sc, qc = R._forward(mc.params, cfg, x, qg.cpu())
        _close_own(sg, sc, 1e-4)
        tol = 1e-4 * float(sc.abs().max())
        for b in range(x.shape[0]):
            cut = float(sc[b, qc[b, -1]])
            for i in set(qg[b].tolist()) ^ set(qc[b].tolist()):
                assert abs(float(sc[b, i]) - cut) <= tol, (b, i)
        _close_own(lg, lc, 1e-4)
        _close_own(bg, bc, 1e-4)
        rg = mg.post(lg, bg, [(96, 128)] * 2).cpu()
        rc = mg.post(lg.cpu(), bg.cpu(), [(96, 128)] * 2)
        _close(rg[..., 1], rc[..., 1], 1e-5)
        # the sigmoids differ by an ulp: two tied scores may swap rows
        for b, i in ((rg - rc).abs().amax(-1) > 1e-3).nonzero().tolist():
            s = rc[b, :, 1]
            assert int(((s - s[i]).abs() <= 1e-5).sum()) >= 2, (b, i)


def test_cuda_yunet_dexined_rrdbnet_match_cpu(cuda_device):
    """Each output within 1e-4 of its own largest |value|; YuNet and
    RRDBNet take weights rescaled to O(1) outputs
    (``tests/torch_unit_scale.py``)."""
    from kornia_tpu_torch.models.dexined import DexiNed
    from kornia_tpu_torch.models.rrdbnet import RRDBNet, RRDBNetConfig
    from kornia_tpu_torch.models.yunet import YuNet
    x = _models_inputs(41, (1, 3, 64, 80))
    yp = yunet_unit_scale(YuNet(device="cpu").params)
    oc = YuNet(yp, device="cpu")(x)
    og = YuNet(yp, device=cuda_device)(x.to(cuda_device))
    for k in oc:
        _close_own(og[k], oc[k], 1e-4)
    _close_own(DexiNed(device=cuda_device)(x.to(cuda_device)),
               DexiNed(device="cpu")(x), 1e-4)
    cfg = RRDBNetConfig(num_block=2, scale=2)
    rp = rrdbnet_unit_scale(RRDBNet(cfg, device="cpu").params)
    rc = RRDBNet(cfg, rp, device="cpu")(x[..., :32, :32])
    _close_own(RRDBNet(cfg, rp, device=cuda_device)(x[..., :32, :32].to(
        cuda_device)), rc, 1e-4)


def test_cuda_small_sr_unet_depth_anything_match_cpu(cuda_device):
    from kornia_tpu_torch.models.depth_anything import (DepthAnything,
                                                        DepthAnythingConfig)
    from kornia_tpu_torch.models.small_sr import SmallSR, UNetSegmentor
    x = _models_inputs(42, (1, 3, 48, 64))
    _close(SmallSR(device=cuda_device)(x.to(cuda_device)),
           SmallSR(device="cpu")(x), 1e-4)
    _close(UNetSegmentor(device=cuda_device)(x.to(cuda_device)),
           UNetSegmentor(device="cpu")(x), 1e-4)
    cfg = DepthAnythingConfig.tiny()
    dg, dc = DepthAnything(cfg, device=cuda_device), DepthAnything(
        cfg, device="cpu")
    dg(torch.zeros((1, 3, 64, 64), device=cuda_device))  # an 8x8 table
    dc.model.load_params({k: v.cpu() for k, v in dg.params.items()})
    _close(dg(x.to(cuda_device)), dc(x), 1e-4)           # resized to 6x8


def test_cuda_contrib_detectors_match_cpu(cuda_device):
    from kornia_tpu_torch.contrib.detection import (EdgeDetector,
                                                    FaceDetector,
                                                    ObjectDetector)
    x = _models_inputs(43, (2, 3, 96, 128))
    yp = yunet_unit_scale(FaceDetector(device="cpu").model.params)
    fc = FaceDetector(keep_top_k=50, params=yp, device="cpu")(x)
    fg = FaceDetector(keep_top_k=50, params=yp, device=cuda_device)(
        x.to(cuda_device))
    for a, b in zip(fg, fc):
        assert int((b.score > 0).sum()) > 0
        assert torch.equal(a.score.cpu() > 0, b.score > 0)
        _close_own(a.data, b.data, 1e-4)
    oc = ObjectDetector(input_size=64, device="cpu")(x)
    og = ObjectDetector(input_size=64, device=cuda_device)(x.to(cuda_device))
    assert torch.equal(og[..., 0].cpu(), oc[..., 0])
    _close(og, oc, 1e-3)
    _close(EdgeDetector(image_size=64, device=cuda_device)(
        x.to(cuda_device)), EdgeDetector(image_size=64, device="cpu")(x),
        1e-4)
