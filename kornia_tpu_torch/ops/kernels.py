"""The port's hand-written CUDA kernels, their plain PyTorch versions, and
the wrappers that choose between them by the device of the input.

Counterpart of ``kornia_tpu/ops/pallas_kernels.py``; every TPU kernel there
has its kernel here:

* ``fused_separable_blur2d`` (one blur, ``out = Sv · x · Shᵀ``) and
  ``multi_level_blur`` (every level of a pyramid octave at once,
  ``level_l = SV_l · x · SH_lᵀ``), and their adjoints
  ``fused_separable_blur2d_adjoint`` (``dx = Svᵀ g Sh``) and
  ``multi_level_blur_adjoint`` (``dx = Σ_l SV_lᵀ g_l SH_l``), all in
  ``csrc/banded_blur.cu``. Each runs one of two routes, chosen before
  the launch: a tiled kernel (both passes of a tile in shared memory; the
  band adjoints sum their levels in the block), or two passes through
  device memory where the taps or bands are too wide to stage or the
  tiled grid too small to fill the card. The two blurs are
  ``torch.autograd.Function``s whose backward runs the adjoint, so a blur
  is differentiable on both devices;
* ``patch_sample`` runs ``csrc/patch_sample.cu`` (the TPU's
  ``patch_sample_mxu`` without its window, in its f32 and bf16 modes);
* ``streaming_min2`` runs ``csrc/streaming_min2.cu`` (per row the two
  nearest squared-L2 distances and the argmin, no (N, M) matrix; the dot
  products on the tensor cores, split 3xTF32 to f32 accuracy).

A wrapper given a CPU tensor computes the plain version (the dense
operator products of the JAX package's ``xla_mm2`` / ``xla`` variants, a
gather-based bilinear sample, the full distance matrix). Given a CUDA
tensor it launches the kernel or raises; it never falls back. Each launch
adds one to ``launches[name]``, and a blur's launch also to
``launches[name + ":tiled"]`` or ``launches[name + ":passes"]``, the
route it took.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` from the
sources in ``kornia_tpu_torch/csrc`` into ``build/kernels/`` and loaded with
``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import itertools
import os
import shutil
import subprocess
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..core.linalg import f32_matmul_precision

__all__ = [
    "launches",
    "reset_launches",
    "build_kernels",
    "band_matrix",
    "cumulative_operators",
    "fused_separable_blur2d",
    "fused_separable_blur2d_plain",
    "fused_separable_blur2d_adjoint",
    "fused_separable_blur2d_adjoint_plain",
    "multi_level_blur",
    "multi_level_blur_plain",
    "multi_level_blur_adjoint",
    "multi_level_blur_adjoint_plain",
    "patch_sample",
    "patch_sample_plain",
    "streaming_min2",
    "streaming_min2_plain",
]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
# library name -> CUDA source; one nvcc per source, all started together
SOURCES = {"banded_blur": "banded_blur.cu", "patch_sample": "patch_sample.cu",
           "streaming_min2": "streaming_min2.cu"}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: kernel launches per wrapper name since the last `reset_launches()`
launches: Counter = Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[str, ctypes._CFuncPtr] = {}  # C function name -> bound function
_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int
_LONG = ctypes.c_longlong
_INTP = ctypes.POINTER(ctypes.c_int)
# C function -> (library, argument types)
_BANDS = [_VOIDP] * 5 + [_INTP] * 2 + [_VOIDP] * 2 + [_INT] * 7 + [_VOIDP]
_FUNCS = {
    "tiled_blur_fits": ("banded_blur", [_INT] * 4),
    "separable_blur": ("banded_blur", [_VOIDP] * 5 + [_INT] * 9 + [_VOIDP]),
    "banded_blur": ("banded_blur", _BANDS),
    "banded_blur_adjoint": ("banded_blur", _BANDS),
    "patch_sample": ("patch_sample", [_VOIDP, _INT, _INT, _VOIDP, _VOIDP,
                                      _VOIDP, _LONG, _LONG, _LONG, _INT,
                                      _INT, _VOIDP]),
    "streaming_min2": ("streaming_min2", [_VOIDP] * 10 + [_INT] * 5
                       + [_VOIDP]),
}
# border rules as csrc/banded_blur.cu numbers them
_BORDERS = {"reflect": 0, "replicate": 1, "circular": 2, "constant": 3}
# borders whose adjoint is the same rule with flipped taps (no table)
_FLIP_ADJOINT = ("constant", "circular")
_MAX_LEVELS = 8         # kMaxLevels in csrc/banded_blur.cu
# rows and columns of LargeTile and BandTile in csrc/banded_blur.cu
_TILE = (32, 64)
# the single blur takes large tiles where they make at least this many
# blocks per SM, else small ones (a small grid's time is its blocks' serial
# work)
_LARGE_TILE_FILL = 2.0
# the multi-level blur takes the tiled kernel (a block per tile and level)
# where that grid has at least this many blocks per SM; on smaller grids
# each block's serial band loops set the time, and the two passes' many
# small blocks are faster
_BAND_TILED_FILL = 1.0
# the band adjoint takes the tiled kernel (a block per 32 x 64 tile, every
# level summed in it) where that grid has at least this many blocks per SM:
# it won at 1.14 (480x640, one image, five levels: 0.068 ms against the
# passes' 0.084) and lost at 0.30 (240x320: 0.052 against 0.038; H100,
# kernel_times.py, both routes forced in one call)
_ADJOINT_TILED_FILL = 1.0
# routes of csrc/banded_blur.cu: two passes, the tiled kernel in large
# (or band) tiles, in small tiles
_PASSES, _TILED, _TILED_SMALL = 0, 1, 2
_MAX_GRID_Z = 65535     # the grid's third dimension: images x levels
# patch_sample modes of the TPU kernel -> bf16 row pass or exact f32
_PATCH_MODES = {"split": False, "highest": False, "bf16": True}
_BIG = 1e9              # kBig in csrc/streaming_min2.cu, _BIG of the reference
_MIN2_TILE = 128        # kTileM and kTileN in csrc/streaming_min2.cu


def reset_launches() -> None:
    launches.clear()


def _so_path(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def build_kernels() -> Dict[str, str]:
    """Compile every CUDA source that has no up-to-date library yet, one
    ``nvcc`` process per source, all started together. Returns the
    compiler's messages (``ptxas -v``: registers, shared memory, spills)
    per library built; raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        so = _so_path(name)
        if so.exists():
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    logs, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def _require_cuda(what: str, *tensors: torch.Tensor) -> None:
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
        if t.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"{what}: unsupported dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensor must be contiguous")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: tensors lie on different devices")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when the first tensor (the data) lies on the CPU (the plain
    version runs); False when it lies on a CUDA device (the kernel runs)."""
    dev = tensors[0].device.type
    if dev == "cpu":
        return True
    if dev != "cuda":
        raise ValueError(f"no kernel for device {tensors[0].device}")
    return False


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# -----------------------------------------------------------------------------
# Banded operators (built in plain torch around the kernel)
# -----------------------------------------------------------------------------

def _fold_index(k: int, size: int, border_type: str, device,
                anchor: Optional[int] = None):
    """Per output index i and tap k of a K-tap kernel whose tap `anchor`
    (default K // 2) lands on i: the source index of ``i + k - anchor``
    under the border rule, and whether the rule keeps the tap. Returns
    (idx (K, size) int64, valid (K, size) bool)."""
    pad = k // 2 if anchor is None else anchor
    taps = (torch.arange(size, device=device)[None, :]
            + torch.arange(k, device=device)[:, None] - pad)  # (K, size)
    if border_type == "reflect":
        # reflected as often as it takes (numpy's and jnp.pad's rule), so a
        # kernel wider than the image still reads inside it
        period = max(2 * (size - 1), 1)
        idx = torch.remainder(taps, period)
        idx = torch.where(idx >= size, period - idx, idx)
        valid = torch.ones_like(taps, dtype=torch.bool)
    elif border_type == "replicate":
        idx = taps.clamp(0, size - 1)
        valid = torch.ones_like(taps, dtype=torch.bool)
    elif border_type == "circular":
        idx = torch.remainder(taps, size)
        valid = torch.ones_like(taps, dtype=torch.bool)
    elif border_type == "constant":
        valid = (taps >= 0) & (taps < size)
        idx = taps.clamp(0, size - 1)
    else:
        raise ValueError(f"unknown border type {border_type!r}")
    valid = valid & (idx >= 0) & (idx < size)
    return idx.clamp(0, size - 1), valid


def _fold_taps(kernel: torch.Tensor, size: int, border_type: str,
               anchor: Optional[int] = None):
    """_fold_index with the tap weights: (idx (K, size) int64, w (K, size)),
    w zero where the rule drops the tap."""
    idx, valid = _fold_index(kernel.numel(), size, border_type,
                             kernel.device, anchor)
    w = torch.where(valid, kernel.reshape(-1, 1).to(torch.float32), 0.0)
    return idx, w


def band_matrix(kernel: torch.Tensor, size: int, border_type: str,
                anchor: Optional[int] = None) -> torch.Tensor:
    """(size, size) 'same'-correlation operator with the border rule folded
    in (``pallas_kernels.py::_band_matrix``): row i sums kernel[k] into
    column border(i + k - anchor), anchor K // 2 unless given."""
    idx, w = _fold_taps(kernel.reshape(-1), size, border_type, anchor)
    rows = torch.arange(size, device=kernel.device)[None, :].expand_as(idx)
    S = torch.zeros((size, size), dtype=torch.float32, device=kernel.device)
    return S.index_put_((rows.reshape(-1), idx.reshape(-1)), w.reshape(-1),
                        accumulate=True)


@f32_matmul_precision
def cumulative_operators(kernels: Sequence[torch.Tensor], size: int,
                         border_type: str) -> torch.Tensor:
    """(L, size, size): level l's operator is the product of the band
    operators of kernels 0..l (``_cum_op``: step @ cum in true f32)."""
    dev = kernels[0].device
    cum = torch.eye(size, dtype=torch.float32, device=dev)
    out = []
    for k in kernels:
        cum = torch.matmul(band_matrix(k, size, border_type), cum)
        out.append(cum)
    return torch.stack(out)


def _half_widths(kernel_sizes: Sequence[int], size: int,
                 border_type: str) -> List[int]:
    """Band half-width of each cumulative operator: R_l, the sum of the
    radii of kernels 0..l. A circular border wraps, so its band is the
    row."""
    if border_type == "circular":
        return [size] * len(kernel_sizes)
    return list(itertools.accumulate(k // 2 for k in kernel_sizes))


def _band_taps(ops: torch.Tensor, half_widths: Sequence[int]):
    """Band tables of dense operators (L, size, size) whose row i of level
    l is zero outside columns [i - R_l, i + R_l]: K_l = min(2·R_l + 1,
    size) consecutive columns per row from start clamp(i - R_l, 0,
    size - K_l). Returns (start (L, size) int32, weights (L, Kmax, size)
    tap-major, zero past K_l, taps (K_0, ..., K_{L-1})). The entries left
    out are exact zeros, so each band sums to its dense row."""
    L, size, _ = ops.shape
    taps = tuple(min(2 * r + 1, size) for r in half_widths)
    kmax = max(taps)
    rows = torch.arange(size, device=ops.device)
    k = torch.arange(kmax, device=ops.device)
    starts, weights = [], []
    for lvl, (r, K) in enumerate(zip(half_widths, taps)):
        start = (rows - r).clamp(0, size - K)
        idx = (start[:, None] + k[None, :]).clamp(max=size - 1)
        w = torch.gather(ops[lvl], 1, idx)  # (size, Kmax)
        starts.append(start)
        weights.append(torch.where(k[None, :] < K, w, 0.0).T)
    return (torch.stack(starts).to(torch.int32).contiguous(),
            torch.stack(weights).contiguous(), taps)


def _values(kernels) -> Tuple[Tuple[float, ...], ...]:
    """The kernels' taps as a hashable key (one host read; none for host
    tensors, which is how the pyramid passes them)."""
    flat = torch.cat([k.reshape(-1) for k in kernels]).tolist()
    sizes = [k.numel() for k in kernels]
    offsets = [0, *itertools.accumulate(sizes)]
    return tuple(tuple(flat[a:b]) for a, b in zip(offsets, offsets[1:]))


@functools.lru_cache(maxsize=32)
def _cumulative_cached(values, size: int, border_type: str,
                       device: str) -> torch.Tensor:
    """cumulative_operators, built once per (taps, size, border, device):
    a pyramid's kernels are the same for every octave of a size."""
    kernels = [torch.tensor(v, dtype=torch.float32, device=device)
               for v in values]
    return cumulative_operators(kernels, size, border_type)


@functools.lru_cache(maxsize=32)
def _band_tables_cached(values, size: int, border_type: str, device: str):
    """_band_taps of the cumulative operators, built once per (taps, size,
    border, device)."""
    return _band_taps(_cumulative_cached(values, size, border_type, device),
                      _half_widths([len(v) for v in values], size,
                                   border_type))


@functools.lru_cache(maxsize=32)
def _adjoint_band_tables_cached(values, size: int, border_type: str,
                                device: str):
    """_band_taps of the TRANSPOSED cumulative operators (a single kernel's
    transposed band operator for L = 1), built once per (taps, size,
    border, device). A transposed operator is banded with the same
    half-widths: its first and last columns collect the taps the border
    rule folds, which lie within R_l of the diagonal."""
    ops = _cumulative_cached(values, size, border_type, device)
    return _band_taps(ops.transpose(1, 2).contiguous(),
                      _half_widths([len(v) for v in values], size,
                                   border_type))


def _fn(name: str):
    """The C function `name`, its library built and loaded at first use."""
    if name not in _FNS:
        lib_name, argtypes = _FUNCS[name]
        if lib_name not in _LIBS:
            build_kernels()
            _LIBS[lib_name] = ctypes.CDLL(str(_so_path(lib_name)))
        fn = getattr(_LIBS[lib_name], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _check_launch(name: str, err: int, route: Optional[int] = None) -> None:
    """Raise on a CUDA error; else count the launch (and its route)."""
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (CUDA error {err})")
    launches[name] += 1
    if route is not None:
        launches[f"{name}:{'passes' if route == _PASSES else 'tiled'}"] += 1


@functools.lru_cache(maxsize=None)
def _tiled_fits(bands: bool, large: bool, kv: int, kh: int) -> bool:
    """Whether the tiled blur kernel stages taps (in large or small tiles)
    or bands of at most kv rows and kh columns in a block's shared memory
    (csrc/banded_blur.cu::tiled_blur_fits)."""
    return bool(_fn("tiled_blur_fits")(int(bands), int(large), kv, kh))


def _check_grid(name: str, depth: int) -> None:
    if depth > _MAX_GRID_Z:
        raise ValueError(f"{name}: {depth} images x levels exceed the "
                         f"grid's {_MAX_GRID_Z}")


# -----------------------------------------------------------------------------
# Launchers shared by the blurs and their adjoints
# -----------------------------------------------------------------------------

def _launch_separable(name: str, xf: torch.Tensor, ky: torch.Tensor,
                      kx: torch.Tensor, anchors: Tuple[int, int],
                      border_type: str) -> torch.Tensor:
    """csrc/banded_blur.cu::separable_blur on xf (N, H, W): the taps of ky
    down the columns, then of kx along the rows, tap anchors[i] of each
    kernel landing on the output pixel."""
    N, H, W = xf.shape
    _check_grid(name, N)
    ky = ky.reshape(-1).to(xf.device, torch.float32).contiguous()
    kx = kx.reshape(-1).to(xf.device, torch.float32).contiguous()
    _require_cuda(name, xf, ky, kx)
    large = _blocks_per_sm(N, H, W, xf.device) >= _LARGE_TILE_FILL
    route = _PASSES
    if _tiled_fits(False, large, ky.numel(), kx.numel()):
        route = _TILED if large else _TILED_SMALL
    # the passes' intermediate; the tiled kernel reads none
    tmp = torch.empty_like(xf) if route == _PASSES else None
    out = torch.empty_like(xf)
    with torch.cuda.device(xf.device):
        err = _fn("separable_blur")(
            xf.data_ptr(), ky.data_ptr(), kx.data_ptr(),
            None if tmp is None else tmp.data_ptr(), out.data_ptr(), N, H, W,
            ky.numel(), kx.numel(), anchors[0], anchors[1],
            _BORDERS[border_type], route, _stream(xf))
    _check_launch(name, err, route)
    return out


def _blocks_per_sm(depth: int, H: int, W: int, device) -> float:
    """Blocks per SM of the tiled kernel's grid in 32 x 64 tiles over
    `depth` images (x levels) of (H, W)."""
    blocks = depth * -(-H // _TILE[0]) * -(-W // _TILE[1])
    return blocks / torch.cuda.get_device_properties(
        device).multi_processor_count


def _launch_bands(name: str, fn: str, xf: torch.Tensor, out_shape,
                  vertical, horizontal) -> torch.Tensor:
    """csrc/banded_blur.cu::banded_blur (xf (N, H, W) → (L, N, H, W)) or
    ::banded_blur_adjoint (xf (L, N, H, W) → (N, H, W)) with the band
    tables (start, weights, taps per level) of each axis."""
    sv, wv, kv = vertical
    sh, wh, kh = horizontal
    L = len(kv)
    H, W = xf.shape[-2:]
    N = xf.shape[-3]
    _check_grid(name, L * N)
    _require_cuda(name, xf, sv, wv, sh, wh)
    kv_max, kh_max = wv.shape[1], wh.shape[1]
    route = _band_route(fn == "banded_blur_adjoint", L, N, H, W, kv_max,
                        kh_max, xf.device)
    # the passes' intermediate; the tiled kernels read none
    tmp = (torch.empty((L, N, H, W), dtype=torch.float32, device=xf.device)
           if route == _PASSES else None)
    out = torch.empty(out_shape, dtype=torch.float32, device=xf.device)
    with torch.cuda.device(xf.device):
        err = _fn(fn)(
            xf.data_ptr(), sv.data_ptr(), wv.data_ptr(), sh.data_ptr(),
            wh.data_ptr(), (_INT * L)(*kv), (_INT * L)(*kh),
            None if tmp is None else tmp.data_ptr(), out.data_ptr(), L, N,
            H, W, kv_max, kh_max, route, _stream(xf))
    _check_launch(name, err, route)
    return out


def _band_route(adjoint: bool, L: int, N: int, H: int, W: int, kv_max: int,
                kh_max: int, device) -> int:
    """The route of a band launch, decided before it: the tiled kernel
    where the bands fit a block's shared memory and its grid (a block per
    tile and level, or for the adjoint per tile) fills the card enough;
    else the two passes."""
    depth, fill = (N, _ADJOINT_TILED_FILL) if adjoint else (L * N,
                                                            _BAND_TILED_FILL)
    if (_blocks_per_sm(depth, H, W, device) >= fill
            and _tiled_fits(True, True, kv_max, kh_max)):
        return _TILED
    return _PASSES


def _check_border(border_type: str) -> None:
    if border_type not in _BORDERS:
        raise ValueError(f"unknown border type {border_type!r}")


# -----------------------------------------------------------------------------
# fused_separable_blur2d and its adjoint
# -----------------------------------------------------------------------------

@f32_matmul_precision
def fused_separable_blur2d_plain(x: torch.Tensor, kernel_y: torch.Tensor,
                                 kernel_x: torch.Tensor,
                                 border_type: str = "reflect") -> torch.Tensor:
    """Plain version: dense band operators, ``Sv · x · Shᵀ`` in true f32
    (the ``xla_mm2`` variant of the JAX package)."""
    B, C, H, W = x.shape
    sv = band_matrix(kernel_y.reshape(-1), H, border_type)
    sh = band_matrix(kernel_x.reshape(-1), W, border_type)
    xf = x.reshape(B * C, H, W).to(torch.float32)
    acc = torch.einsum("ih,nhw->niw", sv, xf)
    out = torch.einsum("niw,jw->nij", acc, sh)
    return out.to(x.dtype).reshape(B, C, H, W)


@f32_matmul_precision
def fused_separable_blur2d_adjoint_plain(g: torch.Tensor,
                                         kernel_y: torch.Tensor,
                                         kernel_x: torch.Tensor,
                                         border_type: str = "reflect"
                                         ) -> torch.Tensor:
    """Plain version of the adjoint: ``Svᵀ · g · Sh`` with the dense band
    operators in true f32 (``_mm2_bwd``'s dx). (B, C, H, W) f32."""
    B, C, H, W = g.shape
    sv = band_matrix(kernel_y.reshape(-1), H, border_type)
    sh = band_matrix(kernel_x.reshape(-1), W, border_type)
    gf = g.reshape(B * C, H, W).to(torch.float32)
    acc = torch.einsum("hi,nhw->niw", sv, gf)
    out = torch.einsum("niw,wj->nij", acc, sh)
    return out.reshape(B, C, H, W)


def fused_separable_blur2d_adjoint(g: torch.Tensor, kernel_y: torch.Tensor,
                                   kernel_x: torch.Tensor,
                                   border_type: str = "reflect"
                                   ) -> torch.Tensor:
    """Adjoint of `fused_separable_blur2d` with respect to its input:
    ``dx = Svᵀ · g · Sh`` for g (B, C, H, W) → f32 (B, C, H, W). One CUDA
    launch on the card: for a constant or circular border the blur kernel
    with flipped taps (the adjoint of a correlation under those rules);
    for reflect and replicate the band kernel on the transposed operators,
    whose tables are built once per (kernel, size, border, device)."""
    if g.ndim != 4:
        raise ValueError(f"expected (B, C, H, W), got {tuple(g.shape)}")
    _check_border(border_type)
    if _on_cpu(g):
        return fused_separable_blur2d_adjoint_plain(g, kernel_y, kernel_x,
                                                    border_type)
    name = "fused_separable_blur2d_adjoint"
    B, C, H, W = g.shape
    gf = g.reshape(B * C, H, W).to(torch.float32).contiguous()
    ky = kernel_y.reshape(-1)
    kx = kernel_x.reshape(-1)
    if border_type in _FLIP_ADJOINT:
        anchors = (ky.numel() - 1 - ky.numel() // 2,
                   kx.numel() - 1 - kx.numel() // 2)
        out = _launch_separable(name, gf, ky.flip(0), kx.flip(0), anchors,
                                border_type)
    else:
        dev = str(g.device)
        vy, vx = _values([ky, kx])
        out = _launch_bands(
            name, "banded_blur_adjoint", gf[None], gf.shape,
            _adjoint_band_tables_cached((vy,), H, border_type, dev),
            _adjoint_band_tables_cached((vx,), W, border_type, dev))
    return out.reshape(B, C, H, W)


def _taps_along(x: torch.Tensor, kernel: torch.Tensor, border_type: str,
                dim: int) -> torch.Tensor:
    """x (N, H, W) correlated along `dim` (1 or 2) with a 1-D kernel under
    the border rule: Σ_k w[k, i] · x[..., idx[k, i], ...], the product with
    band_matrix without building it."""
    idx, w = _fold_taps(kernel.reshape(-1), x.shape[dim], border_type)
    shape = [1, 1, 1]
    shape[dim] = -1
    out = torch.zeros_like(x)
    for k in range(idx.shape[0]):
        out = out + w[k].reshape(shape) * x.index_select(dim, idx[k])
    return out


def _tap_grads(x: torch.Tensor, g: torch.Tensor, kernel_y: torch.Tensor,
               kernel_x: torch.Tensor, border_type: str, need_y: bool,
               need_x: bool):
    """Gradients of ``Sv · x · Shᵀ`` with respect to the 1-D kernels, in
    plain torch: the band operators' gradients (``_mm2_bwd``'s dsv, dsh)
    pulled back through the border fold, tap k of ky collecting
    Σ g[n, i, j] · (x Shᵀ)[n, idx[k, i], j] over the rows i the rule keeps
    (and likewise along the rows for kx)."""
    B, C, H, W = x.shape
    xf = x.reshape(B * C, H, W).to(torch.float32)
    gf = g.reshape(B * C, H, W).to(torch.float32)
    out = []
    for kern, need, dim in ((kernel_y, need_y, 1), (kernel_x, need_x, 2)):
        if not need:
            out.append(None)
            continue
        other = kernel_x if dim == 1 else kernel_y
        # x blurred along the other axis only
        part = _taps_along(xf, other.to(xf.device), border_type, 3 - dim)
        idx, valid = _fold_index(kern.numel(), x.shape[dim + 1], border_type,
                                 xf.device)
        red = (0, 2) if dim == 1 else (0, 1)
        grad = torch.stack([
            ((gf * part.index_select(dim, idx[k])).sum(red)
             * valid[k]).sum() for k in range(idx.shape[0])])
        out.append(grad.to(kern.device, kern.dtype).reshape(kern.shape))
    return out


class _FusedSeparableBlur(torch.autograd.Function):
    """Forward: the blur kernel on the card, the plain version on the CPU.
    Backward: the adjoint the same way for the input (the counterpart of
    ``_mm2_op``'s custom VJP), the taps' gradients in plain torch and only
    when asked for."""

    @staticmethod
    def forward(ctx, x, kernel_y, kernel_x, border_type):
        ctx.border_type = border_type
        taps = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        ctx.save_for_backward(x if taps else None, kernel_y, kernel_x)
        if _on_cpu(x):
            return fused_separable_blur2d_plain(x, kernel_y, kernel_x,
                                                border_type)
        B, C, H, W = x.shape
        K = (kernel_y.numel(), kernel_x.numel())
        out = _launch_separable(
            "fused_separable_blur2d",
            x.reshape(B * C, H, W).to(torch.float32).contiguous(), kernel_y,
            kernel_x, (K[0] // 2, K[1] // 2), border_type)
        return out.to(x.dtype).reshape(B, C, H, W)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        x, kernel_y, kernel_x = ctx.saved_tensors
        need_in, need_ky, need_kx = ctx.needs_input_grad[:3]
        dx = dky = dkx = None
        if need_in:
            dx = fused_separable_blur2d_adjoint(
                grad.contiguous(), kernel_y, kernel_x,
                ctx.border_type).to(grad.dtype)
        if need_ky or need_kx:
            dky, dkx = _tap_grads(x, grad, kernel_y, kernel_x,
                                  ctx.border_type, need_ky, need_kx)
        return dx, dky, dkx, None


def fused_separable_blur2d(x: torch.Tensor, kernel_y: torch.Tensor,
                           kernel_x: torch.Tensor,
                           border_type: str = "reflect") -> torch.Tensor:
    """Separable 2-D correlation of (B, C, H, W) with 1-D kernels and a
    border rule (reflect, replicate, circular, constant); one CUDA launch
    on the card, the plain version on the CPU. Differentiable in x and in
    the kernels on both devices."""
    if x.ndim != 4:
        raise ValueError(f"expected (B, C, H, W), got {tuple(x.shape)}")
    _check_border(border_type)
    return _FusedSeparableBlur.apply(x, kernel_y, kernel_x, border_type)


# -----------------------------------------------------------------------------
# multi_level_blur and its adjoint
# -----------------------------------------------------------------------------

@f32_matmul_precision
def _ml_plain(x: torch.Tensor, SV: torch.Tensor,
              SH: torch.Tensor) -> torch.Tensor:
    B, C, H, W = x.shape
    L = SV.shape[0]
    xf = x.reshape(B * C, H, W).to(torch.float32)
    acc = torch.einsum("lih,nhw->lniw", SV, xf)
    out = torch.einsum("lniw,ljw->lnij", acc, SH)
    return out.reshape(L, B, C, H, W).to(x.dtype)


def _operators(kernels_y, kernels_x, H: int, W: int, border_type: str,
               device: str):
    return (_cumulative_cached(_values(kernels_y), H, border_type, device),
            _cumulative_cached(_values(kernels_x), W, border_type, device))


def multi_level_blur_plain(x: torch.Tensor, kernels_y, kernels_x,
                           border_type: str = "replicate") -> torch.Tensor:
    """Plain version: dense cumulative operators (the ``xla`` variant),
    built once per (kernels, size, border, device)."""
    H, W = x.shape[-2:]
    SV, SH = _operators(kernels_y, kernels_x, H, W, border_type,
                        str(x.device))
    return _ml_plain(x, SV, SH)


@f32_matmul_precision
def multi_level_blur_adjoint_plain(g: torch.Tensor, kernels_y, kernels_x,
                                   border_type: str = "replicate"
                                   ) -> torch.Tensor:
    """Plain version of the adjoint: ``Σ_l SV_lᵀ g_l SH_l`` with the dense
    cumulative operators in true f32 (``_ml_bwd``'s dx). g (L, B, C, H, W)
    → f32 (B, C, H, W)."""
    L, B, C, H, W = g.shape
    SV, SH = _operators(kernels_y, kernels_x, H, W, border_type,
                        str(g.device))
    gf = g.reshape(L, B * C, H, W).to(torch.float32)
    acc = torch.einsum("lhi,lnhw->lniw", SV, gf)
    out = torch.einsum("lniw,lwj->nij", acc, SH)
    return out.reshape(B, C, H, W)


def _check_levels(name: str, kernels_y, kernels_x) -> None:
    L = len(kernels_y)
    if not 1 <= L <= _MAX_LEVELS or len(kernels_x) != L:
        raise ValueError(f"{name}: expects 1..{_MAX_LEVELS} kernels per "
                         f"axis, got {L} and {len(kernels_x)}")


def multi_level_blur_adjoint(g: torch.Tensor, kernels_y, kernels_x,
                             border_type: str = "replicate") -> torch.Tensor:
    """Adjoint of `multi_level_blur` with respect to its base: g (L, B, C,
    H, W) → f32 (B, C, H, W), ``dx = Σ_l SV_lᵀ g_l SH_l``. One CUDA launch
    on the card, which reads the transposed cumulative operators as bands
    (built once per kernels, size, border and device) and sums the levels
    inside the launch: in each tile's block on the tiled route, in the
    second pass on the passes' route."""
    if g.ndim != 5:
        raise ValueError(f"expected (L, B, C, H, W), got {tuple(g.shape)}")
    _check_border(border_type)
    if _on_cpu(g):
        return multi_level_blur_adjoint_plain(g, kernels_y, kernels_x,
                                              border_type)
    name = "multi_level_blur_adjoint"
    _check_levels(name, kernels_y, kernels_x)
    L, B, C, H, W = g.shape
    dev = str(g.device)
    gf = g.reshape(L, B * C, H, W).to(torch.float32).contiguous()
    out = _launch_bands(
        name, "banded_blur_adjoint", gf, (B * C, H, W),
        _adjoint_band_tables_cached(_values(kernels_y), H, border_type, dev),
        _adjoint_band_tables_cached(_values(kernels_x), W, border_type, dev))
    return out.reshape(B, C, H, W)


class _MultiLevelBlur(torch.autograd.Function):
    """Forward: the multi-level kernel on the card, the plain version on
    the CPU. Backward: the adjoint the same way (``_ml_op``'s custom VJP);
    the kernels are static (the pyramid's sigmas), so they get no
    gradient, as the reference gives them zeros."""

    @staticmethod
    def forward(ctx, x, kernels_y, kernels_x, border_type):
        ctx.blur = (kernels_y, kernels_x, border_type)
        if _on_cpu(x):
            return multi_level_blur_plain(x, kernels_y, kernels_x,
                                          border_type)
        name = "multi_level_blur"
        B, C, H, W = x.shape
        L = len(kernels_y)
        dev = str(x.device)
        xf = x.reshape(B * C, H, W).to(torch.float32).contiguous()
        out = _launch_bands(
            name, "banded_blur", xf, (L, B * C, H, W),
            _band_tables_cached(_values(kernels_y), H, border_type, dev),
            _band_tables_cached(_values(kernels_x), W, border_type, dev))
        return out.reshape(L, B, C, H, W).to(x.dtype)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        kernels_y, kernels_x, border_type = ctx.blur
        dx = multi_level_blur_adjoint(grad.contiguous(), kernels_y,
                                      kernels_x, border_type)
        return dx.to(grad.dtype), None, None, None


def multi_level_blur(x: torch.Tensor, kernels_y, kernels_x,
                     border_type: str = "replicate") -> torch.Tensor:
    """All L blur levels of a pyramid octave at once: (B, C, H, W) base and
    L incremental 1-D kernels per axis → (L, B, C, H, W), level l being the
    sequential blur chain up to kernel l (exactly: the cumulative operators
    fold each step's border rule). The kernels may be host tensors; their
    band tables are built once per (kernels, size, border, device).
    Differentiable in x on both devices (the kernels are constants)."""
    if x.ndim != 4:
        raise ValueError(f"expected (B, C, H, W), got {tuple(x.shape)}")
    _check_border(border_type)
    if not _on_cpu(x, *kernels_y, *kernels_x):
        _check_levels("multi_level_blur", kernels_y, kernels_x)
    return _MultiLevelBlur.apply(x, kernels_y, kernels_x, border_type)


# -----------------------------------------------------------------------------
# patch_sample
# -----------------------------------------------------------------------------

def patch_sample_plain(atlas: torch.Tensor, px: torch.Tensor,
                       py: torch.Tensor, mode: str = "split") -> torch.Tensor:
    """Plain version: bilinear samples of a (H, W) atlas at pixel
    coordinates (N, S), 'border' rule (coordinates clamped into the atlas,
    second tap clamped to the last row/column). 'split' and 'highest' are
    exact; 'bf16' rounds as the TPU's default-precision row pass does: the
    y weights and the texels to bf16, their products exact and summed in
    f32 per column, then the x interpolation in f32."""
    H, W = atlas.shape
    x = px.clamp(0.0, W - 1.0)
    y = py.clamp(0.0, H - 1.0)
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    tx = x - x0f
    ty = y - y0f
    x0 = x0f.long()
    y0 = y0f.long()
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    flat = atlas.reshape(-1)
    v00 = flat[y0 * W + x0]
    v01 = flat[y0 * W + x1]
    v10 = flat[y1 * W + x0]
    v11 = flat[y1 * W + x1]
    if _PATCH_MODES[mode]:
        def bf16(t):
            return t.to(torch.bfloat16).to(torch.float32)
        wy0 = bf16(1.0 - ty)
        wy1 = bf16(ty)
        p0 = wy0 * bf16(v00) + wy1 * bf16(v10)
        p1 = wy0 * bf16(v01) + wy1 * bf16(v11)
        return p0 * (1.0 - tx) + p1 * tx
    top = v00 * (1.0 - tx) + v01 * tx
    bot = v10 * (1.0 - tx) + v11 * tx
    return top * (1.0 - ty) + bot * ty


def patch_sample(atlas: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
                 mode: str = "split") -> torch.Tensor:
    """Bilinear-sample S points per keypoint from a (H, W) f32 atlas:
    px, py (N, S) absolute pixel coordinates → (N, S). `mode` is the TPU
    kernel's: 'split' and 'highest' sample exactly, 'bf16' with its
    rounding (kernel "patch_sample[bf16]"). Differentiable on the CPU
    only: the kernel, like the TPU kernel it replaces, has no backward, so
    on the card it refuses inputs that require grad while grad is on."""
    if atlas.ndim != 2 or px.ndim != 2 or px.shape != py.shape:
        raise ValueError(f"expected atlas (H, W) and px, py (N, S), got "
                         f"{tuple(atlas.shape)}, {tuple(px.shape)}, "
                         f"{tuple(py.shape)}")
    if mode not in _PATCH_MODES:
        raise ValueError(f"unknown patch_sample mode {mode!r}")
    if _on_cpu(atlas, px, py):
        return patch_sample_plain(atlas, px, py, mode)
    name = "patch_sample[bf16]" if _PATCH_MODES[mode] else "patch_sample"
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (atlas, px, py)):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward (the TPU kernel has "
            f"none either); detach the inputs or sample under "
            f"torch.no_grad()")
    _require_cuda(name, atlas, px, py)
    if atlas.dtype != torch.float32 or px.dtype != torch.float32 \
            or py.dtype != torch.float32:
        raise TypeError("patch_sample expects f32 atlas and coordinates")
    H, W = atlas.shape
    if not 0 < H * W < 2 ** 31:
        raise ValueError(f"{name}: a {H}x{W} atlas is empty or exceeds the "
                         f"kernel's 32-bit texel offsets")
    n = px.numel()
    if n == 0:
        return torch.empty_like(px)  # nothing to sample: no launch
    # the output starts on px's 8-byte parity, so that the kernel's 8-byte
    # loads and stores line up (csrc/patch_sample.cu)
    shift = (px.data_ptr() // 4) % 2
    out = torch.empty(n + 1, dtype=torch.float32,
                      device=px.device)[shift:shift + n].view(px.shape)
    head, pairs = _patch_plan(n, px.data_ptr(), py.data_ptr(), out.data_ptr())
    with torch.cuda.device(atlas.device):
        sms = torch.cuda.get_device_properties(
            atlas.device).multi_processor_count
        err = _fn("patch_sample")(atlas.data_ptr(), H, W, px.data_ptr(),
                                  py.data_ptr(), out.data_ptr(), n, head,
                                  pairs, sms, int(_PATCH_MODES[mode]),
                                  _stream(atlas))
    _check_launch(name, err)
    return out


def _patch_plan(total: int, px_ptr: int, py_ptr: int,
                out_ptr: int) -> Tuple[int, int]:
    """How csrc/patch_sample.cu splits `total` samples: (head, pairs).
    Samples [head, head + 2 * pairs) go two a thread through 8-byte loads
    and stores, the head and the tail one a thread. A stream that starts
    on an odd 4-byte offset has a head of one sample; px, py and out on
    different 8-byte parities take the one-a-thread loop throughout."""
    if px_ptr % 4 or py_ptr % 4 or out_ptr % 4:
        raise ValueError("patch_sample: streams not 4-byte aligned")
    parity = {p // 4 % 2 for p in (px_ptr, py_ptr, out_ptr)}
    if len(parity) > 1:
        return 0, 0
    head = min(total, parity.pop())
    return head, (total - head) // 2


# -----------------------------------------------------------------------------
# streaming_min2
# -----------------------------------------------------------------------------

@f32_matmul_precision
def streaming_min2_plain(d1: torch.Tensor, d2: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: the full (N, M) squared-L2 matrix n1 + n2 - 2·d1·d2ᵀ
    (clamped at 0) in true f32, then per row the minimum, its first index
    and the minimum with that one entry masked (1e9 when M = 1)."""
    a = d1.to(torch.float32)
    b = d2.to(torch.float32)
    dm = ((a * a).sum(-1)[:, None] + (b * b).sum(-1)[None, :]
          - 2.0 * (a @ b.T)).clamp_min(0.0)
    m1, idx = dm.min(dim=-1)
    m2 = dm.scatter(-1, idx[:, None], _BIG).min(dim=-1).values
    return m1, m2, idx


def streaming_min2(d1: torch.Tensor, d2: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per row of d1 (N, D): the smallest and second-smallest squared L2
    distance to the rows of d2 (M, D), and the index of the smallest (the
    first among equal minima; an equal second minimum counts as the second
    smallest). → (min1 (N,) f32, min2 (N,) f32, argmin (N,) int64). On the
    card one launch that never stores the (N, M) matrix; any N and M."""
    if d1.ndim != 2 or d2.ndim != 2 or d1.shape[1] != d2.shape[1]:
        raise ValueError(f"expected d1 (N, D) and d2 (M, D), got "
                         f"{tuple(d1.shape)} and {tuple(d2.shape)}")
    if d2.shape[0] == 0:
        raise ValueError("streaming_min2: d2 has no rows")
    if _on_cpu(d1, d2):
        return streaming_min2_plain(d1, d2)
    name = "streaming_min2"
    a = d1.to(torch.float32).contiguous()
    b = d2.to(torch.float32).contiguous()
    _require_cuda(name, a, b)
    (N, D), M = a.shape, b.shape[0]
    if N == 0:
        empty = a.new_empty(0)
        return empty, empty, torch.empty(0, dtype=torch.long,
                                         device=a.device)
    # cut d2's rows into ranges of whole tiles, enough of them for about
    # four blocks per SM
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    col_tiles = -(-M // _MIN2_TILE)
    wanted = min(col_tiles, max(1, -(-4 * sms // -(-N // _MIN2_TILE))))
    span = -(-col_tiles // wanted) * _MIN2_TILE
    splits = -(-M // span)
    f32 = dict(dtype=torch.float32, device=a.device)
    norms = torch.empty(N + M, **f32)
    part = torch.empty((2, splits, N), **f32)
    part_idx = torch.empty((splits, N), dtype=torch.int32, device=a.device)
    mins = torch.empty((2, N), **f32)
    idx = torch.empty(N, dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        err = _fn("streaming_min2")(
            a.data_ptr(), b.data_ptr(), norms.data_ptr(),
            norms[N:].data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            part_idx.data_ptr(), mins[0].data_ptr(), mins[1].data_ptr(),
            idx.data_ptr(), N, M, D, splits, span, _stream(a))
    _check_launch(name, err)
    return mins[0], mins[1], idx.long()
