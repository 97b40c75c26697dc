"""Contributed operators (counterpart of ``kornia_tpu/contrib/ops.py``):
connected components by label propagation, the convolutional distance
transform, diamond-square plasma fractals, tensor patches and their
inverse, histogram matching and batched k-means.

The iterative operators (``connected_components``, ``distance_transform``,
``kmeans``) run a fixed number of steps with no host read, as the
reference's scans do; k-means' one-hot products run in true float32.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.check import check_shape
from ..core.dtype import as_float, float32_on, true_div
from ..core.linalg import f32_matmul_precision
from ..ops.warp import resize

__all__ = ["connected_components", "distance_transform", "diamond_square",
           "extract_tensor_patches", "combine_tensor_patches",
           "histogram_matching", "KMeans", "kmeans", "compute_padding",
           "interp", "Lambda"]

Device = Union[str, torch.device]


def diamond_square(
    output_size: Tuple[int, int, int, int],
    roughness: float = 0.7,
    random_scale: float = 1.0,
    generator: Optional[torch.Generator] = None,
    normalize_range: Optional[Tuple[float, float]] = (0.0, 1.0),
    *,
    draws: Optional[Sequence[torch.Tensor]] = None,
    device: Device = "cuda",
) -> torch.Tensor:
    """Plasma fractal (B, C, H, W): a 2x2 uniform seed, upsampled
    (bilinear, corners aligned) level by level with uniform noise scaled by
    `roughness` per level, then resized to (H, W) and normalised per map.

    The uniform draws come from `generator` (None: a generator seeded with
    0, as the reference's default key), or are injected as `draws`: the
    (B, C, 2, 2) seed followed by one draw of each level's shape."""
    B, C, H, W = output_size
    levels = (max(1, math.ceil(math.log2(max(H, W) - 1)))
              if max(H, W) > 1 else 1)
    if draws is None and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    n = [0]

    def uniform(shape):
        if draws is not None:
            u = float32_on(draws[n[0]], device)
            if tuple(u.shape) != tuple(shape):
                raise ValueError(f"draw {n[0]} must be {tuple(shape)}, got "
                                 f"{tuple(u.shape)}")
        else:
            u = torch.rand(shape, generator=generator, device=device)
        n[0] += 1
        return u

    size = 2
    img = uniform((B, C, 2, 2)) * random_scale
    scale = random_scale
    for _ in range(levels):
        size = min(2 * size - 1, max(H, W))
        img = resize(img, (size, size), "bilinear", align_corners=True)
        scale = scale * roughness
        img = img + (uniform(img.shape) - 0.5) * scale
    img = resize(img, (H, W), "bilinear", align_corners=True)
    if normalize_range is not None:
        lo, hi = normalize_range
        mn = img.amin(dim=(-2, -1), keepdim=True)
        mx = img.amax(dim=(-2, -1), keepdim=True)
        img = (img - mn) / (mx - mn).clamp_min(1e-8) * (hi - lo) + lo
    return img


def connected_components(image: torch.Tensor, num_iterations: int = 100
                         ) -> torch.Tensor:
    """Labels of a binary (B, 1, H, W) image by `num_iterations` steps of
    3x3 max propagation: each component carries the largest flat index +
    1 of its pixels (0 is background)."""
    check_shape(image, ["B", "1", "H", "W"], "image")
    image = as_float(image)
    H, W = image.shape[-2:]
    mask = image > 0.5
    labels = (torch.arange(H * W, dtype=torch.float32, device=image.device)
              .reshape(1, 1, H, W) + 1.0) * mask
    for _ in range(num_iterations):
        labels = torch.where(mask, F.max_pool2d(labels, 3, 1, 1), 0.0)
    return labels


def distance_transform(image: torch.Tensor, kernel_size: int = 3,
                       h: float = 0.35) -> torch.Tensor:
    """Convolutional (soft) distance transform of a (B, C, H, W) image,
    zero the background: the approximate distance to the nearest nonzero
    pixel, after ceil(max(H, W) / (k // 2)) steps."""
    from ..ops.filters import filter2d
    image = as_float(image)
    H, W = image.shape[-2:]
    n_iters = -(-max(H, W) // (kernel_size // 2))
    ar = torch.arange(kernel_size, dtype=image.dtype, device=image.device)
    grid = torch.stack(torch.meshgrid(ar, ar, indexing="ij"), -1)
    center = (kernel_size - 1) / 2.0
    kernel = torch.exp(-torch.linalg.vector_norm(grid - center, dim=-1)
                       / h)[None]
    bound = 1e4
    out = torch.zeros_like(image)
    boundary = image
    for i in range(n_iters):
        signal = filter2d(boundary, kernel, border_type="constant")
        near = signal > 1e-6
        cdt = torch.where(near, -h * torch.log(signal.clamp_min(1e-12)),
                          bound).clamp_min(0.0)
        out = out + (cdt + i * (kernel_size // 2)) * (out == 0) * (cdt < bound)
        boundary = torch.where(near, torch.ones_like(boundary), boundary)
    return out * (image <= 0.5)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def extract_tensor_patches(input: torch.Tensor, window_size, stride=1,
                           padding: int = 0) -> torch.Tensor:
    """(B, C, H, W) → (B, L, C, h, w) sliding windows, row-major."""
    x = as_float(input)
    wh, ww = _pair(window_size)
    sh, sw = _pair(stride)
    if padding:
        x = F.pad(x, (padding, padding, padding, padding))
    B, C = x.shape[:2]
    p = x.unfold(2, wh, sh).unfold(3, ww, sw)  # (B, C, ny, nx, wh, ww)
    return p.permute(0, 2, 3, 1, 4, 5).reshape(B, -1, C, wh, ww)


def combine_tensor_patches(patches: torch.Tensor, original_size,
                           window_size, stride,
                           allow_auto_unpadding: bool = False
                           ) -> torch.Tensor:
    """Inverse of `extract_tensor_patches`: overlapping windows averaged,
    uncovered pixels 0 (`allow_auto_unpadding` has no effect, as in the
    reference)."""
    H, W = _pair(original_size)
    wh, ww = _pair(window_size)
    sh, sw = _pair(stride)
    B, L, C = patches.shape[:3]
    cols = patches.reshape(B, L, C * wh * ww).transpose(1, 2)
    out = F.fold(cols, (H, W), (wh, ww), stride=(sh, sw))
    cnt = F.fold(torch.ones_like(cols[:1, :wh * ww]), (H, W), (wh, ww),
                 stride=(sh, sw))
    return out / cnt.clamp_min(1.0)


def histogram_matching(source: torch.Tensor,
                       template: torch.Tensor) -> torch.Tensor:
    """Each source value replaced by the template's quantile at its rank
    (stable sorts; linear between template samples)."""
    source = as_float(source)
    template = as_float(template)
    src = source.reshape(-1)
    tmpl = torch.sort(template.reshape(-1), stable=True).values
    ranks = torch.argsort(torch.argsort(src, stable=True), stable=True)
    n_src, n_tmp = src.shape[0], tmpl.shape[0]
    pos = true_div(ranks.to(source.dtype) * (n_tmp - 1), max(n_src - 1, 1))
    lo = torch.floor(pos).long()
    hi = (lo + 1).clamp_max(n_tmp - 1)
    w = pos - lo
    return (tmpl[lo] * (1 - w) + tmpl[hi] * w).reshape(source.shape)


@f32_matmul_precision
def _lloyd(x: torch.Tensor, centers: torch.Tensor, num_iters: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    K = centers.shape[0]
    classes = torch.arange(K, device=x.device)
    for _ in range(num_iters):
        assign = ((x[:, None, :] - centers[None]) ** 2).sum(-1).argmin(-1)
        oh = (assign[:, None] == classes).to(x.dtype)
        counts = oh.sum(0)
        new = (oh.T @ x) / counts[:, None].clamp_min(1.0)
        centers = torch.where(counts[:, None] > 0, new, centers)
    return centers, ((x[:, None, :] - centers[None]) ** 2).sum(-1).argmin(-1)


def kmeans(x: torch.Tensor, num_clusters: int,
           generator: Optional[torch.Generator] = None, num_iters: int = 20,
           *, draws: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd's k-means of (N, D) points: (centres (K, D), assignments
    (N,)). The initial centres are K distinct points, drawn from
    `generator` (None: one seeded with 0, as the reference's default key)
    or injected as `draws`, their (K,) indices."""
    x = as_float(x)
    if draws is None:
        if generator is None:
            generator = torch.Generator(device=x.device).manual_seed(0)
        draws = torch.randperm(x.shape[0], generator=generator,
                               device=generator.device)[:num_clusters]
    return _lloyd(x, x[torch.as_tensor(draws, device=x.device)], num_iters)


class KMeans:
    """k-means with state: `fit` finds the centres, `predict` assigns."""

    def __init__(self, num_clusters: int, tolerance: float = 1e-4,
                 max_iterations: int = 20, seed: int = 0):
        self.num_clusters = num_clusters
        self.max_iterations = max_iterations
        self.seed = seed
        self.cluster_centers: Optional[torch.Tensor] = None

    def fit(self, x: torch.Tensor, *,
            draws: Optional[torch.Tensor] = None) -> None:
        """Centres from a generator seeded with `seed`, or from the
        injected initial indices `draws`."""
        gen = None
        if draws is None:
            gen = torch.Generator(device=x.device).manual_seed(self.seed)
        self.cluster_centers, self._assignments = kmeans(
            x, self.num_clusters, gen, self.max_iterations, draws=draws)

    def predict(self, x: torch.Tensor) -> torch.Tensor:
        return ((x[:, None, :] - self.cluster_centers[None]) ** 2).sum(
            -1).argmin(-1)


def compute_padding(original_size, window_size, stride=None):
    """(top, bottom, left, right) padding after which windows of
    `window_size` at `stride` tile the image."""
    oh, ow = _pair(original_size)
    wh, ww = _pair(window_size)
    sh, sw = _pair(stride if stride is not None else window_size)
    rv = (oh - wh) % sh
    rh = (ow - ww) % sw
    vp = sh - rv if rv else 0
    hp = sw - rh if rh else 0
    top, left = vp // 2, hp // 2
    return (top, vp - top, left, hp - left)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
           ) -> torch.Tensor:
    """1-D linear interpolation with ``numpy.interp``'s semantics (ends
    held), computed as ``jnp.interp`` computes it."""
    x, xp, fp = as_float(x), as_float(xp), as_float(fp)
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.shape[0] - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    # a zero step takes the left value (no NaN), below spacing(eps)
    np_dtype = torch.empty(0, dtype=xp.dtype).numpy().dtype
    dx0 = dx.abs() <= float(np.spacing(np.finfo(np_dtype).eps))
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class Lambda:
    """Any callable as a module."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    forward = __call__
