"""SOLD2, the line-segment detector, descriptor and matcher (counterpart of
``kornia_tpu/feature/sold2.py``).

- The stacked-hourglass ``SOLD2Net`` gives the junction map (a
  pixel-shuffled SuperPoint head), the line heatmap and semi-dense
  descriptors; the hourglass's upsampling is ``jax.image``'s nearest rule
  to the skip branch's exact (possibly odd) size.
- Junctions are a fixed-K stable top-k with a validity mask; every pair of
  junctions is verified at once: `num_samples` points along each of the
  (K, K) candidate segments, sampled from the heatmap bilinearly or by the
  local maximum in a circle whose radius grows with the segment's length
  (chunks of ``SAMPLE_CHUNK`` samples, summed in the reference's order);
  candidate suppression is a dense (K, K, K) point-to-segment test.
- Segments are padded (L, 2, 2) ij endpoints with a mask, ranked by their
  mean activation; the endpoint refinement perturbs both endpoints over a
  9⁴ grid (chunks of ``REFINE_CHUNK`` segments, the first best candidate
  kept).
- The Needleman-Wunsch matcher scores every pair of lines with the S x S
  recurrence unrolled on (2, N1, N2) planes (both directions of line 2),
  as plain tensor code.

The net is an ``nn.Module`` on NCHW tensors whose weights are frozen
parameters under the reference checkpoint's names (``backbone_net.net.
conv1.weight``, ...); built without parameters, they are drawn from a CPU
generator seeded with 0. ``convert.sold2_from_numpy`` carries the JAX
variables across. Nothing in a forward reads a tensor back to the host.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.check import check
from ..core.dtype import as_float, host_tensor, true_div
from ..core.grid import linspace
from ..core.linalg import f32_matmul_precision
from ..core.sort import top_k as _top_k
from ..geometry.subpix import nms2d
from ..ops.warp import _resize_nearest
from . import _nets
from ._nets import Row, bn, bn_rows, conv, conv_rows

__all__ = ["SOLD2Net", "SOLD2_detector", "SOLD2", "detect_line_segments",
           "refine_segments_perturb", "prob_to_junctions", "match_lines_nw",
           "adjacency_to_segments", "load_torch_weights"]

Device = Union[str, torch.device]

# samples along the (K, K) candidate segments taken at once by the local
# maximum sampling, and segments refined at once: each chunk's largest
# tensors are K² x 29 x 16 and 32 x 9⁴ x 64 float32 (465 MB and 54 MB at
# K = 250)
SAMPLE_CHUNK = 16
REFINE_CHUNK = 32


# ---------------------------------------------------------------------------
# the net
# ---------------------------------------------------------------------------

def _bottleneck_rows(name: str, cin: int, planes: int, downsample: bool,
                     fp: Sequence[str]) -> List[Row]:
    """Pre-activation bottleneck (expansion 2): bn1 on the input, then
    1x1, 3x3 and 1x1 convolutions each after a BN-ReLU."""
    rows = bn_rows(f"{name}.bn1", cin, (*fp, "bn1"))
    rows += conv_rows(f"{name}.conv1", planes, cin, 1, (*fp, "conv1"))
    rows += bn_rows(f"{name}.bn2", planes, (*fp, "bn2"))
    rows += conv_rows(f"{name}.conv2", planes, planes, 3, (*fp, "conv2"))
    rows += bn_rows(f"{name}.bn3", planes, (*fp, "bn3"))
    rows += conv_rows(f"{name}.conv3", 2 * planes, planes, 1, (*fp, "conv3"))
    if downsample:
        rows += conv_rows(f"{name}.downsample.0", 2 * planes, cin, 1,
                          (*fp, "downsample"))
    return rows


def _param_rows(grid_size: int = 8, depth: int = 4, num_stacks: int = 2,
                desc_dim: int = 128, fp: Sequence[str] = ()) -> List[Row]:
    net = "backbone_net.net"
    rows = conv_rows(f"{net}.conv1", 64, 1, 7, (*fp, "conv1"))
    rows += bn_rows(f"{net}.bn1", 64, (*fp, "bn1"))
    rows += _bottleneck_rows(f"{net}.layer1.0", 64, 64, True,
                             (*fp, "layer1"))
    rows += _bottleneck_rows(f"{net}.layer2.0", 128, 128, True,
                             (*fp, "layer2"))
    rows += _bottleneck_rows(f"{net}.layer3.0", 256, 128, False,
                             (*fp, "layer3"))
    for i in range(num_stacks):
        for level in range(depth):
            for k in ((0, 1, 2, 3) if level == 0 else (0, 1, 2)):
                rows += _bottleneck_rows(
                    f"{net}.hg.{i}.hg.{level}.{k}.0", 256, 128, False,
                    (*fp, f"hg{i}", f"hg{level}_{k}"))
        rows += _bottleneck_rows(f"{net}.res.{i}.0", 256, 128, False,
                                 (*fp, f"res{i}"))
        rows += conv_rows(f"{net}.fc.{i}.0", 256, 256, 1, (*fp, f"fc{i}_conv"))
        rows += bn_rows(f"{net}.fc.{i}.1", 256, (*fp, f"fc{i}_bn"))
        for j, out in enumerate((2, 1, 2)):
            rows += conv_rows(f"{net}.score.{i}.heads.{j}.0", 64, 256, 3,
                              (*fp, f"score{i}", f"head{j}_0"))
            rows += conv_rows(f"{net}.score.{i}.heads.{j}.2", out, 64, 1,
                              (*fp, f"score{i}", f"head{j}_2"))
        if i < num_stacks - 1:
            rows += conv_rows(f"{net}.fc_.{i}", 256, 256, 1, (*fp, f"fc_{i}"))
            rows += conv_rows(f"{net}.score_.{i}", 256, 5, 1,
                              (*fp, f"score_{i}"))
    g2 = grid_size * grid_size
    rows += conv_rows("junction_decoder.convPa", 256, 256, 3,
                      (*fp, "junc_convPa"))
    rows += conv_rows("junction_decoder.convPb", g2 + 1, 256, 1,
                      (*fp, "junc_convPb"))
    hd = "heatmap_decoder.conv_block_lst"
    rows += conv_rows(f"{hd}.0.0", 256, 256, 3, (*fp, "heat_conv0"))
    rows += bn_rows(f"{hd}.0.1", 256, (*fp, "heat_bn0"))
    rows += conv_rows(f"{hd}.1.0", 64, 64, 3, (*fp, "heat_conv1"))
    rows += bn_rows(f"{hd}.1.1", 64, (*fp, "heat_bn1"))
    rows += conv_rows(f"{hd}.2.0", 2, 16, 1, (*fp, "heat_out"))
    rows += conv_rows("descriptor_decoder.convPa", 256, 256, 3,
                      (*fp, "desc_convPa"))
    rows += conv_rows("descriptor_decoder.convPb", desc_dim, 256, 1,
                      (*fp, "desc_convPb"))
    return rows


def load_torch_weights(state_dict, num_stacks: int = 2, depth: int = 4
                       ) -> Dict[str, np.ndarray]:
    """A reference SOLD2Net state dict (after the reference's
    ``adapt_state_dict``) → the port's param dict (the checkpoint's names,
    float32 arrays, each shape checked)."""
    return _nets.check_params(
        _param_rows(depth=depth, num_stacks=num_stacks), state_dict)


def _bottleneck(p: Mapping, name: str, x: torch.Tensor,
                downsample: bool = False) -> torch.Tensor:
    y = conv(p, f"{name}.conv1", F.relu(bn(p, f"{name}.bn1", x)))
    y = conv(p, f"{name}.conv2", F.relu(bn(p, f"{name}.bn2", y)), padding=1)
    y = conv(p, f"{name}.conv3", F.relu(bn(p, f"{name}.bn3", y)))
    return y + (conv(p, f"{name}.downsample.0", x) if downsample else x)


def _hourglass(p: Mapping, pre: str, x: torch.Tensor,
               depth: int) -> torch.Tensor:
    def walk(n, x):
        up1 = _bottleneck(p, f"{pre}.hg.{n - 1}.0.0", x)
        low = _bottleneck(p, f"{pre}.hg.{n - 1}.1.0", F.max_pool2d(x, 2))
        low = (walk(n - 1, low) if n > 1
               else _bottleneck(p, f"{pre}.hg.{n - 1}.3.0", low))
        low = _bottleneck(p, f"{pre}.hg.{n - 1}.2.0", low)
        return up1 + _resize_nearest(low, *up1.shape[-2:])

    return walk(depth, x)


@f32_matmul_precision
def _net_forward(p: Mapping, x: torch.Tensor, grid_size: int, depth: int,
                 num_stacks: int) -> Dict[str, torch.Tensor]:
    net = "backbone_net.net"
    y = F.relu(bn(p, f"{net}.bn1", conv(p, f"{net}.conv1", x, 2, 3)))
    y = _bottleneck(p, f"{net}.layer1.0", y, True)
    y = F.max_pool2d(y, 2)
    y = _bottleneck(p, f"{net}.layer2.0", y, True)
    y = _bottleneck(p, f"{net}.layer3.0", y)
    feat = y
    for i in range(num_stacks):
        h = _hourglass(p, f"{net}.hg.{i}", y, depth)
        h = _bottleneck(p, f"{net}.res.{i}.0", h)
        h = F.relu(bn(p, f"{net}.fc.{i}.1", conv(p, f"{net}.fc.{i}.0", h)))
        score = torch.cat([conv(p, f"{net}.score.{i}.heads.{j}.2", F.relu(
            conv(p, f"{net}.score.{i}.heads.{j}.0", h, padding=1)))
            for j in range(3)], 1)
        feat = h
        if i < num_stacks - 1:
            y = y + conv(p, f"{net}.fc_.{i}", h) \
                + conv(p, f"{net}.score_.{i}", score)
    g2 = grid_size * grid_size
    j = F.relu(conv(p, "junction_decoder.convPa", feat, 2, 1))
    j_prob = torch.softmax(conv(p, "junction_decoder.convPb", j), 1)[:, :g2]
    junctions = F.pixel_shuffle(j_prob, grid_size)[:, 0]
    hd = "heatmap_decoder.conv_block_lst"
    h = F.relu(bn(p, f"{hd}.0.1", conv(p, f"{hd}.0.0", feat, padding=1)))
    h = F.pixel_shuffle(h, 2)
    h = F.relu(bn(p, f"{hd}.1.1", conv(p, f"{hd}.1.0", h, padding=1)))
    h = F.pixel_shuffle(h, 2)
    heatmap = torch.softmax(conv(p, f"{hd}.2.0", h), 1)[:, 1]
    d = F.relu(conv(p, "descriptor_decoder.convPa", feat, padding=1))
    desc = conv(p, "descriptor_decoder.convPb", d)
    return {"junctions": junctions, "heatmap": heatmap, "dense_desc": desc}


class SOLD2Net(nn.Module):
    """The stacked-hourglass SOLD2 network: (B, 1, H, W), H and W
    multiples of 16 → {"junctions": (B, H, W), "heatmap": (B, H, W),
    "dense_desc": (B, desc_dim, H/4, W/4)}, the softmaxes applied.
    `parent` and `name` are flax's module-tree arguments, accepted for the
    reference's signature and unused; the weights are drawn from a
    generator seeded with 0 (``_nets.make`` builds one from a param
    dict)."""

    def __init__(self, grid_size: int = 8, depth: int = 4,
                 num_stacks: int = 2, desc_dim: int = 128, parent=None,
                 name: Optional[str] = None, device: Device = "cuda"):
        super().__init__()
        self._setup(grid_size, depth, num_stacks, desc_dim, None, None,
                    device)

    def _setup(self, grid_size, depth, num_stacks, desc_dim, params,
               generator, device):
        self.grid_size, self.depth, self.num_stacks = (grid_size, depth,
                                                       num_stacks)
        _nets.with_params(self, _param_rows(grid_size, depth, num_stacks,
                                            desc_dim), params, device,
                          generator)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        return _net_forward(dict(self.named_parameters()), as_float(x),
                            self.grid_size, self.depth, self.num_stacks)


# ---------------------------------------------------------------------------
# line detection
# ---------------------------------------------------------------------------

def _bilinear_hw(img: torch.Tensor, y: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """Bilinearly sample `img` (H, W) or (H, W, D) at float ij coordinates
    of any shape, clamped to the image (→ y.shape, or y.shape + (D,))."""
    H, W = img.shape[:2]
    y = y.clamp(0.0, H - 1.0)
    x = x.clamp(0.0, W - 1.0)
    y0, x0 = torch.floor(y), torch.floor(x)
    y1 = torch.clamp_max(y0 + 1, H - 1.0)
    x1 = torch.clamp_max(x0 + 1, W - 1.0)
    wy, wx = y - y0, x - x0
    if img.ndim == 3:
        wy, wx = wy[..., None], wx[..., None]
    y0i, y1i, x0i, x1i = y0.long(), y1.long(), x0.long(), x1.long()
    return (img[y0i, x0i] * (1 - wy) * (1 - wx)
            + img[y0i, x1i] * (1 - wy) * wx
            + img[y1i, x0i] * wy * (1 - wx)
            + img[y1i, x1i] * wy * wx)


def prob_to_junctions(prob: torch.Tensor, max_junctions: int = 250,
                      thresh: float = 1 / 65, nms_size: int = 5
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W) junction probability → ((K, 2) ij coordinates, (K,)
    validity): strict NMS, then a stable top-K."""
    H, W = prob.shape
    nmsed = nms2d(prob[None, None], (nms_size, nms_size))[0, 0]
    vals, idx = _top_k(nmsed.reshape(-1), max_junctions)
    ys = torch.div(idx, W, rounding_mode="floor").to(prob.dtype)
    xs = (idx % W).to(prob.dtype)
    return torch.stack([ys, xs], -1), vals > thresh


def _refine_heatmap(heatmap: torch.Tensor, ratio: float = 0.2,
                    valid_thresh: float = 1e-2) -> torch.Tensor:
    """Divide by the mean of the top `ratio` share of the activations above
    `valid_thresh` (a sort and one gather of the cumulative sum, on the
    device), clipped to [0, 1]."""
    flat = heatmap.reshape(-1)
    sorted_desc = torch.sort(flat, descending=True).values
    n_valid = (flat > valid_thresh).sum()
    k = torch.clamp_min(torch.ceil(n_valid * ratio).to(torch.int64), 1)
    csum = torch.cumsum(sorted_desc, 0)
    denom = torch.gather(csum, 0, (k - 1).reshape(1))[0] / k.to(
        heatmap.dtype)
    return torch.clamp(heatmap / torch.clamp_min(denom, 1e-6), 0.0, 1.0)


def _refine_heatmap_local(heatmap: torch.Tensor, num_blocks: int = 5,
                          overlap_ratio: float = 0.5, ratio: float = 0.2,
                          valid_thresh: float = 2e-3) -> torch.Tensor:
    """Blockwise refinement: overlapping blocks refined on their own and
    averaged (the block bounds are static)."""
    H, W = heatmap.shape
    inc = 1 - overlap_ratio
    h_block = round(H / (1 + (num_blocks - 1) * inc))
    w_block = round(W / (1 + (num_blocks - 1) * inc))
    out = torch.zeros_like(heatmap)
    count = torch.zeros_like(heatmap)
    for hi in range(num_blocks):
        for wi in range(num_blocks):
            h0 = round(hi * h_block * inc)
            w0 = round(wi * w_block * inc)
            h1 = h0 + h_block if hi < num_blocks - 1 else H
            w1 = w0 + w_block if wi < num_blocks - 1 else W
            sub = heatmap[h0:h1, w0:w1]
            refined = torch.where(sub.max() > valid_thresh,
                                  _refine_heatmap(sub, ratio, valid_thresh),
                                  sub)
            out[h0:h1, w0:w1] += refined
            count[h0:h1, w0:w1] += 1.0
    return torch.clamp(out / count, 0.0, 1.0)


def _circle_offsets(radius: float) -> np.ndarray:
    """The (P, 2) integer offsets within `radius` of a patch's centre."""
    r = int(radius)
    ys, xs = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                         indexing="ij")
    pts = np.stack([ys, xs], -1).reshape(-1, 2)
    keep = np.sqrt((pts.astype(np.float32) ** 2).sum(-1)) <= radius
    return pts[keep]


def _line_samples(p: torch.Tensor, q: torch.Tensor, num_samples: int,
                  H: int, W: int, lambda_radius: float):
    """The sample points of the segments p → q ((..., 2) ij, broadcast;
    sample s is p · t + q · (1 - t)) clamped to the map, (ys, xs) (...,
    S), and the local maximum's radius 0.5·sqrt(2) + lambda · length /
    diagonal (...)."""
    t = linspace(0.0, 1.0, num_samples, p.device).to(p.dtype)
    ys = (p[..., 0, None] * t + q[..., 0, None] * (1 - t)).clamp(0.0, H - 1.0)
    xs = (p[..., 1, None] * t + q[..., 1, None] * (1 - t)).clamp(0.0, W - 1.0)
    radius = (0.5 * math.sqrt(2.0) + lambda_radius
              * torch.linalg.vector_norm(p - q, dim=-1) / math.hypot(H, W))
    return ys, xs, radius


def _local_max(flat: torch.Tensor, H: int, W: int, y: torch.Tensor,
               x: torch.Tensor, radius: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """The largest activation of the heatmap (flat (H·W,)) at the integer
    offsets `offs` (P, 2) around each sample point (y, x) (..., c), masked
    to the points nearer than `radius` (...): (..., c)."""
    py = torch.round(y)[..., None] + offs[:, 0]          # (..., c, P)
    px = torch.round(x)[..., None] + offs[:, 1]
    d = torch.sqrt((py - y[..., None]) ** 2 + (px - x[..., None]) ** 2)
    ok = d < radius[..., None, None]
    idx = py.clamp(0, H - 1).long() * W + px.clamp(0, W - 1).long()
    return (flat[idx] * ok.to(flat.dtype)).max(-1).values


def detect_line_segments(
    junctions: torch.Tensor,
    valid: torch.Tensor,
    heatmap: torch.Tensor,
    detect_thresh: float = 0.5,
    num_samples: int = 64,
    inlier_thresh: float = 0.99,
    nms_dist_tolerance: float = 3.0,
    use_candidate_suppression: bool = True,
    use_heatmap_refinement: bool = True,
    heatmap_refine_mode: str = "global",
    sampling: str = "local_max",
    max_local_patch_radius: float = 3.0,
    lambda_radius: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Verify every pair of junctions as a line: junctions (K, 2) float ij,
    valid (K,), heatmap (H, W) in [0, 1] → (adjacency (K, K) bool and
    symmetric, score (K, K) the mean sampled activation). `sampling`
    "local_max" (the reference's default) or "bilinear";
    `heatmap_refine_mode` "global" or "local". Sample s of pair (i, j) is
    junction i · t + junction j · (1 - t)."""
    junctions = as_float(junctions)
    K = junctions.shape[0]
    H, W = heatmap.shape
    dt, dev = junctions.dtype, junctions.device
    if use_heatmap_refinement:
        heatmap = (_refine_heatmap_local(heatmap)
                   if heatmap_refine_mode == "local"
                   else _refine_heatmap(heatmap))
    ys, xs, radius = _line_samples(junctions[:, None, :],
                                   junctions[None, :, :], num_samples, H, W,
                                   lambda_radius)
    if sampling == "local_max":
        # the largest activation in a circle around each sample point
        offs = host_tensor(_circle_offsets(max_local_patch_radius), dev, dt)
        flat = heatmap.reshape(-1)
        s_sum = torch.zeros((K, K), dtype=dt, device=dev)
        s_cnt = torch.zeros((K, K), dtype=dt, device=dev)
        for c0 in range(0, num_samples, SAMPLE_CHUNK):
            m = _local_max(flat, H, W, ys[..., c0:c0 + SAMPLE_CHUNK],
                           xs[..., c0:c0 + SAMPLE_CHUNK], radius, offs)
            for s in range(m.shape[-1]):
                s_sum = s_sum + m[..., s]
                s_cnt = s_cnt + (m[..., s] > detect_thresh).to(dt)
        score = s_sum / num_samples
        inlier_ratio = s_cnt / num_samples
    else:
        sampled = _bilinear_hw(heatmap, ys, xs)          # (K, K, S)
        score = sampled.mean(-1)
        inlier_ratio = (sampled > detect_thresh).to(dt).mean(-1)
    keep = score > detect_thresh
    if inlier_thresh > 0:
        keep &= inlier_ratio >= inlier_thresh
    # strict upper-triangle pairs of two valid junctions
    iu = torch.ones((K, K), dtype=torch.bool, device=dev).triu(1)
    keep &= valid[:, None] & valid[None, :] & iu
    if use_candidate_suppression:
        # drop (i, j) where another valid junction projects onto the
        # closed segment within `nms_dist_tolerance` px
        p1 = junctions[:, None, None, :]
        d = junctions[None, :, None, :] - p1
        q = junctions[None, None, :, :]
        len2 = torch.clamp_min((d * d).sum(-1), 1e-12)
        tt = ((q - p1) * d).sum(-1) / len2               # (K, K, K)
        on_seg = (tt >= 0.0) & (tt <= 1.0)
        dist = torch.linalg.vector_norm(q - (p1 + tt[..., None] * d), dim=-1)
        ar = torch.arange(K, device=dev)
        third = (ar[None, None, :] != ar[:, None, None]) \
            & (ar[None, None, :] != ar[None, :, None])
        on_line = on_seg & (dist <= nms_dist_tolerance) \
            & valid[None, None, :] & third
        keep &= ~on_line.any(-1)
    return keep | keep.T, score


def refine_segments_perturb(segments: torch.Tensor, mask: torch.Tensor,
                            heatmap: torch.Tensor, num_perturbs: int = 9,
                            perturb_interval: float = 0.25,
                            num_samples: int = 64) -> torch.Tensor:
    """Endpoint refinement: both endpoints of each segment perturbed over a
    4-D grid of `num_perturbs` steps; the candidate with the highest mean
    bilinear activation wins (the first among equals). segments (L, 2, 2)
    ij, mask (L,) → refined (L, 2, 2)."""
    H, W = heatmap.shape
    dt, dev = segments.dtype, segments.device
    side = (num_perturbs - 1) // 2
    pv = torch.arange(-side, side + 1, device=dev).to(dt) * perturb_interval
    g = torch.meshgrid(pv, pv, pv, pv, indexing="ij")
    perturb = torch.stack([gg.reshape(-1) for gg in g], -1).reshape(-1, 2, 2)
    t = linspace(0.0, 1.0, num_samples, dev).to(dt)
    out = []
    for c0 in range(0, segments.shape[0], REFINE_CHUNK):
        cand = segments[c0:c0 + REFINE_CHUNK, None] + perturb  # (c, P4, 2, 2)
        cand = torch.stack([cand[..., 0].clamp(0.0, H - 1.0),
                            cand[..., 1].clamp(0.0, W - 1.0)], -1)
        ys = cand[..., 0, 0, None] * t + cand[..., 1, 0, None] * (1 - t)
        xs = cand[..., 0, 1, None] * t + cand[..., 1, 1, None] * (1 - t)
        best = torch.argmax(_bilinear_hw(heatmap, ys, xs).mean(-1), -1)
        out.append(torch.gather(cand, 1, best[:, None, None, None].expand(
            -1, 1, 2, 2))[:, 0])
    refined = torch.cat(out) if out else segments
    return torch.where(mask[:, None, None], refined, segments)


def adjacency_to_segments(junctions: torch.Tensor, adjacency: torch.Tensor,
                          score: torch.Tensor, max_segments: int = 512
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(K, K) line map → padded ((L, 2, 2) ij segments, (L,) mask), ranked
    by activation (a stable top-L of the upper triangle)."""
    K = junctions.shape[0]
    iu = torch.ones((K, K), dtype=torch.bool,
                    device=adjacency.device).triu(1)
    flat = torch.where(adjacency & iu, score, -torch.inf).reshape(-1)
    vals, idx = _top_k(flat, max_segments)
    i, j = torch.div(idx, K, rounding_mode="floor"), idx % K
    return torch.stack([junctions[i], junctions[j]], 1), torch.isfinite(vals)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

class SOLD2_detector(nn.Module):
    """The line-segment detector. Call with (B, 1, H, W) → dict with
    ``line_segments`` (B, L, 2, 2) ij and ``line_mask`` (B, L), and the raw
    ``junction_heatmap`` and ``line_heatmap`` (B, H, W). `params`: the
    net's param dict (the checkpoint's names); without it the weights come
    from `generator`, or one seeded with 0 (the reference's key)."""

    def __init__(self, max_junctions: int = 250, max_segments: int = 512,
                 detect_thresh: float = 0.5, num_samples: int = 64,
                 inlier_thresh: float = 0.99, grid_size: int = 8,
                 sampling: str = "local_max",
                 use_junction_refinement: bool = True,
                 params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        super().__init__()
        self.max_junctions = max_junctions
        self.max_segments = max_segments
        self.detect_thresh = detect_thresh
        self.num_samples = num_samples
        self.inlier_thresh = inlier_thresh
        self.grid_size = grid_size
        self.sampling = sampling
        self.use_junction_refinement = use_junction_refinement
        self.net = _nets.make(SOLD2Net, grid_size, 4, 2, 128, params,
                              generator, device)

    def _forward_net(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        B, C, H, W = img.shape
        check(C == 1, f"SOLD2 expects grayscale (B, 1, H, W) input, got C={C}")
        check(H % 8 == 0 and W % 8 == 0,
              f"SOLD2 needs H, W divisible by 8 (pixel-shuffle decoders), "
              f"got {H}x{W}")
        return self.net(as_float(img))

    def _segments(self, j_prob, heat, sampling, refine):
        junc, valid = prob_to_junctions(j_prob, self.max_junctions)
        adj, score = detect_line_segments(
            junc, valid, heat, self.detect_thresh, self.num_samples,
            self.inlier_thresh, sampling=sampling)
        segs, mask = adjacency_to_segments(junc, adj, score,
                                           self.max_segments)
        if refine:
            segs = refine_segments_perturb(segs, mask, heat)
        return segs, mask

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self._forward_net(img)
        per = [self._segments(j, h, self.sampling,
                              self.use_junction_refinement)
               for j, h in zip(out["junctions"], out["heatmap"])]
        return {"junction_heatmap": out["junctions"],
                "line_heatmap": out["heatmap"],
                "line_segments": torch.stack([s for s, _ in per]),
                "line_mask": torch.stack([m for _, m in per])}


def _sample_line_descriptors(segments: torch.Tensor, desc: torch.Tensor,
                             num_samples: int, stride: int) -> torch.Tensor:
    """The descriptors at `num_samples` points along each segment,
    L2-normalised: segments (L, 2, 2) ij at full resolution, desc
    (Hc, Wc, D) at 1/stride → (L, S, D)."""
    t = linspace(0.0, 1.0, num_samples, segments.device).to(segments.dtype)
    pts = (segments[:, 0, None, :] * (1 - t[None, :, None])
           + segments[:, 1, None, :] * t[None, :, None])
    sampled = _bilinear_hw(desc, true_div(pts[..., 0], stride),
                           true_div(pts[..., 1], stride))
    return sampled / torch.linalg.vector_norm(
        sampled, dim=-1, keepdim=True).clamp_min(1e-6)


@f32_matmul_precision
def match_lines_nw(desc1: torch.Tensor, desc2: torch.Tensor,
                   valid1: torch.Tensor, valid2: torch.Tensor,
                   gap: float = 0.1) -> torch.Tensor:
    """Needleman-Wunsch line matching of sampled line descriptors desc*
    (N, S, D): both directions of line 2 scored, the mutual nearest
    neighbours kept. → (N1,) index into lines 2, -1 where unmatched."""
    sim = torch.einsum("isd,jtd->ijst", desc1, desc2)   # (N1, N2, S, S)
    sim = torch.stack([sim, sim.flip(-1)], 0)
    S = desc1.shape[1]
    neg = torch.zeros_like(sim[..., 0, 0])
    prev = [neg - gap * j for j in range(S + 1)]
    for i in range(1, S + 1):
        cur = [neg - gap * i]
        for j in range(1, S + 1):
            cur.append(torch.maximum(
                torch.maximum(prev[j] - gap, cur[j - 1] - gap),
                prev[j - 1] + sim[..., i - 1, j - 1]))
        prev = cur
    scores = prev[S].max(0).values                        # (N1, N2)
    scores = torch.where(valid1[:, None] & valid2[None, :], scores,
                         -torch.inf)
    idx12 = torch.argmax(scores, -1)
    idx21 = torch.argmax(scores, -2)
    mutual = idx21[idx12] == torch.arange(scores.shape[0],
                                          device=scores.device)
    return torch.where(mutual & valid1, idx12, -1)


class SOLD2(SOLD2_detector):
    """Full SOLD2: the detector (local-maximum sampling, no endpoint
    refinement), the dense descriptors and ``match``."""

    def __init__(self, *args, match_num_samples: int = 5, **kw):
        super().__init__(*args, **kw)
        self.match_num_samples = match_num_samples

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = self._forward_net(img)
        per = [self._segments(j, h, "local_max", False)
               for j, h in zip(out["junctions"], out["heatmap"])]
        return {"junction_heatmap": out["junctions"],
                "line_heatmap": out["heatmap"],
                "line_segments": torch.stack([s for s, _ in per]),
                "line_mask": torch.stack([m for _, m in per]),
                "dense_desc": out["dense_desc"]}

    def match(self, out1: Dict[str, torch.Tensor],
              out2: Dict[str, torch.Tensor]) -> torch.Tensor:
        """First-image segments matched to second-image ones, from two
        single-image outputs of the call (batch 1): (L,) indices into the
        second image's segments, -1 where unmatched."""
        d1 = out1["dense_desc"][0].permute(1, 2, 0)
        d2 = out2["dense_desc"][0].permute(1, 2, 0)
        stride = out1["line_heatmap"].shape[-1] // d1.shape[1]
        s1 = _sample_line_descriptors(out1["line_segments"][0], d1,
                                      self.match_num_samples, stride)
        s2 = _sample_line_descriptors(out2["line_segments"][0], d2,
                                      self.match_num_samples, stride)
        return match_lines_nw(s1, s2, out1["line_mask"][0],
                              out2["line_mask"][0])
