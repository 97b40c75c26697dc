"""ALIKED, the detector and descriptor with deformable convolutions, SDDH
and DKD (counterpart of ``kornia_tpu/feature/aliked.py``).

- The backbone's deformable convolutions go through the port's
  ``ops/deform_conv.py::deform_conv2d`` (offsets clipped to max(H, W) / 4).
- DKD is one batched fixed-K pipeline: strict NMS, the border zeroed, a
  stable top-k (the lower index first among ties, as ``lax.top_k``), a
  soft-argmax over each keypoint's 5x5 patch and a validity mask; no host
  read. The LAF shape comes from the closed-form 2x2 eigendecomposition of
  the soft-argmax covariance.
- SDDH gathers each keypoint's patch, predicts its sample offsets, samples
  every deformable position with one ``grid_sample`` and aggregates them.

The nets are ``nn.Module``s on NCHW tensors whose weights are frozen
parameters under the reference checkpoint's names (``block3.conv1.
offset_conv.weight``, ``desc_head.agg_weights``, ...); built without
parameters, they draw them from a CPU generator seeded with 0 (the
reference's key), so they differ from the reference's initialisation.
``convert.aliked_from_numpy`` carries the JAX variables across.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.check import check
from ..core.dtype import as_float, host_tensor
from ..core.linalg import f32_matmul_precision
from ..core.sort import top_k as _top_k
from ..geometry.subpix import nms2d
from ..ops.deform_conv import deform_conv2d
from ..ops.warp import grid_sample, resize
from . import _nets
from ._nets import Row, bn, bn_rows, conv, conv_rows

__all__ = ["ALIKED", "ALIKEDNet", "SDDH", "dkd_detect", "load_torch_weights"]

Device = Union[str, torch.device]

_ALIKED_CFGS = {
    # c1, c2, c3, c4, dim, K, M
    "aliked-t16": (8, 16, 32, 64, 64, 3, 16),
    "aliked-n16": (16, 32, 64, 128, 128, 3, 16),
    "aliked-n16rot": (16, 32, 64, 128, 128, 3, 16),
    "aliked-n32": (16, 32, 64, 128, 128, 3, 32),
}


def _block_rows(pre: str, cin: int, cout: int, dcn: bool, res: bool,
                fp: Sequence[str]) -> List[Row]:
    rows: List[Row] = []
    for i, cname in ((1, "conv1"), (2, "conv2")):
        c_in = cin if i == 1 else cout
        if dcn:
            rows += conv_rows(f"{pre}.{cname}.offset_conv", 18, c_in, 3,
                              (*fp, pre, cname, "offset_conv"))
            rows.append((f"{pre}.{cname}.regular_conv.weight",
                         (cout, c_in, 3, 3),
                         ("params", *fp, pre, cname, "kernel"), "oihw"))
        else:
            rows += conv_rows(f"{pre}.{cname}", cout, c_in, 3,
                              (*fp, pre, cname), bias=False)
        rows += bn_rows(f"{pre}.bn{i}", cout, (*fp, pre, f"BatchNorm_{i - 1}"))
    if res:
        rows += conv_rows(f"{pre}.downsample", cout, cin, 1,
                          (*fp, pre, "downsample"))
    return rows


def _net_rows(model_name: str, fp: Sequence[str] = ()) -> List[Row]:
    """ALIKEDNet's checkpoint names; `fp`: the net's flax path."""
    c1, c2, c3, c4, dim, _, _ = _ALIKED_CFGS[model_name]
    rows = _block_rows("block1", 3, c1, False, False, fp)
    rows += _block_rows("block2", c1, c2, False, True, fp)
    rows += _block_rows("block3", c2, c3, True, True, fp)
    rows += _block_rows("block4", c3, c4, True, True, fp)
    for i, c in enumerate((c1, c2, c3, c4)):
        rows += conv_rows(f"conv{i + 1}", dim // 4, c, 1,
                          (*fp, f"conv{i + 1}"), bias=False)
    for i, (idx, cout, cin, k) in enumerate(((0, 8, dim, 1), (2, 4, 8, 3),
                                             (4, 4, 4, 3), (6, 1, 4, 3))):
        rows += conv_rows(f"score_head.{idx}", cout, cin, k,
                          (*fp, f"score{i + 1}"), bias=False)
    return rows


def _sddh_rows(dims: int, kernel_size: int, n_pos: int, pre: str = "",
               fp: Sequence[str] = ()) -> List[Row]:
    """SDDH's checkpoint names (under `pre`); `fp`: its flax path."""
    chn = 2 * n_pos
    p = ("params", *fp)
    return [
        (f"{pre}offset_conv.0.weight", (chn, dims, kernel_size, kernel_size),
         p + ("offset_w1",), "conv"),
        (f"{pre}offset_conv.0.bias", (chn,), p + ("offset_b1",), "vec"),
        (f"{pre}offset_conv.2.weight", (chn, chn, 1, 1), p + ("offset_w2",),
         "dense1x1"),
        (f"{pre}offset_conv.2.bias", (chn,), p + ("offset_b2",), "vec"),
        (f"{pre}sf_conv.weight", (dims, dims, 1, 1), p + ("sf_w",),
         "dense1x1"),
        (f"{pre}agg_weights", (n_pos, dims, dims), p + ("agg_weights",),
         "oihw"),
    ]


def _param_rows(model_name: str) -> List[Row]:
    """The whole ALIKED checkpoint: the net, then ``desc_head.*``."""
    cfg = _ALIKED_CFGS[model_name]
    return _net_rows(model_name, ("net",)) + _sddh_rows(
        cfg[4], cfg[5], cfg[6], "desc_head.", ("desc_head",))


def load_torch_weights(state_dict, model_name: str = "aliked-n16"
                       ) -> Dict[str, "object"]:
    """A reference ALIKED checkpoint → the port's param dict (the
    checkpoint's names, float32 arrays, each shape checked)."""
    return _nets.check_params(_param_rows(model_name), state_dict)


def _deform_conv(p: Mapping, name: str, x: torch.Tensor) -> torch.Tensor:
    """DCNv1 3x3 without mask: the offset convolution's output clipped to
    max(H, W) / 4, then the deformable convolution."""
    H, W = x.shape[-2:]
    off = conv(p, f"{name}.offset_conv", x, padding=1)
    max_off = max(H, W) / 4.0
    off = off.clamp(-max_off, max_off)
    return deform_conv2d(x, off, p[f"{name}.regular_conv.weight"],
                         padding=(1, 1))


def _conv3(p: Mapping, name: str, x: torch.Tensor, dcn: bool):
    return _deform_conv(p, name, x) if dcn else conv(p, name, x, padding=1)


def _conv_block(p, pre, x, dcn=False):
    x = F.selu(bn(p, f"{pre}.bn1", _conv3(p, f"{pre}.conv1", x, dcn)))
    return F.selu(bn(p, f"{pre}.bn2", _conv3(p, f"{pre}.conv2", x, dcn)))


def _res_block(p, pre, x, dcn=False):
    idn = conv(p, f"{pre}.downsample", x)
    y = F.selu(bn(p, f"{pre}.bn1", _conv3(p, f"{pre}.conv1", x, dcn)))
    y = bn(p, f"{pre}.bn2", _conv3(p, f"{pre}.conv2", y, dcn))
    return F.selu(y + idn)


@f32_matmul_precision
def _net_forward(p: Mapping, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, 3, H, W) → (features (B, dim, H, W) L2-normalised, scores
    (B, H, W))."""
    H, W = x.shape[-2:]
    x1 = _conv_block(p, "block1", x)
    x2 = _res_block(p, "block2", F.avg_pool2d(x1, 2))
    x3 = _res_block(p, "block3", F.avg_pool2d(x2, 4), dcn=True)
    x4 = _res_block(p, "block4", F.avg_pool2d(x3, 4), dcn=True)
    ups = [F.selu(conv(p, f"conv{i + 1}", t))
           for i, t in enumerate((x1, x2, x3, x4))]
    feats = torch.cat([ups[0]] + [resize(t, (H, W), "bilinear",
                                         align_corners=True)
                                  for t in ups[1:]], 1)
    s = F.selu(conv(p, "score_head.0", feats))
    s = F.selu(conv(p, "score_head.2", s, padding=1))
    s = F.selu(conv(p, "score_head.4", s, padding=1))
    score = torch.sigmoid(conv(p, "score_head.6", s, padding=1)[:, 0])
    norm = torch.sqrt((feats * feats).sum(1, keepdim=True) + 1e-12)
    return feats / norm, score


def _eigh2x2(cov: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Closed-form symmetric 2x2 eigendecomposition, ascending eigenvalues:
    cov (..., 2, 2) → (evals (..., 2), evecs (..., 2, 2) as columns)."""
    a, b, c = cov[..., 0, 0], cov[..., 0, 1], cov[..., 1, 1]
    half_tr = 0.5 * (a + c)
    disc = torch.sqrt(torch.square(0.5 * (a - c)) + torch.square(b) + 1e-24)
    l1, l2 = half_tr - disc, half_tr + disc
    # the eigenvector of l2 from the better-conditioned formula
    v2a = torch.stack([b, l2 - a], -1)
    v2b = torch.stack([l2 - c, b], -1)
    v2 = torch.where(((l2 - a).abs() > (l2 - c).abs())[..., None], v2a, v2b)
    n = torch.sqrt((v2 * v2).sum(-1, keepdim=True))
    v2 = torch.where(n > 1e-12, v2 / n.clamp_min(1e-12),
                     torch.stack([torch.ones_like(a), torch.zeros_like(a)],
                                 -1))
    v1 = torch.stack([-v2[..., 1], v2[..., 0]], -1)
    return torch.stack([l1, l2], -1), torch.stack([v1, v2], -1)


@f32_matmul_precision
def dkd_detect(score_map: torch.Tensor, num_keypoints: int = 2048,
               radius: int = 2, scores_th: float = 0.2,
               temperature: float = 0.1, subpixel: bool = True,
               return_affine: bool = False):
    """Differentiable keypoint detection, fixed-K: score_map (B, H, W) →
    (kps_norm (B, N, 2) in [-1, 1], scores (B, N), dispersity (B, N),
    valid (B, N)[, affine (B, N, 2, 2)]). Where no score of an image
    clears `scores_th`, that image's mean score is its threshold."""
    score_map = as_float(score_map)
    B, H, W = score_map.shape
    k = 2 * radius + 1
    nms = nms2d(score_map[:, None], (k, k))[:, 0]
    inner = torch.zeros_like(nms)
    inner[:, radius:H - radius, radius:W - radius] = \
        nms[:, radius:H - radius, radius:W - radius]
    N = min(num_keypoints, H * W)
    nms_vals, idx = _top_k(inner.reshape(B, -1), N)
    if scores_th > 0:
        valid = nms_vals > scores_th
        mean_th = score_map.reshape(B, -1).mean(-1, keepdim=True)
        valid = torch.where(valid.any(-1, keepdim=True), valid,
                            nms_vals > mean_th)
    else:
        valid = nms_vals > 0
    dt, dev = score_map.dtype, score_map.device
    iy = torch.div(idx, W, rounding_mode="floor")
    ix = idx % W
    ys, xs = iy.to(dt), ix.to(dt)
    wh = host_tensor([W - 1, H - 1], dev, dt)

    def sample(kps):
        return grid_sample(score_map[:, None], kps[:, :, None, :],
                           mode="bilinear", align_corners=True)[:, 0, :, 0]

    if not subpixel:
        kps = torch.stack([xs, ys], -1) / wh * 2 - 1
        sc = sample(kps)
        out = (kps, sc, torch.zeros_like(sc), valid)
        if return_affine:
            out = out + (torch.eye(2, dtype=dt, device=dev).expand(
                B, N, 2, 2),)
        return out
    # each keypoint's k x k patch of the zero-padded map, row-major over
    # (dy, dx); offset n is hw_grid[n] = (dx, dy)
    pad = F.pad(score_map, (radius, radius, radius, radius))
    Wp = W + 2 * radius
    taps = torch.arange(k, device=dev)
    flat = ((iy[..., None, None] + taps[:, None]) * Wp
            + ix[..., None, None] + taps[None, :]).reshape(B, N * k * k)
    patch = torch.gather(pad.reshape(B, -1), 1, flat).reshape(B, N, k * k)
    grid1d = torch.arange(k, dtype=dt, device=dev) - radius
    hw_grid = torch.stack([grid1d.repeat(k), grid1d.repeat_interleave(k)],
                          -1)
    x_exp = torch.exp((patch - patch.max(-1, keepdim=True).values)
                      / temperature)
    x_sum = x_exp.sum(-1, keepdim=True)
    wgt = x_exp / x_sum
    residual = wgt @ hw_grid
    d2 = torch.square((hw_grid[None, None] - residual[:, :, None])
                      / radius).sum(-1)
    dispersity = (x_exp * d2).sum(-1) / x_sum[..., 0]
    kps = (torch.stack([xs, ys], -1) + residual) / wh * 2 - 1
    sc = sample(kps)
    out = (kps, sc, dispersity, valid)
    if return_affine:
        delta = hw_grid[None, None] - residual[:, :, None]
        cov = torch.einsum("bnk,bnki,bnkj->bnij", wgt, delta, delta)
        evals, evecs = _eigh2x2(cov)
        scales = torch.sqrt(evals.clamp_min(1e-8))
        out = out + (evecs * scales[..., None, :],)
    return out


@f32_matmul_precision
def _sddh_forward(p: Mapping, x: torch.Tensor, kps_norm: torch.Tensor,
                  kernel_size: int, n_pos: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, C, H, W), kps_norm (B, N, 2) in [-1, 1] → (descriptors
    (B, N, C) L2-normalised, offsets (B, N, P, 2))."""
    B, C, H, W = x.shape
    N = kps_norm.shape[1]
    ps, P = kernel_size, n_pos
    dt, dev = x.dtype, x.device
    wh = host_tensor([W - 1, H - 1], dev, dt)
    kpts_wh = (kps_norm / 2 + 0.5) * wh
    max_off = max(H, W) / 4.0
    # the ps x ps patch at each keypoint, truncated to int first and then
    # shifted by ps // 2, as the reference does
    corner = kpts_wh.to(torch.int32) - ps // 2
    cx = corner[..., 0].clamp(0, max(W - 1 - ps, 0)).long()
    cy = corner[..., 1].clamp(0, max(H - 1 - ps, 0)).long()
    taps = torch.arange(ps, device=dev)
    flat = ((cy[:, :, None, None] + taps[:, None]) * W
            + cx[:, :, None, None] + taps[None, :]).reshape(B, N * ps * ps)
    xf = x.reshape(B, C, H * W)
    patch = torch.gather(xf, 2, flat[:, None, :].expand(B, C, -1)).reshape(
        B, C, N, ps, ps)
    off = torch.einsum("bcnij,dcij->bnd", patch, p["offset_conv.0.weight"])
    off = F.selu(off + p["offset_conv.0.bias"])
    off = F.linear(off, p["offset_conv.2.weight"][:, :, 0, 0],
                   p["offset_conv.2.bias"])
    off = off.clamp(-max_off, max_off)
    # channels (2, P): the first P are dx, the next P dy
    off = off.reshape(B, N, 2, P).transpose(2, 3)
    pos = 2.0 * (kpts_wh[:, :, None, :] + off) / wh - 1
    feats = grid_sample(x, pos.reshape(B, N * P, 1, 2), mode="bilinear",
                        align_corners=True)
    feats = feats[:, :, :, 0].transpose(1, 2).reshape(B, N, P, C)
    feats = F.selu(F.linear(feats, p["sf_conv.weight"][:, :, 0, 0]))
    desc = torch.einsum("bnpc,pcd->bnd", feats, p["agg_weights"])
    norm = torch.sqrt((desc * desc).sum(-1, keepdim=True) + 1e-12)
    return desc / norm, off


class ALIKEDNet(nn.Module):
    """Backbone and score head: (B, 3, H, W) → (feature map (B, dim, H, W)
    L2-normalised, score map (B, H, W)). `parent` and `name` are flax's
    module-tree arguments, accepted for the reference's signature and
    unused."""

    def __init__(self, model_name: str = "aliked-n16", parent=None,
                 name: Optional[str] = None, device: Device = "cuda"):
        super().__init__()
        check(model_name in _ALIKED_CFGS,
              f"unknown ALIKED config {model_name!r}")
        self.model_name = model_name
        _nets.with_params(self, _net_rows(model_name), None, device)

    def forward(self, x: torch.Tensor):
        return _net_forward(dict(self.named_parameters()), x)


class SDDH(nn.Module):
    """Sparse deformable descriptor head: (feature map (B, C, H, W),
    keypoints (B, N, 2) in [-1, 1]) → (descriptors (B, N, C), offsets
    (B, N, P, 2)). `parent` and `name` as ALIKEDNet's."""

    def __init__(self, dims: int, kernel_size: int = 3, n_pos: int = 8,
                 parent=None, name: Optional[str] = None,
                 device: Device = "cuda"):
        super().__init__()
        self.kernel_size, self.n_pos = kernel_size, n_pos
        _nets.with_params(self, _sddh_rows(dims, kernel_size, n_pos), None,
                          device)

    def forward(self, x: torch.Tensor, kps_norm: torch.Tensor):
        return _sddh_forward(dict(self.named_parameters()), x, kps_norm,
                             self.kernel_size, self.n_pos)


class ALIKED(nn.Module):
    """ALIKED local features, fixed-K padded. Call with (B, C, H, W) float
    images in [0, 1] (1 or 3 channels; H, W multiples of 32): → (kps_px
    (B, N, 2) xy, scores (B, N), descs (B, N, D), valid (B, N)).
    ``forward_laf`` returns (lafs (B, N, 2, 3), responses (B, N, 1), descs
    (B, N, D)), the LAF's shape from the soft-argmax covariance. `params`:
    the checkpoint's names (``load_torch_weights``); without it the weights
    come from `generator`, or one seeded with 0 (the reference's key)."""

    def __init__(self, model_name: str = "aliked-n16",
                 num_keypoints: int = 2048,
                 detection_threshold: float = 0.2, nms_radius: int = 2,
                 params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        super().__init__()
        check(model_name in _ALIKED_CFGS,
              f"unknown ALIKED config {model_name!r}")
        self.model_name = model_name
        self.num_keypoints = num_keypoints
        self.detection_threshold = detection_threshold
        self.nms_radius = nms_radius
        _nets.with_params(self, _param_rows(model_name), params, device,
                          generator)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Checkpoint name → parameter."""
        return dict(self.named_parameters())

    def _prep(self, images: torch.Tensor) -> torch.Tensor:
        B, C, H, W = images.shape
        check(C in (1, 3), f"ALIKED expects 1- or 3-channel input, got {C}")
        check(H % 32 == 0 and W % 32 == 0,
              f"ALIKED needs H, W divisible by 32, got {H}x{W}")
        x = as_float(images)
        return x.expand(B, 3, H, W) if C == 1 else x

    def _run(self, images, n, return_affine):
        x = self._prep(images)
        H, W = x.shape[-2:]
        cfg = _ALIKED_CFGS[self.model_name]
        p = self.params
        fmap, smap = _net_forward(p, x)
        det = dkd_detect(smap, n or self.num_keypoints,
                         radius=self.nms_radius,
                         scores_th=self.detection_threshold,
                         return_affine=return_affine)
        desc, _ = _sddh_forward(_nets.sub(p, "desc_head"), fmap, det[0],
                                cfg[5], cfg[6])
        wh = host_tensor([W - 1, H - 1], x.device, x.dtype)
        kps_px = (det[0] + 1) / 2 * wh
        return kps_px, det[1], det[3], desc, det[4:]

    def forward(self, images: torch.Tensor, n: Optional[int] = None):
        kps_px, sc, valid, desc, _ = self._run(images, n, False)
        return kps_px, sc, desc, valid

    def forward_laf(self, images: torch.Tensor, n: Optional[int] = None):
        kps_px, sc, valid, desc, (aff,) = self._run(images, n, True)
        m = valid[..., None].to(kps_px.dtype)
        lafs = torch.cat([aff * m[..., None], (kps_px * m)[..., None]], -1)
        return lafs, (sc * valid)[..., None], desc * m
