"""XFeat, the lightweight detector and descriptor (counterpart of
``kornia_tpu/feature/xfeat.py``): the XFeatModel backbone, the sparse
``detectAndCompute``, the dual-scale dense extraction, the mutual nearest
neighbour match and XFeat*'s fine-matcher refinement.

Sparse outputs are padded fixed-K sets with validity masks, as in the
reference; every top-k is stable (the lower index first among ties, as
``lax.top_k``): at 480x640 most of the score map is the -1 fill. The net
computes in NCHW with the checkpoint's OIHW weights, registered under the
checkpoint's names (``block1.0.layer.0.weight``, ...), described by a
parameter table (``_param_rows``, ``feature/_nets.py``): `params`,
``load_torch_weights`` and ``xfeat_init_params`` are in the checkpoint's
layout; the reference's dict (HWIO convolutions) crosses with
``convert.xfeat_from_numpy``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtype import as_float, host_tensor
from ..core.linalg import f32_matmul_precision, f32_precision
from ..core.sort import top_k as _top_k
from ..geometry.subpix import nms2d
from ..ops.warp import grid_sample, resize
from . import _nets

__all__ = ["XFeat"]

Device = Union[str, torch.device]

# BasicLayer plan per Sequential block: (idx, cin, cout, kernel, stride, pad)
_BLOCKS = {
    "block1": ((0, 1, 4, 3, 1, 1), (1, 4, 8, 3, 2, 1), (2, 8, 8, 3, 1, 1),
               (3, 8, 24, 3, 2, 1)),
    "block2": ((0, 24, 24, 3, 1, 1), (1, 24, 24, 3, 1, 1)),
    "block3": ((0, 24, 64, 3, 2, 1), (1, 64, 64, 3, 1, 1),
               (2, 64, 64, 1, 1, 0)),
    "block4": ((0, 64, 64, 3, 2, 1), (1, 64, 64, 3, 1, 1),
               (2, 64, 64, 3, 1, 1)),
    "block5": ((0, 64, 128, 3, 2, 1), (1, 128, 128, 3, 1, 1),
               (2, 128, 128, 3, 1, 1), (3, 128, 64, 1, 1, 0)),
    "block_fusion": ((0, 64, 64, 3, 1, 1), (1, 64, 64, 3, 1, 1)),
    "heatmap_head": ((0, 64, 64, 1, 1, 0), (1, 64, 64, 1, 1, 0)),
    "keypoint_head": ((0, 64, 64, 1, 1, 0), (1, 64, 64, 1, 1, 0),
                      (2, 64, 64, 1, 1, 0)),
}
# trailing plain Conv2d per block: (idx, cin, cout), all 1x1 with bias
_TAIL_CONVS = {"block_fusion": (2, 64, 64), "heatmap_head": (2, 64, 1),
               "keypoint_head": (3, 64, 65)}
# fine matcher MLP: (linear idx, in, out); BatchNorm1d(affine=False) after
# each hidden linear at idx + 1
_FINE = ((0, 128, 512), (3, 512, 512), (6, 512, 512), (9, 512, 512),
         (12, 512, 64))


def _param_rows() -> List[_nets.Row]:
    """The checkpoint's names and torch shapes (OIHW convolutions,
    (out, in) linears). The reference's dict is flat and keyed by the same
    names, so a row's path is its name; its convolutions are HWIO
    ("conv"), its linears already (out, in) ("linear")."""
    rows: List[_nets.Row] = []

    def add(name, shape, kind):
        rows.append((name, shape, (name,), kind))

    add("skip1.1.weight", (24, 1, 1, 1), "conv")
    add("skip1.1.bias", (24,), "vec")
    for block, layers in _BLOCKS.items():
        for i, cin, cout, k, _s, _p in layers:
            add(f"{block}.{i}.layer.0.weight", (cout, cin, k, k), "conv")
            add(f"{block}.{i}.layer.1.running_mean", (cout,), "vec")
            add(f"{block}.{i}.layer.1.running_var", (cout,), "vec")
    for block, (i, cin, cout) in _TAIL_CONVS.items():
        add(f"{block}.{i}.weight", (cout, cin, 1, 1), "conv")
        add(f"{block}.{i}.bias", (cout,), "vec")
    for i, cin, cout in _FINE:
        add(f"fine_matcher.{i}.weight", (cout, cin), "linear")
        add(f"fine_matcher.{i}.bias", (cout,), "vec")
        if cout != 64:
            add(f"fine_matcher.{i + 1}.running_mean", (cout,), "vec")
            add(f"fine_matcher.{i + 1}.running_var", (cout,), "vec")
    return rows


def xfeat_init_params(generator: torch.Generator,
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """He-normal convolutions and linears drawn from a CPU `generator` in
    the order of the names, zero biases and means, unit variances; the
    checkpoint's names and layout."""
    return _nets.init_params(_param_rows(), generator, dtype, gain=2.0)


def load_torch_weights(state_dict) -> Dict[str, np.ndarray]:
    """An ``XFeatModel.state_dict()`` (the ``xfeat.pt`` layout) → XFeat's
    `params`, shapes checked."""
    return _nets.check_params(_param_rows(), state_dict)


def _with_params(module: nn.Module, params: Optional[Mapping],
                 generator: Optional[torch.Generator], device) -> None:
    """Register `params` (shapes checked), or xfeat_init_params's draw
    from `generator` (one seeded with 0 if None), on `module`."""
    if params is None:
        params = xfeat_init_params(generator if generator is not None
                                   else torch.Generator().manual_seed(0))
    _nets.with_params(module, _param_rows(), params, device)


def _bn_noaffine(p: Mapping, name: str, x: torch.Tensor) -> torch.Tensor:
    mean = p[f"{name}.running_mean"].reshape(1, -1, 1, 1)
    var = p[f"{name}.running_var"].reshape(1, -1, 1, 1)
    return (x - mean) * torch.rsqrt(var + 1e-5)


def _block(p: Mapping, name: str, x: torch.Tensor) -> torch.Tensor:
    for i, _cin, _cout, _k, s, pad in _BLOCKS[name]:
        pre = f"{name}.{i}.layer"
        x = F.relu(_bn_noaffine(p, f"{pre}.1", F.conv2d(
            x, p[f"{pre}.0.weight"], stride=s, padding=pad)))
    if name in _TAIL_CONVS:
        t = f"{name}.{_TAIL_CONVS[name][0]}"
        x = F.conv2d(x, p[f"{t}.weight"], p[f"{t}.bias"])
    return x


def _unfold2d(x: torch.Tensor, ws: int) -> torch.Tensor:
    """torch ``x.unfold(2, ws, ws).unfold(3, ws, ws)`` channel packing:
    (B, C, H, W) → (B, C·ws², H/ws, W/ws), channel c·ws² + dy·ws + dx."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // ws, ws, W // ws, ws)
    return x.permute(0, 1, 3, 5, 2, 4).reshape(B, C * ws * ws, H // ws,
                                               W // ws)


@f32_matmul_precision
def xfeat_model(params: Mapping, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """XFeatModel.forward: (B, C, H, W) → (feats (B, 64, H/8, W/8),
    keypoint logits (B, 65, H/8, W/8), heatmap (B, 1, H/8, W/8)).
    `params`: the checkpoint's names with OIHW convolutions (an XFeat's
    ``params``)."""
    p = params
    x = as_float(images).mean(dim=1, keepdim=True)
    mu = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), keepdim=True, correction=0)
    x = ((x - mu) * torch.rsqrt(var + 1e-5)).detach()

    skip = F.conv2d(F.avg_pool2d(x, 4), p["skip1.1.weight"],
                    p["skip1.1.bias"])
    x1 = _block(p, "block1", x)
    x2 = _block(p, "block2", x1 + skip)
    x3 = _block(p, "block3", x2)
    x4 = _block(p, "block4", x3)
    x5 = _block(p, "block5", x4)
    hw3 = tuple(x3.shape[-2:])
    feats = _block(p, "block_fusion",
                   x3 + resize(x4, hw3, "bilinear", align_corners=False)
                   + resize(x5, hw3, "bilinear", align_corners=False))
    heat = torch.sigmoid(_block(p, "heatmap_head", feats))
    kpts = _block(p, "keypoint_head", _unfold2d(x, 8))
    return feats, kpts, heat


def _interpolate_sparse2d(x: torch.Tensor, pos: torch.Tensor, H: int,
                          W: int, mode: str) -> torch.Tensor:
    """InterpolateSparse2d: the grid normalised with a (W-1, H-1)
    denominator but sampled with align_corners=False, the asymmetry the
    pretrained weights bake in. x (B, C, h, w), pos (B, N, 2) xy →
    (B, N, C)."""
    denom = host_tensor([W - 1, H - 1], pos.device, pos.dtype)
    grid = (2.0 * pos / denom - 1.0)[:, :, None, :]
    out = grid_sample(x, grid, mode, "zeros", align_corners=False)
    return out[..., 0].transpose(1, 2)


class XFeat(nn.Module):
    """Sparse and semi-dense XFeat with fixed-K padded outputs. `params`:
    the checkpoint's names and layout; without it the weights come from
    `generator`, or one seeded with 0 (the reference's key).
    ``XFeat.from_torch(state_dict)`` loads ``xfeat.pt``. True float32
    (TF32 off)."""

    def __init__(self, top_k: int = 4096, detection_threshold: float = 0.05,
                 params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        super().__init__()
        self.top_k = top_k
        self.detection_threshold = detection_threshold
        _with_params(self, params, generator, device)

    @classmethod
    def from_torch(cls, state_dict, top_k: int = 4096,
                   detection_threshold: float = 0.05,
                   device: Device = "cuda") -> "XFeat":
        return cls(top_k, detection_threshold, params=state_dict,
                   device=device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Checkpoint name → parameter (OIHW convolutions)."""
        return dict(self.named_parameters())

    # -- helpers ----------------------------------------------------------

    @staticmethod
    def _preprocess(x: torch.Tensor) -> Tuple[torch.Tensor, float, float]:
        """Resize to the largest multiple of 32 (at least 32)."""
        H, W = x.shape[-2:]
        H32, W32 = max(32, (H // 32) * 32), max(32, (W // 32) * 32)
        x = as_float(x)
        if (H32, W32) != (H, W):
            x = resize(x, (H32, W32), "bilinear", align_corners=False)
        return x, H / H32, W / W32

    @staticmethod
    def _get_kpts_heatmap(kpts: torch.Tensor, softmax_temp: float = 1.0
                          ) -> torch.Tensor:
        """(B, 65, h, w) logits → (B, 1, 8h, 8w) heatmap."""
        scores = torch.softmax(kpts * softmax_temp, dim=1)[:, :64]
        B, _, H, W = scores.shape
        heat = scores.permute(0, 2, 3, 1).reshape(B, H, W, 8, 8)
        return heat.permute(0, 1, 3, 2, 4).reshape(B, 1, H * 8, W * 8)

    def detectAndCompute(self, images: torch.Tensor,
                         top_k: Optional[int] = None,
                         detection_threshold: Optional[float] = None
                         ) -> Dict[str, torch.Tensor]:
        """(B, C, H, W) → dict(keypoints (B, K, 2) xy, scores (B, K),
        descriptors (B, K, 64), valid (B, K)): the score is the keypoint
        heatmap at the pixel times the reliability map sampled there, -1
        where the 5x5 NMS or the threshold drops the pixel."""
        K = top_k or self.top_k
        thr = (detection_threshold if detection_threshold is not None
               else self.detection_threshold)
        x, rh, rw = self._preprocess(images)
        B, _, H1, W1 = x.shape
        M1, K1, H1map = xfeat_model(self.params, x)
        M1 = M1 / torch.linalg.vector_norm(M1, dim=1,
                                           keepdim=True).clamp_min(1e-12)
        K1h = self._get_kpts_heatmap(K1)
        keep = nms2d(K1h, (5, 5), mask_only=True) & (K1h > thr)
        dev, dt = K1h.device, K1h.dtype
        ys, xs = torch.meshgrid(torch.arange(H1, device=dev),
                                torch.arange(W1, device=dev), indexing="ij")
        pos_all = torch.stack([xs, ys], -1).reshape(1, -1, 2).to(dt)
        h1s = _interpolate_sparse2d(H1map, pos_all.expand(B, -1, -1), H1,
                                    W1, "bilinear").reshape(B, H1, W1)
        score_map = torch.where(keep[:, 0], K1h[:, 0] * h1s, -1.0)
        scores, idx = _top_k(score_map.reshape(B, -1), K)
        mkpts = torch.stack([(idx % W1).to(dt),
                             torch.div(idx, W1, rounding_mode="floor").to(dt)],
                            -1)
        feats = _interpolate_sparse2d(M1, mkpts, H1, W1, "bicubic")
        feats = feats / torch.linalg.vector_norm(
            feats, dim=-1, keepdim=True).clamp_min(1e-12)
        mkpts = mkpts * host_tensor([rw, rh], dev, dt)
        return {"keypoints": mkpts, "scores": scores, "descriptors": feats,
                "valid": scores > 0}

    # -- semi-dense (XFeat*) ----------------------------------------------

    def _extract_dense(self, x: torch.Tensor, top_k: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Coarse descriptors and their cells (x8), top-k by
        reliability."""
        x, rh, rw = self._preprocess(x)
        M1, _K1, H1 = xfeat_model(self.params, x)
        B, C, h, w = M1.shape
        dev, dt = M1.device, M1.dtype
        ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                                torch.arange(w, device=dev), indexing="ij")
        xy = (torch.stack([xs, ys], -1).reshape(-1, 2) * 8).to(dt)
        rel = H1.reshape(B, -1)
        k = min(top_k, rel.shape[1])
        _, idx = _top_k(rel, k)
        feats = torch.gather(M1.reshape(B, C, -1), 2,
                             idx[:, None, :].expand(B, C, k)).transpose(1, 2)
        mk = xy[idx]
        return mk * host_tensor([rw, rh], dev, dt), feats

    def detectAndComputeDense(self, images: torch.Tensor,
                              top_k: Optional[int] = None,
                              multiscale: bool = True
                              ) -> Dict[str, torch.Tensor]:
        """keypoints (B, K, 2), descriptors (B, K, 64), scales (B, K); with
        `multiscale` a fifth of K from the image at 0.6 and the rest at
        1.3."""
        K = top_k or self.top_k
        if not multiscale:
            mk, feats = self._extract_dense(images, K)
            return {"keypoints": mk, "descriptors": feats,
                    "scales": torch.ones(mk.shape[:2], dtype=mk.dtype,
                                         device=mk.device)}
        H, W = images.shape[-2:]
        s1, s2 = 0.6, 1.3
        img = as_float(images)
        x1 = resize(img, (int(H * s1), int(W * s1)), "bilinear",
                    align_corners=False)
        x2 = resize(img, (int(H * s2), int(W * s2)), "bilinear",
                    align_corners=False)
        mk1, f1 = self._extract_dense(x1, int(K * 0.20))
        mk2, f2 = self._extract_dense(x2, int(K * 0.80))
        mk = torch.cat([mk1 / s1, mk2 / s2], 1)
        sc = torch.cat([torch.full(mk1.shape[:2], 1 / s1, dtype=mk.dtype,
                                   device=mk.device),
                        torch.full(mk2.shape[:2], 1 / s2, dtype=mk.dtype,
                                   device=mk.device)], 1)
        return {"keypoints": mk, "descriptors": torch.cat([f1, f2], 1),
                "scales": sc}

    @staticmethod
    def _subpix_softmax2d(heatmaps: torch.Tensor, temp: float = 3.0
                          ) -> torch.Tensor:
        """(N, H, W) → (N, 2) soft-argmax offsets centred at
        (W // 2, H // 2)."""
        N, H, W = heatmaps.shape
        sm = torch.softmax(temp * heatmaps.reshape(N, -1), -1).reshape(
            N, H, W)
        ys, xs = torch.meshgrid(torch.arange(H, device=sm.device),
                                torch.arange(W, device=sm.device),
                                indexing="ij")
        xs = (xs - W // 2).to(sm.dtype)
        ys = (ys - H // 2).to(sm.dtype)
        return torch.stack([(xs * sm).sum((-2, -1)),
                            (ys * sm).sum((-2, -1))], -1)

    @staticmethod
    def _mnn(d0: torch.Tensor, d1: torch.Tensor):
        """Cosine similarities and the mutual nearest neighbours (argmax
        takes the first maximum on both devices)."""
        with f32_precision():
            cossim = d0 @ d1.T
        m12 = torch.argmax(cossim, 1)
        m21 = torch.argmax(cossim, 0)
        idx0 = torch.arange(m12.shape[0], device=m12.device)
        return cossim, m12, m21[m12] == idx0

    def match_xfeat(self, img0: torch.Tensor, img1: torch.Tensor,
                    top_k: Optional[int] = None, min_cossim: float = -1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Sparse detection on both images and the mutual nearest
        neighbour match of batch item 0: (mkpts0 (K, 2), mkpts1 (K, 2),
        valid (K,))."""
        f0 = self.detectAndCompute(img0, top_k)
        f1 = self.detectAndCompute(img1, top_k)
        cossim, m12, mutual = self._mnn(f0["descriptors"][0],
                                        f1["descriptors"][0])
        valid = mutual & f0["valid"][0] & f1["valid"][0][m12]
        if min_cossim > 0:
            valid = valid & (cossim.max(1).values > min_cossim)
        return f0["keypoints"][0], f1["keypoints"][0][m12], valid

    def match_xfeat_star(self, img0: torch.Tensor, img1: torch.Tensor,
                         top_k: Optional[int] = None, fine_conf: float = 0.25
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Semi-dense match with the fine matcher's refinement of the
        first image's points, batch item 0: (mkpts0 (K, 2), mkpts1 (K, 2),
        valid (K,))."""
        out0 = self.detectAndComputeDense(img0, top_k)
        out1 = self.detectAndComputeDense(img1, top_k)
        d0, d1 = out0["descriptors"][0], out1["descriptors"][0]
        _, m12, mutual = self._mnn(d0, d1)
        mk0 = out0["keypoints"][0]
        mk1 = out1["keypoints"][0][m12]
        sc0 = out0["scales"][0]
        offsets = self._fine_matcher(torch.cat([d0, d1[m12]], -1))
        conf = torch.softmax(offsets * 3, -1).max(-1).values
        off_xy = self._subpix_softmax2d(offsets.reshape(-1, 8, 8))
        mk0 = mk0 + off_xy * sc0[:, None]
        return mk0, mk1, mutual & (conf > fine_conf)

    @f32_matmul_precision
    def _fine_matcher(self, x: torch.Tensor) -> torch.Tensor:
        """4 × (linear → BatchNorm1d without affine → ReLU), then a linear
        to 64."""
        p = self.params
        for i, _cin, cout in _FINE:
            x = F.linear(x, p[f"fine_matcher.{i}.weight"],
                         p[f"fine_matcher.{i}.bias"])
            if cout != 64:
                mean = p[f"fine_matcher.{i + 1}.running_mean"]
                var = p[f"fine_matcher.{i + 1}.running_var"]
                x = F.relu((x - mean) * torch.rsqrt(var + 1e-5))
        return x

    def forward(self, images: torch.Tensor, top_k: Optional[int] = None,
                detection_threshold: Optional[float] = None
                ) -> Dict[str, torch.Tensor]:
        return self.detectAndCompute(images, top_k, detection_threshold)
