"""The multi-resolution (Key.Net) detector (counterpart of
``kornia_tpu/feature/multires_detector.py``).

Every level's shape and keypoint budget follows from the input shape: an
upscaled level, the base and `pyramid_levels` ``pyrdown`` levels by
`scale_factor_levels`. Per level: response → borders zeroed → NMS → a
fixed-k top-k; then one top-`num_features` over all levels, on padded
fixed-K sets with validity masks. The top-k keeps the lower index first
among equal scores, as ``lax.top_k`` does.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import torch

from ..core.dtype import as_float
from ..core.sort import top_k
from ..geometry.subpix import nms2d
from ..ops.pyramid import pyrdown
from ..ops.warp import resize
from .descriptors import KeyNet
from .laf import laf_from_center_scale_ori

__all__ = ["MultiResolutionDetector", "KeyNetDetector",
           "default_detector_config"]

Device = Union[str, torch.device]

default_detector_config: Dict = {
    "nms_size": 15,
    "pyramid_levels": 4,
    "up_levels": 1,
    "scale_factor_levels": math.sqrt(2.0),
    "s_mult": 22.0,
}


class MultiResolutionDetector:
    """Any-response multi-scale detector: (B, 1, H, W) → (lafs (B, K, 2, 3),
    responses (B, K), valid (B, K)); `aff_module` then `ori_module` refine
    the LAFs."""

    def __init__(self, model: Callable[[torch.Tensor], torch.Tensor],
                 num_features: int = 2048,
                 config: Optional[Dict] = None,
                 ori_module=None, aff_module=None,
                 score_threshold: float = 0.0):
        config = config or default_detector_config
        self.model = model
        self.num_features = num_features
        self.num_pyramid_levels = config["pyramid_levels"]
        self.num_upscale_levels = config["up_levels"]
        self.scale_factor_levels = config["scale_factor_levels"]
        self.mr_size = config["s_mult"]
        self.nms_size = config["nms_size"]
        self.score_threshold = score_threshold
        self.ori = ori_module
        self.aff = aff_module

    def _points_per_level(self):
        """The budget split in proportion to each level's area, then
        truncated to int."""
        factor_points = self.scale_factor_levels ** 2
        levels = self.num_pyramid_levels + self.num_upscale_levels + 1
        tmp = 0.0
        nfl = []
        for i in range(levels):
            tmp += factor_points ** (-1 * (i - self.num_upscale_levels))
            nfl.append(self.num_features
                       * factor_points ** (-1 * (i - self.num_upscale_levels)))
        return [int(x / tmp) for x in nfl]

    def _level_topk(self, level_img: torch.Tensor, num_kp: int,
                    factor: Tuple[float, float], borders: int = 15):
        """One level: response → borders zeroed (before the NMS, so that a
        strong border pixel cannot suppress its inside neighbours) → NMS →
        top-k → LAFs in the input image's coordinates."""
        B, _, H, W = level_img.shape
        resp = self.model(level_img)
        dev = resp.device
        ys = torch.arange(H, device=dev)
        xs = torch.arange(W, device=dev)
        inside = ((ys[:, None] >= borders) & (ys[:, None] < H - borders)
                  & (xs[None, :] >= borders) & (xs[None, :] < W - borders))
        resp = resp * inside.to(resp.dtype)
        det = nms2d(resp, (self.nms_size, self.nms_size))
        flat = det.reshape(B, H * W)
        neg_fill = torch.finfo(flat.dtype).min / 2
        masked = torch.where(flat <= self.score_threshold,
                             torch.full_like(flat, neg_fill), flat)
        scores, idx = top_k(masked, min(num_kp, H * W))
        valid = scores > self.score_threshold
        y = torch.div(idx, W, rounding_mode="floor").to(flat.dtype)
        x = (idx % W).to(flat.dtype)
        fx, fy = factor
        xy = torch.stack([x * fx, y * fy], dim=-1)
        scale = torch.full((B, idx.shape[1], 1, 1),
                           0.5 * (fx + fy) * self.mr_size, dtype=flat.dtype,
                           device=dev)
        return scores, laf_from_center_scale_ori(xy, scale), valid

    def detect(self, img: torch.Tensor):
        img = as_float(img)
        h, w = img.shape[-2:]
        nfl = self._points_per_level()
        sf = self.scale_factor_levels
        all_scores, all_lafs, all_valid = [], [], []

        def add(level):
            all_scores.append(level[0])
            all_lafs.append(level[1])
            all_valid.append(level[2])

        img_up = img
        for i in range(self.num_upscale_levels):
            nf = nfl[len(nfl) - self.num_pyramid_levels - 1 - (i + 1)]
            up = sf ** (1 + i)
            nh, nw = int(h * up), int(w * up)
            img_up = resize(img_up, (nh, nw), "bilinear",
                            align_corners=False)
            add(self._level_topk(img_up, int(nf), (w / nw, h / nh)))
        cur = img
        for i in range(self.num_pyramid_levels + 1):
            if i > 0:
                cur = pyrdown(cur, factor=sf)
                nh, nw = cur.shape[-2:]
                factor = (w / nw, h / nh)
            else:
                factor = (1.0, 1.0)
            num_points = int(nfl[i])
            if i > 0 or self.num_upscale_levels > 0:
                num_points = sum(nfl[: i + 1 + self.num_upscale_levels])
            add(self._level_topk(cur, num_points, factor))
        scores = torch.cat(all_scores, dim=1)
        lafs = torch.cat(all_lafs, dim=1)
        valid = torch.cat(all_valid, dim=1)
        # the global fixed-K selection; invalid slots score hugely negative
        neg_fill = torch.finfo(scores.dtype).min / 2
        top, idx = top_k(torch.where(valid, scores,
                                     torch.full_like(scores, neg_fill)),
                         min(self.num_features, scores.shape[1]))
        lafs = torch.gather(lafs, 1, idx[..., None, None].expand(
            -1, -1, 2, 3))
        valid = torch.gather(valid, 1, idx)
        return torch.where(valid, top, torch.zeros_like(top)), lafs, valid

    def __call__(self, img: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """→ (lafs, responses, valid)."""
        resp, lafs, valid = self.detect(img)
        if self.aff is not None:
            lafs = self.aff(lafs, img)
        if self.ori is not None:
            lafs = self.ori(lafs, img)
        return lafs, resp, valid


class KeyNetDetector(MultiResolutionDetector):
    """The multi-resolution detector over the Key.Net response (`params`
    the reference's KeyNet dict; without it, KeyNet's seeded default)."""

    def __init__(self, params: Optional[Mapping] = None,
                 num_features: int = 2048,
                 config: Optional[Dict] = None,
                 ori_module=None, aff_module=None,
                 score_threshold: float = 0.0, device: Device = "cuda"):
        super().__init__(KeyNet(params, device=device), num_features, config,
                         ori_module, aff_module, score_threshold)
