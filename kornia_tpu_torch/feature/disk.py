"""DISK, the learned keypoint detector and descriptor (counterpart of
``kornia_tpu/feature/disk.py``): a U-Net of five down and four up blocks
(instance norm → PReLU → 5x5 conv) gives a heatmap and dense descriptors;
keypoints are the window maxima of the heatmap, the top `n` of them kept in
a padded fixed-size set with a validity mask.

The port computes in NCHW with the checkpoint's OIHW weights, registered
under the checkpoint's names (``unet.path_down.0.1.3.weight``, ...). The
reference's param dict holds its convolution weights as HWIO; `params`
takes that dict, and ``load_torch_weights`` and ``disk_init_params``
return it, so that dicts move between the two packages unchanged.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtype import as_float
from ..core.linalg import f32_matmul_precision
from ..core.sort import top_k
from ..geometry.subpix import nms2d
from .hardnet import _numpy, _register_tree

__all__ = ["DISK", "DISKFeatures"]

Device = Union[str, torch.device]

_DOWN = (16, 32, 64, 64, 64)
_UP = (64, 64, 64, 129)  # last = desc_dim + 1


class DISKFeatures:
    """A padded fixed-K set: keypoints (B, K, 2) as (x, y), descriptors
    (B, K, D) L2-normalised, detection_scores (B, K), valid (B, K)."""

    def __init__(self, keypoints, descriptors, detection_scores, valid):
        self.keypoints = keypoints
        self.descriptors = descriptors
        self.detection_scores = detection_scores
        self.valid = valid

    @property
    def x(self):
        return self.keypoints[..., 0]

    @property
    def y(self):
        return self.keypoints[..., 1]


def _unet_plan() -> List[Dict]:
    """The U-Net's layers: 5 down blocks, then 4 up blocks."""
    plan = []
    down_dims = (3, *_DOWN)
    for i in range(len(_DOWN)):
        plan.append({"kind": "down", "idx": i, "cin": down_dims[i],
                     "cout": down_dims[i + 1], "first": i == 0})
    bot = [_DOWN[-1], *_UP[:-1]]
    hor = down_dims[-2::-1]
    for i, (b, h, o) in enumerate(zip(bot, hor, _UP)):
        plan.append({"kind": "up", "idx": i, "cin": b + h, "cout": o})
    return plan


def _prefix(blk: Dict) -> str:
    return (f"unet.path_down.{blk['idx']}.1" if blk["kind"] == "down"
            else f"unet.path_up.{blk['idx']}.conv")


def _param_specs() -> Dict[str, Tuple[int, ...]]:
    """The torch state dict's names and shapes (OIHW convolutions)."""
    specs: Dict[str, Tuple[int, ...]] = {}
    for blk in _unet_plan():
        pre = _prefix(blk)
        if not blk.get("first"):
            specs[f"{pre}.1.weight"] = (blk["cin"],)  # PReLU slopes
        specs[f"{pre}.3.weight"] = (blk["cout"], blk["cin"], 5, 5)
        specs[f"{pre}.3.bias"] = (blk["cout"],)
    return specs


def disk_init_params(generator: torch.Generator,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """He-normal convolutions (HWIO, the reference's layout) drawn from a
    CPU `generator` in the order of the names, PReLU slopes of 0.25, zero
    biases."""
    params = {}
    for name, shape in _param_specs().items():
        if len(shape) == 4:
            o, i, kh, kw = shape
            std = (2.0 / (i * kh * kw)) ** 0.5
            params[name] = torch.randn((kh, kw, i, o), generator=generator,
                                       dtype=dtype) * std
        elif name.endswith("1.weight"):
            params[name] = torch.full(shape, 0.25, dtype=dtype)
        else:
            params[name] = torch.zeros(shape, dtype=dtype)
    return params


def load_torch_weights(state_dict) -> Dict[str, np.ndarray]:
    """A torch DISK state dict (a checkpoint's ['extractor']) → the
    reference's param dict: convolutions OIHW → HWIO, shapes checked."""
    params = {}
    for k, shape in _param_specs().items():
        v = _numpy(state_dict[k])
        if v.shape != tuple(shape):
            raise ValueError(f"{k}: shape {v.shape}, expected {shape}")
        params[k] = v.transpose(2, 3, 1, 0) if v.ndim == 4 else v
    return params


def _conv_block(p: Mapping, pre: str, x: torch.Tensor,
                first: bool) -> torch.Tensor:
    """[instance norm → PReLU →] 5x5 conv, 'same' size."""
    if not first:
        mu = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, correction=0)
        x = (x - mu) * torch.rsqrt(var + 1e-5)
        a = p[f"{pre}.1.weight"].reshape(1, -1, 1, 1)
        x = torch.where(x >= 0, x, a * x)
    return F.conv2d(x, p[f"{pre}.3.weight"], p[f"{pre}.3.bias"], padding=2)


def disk_unet(params: Mapping, images: torch.Tensor) -> torch.Tensor:
    """(B, 3, H, W) → (B, desc_dim + 1, H, W), H and W multiples of 16.
    `params`: the checkpoint's names with OIHW convolutions (a DISK's
    ``params``)."""
    plan = _unet_plan()
    feats = [as_float(images)]
    for blk in (b for b in plan if b["kind"] == "down"):
        h = feats[-1]
        if not blk["first"]:
            h = F.avg_pool2d(h, 2)
        feats.append(_conv_block(params, _prefix(blk), h, blk["first"]))
    bot = feats[-1]
    for blk in (b for b in plan if b["kind"] == "up"):
        hor = feats[-2 - blk["idx"]]
        up = F.interpolate(bot, scale_factor=2, mode="bilinear",
                           align_corners=False)
        bot = _conv_block(params, _prefix(blk), torch.cat([up, hor], 1),
                          False)
    return bot


class DISK(nn.Module):
    """The DISK detector and descriptor. `params`: the reference's dict
    (HWIO convolutions); without it the weights come from `generator`, or
    one seeded with 0 (the reference's key). True float32 (TF32 off)."""

    def __init__(self, desc_dim: int = 128,
                 params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        super().__init__()
        if desc_dim != _UP[-1] - 1:
            raise ValueError("pretrained DISK has desc_dim=128")
        self.desc_dim = desc_dim
        if params is None:
            params = disk_init_params(generator if generator is not None
                                      else torch.Generator().manual_seed(0))
        _register_tree(self, {
            k: (_numpy(v).transpose(3, 2, 0, 1) if _numpy(v).ndim == 4
                else v) for k, v in params.items()}, device)

    @classmethod
    def from_torch(cls, state_dict, device: Device = "cuda") -> "DISK":
        return cls(params=load_torch_weights(state_dict), device=device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Checkpoint name → parameter (OIHW convolutions)."""
        return dict(self.named_parameters())

    @f32_matmul_precision
    def heatmap_and_dense_descriptors(self, images: torch.Tensor
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, 3, H, W) → heatmap (B, 1, H, W), descriptors (B, D, H, W)."""
        out = disk_unet(self.params, images)
        return out[:, self.desc_dim:], out[:, :self.desc_dim]

    def forward(self, images: torch.Tensor, n: int = 512,
                window_size: int = 5, score_threshold: float = 0.0,
                pad_if_not_divisible: bool = True) -> DISKFeatures:
        """Window NMS over the heatmap, then its top `n` scores (the lower
        index first among ties, as ``lax.top_k``; suppressed entries are
        -inf and come out invalid)."""
        images = as_float(images)
        H, W = images.shape[-2:]
        if pad_if_not_divisible:
            images = F.pad(images, (0, (-W) % 16, 0, (-H) % 16))
        heat, desc = self.heatmap_and_dense_descriptors(images)
        heat = heat[..., :H, :W]
        desc = desc[..., :H, :W]
        B = heat.shape[0]
        keep = nms2d(heat, (window_size, window_size), mask_only=True)
        keep = keep & (heat > score_threshold)
        scores = torch.where(keep, heat, -torch.inf)[:, 0].reshape(B, -1)
        vals, idx = top_k(scores, n)
        kp = torch.stack([(idx % W).to(heat.dtype),
                          torch.div(idx, W, rounding_mode="floor").to(
                              heat.dtype)], -1)
        D = desc.shape[1]
        dsel = torch.gather(desc.reshape(B, D, -1), 2,
                            idx[:, None, :].expand(B, D, n)).transpose(1, 2)
        dsel = dsel / torch.linalg.vector_norm(
            dsel, dim=-1, keepdim=True).clamp_min(1e-8)
        valid = torch.isfinite(vals)
        return DISKFeatures(kp, dsel, torch.where(valid, vals, 0.0), valid)
