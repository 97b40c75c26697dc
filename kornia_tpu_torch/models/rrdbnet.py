"""RRDBNet, the ESRGAN / Real-ESRGAN generator (counterpart of
``kornia_tpu/models/rrdbnet.py``): conv_first, N RRDBs of three residual
dense blocks of five convolutions, the trunk convolution, two nearest x2
upsamples with their convolutions, the HR and last convolutions; a
pixel-unshuffled input for scale 2 and 1.

The weights are frozen parameters under basicsr's state dict names
(``body.0.rdb1.conv1.weight``, ...) in torch's layout, so the published
``params_ema`` checkpoints load with ``load_torch_weights``;
``convert.rrdbnet_from_numpy`` carries the JAX package's HWIO dict across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.linalg import f32_matmul_precision
from ..feature import _nets

__all__ = ["RRDBNet", "RRDBNetConfig", "RRDBNetBuilder", "init_params",
           "load_torch_weights"]

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class RRDBNetConfig:
    num_in_ch: int = 3
    num_out_ch: int = 3
    num_feat: int = 64
    num_block: int = 23
    num_grow_ch: int = 32
    scale: int = 4

    @staticmethod
    def from_name(name: str) -> "RRDBNetConfig":
        presets = {
            "RealESRGAN_x4plus": (23, 4),
            "RealESRNet_x4plus": (23, 4),
            "RealESRGAN_x4plus_anime_6B": (6, 4),
            "RealESRGAN_x2plus": (23, 2),
        }
        if name not in presets:
            raise ValueError(
                f"Model {name} not found. Please choose from "
                "'RealESRGAN_x4plus', 'RealESRNet_x4plus', "
                "'RealESRGAN_x4plus_anime_6B', 'RealESRGAN_x2plus'.")
        nb, sc = presets[name]
        return RRDBNetConfig(num_block=nb, scale=sc)


def _param_specs(cfg: RRDBNetConfig):
    f, g = cfg.num_feat, cfg.num_grow_ch
    in_ch = cfg.num_in_ch * {2: 4, 1: 16}.get(cfg.scale, 1)
    s: Dict[str, tuple] = {}

    def conv(name, i, o, k=3):
        s[f"{name}.weight"] = ("conv", (o, i, k, k))
        s[f"{name}.bias"] = ("raw", (o,))

    conv("conv_first", in_ch, f)
    for b in range(cfg.num_block):
        for r in (1, 2, 3):
            for c in range(1, 6):
                conv(f"body.{b}.rdb{r}.conv{c}", f + (c - 1) * g,
                     g if c < 5 else f)
    conv("conv_body", f, f)
    conv("conv_up1", f, f)
    conv("conv_up2", f, f)
    conv("conv_hr", f, f)
    conv("conv_last", f, cfg.num_out_ch)
    return s


def _rows(cfg: RRDBNetConfig):
    return [(k, shape, (k,), kind) for k, (kind, shape) in
            _param_specs(cfg).items()]


def init_params(generator: torch.Generator, cfg: RRDBNetConfig,
                dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """basicsr's 0.1-scaled He-normal convolutions drawn from a CPU
    `generator` in the table's order, zero biases."""
    params: Dict[str, torch.Tensor] = {}
    for name, (kind, shape) in _param_specs(cfg).items():
        if kind == "conv":
            std = 0.1 * math.sqrt(2.0 / math.prod(shape[1:]))
            params[name] = torch.randn(shape, generator=generator,
                                       dtype=dtype) * std
        else:
            params[name] = torch.zeros(shape, dtype=dtype)
    return params


def load_torch_weights(state_dict, cfg: Optional[RRDBNetConfig] = None
                       ) -> Dict[str, np.ndarray]:
    """A basicsr RRDBNet state dict (or a checkpoint holding one under
    "params_ema") → RRDBNet's `params`, each shape checked."""
    cfg = cfg or RRDBNetConfig()
    if "params_ema" in state_dict:
        state_dict = state_dict["params_ema"]
    return _nets.check_params(_rows(cfg), state_dict)


def _conv3(p, name, x):
    return F.conv2d(x, p[f"{name}.weight"], p[f"{name}.bias"], 1, 1)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _rdb(p, prefix, x):
    """ResidualDenseBlock: five dense convolutions, the residual scaled
    by 0.2."""
    feats = [x]
    for c in range(1, 5):
        feats.append(_lrelu(_conv3(p, f"{prefix}.conv{c}",
                                   torch.cat(feats, 1))))
    return _conv3(p, f"{prefix}.conv5", torch.cat(feats, 1)) * 0.2 + x


def _pixel_unshuffle(x, r):
    """torch's pixel_unshuffle: channel c·r² + i·r + j."""
    return F.pixel_unshuffle(x, r)


def _nearest2x(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


@f32_matmul_precision
def forward(p: Mapping[str, torch.Tensor], cfg: RRDBNetConfig,
            images: torch.Tensor) -> torch.Tensor:
    """images (B, C, H, W) -> (B, C_out, scale·H, scale·W)."""
    x = images
    if cfg.scale == 2:
        x = _pixel_unshuffle(x, 2)
    elif cfg.scale == 1:
        x = _pixel_unshuffle(x, 4)
    feat = _conv3(p, "conv_first", x)
    body = feat
    for b in range(cfg.num_block):
        h = body
        for r in (1, 2, 3):
            h = _rdb(p, f"body.{b}.rdb{r}", h)
        body = h * 0.2 + body
    feat = feat + _conv3(p, "conv_body", body)
    feat = _lrelu(_conv3(p, "conv_up1", _nearest2x(feat)))
    feat = _lrelu(_conv3(p, "conv_up2", _nearest2x(feat)))
    return _conv3(p, "conv_last", _lrelu(_conv3(p, "conv_hr", feat)))


class RRDBNet(nn.Module):
    """basicsr's RRDBNet. `params`: the state dict's names and layout;
    without it the weights come from `generator`, or one seeded with 0."""

    def __init__(self, cfg: Optional[RRDBNetConfig] = None, params=None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        super().__init__()
        self.cfg = cfg or RRDBNetConfig()
        if params is None:
            params = init_params(generator if generator is not None
                                 else torch.Generator().manual_seed(0),
                                 self.cfg)
        else:
            params = load_torch_weights(params, self.cfg)
        _nets._register_tree(self, params, device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return forward(self.params, self.cfg, images)


class RRDBNetBuilder:
    """A ``contrib.SuperResolution`` around an RRDBNet preset, its output
    clamped to [0, 1]."""

    @staticmethod
    def build(model_name: str = "RealESRNet_x4plus", params=None,
              device: Device = "cuda"):
        from ..contrib import SuperResolution
        model = RRDBNet(RRDBNetConfig.from_name(model_name), params,
                        device=device)
        return SuperResolution(model,
                               post_processor=lambda x: x.clamp(0.0, 1.0))
