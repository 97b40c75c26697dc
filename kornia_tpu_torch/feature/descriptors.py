"""Key.Net, the learned multi-scale response network (counterpart of
``KeyNet`` in ``kornia_tpu/feature/descriptors.py``; the other nets of that
module wait for a later slice).

Per pyramid level (``pyrdown`` by 1.2, `num_levels` levels) a handcrafted
block computes 10 maps from iterated Sobel gradients and a learnable block
runs three conv → batch norm → ReLU layers; every level is resized back to
the input size, the levels are concatenated and a final conv → ReLU gives
the (B, 1, H, W) response. The weights keep the published checkpoint's
names (``feature_extractor.lb_block.conv0.0.weight``, ...) as a module tree
of parameters that do not require grad (see ``hardnet.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtype import as_float
from ..core.linalg import f32_matmul_precision
from ..ops.filters import spatial_gradient
from ..ops.pyramid import pyrdown
from ..ops.warp import resize
from .hardnet import _numpy, _register_tree, _running_bn

__all__ = ["KeyNet", "load_keynet_torch_weights"]

Device = Union[str, torch.device]


def _convert_torch(state_dict, specs) -> Dict[str, np.ndarray]:
    """A torch state dict → the param dict under the same names, each
    entry's shape checked against `specs`."""
    params = {}
    for k, shape in specs.items():
        v = _numpy(state_dict[k])
        if v.shape != tuple(shape):
            raise ValueError(f"{k}: shape {v.shape}, expected {shape}")
        params[k] = v
    return params


def _init_from_specs(generator: torch.Generator, specs,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """He-normal conv weights drawn from a CPU `generator` in the order of
    `specs`, unit running variances and norm scales, zero means and
    biases."""
    params = {}
    for name, shape in specs.items():
        if name.endswith("running_var"):
            params[name] = torch.ones(shape, dtype=dtype)
        elif len(shape) >= 2:
            fan_in = math.prod(shape[1:])
            params[name] = torch.randn(shape, generator=generator,
                                       dtype=dtype) * math.sqrt(2.0 / fan_in)
        elif name.endswith(".weight"):
            params[name] = torch.ones(shape, dtype=dtype)
        else:
            params[name] = torch.zeros(shape, dtype=dtype)
    return params


class KeyNet(nn.Module):
    """Key.Net response map: (B, 1, H, W) → (B, 1, H, W). `params` is the
    reference's dict (checkpoint names; numpy arrays or tensors); without
    it the weights come from `generator`, or one seeded with 3 (the
    reference's key). With `sigmas` the response is scaled by σ² (the
    scale-space detector's convention). Runs in true float32 (TF32 off)."""

    def __init__(self, params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 num_filters: int = 8, num_levels: int = 3,
                 kernel_size: int = 5, device: Device = "cuda"):
        super().__init__()
        self.num_filters = num_filters
        self.num_levels = num_levels
        self.kernel_size = kernel_size
        if params is None:
            params = _init_from_specs(
                generator if generator is not None
                else torch.Generator().manual_seed(3),
                self._specs(num_filters, num_levels, kernel_size))
        _register_tree(self, params, device)

    @staticmethod
    def _specs(num_filters: int = 8, num_levels: int = 3,
               kernel_size: int = 5) -> Dict[str, Tuple[int, ...]]:
        specs: Dict[str, Tuple[int, ...]] = {}
        cin = 10
        for i in range(3):
            pre = f"feature_extractor.lb_block.conv{i}"
            specs[f"{pre}.0.weight"] = (num_filters, cin, kernel_size,
                                        kernel_size)
            specs[f"{pre}.0.bias"] = (num_filters,)
            for suffix in ("weight", "bias", "running_mean", "running_var"):
                specs[f"{pre}.1.{suffix}"] = (num_filters,)
            cin = num_filters
        specs["last_conv.0.weight"] = (1, num_filters * num_levels,
                                       kernel_size, kernel_size)
        specs["last_conv.0.bias"] = (1,)
        return specs

    @classmethod
    def from_torch(cls, state_dict, num_filters: int = 8,
                   num_levels: int = 3, kernel_size: int = 5,
                   device: Device = "cuda") -> "KeyNet":
        return cls(_convert_torch(
            state_dict, cls._specs(num_filters, num_levels, kernel_size)),
            num_filters=num_filters, num_levels=num_levels,
            kernel_size=kernel_size, device=device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Checkpoint name → parameter."""
        return dict(self.named_parameters())

    @staticmethod
    def _handcrafted(x: torch.Tensor) -> torch.Tensor:
        """The 10 gradient maps, in the reference's order."""
        g = spatial_gradient(x, "sobel", 1)
        dx, dy = g[:, :, 0], g[:, :, 1]
        gx2 = spatial_gradient(dx, "sobel", 1)
        dxx, dxy = gx2[:, :, 0], gx2[:, :, 1]
        dyy = spatial_gradient(dy, "sobel", 1)[:, :, 1]
        return torch.cat([dx, dy, dx * dx, dy * dy, dx * dy, dxy, dxy * dxy,
                          dxx, dyy, dxx * dyy], dim=1)

    def _extract(self, x: torch.Tensor, p: Mapping) -> torch.Tensor:
        h = self._handcrafted(x)
        pad = self.kernel_size // 2
        for i in range(3):
            pre = f"feature_extractor.lb_block.conv{i}"
            h = F.conv2d(h, p[f"{pre}.0.weight"], p[f"{pre}.0.bias"],
                         padding=pad)
            # batch norm on the running statistics in every mode
            h = F.relu(_running_bn(h, p[f"{pre}.1.running_mean"],
                                   p[f"{pre}.1.running_var"],
                                   p[f"{pre}.1.weight"], p[f"{pre}.1.bias"]))
        return h

    @f32_matmul_precision
    def forward(self, x: torch.Tensor,
                sigmas: Optional[torch.Tensor] = None) -> torch.Tensor:
        p = self.params
        x = as_float(x)
        H, W = x.shape[-2:]
        feats = [self._extract(x, p)]
        for _ in range(1, self.num_levels):
            x = pyrdown(x, factor=1.2)
            feats.append(resize(self._extract(x, p), (H, W), "bilinear",
                                align_corners=False))
        out = F.relu(F.conv2d(torch.cat(feats, dim=1),
                              p["last_conv.0.weight"], p["last_conv.0.bias"],
                              padding=self.kernel_size // 2))
        if sigmas is not None:
            s = torch.as_tensor(sigmas, dtype=out.dtype,
                                device=out.device).reshape(-1, 1, 1, 1)
            out = out * (s * s)
        return out


def load_keynet_torch_weights(state_dict) -> Dict[str, np.ndarray]:
    """The published Key.Net checkpoint → the param dict (shapes
    checked)."""
    return _convert_torch(state_dict, KeyNet._specs())
