"""OriNet and AffNet, the learned LAF refiners (counterpart of
``kornia_tpu/feature/affnet.py``).

Both nets share one trunk over standardised 32x32 patches: six bias-free
convolutions, each followed by a batch norm with running statistics only and
ReLU, then an 8x8 head conv with bias, tanh and a global mean. OriNet's head
(padded by 1) gives a (cos-ish, sin-ish) pair → angle; AffNet's (unpadded)
gives the three free entries of a lower-triangular shape update. Weights
are the reference's flat dict, held as parameters that do not require grad
(see ``hardnet.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtype import as_float
from ..core.linalg import f32_matmul_precision
from ..ops.color import rgb_to_grayscale
from .hardnet import _frozen, _numpy, _running_bn, _torch_key_order
from .laf import (extract_patches_from_pyramid, get_laf_orientation,
                  get_laf_scale, make_upright, scale_laf,
                  set_laf_orientation)

__all__ = ["OriNet", "AffNet", "LAFAffNetShapeEstimator",
           "load_orinet_torch_weights", "load_affnet_torch_weights"]

Device = Union[str, torch.device]

# shared trunk: (out_ch, kernel, stride, padding), conv bias=False, each
# followed by BatchNorm2d(affine=False) + ReLU
_TRUNK = [
    (16, 3, 1, 1),
    (16, 3, 1, 1),
    (32, 3, 2, 1),
    (32, 3, 1, 1),
    (64, 3, 2, 1),
    (64, 3, 1, 1),
]


def _init_params(generator: torch.Generator, head_out: int, head_pad: int,
                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """He-normal weights drawn from a CPU `generator`, zero means, unit
    variances, zero head bias."""
    params = {}
    in_ch = 1
    for i, (out_ch, k, _, _) in enumerate(_TRUNK):
        params[f"conv{i}_w"] = torch.randn(
            (out_ch, in_ch, k, k), generator=generator, dtype=dtype) \
            * math.sqrt(2.0 / (in_ch * k * k))
        params[f"bn{i}_mean"] = torch.zeros(out_ch, dtype=dtype)
        params[f"bn{i}_var"] = torch.ones(out_ch, dtype=dtype)
        in_ch = out_ch
    params["head_w"] = torch.randn((head_out, in_ch, 8, 8),
                                   generator=generator, dtype=dtype) \
        * math.sqrt(2.0 / (in_ch * 64))
    params["head_b"] = torch.zeros(head_out, dtype=dtype)
    return params


@f32_matmul_precision
def _trunk_forward(params: Mapping[str, torch.Tensor], patches: torch.Tensor,
                   head_pad: int, eps: float = 1e-6) -> torch.Tensor:
    """Patches → (B, head_out) after tanh and the global mean, in true
    float32 (TF32 off)."""
    x = as_float(patches)
    # per-patch standardisation with the UNBIASED variance
    mu = x.mean(dim=(1, 2, 3), keepdim=True)
    var = x.var(dim=(1, 2, 3), keepdim=True,
                correction=int(x[0].numel() > 1))
    x = (x - mu) / (torch.sqrt(var) + eps)
    for i, (_, _, s, pad) in enumerate(_TRUNK):
        x = F.relu(_running_bn(
            F.conv2d(x, params[f"conv{i}_w"], stride=s, padding=pad),
            params[f"bn{i}_mean"], params[f"bn{i}_var"]))
    # dropout(0.25) is the identity at inference
    x = torch.tanh(F.conv2d(x, params["head_w"], params["head_b"],
                            padding=head_pad))
    return x.mean(dim=(2, 3))  # AdaptiveAvgPool2d(1)


def _convert_torch(state_dict, n_trunk: int = len(_TRUNK)) -> Dict:
    """``features.N.{weight,bias,running_mean,running_var}`` → the param
    dict, in the order of the layer index."""
    items = sorted(((k, _numpy(v)) for k, v in state_dict.items()
                    if k.split(".")[-1] in
                    ("weight", "bias", "running_mean", "running_var")),
                   key=lambda kv: _torch_key_order(kv[0]))
    params: Dict = {}
    conv_i = 0
    for k, v in items:
        leaf = k.split(".")[-1]
        if leaf == "weight" and v.ndim == 4:
            params[f"conv{conv_i}_w" if conv_i < n_trunk else "head_w"] = v
        elif leaf == "bias" and v.ndim == 1 and conv_i >= n_trunk:
            params["head_b"] = v
        elif leaf == "running_mean":
            params[f"bn{conv_i}_mean"] = v
        elif leaf == "running_var":
            params[f"bn{conv_i}_var"] = v
            conv_i += 1
    return params


def load_orinet_torch_weights(state_dict) -> Dict:
    """The reference OriNet checkpoint (``features.N.*``) → param dict."""
    return _convert_torch(state_dict)


def load_affnet_torch_weights(state_dict) -> Dict:
    """The reference AffNet checkpoint (``features.N.*``) → param dict."""
    return _convert_torch(state_dict)


class _TrunkNet(nn.Module):
    def __init__(self, params: Mapping, device: Device):
        super().__init__()
        self.params = nn.ParameterDict(
            {k: _frozen(v, device) for k, v in params.items()})


class OriNet(_TrunkNet):
    """Canonical patch orientation in radians, zero pointing right:
    (B, 1, 32, 32) → (B,). Without `params` the weights come from a
    generator seeded with 0, the reference's key."""

    patch_size = 32

    def __init__(self, params: Optional[Mapping] = None, eps: float = 1e-8,
                 device: Device = "cuda"):
        super().__init__(params if params is not None else _init_params(
            torch.Generator().manual_seed(0), head_out=2, head_pad=1), device)
        self.eps = eps

    def forward(self, patch: torch.Tensor) -> torch.Tensor:
        xy = _trunk_forward(self.params, patch, head_pad=1)
        return torch.atan2(xy[:, 0] + 1e-8, xy[:, 1] + self.eps)


class AffNet(_TrunkNet):
    """Affine-shape residual net: (B, 1, 32, 32) → (B, 3) tanh outputs.
    Without `params` the weights come from a generator seeded with 1, the
    reference's key."""

    patch_size = 32

    def __init__(self, params: Optional[Mapping] = None,
                 device: Device = "cuda"):
        super().__init__(params if params is not None else _init_params(
            torch.Generator().manual_seed(1), head_out=3, head_pad=0), device)

    def forward(self, patch: torch.Tensor) -> torch.Tensor:
        return _trunk_forward(self.params, patch, head_pad=0)


class LAFAffNetShapeEstimator(nn.Module):
    """Replace each LAF's shape with AffNet's estimate on its upright
    patch, keeping the original scale (and, with `preserve_orientation`,
    the orientation; otherwise the result is upright)."""

    def __init__(self, params: Optional[Mapping] = None,
                 preserve_orientation: bool = True, device: Device = "cuda"):
        super().__init__()
        self.net = AffNet(params, device)
        self.patch_size = 32
        self.preserve_orientation = preserve_orientation

    def forward(self, laf: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        B, N = laf.shape[:2]
        PS = self.patch_size
        patches = extract_patches_from_pyramid(img, make_upright(laf), PS)
        patches = patches.reshape(B * N, -1, PS, PS)
        if patches.shape[1] == 3:
            patches = rgb_to_grayscale(patches)
        xy = self.net(patches)  # (B*N, 3)
        # A' = [[1 + x0, 0], [x1, 1 + x2]]
        a = torch.stack([1.0 + xy[:, 0], torch.zeros_like(xy[:, 0]),
                         xy[:, 1], 1.0 + xy[:, 2]], dim=-1)
        new_laf = torch.cat([a.reshape(B, N, 2, 2), laf[..., :, 2:3]], dim=-1)
        laf_out = scale_laf(make_upright(new_laf),
                            get_laf_scale(laf) / get_laf_scale(new_laf))
        if self.preserve_orientation:
            laf_out = set_laf_orientation(laf_out, get_laf_orientation(laf))
        return laf_out
