"""DexiNed, the edge-detection network (counterpart of
``kornia_tpu/models/dexined.py``).

The weights are frozen parameters under the reference state dict's names
(``block_1.conv1.weight``, ...) in torch's layout, the transposed
convolutions' as ``nn.ConvTranspose2d`` holds them, (in, out, k, k), run by
``F.conv_transpose2d(stride=2, padding=pad)``. The JAX package keeps them
as the equivalent lhs-dilated convolution (kernel flipped, in and out
swapped, padding k - 1 - pad); ``convert.dexined_from_numpy`` turns them
back. The six side outputs are resized to the input with the port's
``ops/warp.resize`` (bilinear, half-pixel).

Blocks:
  DoubleConvBlock  conv3x3(s)->BN->ReLU->conv3x3->BN[->ReLU]
  SingleConvBlock  conv1x1(s)[->BN]
  _DenseLayer      ReLU->conv3x3(p=2)->BN->ReLU->conv3x3(p=0)->BN,
                   [x1,x2] -> [0.5*(f(x1)+x2), x2]
  UpConvBlock      (conv1x1->ReLU->convT(k=2^s, s=2))*s + resize
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtype import as_float
from ..core.linalg import f32_matmul_precision
from ..feature import _nets
from ..feature._nets import bn_folded, conv
from ..ops.warp import resize

__all__ = ["DexiNed", "dexined_init_params", "load_torch_weights"]

Device = Union[str, torch.device]

# name -> (in, mid, out, stride, use_act)
_DOUBLE = {
    "block_1": (3, 32, 64, 2, True),
    "block_2": (64, 128, 128, 1, False),
}
# name -> (num_layers, in, out)
_DENSE = {
    "dblock_3": (2, 128, 256),
    "dblock_4": (3, 256, 512),
    "dblock_5": (3, 512, 512),
    "dblock_6": (3, 512, 256),
}
# name -> (in, out, stride, use_bn)
_SINGLE = {
    "side_1": (64, 128, 2, True),
    "side_2": (128, 256, 2, True),
    "side_3": (256, 512, 2, True),
    "side_4": (512, 512, 1, True),
    "side_5": (512, 256, 1, True),  # in the reference, unused by forward
    "pre_dense_2": (128, 256, 2, True),
    "pre_dense_3": (128, 256, 1, True),
    "pre_dense_4": (256, 512, 1, True),
    "pre_dense_5": (512, 512, 1, True),
    "pre_dense_6": (512, 256, 1, True),
    "block_cat": (6, 1, 1, False),
}
# name -> (in, up_scale): stage i's out is 1 if last else 16, kernel
# 2**up_scale, padding _ALL_PADS[up_scale]
_UP = {
    "up_block_1": (64, 1),
    "up_block_2": (128, 1),
    "up_block_3": (256, 2),
    "up_block_4": (512, 3),
    "up_block_5": (512, 4),
    "up_block_6": (256, 4),
}
_ALL_PADS = [0, 0, 1, 3, 7]
_UP_CONST_FEATURES = 16


def _up_stages(in_ch: int, up_scale: int) -> List[Tuple[int, int, int, int]]:
    """(seq index of the conv, in, out, seq index of the convT) of an
    UpConvBlock's stages."""
    stages = []
    cur = in_ch
    for i in range(up_scale):
        out = 1 if i == up_scale - 1 else _UP_CONST_FEATURES
        stages.append((3 * i, cur, out, 3 * i + 2))
        cur = out
    return stages


def _param_specs() -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """State-dict name -> (kind, torch shape); kind conv_w, convT_w or
    vec."""
    specs: Dict[str, Tuple[str, Tuple[int, ...]]] = {}

    def bn(prefix, ch):
        for suffix in ("weight", "bias", "running_mean", "running_var"):
            specs[f"{prefix}.{suffix}"] = ("vec", (ch,))

    for name, (cin, mid, cout, _s, _a) in _DOUBLE.items():
        specs[f"{name}.conv1.weight"] = ("conv_w", (mid, cin, 3, 3))
        specs[f"{name}.conv1.bias"] = ("vec", (mid,))
        bn(f"{name}.bn1", mid)
        specs[f"{name}.conv2.weight"] = ("conv_w", (cout, mid, 3, 3))
        specs[f"{name}.conv2.bias"] = ("vec", (cout,))
        bn(f"{name}.bn2", cout)
    for name, (nl, cin, cout) in _DENSE.items():
        cur = cin
        for i in range(1, nl + 1):
            p = f"{name}.denselayer{i}"
            specs[f"{p}.conv1.weight"] = ("conv_w", (cout, cur, 3, 3))
            specs[f"{p}.conv1.bias"] = ("vec", (cout,))
            bn(f"{p}.norm1", cout)
            specs[f"{p}.conv2.weight"] = ("conv_w", (cout, cout, 3, 3))
            specs[f"{p}.conv2.bias"] = ("vec", (cout,))
            bn(f"{p}.norm2", cout)
            cur = cout
    for name, (cin, cout, _s, _use_bn) in _SINGLE.items():
        specs[f"{name}.conv.weight"] = ("conv_w", (cout, cin, 1, 1))
        specs[f"{name}.conv.bias"] = ("vec", (cout,))
        # the reference always creates the BN, so the checkpoint carries it
        bn(f"{name}.bn", cout)
    for name, (cin, up_scale) in _UP.items():
        k = 2 ** up_scale
        for idx_c, ci, co, idx_t in _up_stages(cin, up_scale):
            specs[f"{name}.features.{idx_c}.weight"] = ("conv_w",
                                                        (co, ci, 1, 1))
            specs[f"{name}.features.{idx_c}.bias"] = ("vec", (co,))
            specs[f"{name}.features.{idx_t}.weight"] = ("convT_w",
                                                        (co, co, k, k))
            specs[f"{name}.features.{idx_t}.bias"] = ("vec", (co,))
    return specs


def _rows():
    return [(k, shape, (k,), kind) for k, (kind, shape) in
            _param_specs().items()]


def dexined_init_params(generator: torch.Generator,
                        dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Xavier-normal convolutions (the reference's weight_init) drawn from
    a CPU `generator` in the table's order, identity batch norms; the
    state dict's layout."""
    params: Dict[str, torch.Tensor] = {}
    for name, (kind, shape) in _param_specs().items():
        if kind in ("conv_w", "convT_w"):
            o, i, kh, kw = shape
            std = math.sqrt(2.0 / ((i + o) * kh * kw))
            params[name] = torch.randn(shape, generator=generator,
                                       dtype=dtype) * std
        elif name.endswith("running_var") or name.endswith(".weight"):
            params[name] = torch.ones(shape, dtype=dtype)
        else:
            params[name] = torch.zeros(shape, dtype=dtype)
    return params


def load_torch_weights(state_dict) -> Dict[str, np.ndarray]:
    """The reference ``DexiNed_BIPED_10.pth`` state dict → DexiNed's
    `params` (each shape checked)."""
    return _nets.check_params(_rows(), state_dict)


def _double_conv(p, name, x):
    _cin, _mid, _cout, stride, use_act = _DOUBLE[name]
    x = F.relu(bn_folded(p, f"{name}.bn1",
                         conv(p, f"{name}.conv1", x, stride, 1)))
    x = bn_folded(p, f"{name}.bn2", conv(p, f"{name}.conv2", x, 1, 1))
    return F.relu(x) if use_act else x


def _single_conv(p, name, x):
    _cin, _cout, stride, use_bn = _SINGLE[name]
    x = conv(p, f"{name}.conv", x, stride, 0)
    return bn_folded(p, f"{name}.bn", x) if use_bn else x


def _dense_block(p, name, x1, x2):
    for i in range(1, _DENSE[name][0] + 1):
        pre = f"{name}.denselayer{i}"
        x3 = F.relu(x1)
        x3 = F.relu(bn_folded(p, f"{pre}.norm1",
                              conv(p, f"{pre}.conv1", x3, 1, 2)))
        x3 = bn_folded(p, f"{pre}.norm2", conv(p, f"{pre}.conv2", x3, 1, 0))
        x1 = 0.5 * (x3 + x2)
    return x1


def _up_block(p, name, x, out_hw):
    cin, up_scale = _UP[name]
    pad = _ALL_PADS[up_scale]
    for idx_c, _ci, _co, idx_t in _up_stages(cin, up_scale):
        x = F.relu(conv(p, f"{name}.features.{idx_c}", x))
        t = f"{name}.features.{idx_t}"
        x = F.conv_transpose2d(x, p[f"{t}.weight"], p[f"{t}.bias"],
                               stride=2, padding=pad)
    return resize(x, tuple(out_hw), "bilinear", align_corners=False)


def _maxpool3x3s2(x):
    return F.max_pool2d(x, 3, 2, 1)


@f32_matmul_precision
def dexined_features(params: Mapping[str, torch.Tensor],
                     images: torch.Tensor) -> List[torch.Tensor]:
    """The six side outputs: (B, 3, H, W) -> six (B, 1, H, W)."""
    x = as_float(images)
    out_hw = images.shape[-2:]
    p = params

    block_1 = _double_conv(p, "block_1", x)
    block_1_side = _single_conv(p, "side_1", block_1)

    block_2 = _double_conv(p, "block_2", block_1)
    block_2_down = _maxpool3x3s2(block_2)
    block_2_add = block_2_down + block_1_side
    block_2_side = _single_conv(p, "side_2", block_2_add)

    block_3_pre_dense = _single_conv(p, "pre_dense_3", block_2_down)
    block_3 = _dense_block(p, "dblock_3", block_2_add, block_3_pre_dense)
    block_3_down = _maxpool3x3s2(block_3)
    block_3_add = block_3_down + block_2_side
    block_3_side = _single_conv(p, "side_3", block_3_add)

    block_2_resize_half = _single_conv(p, "pre_dense_2", block_2_down)
    block_4_pre_dense = _single_conv(p, "pre_dense_4",
                                     block_3_down + block_2_resize_half)
    block_4 = _dense_block(p, "dblock_4", block_3_add, block_4_pre_dense)
    block_4_down = _maxpool3x3s2(block_4)
    block_4_add = block_4_down + block_3_side
    block_4_side = _single_conv(p, "side_4", block_4_add)

    block_5_pre_dense = _single_conv(p, "pre_dense_5", block_4_down)
    block_5 = _dense_block(p, "dblock_5", block_4_add, block_5_pre_dense)
    block_5_add = block_5 + block_4_side

    block_6_pre_dense = _single_conv(p, "pre_dense_6", block_5)
    block_6 = _dense_block(p, "dblock_6", block_5_add, block_6_pre_dense)

    return [_up_block(p, name, feat, out_hw)
            for name, feat in zip(_UP, (block_1, block_2, block_3, block_4,
                                        block_5, block_6))]


@f32_matmul_precision
def dexined_forward(params: Mapping[str, torch.Tensor],
                    images: torch.Tensor) -> torch.Tensor:
    """The fused edge map (B, 1, H, W), before the sigmoid."""
    feats = dexined_features(params, images)
    return _single_conv(params, "block_cat", torch.cat(feats, 1))


class DexiNed(nn.Module):
    """(B, 3, H, W) -> (B, 1, H, W) edges before the sigmoid. `params`:
    the state dict's names and layout; without it the weights come from
    `generator`, or one seeded with 0."""

    def __init__(self, params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        super().__init__()
        if params is None:
            params = dexined_init_params(
                generator if generator is not None
                else torch.Generator().manual_seed(0))
        else:
            params = load_torch_weights(params)
        _nets._register_tree(self, params, device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def get_features(self, images: torch.Tensor) -> List[torch.Tensor]:
        return dexined_features(self.params, images)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return dexined_forward(self.params, images)
