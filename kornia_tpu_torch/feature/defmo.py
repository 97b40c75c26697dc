"""DeFMO, fast-moving-object deblurring (counterpart of
``kornia_tpu/feature/defmo.py``): a ResNet-50 encoder with a 6-channel stem
(the blurred image and a background) and no max pool gives a stride-16
latent; a time-conditioned decoder of bottlenecks and pixel shuffles
renders T RGBA sub-frames, the T time steps folded into the batch so that
the decoder runs once. The stride-2 convolutions pad symmetrically, as
torch's and the reference's explicit pads do.

The nets are ``nn.Module``s on NCHW tensors whose weights are frozen
parameters under the reference checkpoint's names (``encoder.net.1.0.0.
conv1.weight``, ``rendering.net.0.weight``, ...); built without parameters,
they are drawn from a CPU generator seeded with 0. ``convert.
defmo_from_numpy`` carries the JAX variables across.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.check import check
from ..core.dtype import as_float
from ..core.grid import linspace
from ..core.linalg import f32_matmul_precision
from . import _nets
from ._nets import Row, bn, bn_rows, conv, conv_rows

__all__ = ["DeFMO", "EncoderDeFMO", "RenderingDeFMO", "load_torch_weights"]

Device = Union[str, torch.device]

_LAYERS = (3, 4, 6, 3)


def _bottleneck_rows(pre: str, cin: int, planes: int, downsample: bool,
                     fp: Sequence[str]) -> List[Row]:
    rows: List[Row] = []
    for i, (co, ci, k) in enumerate(((planes, cin, 1), (planes, planes, 3),
                                     (4 * planes, planes, 1))):
        rows += conv_rows(f"{pre}.conv{i + 1}", co, ci, k, (*fp, f"Conv_{i}"),
                          bias=False)
        rows += bn_rows(f"{pre}.bn{i + 1}", co, (*fp, f"BatchNorm_{i}"))
    if downsample:
        rows += conv_rows(f"{pre}.downsample.0", 4 * planes, cin, 1,
                          (*fp, "downsample"), bias=False)
        rows += bn_rows(f"{pre}.downsample.1", 4 * planes,
                        (*fp, "BatchNorm_3"))
    return rows


def _encoder_rows(layers: Sequence[int] = _LAYERS,
                  fp: Sequence[str] = ()) -> List[Row]:
    rows = conv_rows("encoder.net.0.0", 64, 6, 7, (*fp, "stem"), bias=False)
    rows += bn_rows("encoder.net.0.1", 64, (*fp, "BatchNorm_0"))
    cin = 64
    for li, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
        for b in range(n):
            rows += _bottleneck_rows(f"encoder.net.1.{li}.{b}", cin, planes,
                                     b == 0, (*fp, f"layer{li + 1}_{b}"))
            cin = 4 * planes
    return rows


def _rendering_rows(fp: Sequence[str] = ()) -> List[Row]:
    rows = conv_rows("rendering.net.0", 1024, 2049, 3, (*fp, "Conv_0"),
                     bias=False)
    rows += bn_rows("rendering.net.1", 1024, (*fp, "BatchNorm_0"))
    for i, (idx, planes) in enumerate(((3, 256), (5, 64), (7, 16))):
        rows += _bottleneck_rows(f"rendering.net.{idx}", 4 * planes, planes,
                                 False, (*fp, f"_Bottleneck_{i}"))
    rows += conv_rows("rendering.net.9", 16, 16, 3, (*fp, "Conv_1"),
                      bias=False)
    rows += conv_rows("rendering.net.11", 4, 4, 3, (*fp, "Conv_2"))
    rows += conv_rows("rendering.net.13", 4, 4, 3, (*fp, "Conv_3"))
    return rows


def _param_rows() -> List[Row]:
    return _encoder_rows(fp=("encoder",)) + _rendering_rows(("rendering",))


def load_torch_weights(state_dict) -> dict:
    """The reference DeFMO state dict (``encoder.net.*`` and
    ``rendering.net.*``; the two standalone artifacts' ``net.*`` keys
    merged under those prefixes by the caller) → the port's param dict
    (the checkpoint's names, float32 arrays, each shape checked)."""
    return _nets.check_params(_param_rows(), state_dict)


def _bottleneck(p: Mapping, pre: str, x: torch.Tensor, stride: int = 1,
                downsample: bool = False) -> torch.Tensor:
    y = F.relu(bn(p, f"{pre}.bn1", conv(p, f"{pre}.conv1", x)))
    y = F.relu(bn(p, f"{pre}.bn2", conv(p, f"{pre}.conv2", y, stride, 1)))
    y = bn(p, f"{pre}.bn3", conv(p, f"{pre}.conv3", y))
    idn = (bn(p, f"{pre}.downsample.1",
              conv(p, f"{pre}.downsample.0", x, stride))
           if downsample else x)
    return F.relu(y + idn)


@f32_matmul_precision
def _encode(p: Mapping, x: torch.Tensor,
            layers: Sequence[int] = _LAYERS) -> torch.Tensor:
    """(B, 6, H, W) → (B, 2048, H/16, W/16)."""
    x = F.relu(bn(p, "encoder.net.0.1", conv(p, "encoder.net.0.0", x, 2, 3)))
    for li, (n, stride) in enumerate(zip(layers, (1, 2, 2, 2))):
        for b in range(n):
            x = _bottleneck(p, f"encoder.net.1.{li}.{b}", x,
                            stride if b == 0 else 1, b == 0)
    return x


@f32_matmul_precision
def _render(p: Mapping, latent: torch.Tensor, T: int) -> torch.Tensor:
    """(B, 2048, h, w) → (B, T, 4, 16h, 16w) RGBA: the time channel first,
    the T steps folded into the batch."""
    B, C, h, w = latent.shape
    times = linspace(0.0, 1.0, T, latent.device).to(latent.dtype)
    lat = latent[:, None].expand(B, T, C, h, w).reshape(B * T, C, h, w)
    tch = times[None, :, None, None, None].expand(B, T, 1, h, w).reshape(
        B * T, 1, h, w)
    x = torch.cat([tch, lat], 1)
    x = F.relu(bn(p, "rendering.net.1", conv(p, "rendering.net.0", x,
                                             padding=1)))
    for idx in (3, 5, 7):
        x = F.pixel_shuffle(_bottleneck(p, f"rendering.net.{idx}", x), 2)
    x = F.pixel_shuffle(conv(p, "rendering.net.9", x, padding=1), 2)
    x = F.relu(conv(p, "rendering.net.11", x, padding=1))
    x = torch.sigmoid(conv(p, "rendering.net.13", x, padding=1))
    return x.reshape(B, T, 4, 16 * h, 16 * w)


class EncoderDeFMO(nn.Module):
    """The ResNet-50 encoder: (B, 6, H, W) → (B, 2048, H/16, W/16).
    `parent` and `name` are flax's module-tree arguments, accepted for the
    reference's signature and unused; the weights are drawn from a
    generator seeded with 0."""

    def __init__(self, layers: Sequence[int] = _LAYERS, parent=None,
                 name: Optional[str] = None, device: Device = "cuda"):
        super().__init__()
        self.layers = tuple(layers)
        _nets.with_params(self, _encoder_rows(self.layers), None, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _encode(dict(self.named_parameters()), as_float(x),
                       self.layers)


class RenderingDeFMO(nn.Module):
    """The time-conditioned decoder: (B, 2048, h, w) → (B, T, 4, 16h, 16w)
    RGBA. `parent` and `name` as EncoderDeFMO's."""

    def __init__(self, tsr_steps: int = 24, parent=None,
                 name: Optional[str] = None, device: Device = "cuda"):
        super().__init__()
        self.tsr_steps = tsr_steps
        _nets.with_params(self, _rendering_rows(), None, device)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        return _render(dict(self.named_parameters()), latent,
                       self.tsr_steps)


class DeFMO(nn.Module):
    """Deblur a fast-moving object into T RGBA sub-frames. Call with
    (B, 6, H, W), the blurred RGB and a background estimate, H and W
    multiples of 16 → (B, T, 4, H, W). `params`: the checkpoint's names
    (``load_torch_weights``); without it the weights come from `generator`,
    or one seeded with 0 (the reference's key)."""

    def __init__(self, tsr_steps: int = 24, params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        super().__init__()
        self.tsr_steps = tsr_steps
        _nets.with_params(self, _param_rows(), params, device, generator)

    def encode(self, images: torch.Tensor) -> torch.Tensor:
        B, C, H, W = images.shape
        check(C == 6, f"DeFMO expects (B, 6, H, W) input, got C={C}")
        check(H % 16 == 0 and W % 16 == 0,
              f"DeFMO needs H, W divisible by 16, got {H}x{W}")
        return _encode(dict(self.named_parameters()), as_float(images))

    def render(self, latent: torch.Tensor) -> torch.Tensor:
        return _render(dict(self.named_parameters()), latent,
                       self.tsr_steps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.render(self.encode(images))
