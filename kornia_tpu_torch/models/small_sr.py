"""A small super-resolution net and a UNet segmentor (counterpart of
``kornia_tpu/models/small_sr.py``).

Both JAX nets are flax modules whose input width is read at their first
call; their twins here (``_SmallSRModule``, ``_UNetModule``,
``common.LazyNet``) draw their parameters then, on `device`, from a
generator seeded with 0, or take the dict given to ``load_params`` (flax's
names, ``Conv_0.weight``, ..., in torch's layout;
``convert.{small_sr,unet_segmentor}_from_numpy`` carry flax variables
across). The JAX package resizes with ``jax.image.resize(..., "bilinear")``,
which on these upsamplings (every output at or above its input) is
``F.interpolate(mode="bilinear", align_corners=False)``: both sample at
half-pixel centres and take the edge pixel where the sample falls
outside, as the parity tests hold.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Union

import torch
import torch.nn.functional as F

from ..core.linalg import f32_matmul_precision
from ..feature._nets import Row, conv_rows, norm_rows
from .common import LazyNet, group_norm, same_conv

__all__ = ["SmallSR", "UNetSegmentor"]

Device = Union[str, torch.device]


def _upsample(x: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(x, size=tuple(hw), mode="bilinear",
                         align_corners=False)


class _SmallSRModule(LazyNet):
    """Residual convolutions, a pixel shuffle and the bilinear upsample of
    the input's first three channels added."""

    def __init__(self, scale: int = 2, ch: int = 32, blocks: int = 4,
                 parent=None, name: Optional[str] = None,
                 device: Device = "cuda"):
        super().__init__()
        self.scale, self.ch, self.blocks = scale, ch, blocks
        self._lazy(device)

    def _rows(self, cin: int) -> List[Row]:
        rows = conv_rows("Conv_0", self.ch, cin, 3, ("Conv_0",))
        for i in range(1, 2 * self.blocks + 1):
            rows += conv_rows(f"Conv_{i}", self.ch, self.ch, 3, (f"Conv_{i}",))
        last = f"Conv_{2 * self.blocks + 1}"
        return rows + conv_rows(last, 3 * self.scale ** 2, self.ch, 3,
                                (last,))

    @f32_matmul_precision
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._ensure(x.shape[1])
        p = dict(self.named_parameters())

        def conv(i, t):
            return same_conv(t, p[f"Conv_{i}.weight"], p[f"Conv_{i}.bias"])

        h = conv(0, x)
        skip = h
        for b in range(self.blocks):
            h = h + conv(2 + 2 * b, F.relu(conv(1 + 2 * b, h)))
        h = conv(2 * self.blocks + 1, h + skip)
        # the reference's shuffle: (B, H, W, s, s, 3) → channel (i·s + j)·3
        # + c, unlike torch's pixel_shuffle (c·s² + i·s + j)
        B, _, H, W = h.shape
        s = self.scale
        h = h.reshape(B, s, s, 3, H, W).permute(0, 3, 4, 1, 5, 2).reshape(
            B, 3, H * s, W * s)
        return h + _upsample(x[:, :3], (H * s, W * s))


class SmallSR:
    """2x / 4x super-resolution: (B, C >= 3, H, W) → (B, 3, sH, sW).
    `params`: ``_SmallSRModule``'s (flax's names, torch layout); without
    them the net draws from `generator`, or one seeded with 0, at its first
    call."""

    def __init__(self, scale: int = 2, params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        self.module = _SmallSRModule(scale=scale, device=device)
        self.module.load_params(params, generator)
        self.scale = scale

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        return self.module(images)


class _UNetModule(LazyNet):
    """Three-level UNet: two (conv, GroupNorm(4), ReLU) a block, 2x2
    average pools down, bilinear upsamples and concatenations up, a 1x1
    classifier."""

    def __init__(self, num_classes: int, base_ch: int = 16, parent=None,
                 name: Optional[str] = None, device: Device = "cuda"):
        super().__init__()
        self.num_classes, self.base_ch = num_classes, base_ch
        self._lazy(device)

    def _plan(self, cin: int):
        """(in, out) of the ten block convolutions, flax's order."""
        c = self.base_ch
        blocks = [(cin, c), (c, 2 * c), (2 * c, 4 * c), (6 * c, 2 * c),
                  (3 * c, c)]
        plan = []
        for i, o in blocks:
            plan += [(i, o), (o, o)]
        return plan

    def _rows(self, cin: int) -> List[Row]:
        rows = []
        for j, (i, o) in enumerate(self._plan(cin)):
            rows += conv_rows(f"Conv_{j}", o, i, 3, (f"Conv_{j}",),
                              bias=False)
            rows += norm_rows(f"GroupNorm_{j}", o, (f"GroupNorm_{j}",))
        return rows + conv_rows("Conv_10", self.num_classes, self.base_ch, 1,
                                ("Conv_10",))

    @f32_matmul_precision
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._ensure(x.shape[1])
        p = dict(self.named_parameters())
        n = iter(range(10))

        def block(h):
            for _ in range(2):
                j = next(n)
                h = F.relu(group_norm(same_conv(h, p[f"Conv_{j}.weight"]),
                                      p, f"GroupNorm_{j}"))
            return h

        d1 = block(x)
        d2 = block(F.avg_pool2d(d1, 2, 2))
        d3 = block(F.avg_pool2d(d2, 2, 2))
        c2 = block(torch.cat([_upsample(d3, d2.shape[-2:]), d2], 1))
        c1 = block(torch.cat([_upsample(c2, d1.shape[-2:]), d1], 1))
        return F.conv2d(c1, p["Conv_10.weight"], p["Conv_10.bias"])


class UNetSegmentor:
    """Semantic segmentation: (B, 3, H, W) → (B, num_classes, H, W)
    logits. `params`: ``_UNetModule``'s (flax's names, torch layout);
    without them the net draws from `generator`, or one seeded with 0, at
    its first call."""

    def __init__(self, num_classes: int = 21,
                 params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        self.module = _UNetModule(num_classes, device=device)
        self.module.load_params(params, generator)

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        return self.module(images)
