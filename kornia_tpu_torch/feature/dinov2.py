"""The DINOv2 vision transformer backbone (counterpart of
``kornia_tpu/feature/dinov2.py``), the frozen encoder of DeDoDe-G.

A stride-p patch projection, the class token, the position embedding
interpolated to the patch grid by the exact operator of torch's
``F.interpolate(mode="bicubic", align_corners=False, antialias=False)``
with the reference's ``(g + 0.1) / pos_grid`` scale, then pre-norm blocks
with LayerScale and exact GELU (LayerNorm epsilon 1e-6), and the final
LayerNorm. Attention is ``F.scaled_dot_product_attention`` in float32 (no
TPU kernel computes it); outside f32_precision the card may sum in another
order than the CPU. The weights are frozen parameters under the torch
checkpoint's names (``blocks.0.attn.qkv.weight``, ...); built without
parameters, they are drawn from a CPU generator seeded with 0.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtype import device_table
from ..core.linalg import f32_matmul_precision
from . import _nets
from ._nets import Row, conv_rows, dense_rows, norm_rows

__all__ = ["DinoV2ViT", "load_dinov2_torch_weights", "VIT_LARGE_CFG"]

Device = Union[str, torch.device]

VIT_LARGE_CFG = dict(patch_size=14, embed_dim=1024, depth=24, num_heads=16,
                     mlp_ratio=4.0, init_values=1.0, pos_grid=37)


def _torch_bicubic_matrix(n_in: int, n_out: int, sigma: float) -> np.ndarray:
    """(n_out, n_in) operator equal to torch ``F.interpolate(scale_factor=
    sigma, mode="bicubic", align_corners=False, antialias=False)``: cubic
    convolution with a = -0.75, src = (dst + 0.5) / sigma - 0.5, the taps
    clamped to the border."""
    a = -0.75

    def cubic(d):
        d = abs(d)
        if d <= 1.0:
            return ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0
        if d < 2.0:
            return (((d - 5.0) * d + 8.0) * d - 4.0) * a
        return 0.0

    A = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        src = (i + 0.5) / sigma - 0.5
        f = math.floor(src)
        for k in range(-1, 3):
            idx = min(max(f + k, 0), n_in - 1)
            A[i, idx] += cubic(src - (f + k))
    return A.astype(np.float32)


def _param_rows(patch_size: int, embed_dim: int, depth: int,
                mlp_ratio: float, pos_grid: int,
                fp=()) -> List[Row]:
    """The torch checkpoint's names; `fp`: the flax path of the ViT."""
    D, p = embed_dim, patch_size
    hidden = int(D * mlp_ratio)
    rows: List[Row] = [
        ("cls_token", (1, 1, D), ("params", *fp, "cls_token"), "token"),
        ("pos_embed", (1, pos_grid * pos_grid + 1, D),
         ("params", *fp, "pos_embed"), "token")]
    rows += conv_rows("patch_embed.proj", D, 3, p, (*fp, "patch_proj"))
    for i in range(depth):
        pre, f = f"blocks.{i}", (*fp, f"block{i}")
        rows += norm_rows(f"{pre}.norm1", D, (*f, "norm1"))
        rows += dense_rows(f"{pre}.attn.qkv", 3 * D, D, (*f, "qkv"))
        rows += dense_rows(f"{pre}.attn.proj", D, D, (*f, "proj"))
        rows.append((f"{pre}.ls1.gamma", (D,), ("params", *f, "ls1_gamma"),
                     "vec"))
        rows += norm_rows(f"{pre}.norm2", D, (*f, "norm2"))
        rows += dense_rows(f"{pre}.mlp.fc1", hidden, D, (*f, "fc1"))
        rows += dense_rows(f"{pre}.mlp.fc2", D, hidden, (*f, "fc2"))
        rows.append((f"{pre}.ls2.gamma", (D,), ("params", *f, "ls2_gamma"),
                     "vec"))
    rows += norm_rows("norm", D, (*fp, "norm"))
    return rows


def load_dinov2_torch_weights(state_dict: Mapping, depth: int = 24
                              ) -> Dict[str, np.ndarray]:
    """A torch DINOv2 state dict (ViT-L/14 unless the shapes say
    otherwise) → the port's param dict (the checkpoint's names, float32
    arrays, each shape checked)."""
    D = int(np.shape(state_dict["cls_token"])[-1])
    p = int(np.shape(state_dict["patch_embed.proj.weight"])[-1])
    hidden = int(np.shape(state_dict["blocks.0.mlp.fc1.weight"])[0])
    grid = int(round(math.sqrt(np.shape(state_dict["pos_embed"])[1] - 1)))
    return _nets.check_params(
        _param_rows(p, D, depth, hidden / D, grid), state_dict)


def _block(p: Mapping, pre: str, x: torch.Tensor,
           num_heads: int) -> torch.Tensor:
    B, N, D = x.shape
    hd = D // num_heads
    h = F.layer_norm(x, (D,), p[f"{pre}.norm1.weight"],
                     p[f"{pre}.norm1.bias"], 1e-6)
    qkv = F.linear(h, p[f"{pre}.attn.qkv.weight"], p[f"{pre}.attn.qkv.bias"])
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v)
    o = F.linear(o.transpose(1, 2).reshape(B, N, D),
                 p[f"{pre}.attn.proj.weight"], p[f"{pre}.attn.proj.bias"])
    x = x + p[f"{pre}.ls1.gamma"] * o
    h = F.layer_norm(x, (D,), p[f"{pre}.norm2.weight"],
                     p[f"{pre}.norm2.bias"], 1e-6)
    h = F.gelu(F.linear(h, p[f"{pre}.mlp.fc1.weight"],
                        p[f"{pre}.mlp.fc1.bias"]))
    h = F.linear(h, p[f"{pre}.mlp.fc2.weight"], p[f"{pre}.mlp.fc2.bias"])
    return x + p[f"{pre}.ls2.gamma"] * h


class DinoV2ViT(nn.Module):
    """(B, 3, H, W) normalised image → (B, D, H/p, W/p) patch tokens after
    the final LayerNorm (the reference's ``x_norm_patchtokens``). `parent`
    and `name` are flax's module-tree arguments, accepted for the
    reference's signature and unused; the weights are drawn from a
    generator seeded with 0 (``_nets.make`` builds one from a param
    dict)."""

    def __init__(self, patch_size: int = 14, embed_dim: int = 1024,
                 depth: int = 24, num_heads: int = 16,
                 mlp_ratio: float = 4.0, init_values: float = 1.0,
                 pos_grid: int = 37, parent=None, name: Optional[str] = None,
                 device: Device = "cuda"):
        super().__init__()
        self._setup(patch_size, embed_dim, depth, num_heads, mlp_ratio,
                    pos_grid, None, None, device)

    def _setup(self, patch_size, embed_dim, depth, num_heads, mlp_ratio,
               pos_grid, params, generator, device):
        self.patch_size, self.embed_dim, self.depth = (patch_size,
                                                       embed_dim, depth)
        self.num_heads, self.pos_grid = num_heads, pos_grid
        _nets.with_params(self, _param_rows(patch_size, embed_dim, depth,
                                            mlp_ratio, pos_grid),
                          params, device, generator)

    def _pos_operators(self, gh: int, gw: int, device):
        """The bicubic operators of the position grid to (gh, gw), one
        table per object, size and device."""
        g = self.pos_grid
        return (device_table(self, ("pos_y", gh), _torch_bicubic_matrix(
                    g, gh, (gh + 0.1) / g), device),
                device_table(self, ("pos_x", gw), _torch_bicubic_matrix(
                    g, gw, (gw + 0.1) / g), device))

    @f32_matmul_precision
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = dict(self.named_parameters())
        B, _, H, W = x.shape
        P, D, g = self.patch_size, self.embed_dim, self.pos_grid
        gh, gw = H // P, W // P
        x = F.conv2d(x, p["patch_embed.proj.weight"],
                     p["patch_embed.proj.bias"], stride=P)
        x = x.flatten(2).transpose(1, 2)
        pos = p["pos_embed"]
        patch_pos = pos[:, 1:].reshape(1, g, g, D)
        if (gh, gw) != (g, g):
            Ay, Ax = self._pos_operators(gh, gw, x.device)
            patch_pos = torch.einsum("oh,bhwd,pw->bopd", Ay, patch_pos, Ax)
        x = x + patch_pos.reshape(1, gh * gw, D)
        cls_tok = (p["cls_token"] + pos[:, :1]).expand(B, 1, D)
        x = torch.cat([cls_tok, x], 1)
        for i in range(self.depth):
            x = _block(p, f"blocks.{i}", x, self.num_heads)
        x = F.layer_norm(x, (D,), p["norm.weight"], p["norm.bias"], 1e-6)
        return x[:, 1:].transpose(1, 2).reshape(B, D, gh, gw)


def _vit(cfg: Mapping, params: Optional[Mapping] = None,
         generator: Optional[torch.Generator] = None,
         device: Device = "cuda") -> DinoV2ViT:
    """A DinoV2ViT of `cfg` (VIT_LARGE_CFG's keys) with `params` or the
    draw from `generator`."""
    c = dict(VIT_LARGE_CFG, **cfg)
    return _nets.make(DinoV2ViT, c["patch_size"], c["embed_dim"],
                      c["depth"], c["num_heads"], c["mlp_ratio"],
                      c["pos_grid"], params, generator, device)
