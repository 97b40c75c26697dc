"""Depth Anything, monocular relative depth: a DINOv2 ViT and the DPT head
(counterpart of ``kornia_tpu/models/depth_anything.py``).

The backbone is the DINOv2 ViT of the official release (class token,
pre-norm blocks, exact GELU, LayerNorm epsilon 1e-6, one shared final norm
on the four taps) with LayerScale folded into ``attn.proj`` and
``mlp.fc2``, and the class token's position folded into the token, as the
JAX package folds them at load time. The head is the official DPT topology
(projects → resize_layers → scratch.layerN_rn → refinenet4..1 →
output_conv1/2). The weights are frozen parameters under the official
names (``pretrained.blocks.0.attn.qkv.weight``, ``depth_head.projects.0
.weight``, ...) with those two folds: ``pretrained.cls_token`` holds its
position, ``pretrained.pos_embed`` is the (N, D) patch table, and there is
no ``ls1``/``ls2``; ``load_torch_weights`` makes them from the official
state dict and ``convert.depth_anything_from_numpy`` from the JAX
package's flax tree.

The bilinear resizes are the JAX package's align-corners interpolation
matrices (``_interp_ac``). Where the patch grid differs from the position
table's, the table is resized as ``jax.image.resize(..., "bicubic")`` does
it: Keys' cubic with a = -0.5, antialiased when shrinking, weights
renormalised at the border (``ops/warp.py::_resample_weights``), which
``F.interpolate(mode="bicubic")`` (a = -0.75, no antialias) is not.
Like the JAX package's, the net draws its parameters at its first call
(the table sized to that input's grid) unless it was given them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..core.check import check
from ..core.linalg import f32_matmul_precision
from ..feature import _nets
from ..feature._nets import Row, conv_rows, dense_rows, norm_rows
from ..ops.warp import _keys_cubic, _resize_antialias
from .common import LazyNet

__all__ = ["DepthAnythingConfig", "DPTHead", "DepthAnythingNet",
           "DepthAnything", "load_torch_weights"]

Device = Union[str, torch.device]

_LN_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    patch_size: int = 14
    hidden_size: int = 384            # ViT-S
    num_layers: int = 12
    num_heads: int = 6
    mlp_ratio: float = 4.0
    out_indices: Tuple[int, int, int, int] = (2, 5, 8, 11)
    reassemble_channels: Tuple[int, int, int, int] = (48, 96, 192, 384)
    fusion_channels: int = 64

    @classmethod
    def vits(cls) -> "DepthAnythingConfig":
        return cls()

    @classmethod
    def vitb(cls) -> "DepthAnythingConfig":
        return cls(hidden_size=768, num_heads=12,
                   reassemble_channels=(96, 192, 384, 768),
                   fusion_channels=128)

    @classmethod
    def vitl(cls) -> "DepthAnythingConfig":
        return cls(hidden_size=1024, num_layers=24, num_heads=16,
                   out_indices=(4, 11, 17, 23),
                   reassemble_channels=(256, 512, 1024, 1024),
                   fusion_channels=256)

    @classmethod
    def tiny(cls) -> "DepthAnythingConfig":
        return cls(patch_size=8, hidden_size=64, num_layers=4, num_heads=4,
                   out_indices=(0, 1, 2, 3),
                   reassemble_channels=(16, 24, 32, 48), fusion_channels=16)


def _interp_matrix(n_out: int, n_in: int, dtype=torch.float32,
                   device: Device = "cuda") -> torch.Tensor:
    """(n_out, n_in) bilinear align_corners=True interpolation weights."""
    if n_in == 1:
        return torch.ones((n_out, 1), dtype=dtype, device=device)
    if n_out == 1:  # the single output sits on input 0
        return F.one_hot(torch.zeros(1, dtype=torch.long, device=device),
                         n_in).to(dtype)
    pos = torch.linspace(0.0, n_in - 1.0, n_out, device=device)
    lo = pos.floor().long().clamp(0, n_in - 2)
    frac = (pos - lo).to(dtype)
    return (F.one_hot(lo, n_in).to(dtype) * (1 - frac)[:, None]
            + F.one_hot(lo + 1, n_in).to(dtype) * frac[:, None])


def _interp_ac(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) bilinear resize with align_corners=True, as two
    interpolation-matrix products."""
    h, w = hw
    if tuple(x.shape[-2:]) == (h, w):
        return x
    my = _interp_matrix(h, x.shape[-2], x.dtype, x.device)
    mx = _interp_matrix(w, x.shape[-1], x.dtype, x.device)
    return torch.einsum("oh,bchw,pw->bcop", my, x, mx)


# -- parameter table -----------------------------------------------------------

def _vit_rows(c: DepthAnythingConfig, n_pos: int) -> List[Row]:
    D, p = c.hidden_size, c.patch_size
    hidden = int(D * c.mlp_ratio)
    rows: List[Row] = [
        ("pretrained.cls_token", (1, 1, D), ("params", "cls_token"), "token"),
        ("pretrained.pos_embed", (n_pos, D), ("params", "pos_embed"),
         "token")]
    rows += conv_rows("pretrained.patch_embed.proj", D, 3, p,
                      ("patch_embed",))
    for i in range(c.num_layers):
        pre, f = f"pretrained.blocks.{i}", (f"block{i}",)
        rows += norm_rows(f"{pre}.norm1", D, (*f, "norm1"))
        rows += dense_rows(f"{pre}.attn.qkv", 3 * D, D, (*f, "attn", "qkv"))
        rows += dense_rows(f"{pre}.attn.proj", D, D, (*f, "attn", "proj"))
        rows += norm_rows(f"{pre}.norm2", D, (*f, "norm2"))
        rows += dense_rows(f"{pre}.mlp.fc1", hidden, D, (*f, "fc1"))
        rows += dense_rows(f"{pre}.mlp.fc2", D, hidden, (*f, "fc2"))
    return rows + norm_rows("pretrained.norm", D, ("norm",))


def _head_rows(c: DepthAnythingConfig, fp=("dpt",)) -> List[Row]:
    D, F_, R = c.hidden_size, c.fusion_channels, c.reassemble_channels
    h = "depth_head"
    rows: List[Row] = []
    for i in range(4):
        p = ("params", *fp, f"proj{i}")
        rows += [(f"{h}.projects.{i}.weight", (R[i], D, 1, 1),
                  p + ("kernel",), "dense1x1"),
                 (f"{h}.projects.{i}.bias", (R[i],), p + ("bias",), "vec")]
    for i, s in ((0, 4), (1, 2)):
        # flax keeps these ConvTranspose2d weights in torch's layout
        p = ("params", *fp, f"resize{i}")
        rows += [(f"{h}.resize_layers.{i}.weight", (R[i], R[i], s, s),
                  p + ("kernel",), "convT"),
                 (f"{h}.resize_layers.{i}.bias", (R[i],), p + ("bias",),
                  "vec")]
    rows += conv_rows(f"{h}.resize_layers.3", R[3], R[3], 3, (*fp, "resize3"))
    for i in range(4):
        rows += conv_rows(f"{h}.scratch.layer{i + 1}_rn", F_, R[i], 3,
                          (*fp, f"layer{i + 1}_rn"), bias=False)
    for n in (1, 2, 3, 4):
        r, fr = f"{h}.scratch.refinenet{n}", (*fp, f"refinenet{n}")
        for u in ((1, 2) if n != 4 else (2,)):   # refinenet4 has no skip
            for k in (1, 2):
                rows += conv_rows(f"{r}.resConfUnit{u}.conv{k}", F_, F_, 3,
                                  (*fr, f"rcu{u}", f"conv{k}"))
        rows += conv_rows(f"{r}.out_conv", F_, F_, 1, (*fr, "out_conv"))
    rows += conv_rows(f"{h}.scratch.output_conv1", F_ // 2, F_, 3,
                      (*fp, "output_conv1"))
    rows += conv_rows(f"{h}.scratch.output_conv2.0", 32, F_ // 2, 3,
                      (*fp, "output_conv2_0"))
    return rows + conv_rows(f"{h}.scratch.output_conv2.2", 1, 32, 1,
                            (*fp, "output_conv2_2"))


def _param_rows(c: DepthAnythingConfig, n_pos: int) -> List[Row]:
    return _vit_rows(c, n_pos) + _head_rows(c)


def load_torch_weights(state_dict: Mapping[str, Any],
                       cfg: Optional[DepthAnythingConfig] = None
                       ) -> Dict[str, np.ndarray]:
    """The official state dict (``pretrained.*`` DINOv2 and
    ``depth_head.*`` DPT, e.g. depth_anything_vits14.pth) → the port's
    `params`: LayerScale folded into ``attn.proj`` and ``mlp.fc2``, the
    class token's position into the token, the patch positions kept as an
    (N, D) table; each shape checked."""
    sd = {k: np.asarray(_nets._numpy(v), np.float32)
          for k, v in state_dict.items()}
    if cfg is None:
        depth = len({k.split(".")[2] for k in sd
                     if k.startswith("pretrained.blocks.")})
        dim = sd["pretrained.cls_token"].shape[-1]
        by_dim = {384: DepthAnythingConfig.vits,
                  768: DepthAnythingConfig.vitb,
                  1024: DepthAnythingConfig.vitl}
        cfg = by_dim[dim]() if dim in by_dim else DepthAnythingConfig(
            hidden_size=dim, num_layers=depth)
        if cfg.num_layers != depth:
            cfg = dataclasses.replace(cfg, num_layers=depth)
    out = {k: v for k, v in sd.items()
           if ".ls1." not in k and ".ls2." not in k}
    pos = sd["pretrained.pos_embed"][0]                     # (1 + N, D)
    out["pretrained.cls_token"] = sd["pretrained.cls_token"] + pos[:1][None]
    out["pretrained.pos_embed"] = pos[1:]
    for i in range(cfg.num_layers):
        b = f"pretrained.blocks.{i}"
        for ls, lin in (("ls1", "attn.proj"), ("ls2", "mlp.fc2")):
            g = sd.get(f"{b}.{ls}.gamma")
            if g is not None:
                out[f"{b}.{lin}.weight"] = g[:, None] * sd[f"{b}.{lin}.weight"]
                out[f"{b}.{lin}.bias"] = g * sd[f"{b}.{lin}.bias"]
    return _nets.check_params(_param_rows(cfg, pos.shape[0] - 1), out)


# -- the network ---------------------------------------------------------------

def _vit_block(p: Mapping, pre: str, x: torch.Tensor,
               heads: int) -> torch.Tensor:
    B, N, D = x.shape
    h = F.layer_norm(x, (D,), p[f"{pre}.norm1.weight"],
                     p[f"{pre}.norm1.bias"], _LN_EPS)
    qkv = F.linear(h, p[f"{pre}.attn.qkv.weight"], p[f"{pre}.attn.qkv.bias"])
    q, k, v = qkv.reshape(B, N, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v)
    x = x + F.linear(o.transpose(1, 2).reshape(B, N, D),
                     p[f"{pre}.attn.proj.weight"],
                     p[f"{pre}.attn.proj.bias"])
    h = F.layer_norm(x, (D,), p[f"{pre}.norm2.weight"],
                     p[f"{pre}.norm2.bias"], _LN_EPS)
    h = F.gelu(F.linear(h, p[f"{pre}.mlp.fc1.weight"],
                        p[f"{pre}.mlp.fc1.bias"]))
    return x + F.linear(h, p[f"{pre}.mlp.fc2.weight"],
                        p[f"{pre}.mlp.fc2.bias"])


def _conv(p: Mapping, name: str, x: torch.Tensor, stride: int = 1,
          pad: Optional[int] = None) -> torch.Tensor:
    w = p[f"{name}.weight"]
    return F.conv2d(x, w, p.get(f"{name}.bias"), stride,
                    w.shape[-1] // 2 if pad is None else pad)


def _rcu(p: Mapping, name: str, x: torch.Tensor) -> torch.Tensor:
    """relu → conv1 → relu → conv2 → + x."""
    h = _conv(p, f"{name}.conv1", F.relu(x))
    return x + _conv(p, f"{name}.conv2", F.relu(h))


def _fusion(p: Mapping, name: str, x: torch.Tensor,
            skip: Optional[torch.Tensor] = None,
            size: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """x (+ rcu1(skip)) → rcu2 → bilinear (align corners) → 1x1
    out_conv."""
    if skip is not None:
        x = x + _rcu(p, f"{name}.resConfUnit1", skip)
    x = _rcu(p, f"{name}.resConfUnit2", x)
    if size is None:
        size = (2 * x.shape[-2], 2 * x.shape[-1])
    return _conv(p, f"{name}.out_conv", _interp_ac(x, size))


def _dpt(p: Mapping, c: DepthAnythingConfig, taps: Sequence[torch.Tensor],
         grid_hw: Tuple[int, int]) -> torch.Tensor:
    h, w = grid_hw
    dh = "depth_head"
    feats = []
    for i, t in enumerate(taps):
        wp = p[f"{dh}.projects.{i}.weight"]
        f = F.linear(t, wp[:, :, 0, 0], p[f"{dh}.projects.{i}.bias"])
        f = f.transpose(1, 2).reshape(t.shape[0], -1, h, w)
        if i in (0, 1):
            r = f"{dh}.resize_layers.{i}"
            f = F.conv_transpose2d(f, p[f"{r}.weight"], p[f"{r}.bias"],
                                   stride=4 if i == 0 else 2)
        elif i == 3:
            f = _conv(p, f"{dh}.resize_layers.3", f, stride=2, pad=1)
        feats.append(_conv(p, f"{dh}.scratch.layer{i + 1}_rn", f))
    l1, l2, l3, l4 = feats
    s = f"{dh}.scratch"
    x = _fusion(p, f"{s}.refinenet4", l4, size=l3.shape[-2:])
    x = _fusion(p, f"{s}.refinenet3", x, l3, size=l2.shape[-2:])
    x = _fusion(p, f"{s}.refinenet2", x, l2, size=l1.shape[-2:])
    x = _fusion(p, f"{s}.refinenet1", x, l1)
    x = _conv(p, f"{s}.output_conv1", x)
    x = _interp_ac(x, (h * c.patch_size, w * c.patch_size))
    x = F.relu(_conv(p, f"{s}.output_conv2.0", x))
    x = _conv(p, f"{s}.output_conv2.2", x)
    return F.relu(x[:, 0])   # non-negative relative depth


class DPTHead(LazyNet):
    """The DPT decoder on four (B, N, D) taps of an (h, w) patch grid →
    (B, h·p, w·p) depth. Its parameters are ``depth_head.*``."""

    def __init__(self, cfg: DepthAnythingConfig, dtype: Any = torch.float32,
                 parent=None, name: Optional[str] = None,
                 device: Device = "cuda"):
        super().__init__()
        self.cfg = cfg
        self._lazy(device)

    def _rows(self) -> List[Row]:
        return _head_rows(self.cfg, ())

    @f32_matmul_precision
    def forward(self, taps: Sequence[torch.Tensor],
                grid_hw: Tuple[int, int]) -> torch.Tensor:
        self._ensure()
        return _dpt(dict(self.named_parameters()), self.cfg, taps, grid_hw)


class DepthAnythingNet(LazyNet):
    """(B, 3, H, W) → (B, H, W) relative depth; H and W multiples of the
    patch size. The position table is sized at the first call's grid when
    the parameters are drawn."""

    def __init__(self, cfg: DepthAnythingConfig,
                 dtype: Any = torch.float32, parent=None,
                 name: Optional[str] = None, device: Device = "cuda"):
        super().__init__()
        self.cfg = cfg
        self._lazy(device)

    def _rows(self, n_pos: int) -> List[Row]:
        return _param_rows(self.cfg, n_pos)

    def _ensure(self, n_pos: int) -> None:
        """Given parameters keep their own table's size."""
        if self._pending is not None and self._pending[0] is not None:
            n_pos = int(np.shape(self._pending[0]["pretrained.pos_embed"])[0])
        super()._ensure(n_pos)

    def _pos_table(self, pos: torch.Tensor, h: int, w: int) -> torch.Tensor:
        """The (N, D) table on the (h, w) grid: itself, or its g x g grid
        resized as jax.image.resize's bicubic does."""
        if pos.shape[0] == h * w:
            return pos
        g = int(round(float(pos.shape[0]) ** 0.5))
        D = pos.shape[1]
        grid = pos.reshape(g, g, D).permute(2, 0, 1)
        return _resize_antialias(grid, h, w, _keys_cubic).permute(
            1, 2, 0).reshape(h * w, D)

    @f32_matmul_precision
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        P, D = c.patch_size, c.hidden_size
        B = images.shape[0]
        h, w = images.shape[-2] // P, images.shape[-1] // P
        self._ensure(h * w)
        p = dict(self.named_parameters())
        x = F.conv2d(images, p["pretrained.patch_embed.proj.weight"],
                     p["pretrained.patch_embed.proj.bias"], stride=P)
        x = x.flatten(2).transpose(1, 2)
        x = x + self._pos_table(p["pretrained.pos_embed"], h, w)
        x = torch.cat([p["pretrained.cls_token"].expand(B, 1, D), x], 1)
        taps = []
        for i in range(c.num_layers):
            x = _vit_block(p, f"pretrained.blocks.{i}", x, c.num_heads)
            if i in c.out_indices:
                taps.append(x)
        taps = [F.layer_norm(t, (D,), p["pretrained.norm.weight"],
                             p["pretrained.norm.bias"], _LN_EPS)[:, 1:]
                for t in taps]
        return _dpt(p, c, taps, (h, w))


class DepthAnything:
    """Relative monocular depth: (B, 3, H, W) in [0, 1] → (B, 1, H, W);
    H and W multiples of ``cfg.patch_size``. `params`: the port's (see the
    module's docstring); without them the net draws from `generator`, or
    one seeded with 0, at its first call."""

    def __init__(self, cfg: Optional[DepthAnythingConfig] = None,
                 params: Optional[Mapping] = None,
                 dtype: Any = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        self.cfg = cfg or DepthAnythingConfig()
        self.model = DepthAnythingNet(self.cfg, dtype, device=device)
        self.model.load_params(params, generator)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        B, C, H, W = images.shape
        p = self.cfg.patch_size
        check(C == 3, f"DepthAnything expects RGB (B, 3, H, W), got C={C}")
        check(H % p == 0 and W % p == 0,
              f"H, W must be multiples of patch_size={p}, got {H}x{W}")
        return self.model(images)[:, None]
