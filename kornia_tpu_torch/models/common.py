"""Shared model building blocks (counterpart of
``kornia_tpu/models/common.py``): ConvNormAct, LayerNorm2d, MLP, DropPath
and TransformerEncoderLayer, and the layout helpers.

The JAX blocks are flax modules that learn their input width at their
first call. Their twins here do the same: the parameters are drawn at the
first call, on `device`, from a generator seeded with 0 (normal with
variance 1 / fan-in, unit scales, zero biases; the values differ from a
flax init), or taken from the dict given to ``load_params`` (the port's
names, torch layout; ``_nets.from_flax`` with the block's ``_rows``
carries flax variables across). `parent` and `name` are flax's module-tree
arguments, accepted for the reference's signature and unused. The port's
convolutions take NCHW; ``nchw_to_nhwc`` and ``nhwc_to_nchw`` move the
channel axis where a block works on (..., C) rows, as attention does.
"""

from __future__ import annotations

from typing import Callable, List, Mapping, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.linalg import f32_matmul_precision
from ..feature import _nets
from ..feature._nets import Row, bn_rows, conv_rows, dense_rows, norm_rows

__all__ = ["ConvNormAct", "MLP", "LayerNorm2d", "DropPath", "nchw_to_nhwc",
           "nhwc_to_nchw", "TransformerEncoderLayer"]

Device = Union[str, torch.device]

_LN_EPS = 1e-6   # flax LayerNorm's and GroupNorm's epsilon
_BN_EPS = 1e-5   # flax BatchNorm's


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.gelu`` (the tanh approximation by default)."""
    return F.gelu(x, approximate="tanh")


def same_conv(x: torch.Tensor, weight: torch.Tensor,
              bias: Optional[torch.Tensor] = None, stride: int = 1,
              groups: int = 1) -> torch.Tensor:
    """flax ``nn.Conv``'s default "SAME" padding: out = ceil(in / stride),
    the padding split with the odd pixel at the end (bottom, right)."""
    pads = []
    for n, k in zip(reversed(x.shape[-2:]), reversed(weight.shape[-2:])):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    if pads[0] == pads[1] and pads[2] == pads[3]:
        return F.conv2d(x, weight, bias, stride, (pads[2], pads[0]), 1,
                        groups)
    return F.conv2d(F.pad(x, pads), weight, bias, stride, 0, 1, groups)


def group_norm(x: torch.Tensor, p: Mapping, name: str,
               groups: int = 4) -> torch.Tensor:
    """flax ``nn.GroupNorm`` (epsilon 1e-6) on NCHW with `p`'s
    ``name.weight``/``name.bias``."""
    return F.group_norm(x, groups, p[f"{name}.weight"], p[f"{name}.bias"],
                        _LN_EPS)


class LazyNet(nn.Module):
    """A twin of a flax module whose parameter shapes follow from its
    first input: ``_rows(*shape)`` is its table; ``_ensure(*shape)``
    registers the parameters at the first call (``load_params``'s dict,
    shapes checked, or the seeded draw)."""

    def _lazy(self, device: Device) -> None:
        self.device = device
        self._pending = (None, None)

    def load_params(self, params: Mapping,
                    generator: Optional[torch.Generator] = None
                    ) -> "LazyNet":
        """Use `params` (the port's names, torch layout) at the first
        call, or draw from `generator` when `params` is None."""
        if self._pending is None:
            raise RuntimeError("the parameters are already registered")
        self._pending = (params, generator)
        return self

    def _ensure(self, *shape) -> None:
        if self._pending is not None:
            params, gen = self._pending
            _nets.with_params(self, self._rows(*shape), params, self.device,
                              gen)
            self._pending = None

    def _rows(self, *shape) -> List[Row]:
        raise NotImplementedError


class ConvNormAct(LazyNet):
    """Convolution ("SAME" padding), norm and activation on NCHW: ``norm``
    "bn" (running statistics; ``train=True`` normalises by the batch's own
    and updates nothing), "ln" (over channels) or "none" (then the
    convolution has a bias)."""

    def __init__(self, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, groups: int = 1,
                 act: Optional[Callable] = F.relu, norm: str = "bn",
                 parent=None, name: Optional[str] = None,
                 device: Device = "cuda"):
        super().__init__()
        self.out_channels, self.kernel_size = out_channels, kernel_size
        self.stride, self.groups, self.act, self.norm_kind = (stride, groups,
                                                              act, norm)
        self._lazy(device)

    def _rows(self, cin: int) -> List[Row]:
        c = self.out_channels
        rows = conv_rows("conv", c, cin, self.kernel_size, ("Conv_0",),
                         bias=self.norm_kind == "none", groups=self.groups)
        if self.norm_kind == "bn":
            rows += bn_rows("norm", c, ("BatchNorm_0",))
        elif self.norm_kind == "ln":
            rows += norm_rows("norm", c, ("LayerNorm_0",))
        return rows

    @f32_matmul_precision
    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        self._ensure(x.shape[1])
        p = dict(self.named_parameters())
        x = same_conv(x, p["conv.weight"], p.get("conv.bias"), self.stride,
                      self.groups)
        if self.norm_kind == "bn":
            if train:
                x = F.batch_norm(x, None, None, p["norm.weight"],
                                 p["norm.bias"], True, 0.0, _BN_EPS)
            else:
                x = _nets.bn(p, "norm", x, _BN_EPS)
        elif self.norm_kind == "ln":
            x = nhwc_to_nchw(F.layer_norm(
                nchw_to_nhwc(x), (x.shape[1],), p["norm.weight"],
                p["norm.bias"], _LN_EPS))
        return x if self.act is None else self.act(x)


class LayerNorm2d(LazyNet):
    """LayerNorm over the channels of an NCHW map (flax's over the last
    axis of NHWC)."""

    def __init__(self, parent=None, name: Optional[str] = None,
                 device: Device = "cuda"):
        super().__init__()
        self._lazy(device)

    def _rows(self, c: int) -> List[Row]:
        return norm_rows("norm", c, ("LayerNorm_0",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._ensure(x.shape[1])
        return nhwc_to_nchw(F.layer_norm(
            nchw_to_nhwc(x), (x.shape[1],), self.norm.weight,
            self.norm.bias, _LN_EPS))


class MLP(LazyNet):
    """`num_layers` dense layers on (..., C) rows, `act` between them
    (flax's tanh GELU by default)."""

    def __init__(self, hidden_dim: int, out_dim: int, num_layers: int = 2,
                 act: Callable = gelu_tanh, parent=None,
                 name: Optional[str] = None, device: Device = "cuda"):
        super().__init__()
        self.hidden_dim, self.out_dim = hidden_dim, out_dim
        self.num_layers, self.act = num_layers, act
        self._lazy(device)

    def _rows(self, cin: int) -> List[Row]:
        rows, c = [], cin
        for i in range(self.num_layers):
            o = self.hidden_dim if i < self.num_layers - 1 else self.out_dim
            rows += dense_rows(f"layers.{i}", o, c, (f"Dense_{i}",))
            c = o
        return rows

    @f32_matmul_precision
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._ensure(x.shape[-1])
        p = dict(self.named_parameters())
        for i in range(self.num_layers):
            x = F.linear(x, p[f"layers.{i}.weight"], p[f"layers.{i}.bias"])
            if i < self.num_layers - 1:
                x = self.act(x)
        return x


class DropPath(nn.Module):
    """Stochastic depth: each sample's path kept with probability
    1 - rate (and scaled by its inverse) unless `deterministic`; the draw
    comes from `generator` (flax's "droppath" stream)."""

    def __init__(self, rate: float = 0.0, deterministic: bool = True,
                 parent=None, name: Optional[str] = None):
        super().__init__()
        self.rate, self.deterministic = rate, deterministic

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.deterministic or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = torch.rand(shape, generator=generator, device=x.device) < keep
        return x * mask / keep


def _attn_rows(name: str, dim: int, heads: int, path) -> List[Row]:
    """flax ``MultiHeadDotProductAttention``'s query, key, value and out
    DenseGenerals as (out, in) products."""
    p = ("params", *path)
    rows = []
    for part in ("query", "key", "value"):
        rows += [(f"{name}.{part}.weight", (dim, dim), p + (part, "kernel"),
                  "heads_in"),
                 (f"{name}.{part}.bias", (dim,), p + (part, "bias"), "flat")]
    return rows + [(f"{name}.out.weight", (dim, dim), p + ("out", "kernel"),
                    "heads_out"),
                   (f"{name}.out.bias", (dim,), p + ("out", "bias"), "vec")]


def attention(p: Mapping, name: str, q: torch.Tensor, kv: torch.Tensor,
              heads: int) -> torch.Tensor:
    """flax multi-head attention on (B, L, D) rows, weights from
    ``_attn_rows``."""
    B, L, D = q.shape
    hd = D // heads

    def split(x, part):
        y = F.linear(x, p[f"{name}.{part}.weight"], p[f"{name}.{part}.bias"])
        return y.reshape(B, -1, heads, hd).transpose(1, 2)

    o = F.scaled_dot_product_attention(split(q, "query"), split(kv, "key"),
                                       split(kv, "value"))
    return F.linear(o.transpose(1, 2).reshape(B, L, D),
                    p[f"{name}.out.weight"], p[f"{name}.out.bias"])


class TransformerEncoderLayer(LazyNet):
    """Pre-norm multi-head attention and MLP block on (B, L, dim) rows;
    with `context`, the keys and values are its normed rows."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 parent=None, name: Optional[str] = None,
                 device: Device = "cuda"):
        super().__init__()
        self.dim, self.num_heads, self.mlp_ratio = dim, num_heads, mlp_ratio
        self._lazy(device)

    def _rows(self, with_context: bool) -> List[Row]:
        d, hidden = self.dim, int(self.dim * self.mlp_ratio)
        # flax numbers the LayerNorms in call order: the context's is the
        # second where there is one
        rows = norm_rows("norm1", d, ("LayerNorm_0",))
        if with_context:
            rows += norm_rows("norm_ctx", d, ("LayerNorm_1",))
        rows += _attn_rows("attn", d, self.num_heads,
                           ("MultiHeadDotProductAttention_0",))
        rows += norm_rows("norm2", d, (f"LayerNorm_{1 + with_context}",))
        rows += dense_rows("mlp.layers.0", hidden, d, ("MLP_0", "Dense_0"))
        rows += dense_rows("mlp.layers.1", d, hidden, ("MLP_0", "Dense_1"))
        return rows

    @f32_matmul_precision
    def forward(self, x: torch.Tensor,
                context: Optional[torch.Tensor] = None) -> torch.Tensor:
        self._ensure(context is not None)
        p = dict(self.named_parameters())
        d = self.dim

        def ln(name, t):
            return F.layer_norm(t, (d,), p[f"{name}.weight"],
                                p[f"{name}.bias"], _LN_EPS)

        h = ln("norm1", x)
        c = ln("norm_ctx", context) if context is not None else h
        x = x + attention(p, "attn", h, c, self.num_heads)
        h = ln("norm2", x)
        h = gelu_tanh(F.linear(h, p["mlp.layers.0.weight"],
                               p["mlp.layers.0.bias"]))
        return x + F.linear(h, p["mlp.layers.1.weight"],
                            p["mlp.layers.1.bias"])
