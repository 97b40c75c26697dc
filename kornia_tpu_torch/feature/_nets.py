"""Parameter tables of the learned families (XFeat, ALIKED, DINOv2,
DeDoDe, SOLD2, DeFMO) and of the models of ``models/``.

A family's net is described once, as a list of rows ``(name, shape, path,
kind)``: the reference checkpoint's name of a tensor, its shape in the
torch layout (OIHW convolutions, (out, in) linears), the path of the same
tensor in the JAX package's variables (flax's collection first; XFeat's
flat dict is keyed by the checkpoint's names), and its kind. From the table come the seeded initialisation (``init_params``),
the checkpoint loader's shape check (``check_params``) and the crossing of
the JAX variables into the port (``from_flax``: HWIO kernels → OIHW, dense
kernels transposed). The port's nets hold their parameters under the
checkpoint's names (``hardnet.py::_register_tree``) and compute in NCHW.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .hardnet import _numpy, _register_tree

Row = Tuple[str, Tuple[int, ...], Tuple[str, ...], str]

# kind → the transform of the flax array into the torch layout; the other
# kinds ("vec", "token", XFeat's "linear", a transposed convolution that
# flax holds in torch's layout, "convT") cross as they are
_FROM_FLAX = {
    "conv": lambda v: v.transpose(3, 2, 0, 1),       # HWIO → OIHW
    "dense": lambda v: v.T,                          # (in, out) → (out, in)
    "dense1x1": lambda v: v.T[:, :, None, None],     # → a 1x1 convolution
    # flax attention's DenseGeneral kernels: (in, heads, head_dim) →
    # (heads·head_dim, in), (heads, head_dim, out) → (out, heads·head_dim),
    # and their (heads, head_dim) biases flattened
    "heads_in": lambda v: v.reshape(v.shape[0], -1).T,
    "heads_out": lambda v: v.reshape(-1, v.shape[-1]).T,
    "flat": lambda v: v.reshape(-1),
}


def conv_rows(name: str, cout: int, cin: int, k: int, path: Sequence[str],
              bias: bool = True, groups: int = 1) -> List[Row]:
    """A convolution's weight (and bias) from the flax Conv at `path`
    (under "params")."""
    p = ("params", *path)
    rows = [(f"{name}.weight", (cout, cin // groups, k, k), p + ("kernel",),
             "conv")]
    if bias:
        rows.append((f"{name}.bias", (cout,), p + ("bias",), "vec"))
    return rows


def bn_rows(name: str, c: int, path: Sequence[str]) -> List[Row]:
    """A batch norm's scale, bias and running statistics from the flax
    BatchNorm at `path`."""
    p, s = ("params", *path), ("batch_stats", *path)
    return [(f"{name}.weight", (c,), p + ("scale",), "vec"),
            (f"{name}.bias", (c,), p + ("bias",), "vec"),
            (f"{name}.running_mean", (c,), s + ("mean",), "vec"),
            (f"{name}.running_var", (c,), s + ("var",), "vec")]


def dense_rows(name: str, cout: int, cin: int, path: Sequence[str]
               ) -> List[Row]:
    p = ("params", *path)
    return [(f"{name}.weight", (cout, cin), p + ("kernel",), "dense"),
            (f"{name}.bias", (cout,), p + ("bias",), "vec")]


def norm_rows(name: str, c: int, path: Sequence[str]) -> List[Row]:
    """A LayerNorm's scale and bias."""
    p = ("params", *path)
    return [(f"{name}.weight", (c,), p + ("scale",), "vec"),
            (f"{name}.bias", (c,), p + ("bias",), "vec")]


def init_params(rows: Sequence[Row], generator: torch.Generator,
                dtype=torch.float32, gain: float = 1.0
                ) -> Dict[str, torch.Tensor]:
    """Seeded parameters in the order of the rows, drawn from a CPU
    `generator`: weights normal with variance gain / fan-in (flax's LeCun
    normal at 1, He's at 2; the fan-in is the product of the torch shape
    after its first axis), scales and LayerScales one, biases and running
    means zero,
    running variances one, class and position tokens normal(0, 0.02). A
    torch generator cannot reproduce ``jax.random``: the values differ from
    the reference's initialisation."""
    out = {}
    for name, shape, _, kind in rows:
        leaf = name.rsplit(".", 1)[-1]
        if kind == "token":
            v = torch.randn(shape, generator=generator, dtype=dtype) * 0.02
        elif kind in ("vec", "flat"):
            one = leaf in ("running_var", "weight", "gamma")
            v = (torch.ones if one else torch.zeros)(shape, dtype=dtype)
        else:
            fan_in = math.prod(shape[1:])
            v = torch.randn(shape, generator=generator, dtype=dtype) \
                * math.sqrt(gain / fan_in)
        out[name] = v
    return out


def check_params(rows: Sequence[Row], state_dict: Mapping
                 ) -> Dict[str, np.ndarray]:
    """A checkpoint's entries of the table as float32 numpy arrays, each
    shape checked."""
    out = {}
    for name, shape, _, _ in rows:
        v = np.asarray(_numpy(state_dict[name]), np.float32)
        if v.shape != tuple(shape):
            raise ValueError(f"{name}: shape {v.shape}, expected "
                             f"{tuple(shape)}")
        out[name] = v
    return out


def from_flax(rows: Sequence[Row], variables: Mapping
              ) -> Dict[str, np.ndarray]:
    """The JAX package's flax variables (``{"params": ..., "batch_stats":
    ...}`` as nested dicts of arrays) → the checkpoint's names and
    layouts."""
    out = {}
    for name, shape, path, kind in rows:
        v = variables
        for k in path:
            v = v[k]
        v = np.asarray(v, np.float32)
        v = _FROM_FLAX.get(kind, lambda a: a)(v)
        if v.shape != tuple(shape):
            raise ValueError(f"{'/'.join(path)} → {name}: shape {v.shape}, "
                             f"expected {tuple(shape)}")
        out[name] = np.ascontiguousarray(v)
    return out


def conv(p: Mapping, name: str, x: torch.Tensor, stride: int = 1,
         padding: int = 0, groups: int = 1) -> torch.Tensor:
    """F.conv2d with `p`'s ``name.weight`` and, where it has one,
    ``name.bias``."""
    return F.conv2d(x, p[f"{name}.weight"], p.get(f"{name}.bias"), stride,
                    padding, 1, groups)


def bn_folded(p: Mapping, name: str, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Batch norm with running statistics folded into one scale and
    shift, x · scale + (bias - mean · scale), as the YuNet and DexiNed
    references round it."""
    scale = p[f"{name}.weight"] * torch.rsqrt(p[f"{name}.running_var"]
                                              + eps)
    shift = p[f"{name}.bias"] - p[f"{name}.running_mean"] * scale
    return x * scale[:, None, None] + shift[:, None, None]


def bn(p: Mapping, name: str, x: torch.Tensor,
       eps: float = 1e-5) -> torch.Tensor:
    """Batch norm with running statistics in every mode (flax's
    ``use_running_average=True``, epsilon 1e-5)."""
    return F.batch_norm(x, p[f"{name}.running_mean"],
                        p[f"{name}.running_var"], p.get(f"{name}.weight"),
                        p.get(f"{name}.bias"), training=False, eps=eps)


def sub(p: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    """The entries of `p` under ``prefix.``, with the prefix taken off."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in p.items() if k.startswith(prefix + ".")}


def make(cls, *setup_args):
    """An instance of the port's twin `cls` of a flax module, set up by its
    ``_setup(*setup_args)`` (a param dict or a generator among them)
    instead of its ``__init__``, whose arguments are the reference's."""
    m = cls.__new__(cls)
    torch.nn.Module.__init__(m)
    m._setup(*setup_args)
    return m


def with_params(module: torch.nn.Module, rows: Sequence[Row],
                params: Optional[Mapping], device,
                generator: Optional[torch.Generator] = None) -> None:
    """Register `params` (checkpoint names, torch layout), or the table's
    draw from `generator` (one seeded with 0, the reference's key, if
    None), as frozen parameters of `module`."""
    if params is None:
        params = init_params(rows, generator if generator is not None
                             else torch.Generator().manual_seed(0))
    else:
        params = check_params(rows, params)
    _register_tree(module, params, device)
