"""HardNet patch descriptor (counterpart of ``kornia_tpu/feature/hardnet.py``).

A CNN over (B, 1, 32, 32) patches → (B, 128) L2-normalised descriptors:
seven bias-free convolutions, each followed by a batch norm with running
statistics only (no affine), ReLU between them. The weights are the
reference's flat dict (``conv{i}_w`` OIHW, ``bn{i}_mean``, ``bn{i}_var``),
held as parameters that do not require grad: nothing trains them, and
patch coordinates that come out of a learned LAF must not carry a graph
into the patch sampler, which has no backward on the card.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtype import as_float
from ..core.linalg import f32_matmul_precision
from ..ops.warp import resize

__all__ = ["HardNet", "hardnet_init_params", "load_torch_weights"]

Device = Union[str, torch.device]

# (out_ch, kernel, stride, padding) per conv layer — reference architecture
_ARCH = [
    (32, 3, 1, 1),
    (32, 3, 1, 1),
    (64, 3, 2, 1),
    (64, 3, 1, 1),
    (128, 3, 2, 1),
    (128, 3, 1, 1),
    (128, 8, 1, 0),  # final 8x8 conv → 1x1
]


def hardnet_init_params(generator: torch.Generator,
                        dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """He-normal conv weights, zero means and unit variances, drawn from a
    CPU `generator` (``torch.Generator`` cannot reproduce ``jax.random``:
    the same seed gives other weights than the reference's key)."""
    params = {}
    in_ch = 1
    for i, (out_ch, k, _, _) in enumerate(_ARCH):
        params[f"conv{i}_w"] = torch.randn(
            (out_ch, in_ch, k, k), generator=generator, dtype=dtype) \
            * math.sqrt(2.0 / (in_ch * k * k))
        params[f"bn{i}_mean"] = torch.zeros(out_ch, dtype=dtype)
        params[f"bn{i}_var"] = torch.ones(out_ch, dtype=dtype)
        in_ch = out_ch
    return params


def _frozen(value, device: Device) -> nn.Parameter:
    """A float32 parameter on `device` that does not require grad."""
    if not isinstance(value, torch.Tensor):
        value = torch.from_numpy(np.array(value, np.float32))
    return nn.Parameter(value.detach().to(device=device, dtype=torch.float32),
                        requires_grad=False)


def _register_tree(module: nn.Module, params: Mapping, device: Device
                   ) -> None:
    """Register each entry of a flat dict with dotted checkpoint names
    (``a.b.0.weight``) as a frozen parameter of a submodule tree under
    `module`, so that ``named_parameters()`` gives the names back."""
    for name, v in params.items():
        *path, leaf = name.split(".")
        m = module
        for part in path:
            if part not in m._modules:
                m.add_module(part, nn.Module())
            m = m._modules[part]
        m.register_parameter(leaf, _frozen(v, device))


def _numpy(v) -> np.ndarray:
    """A checkpoint entry (tensor or array) as a numpy array."""
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def _running_bn(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
               weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batch norm with the running statistics in every mode (eps 1e-5)."""
    return F.batch_norm(x, mean, var, weight, bias, training=False,
                        eps=1e-5)


class HardNet(nn.Module):
    """(B, 1, 32, 32) → (B, 128); patches of another size are resized to
    32² first. `params` is the reference's dict (numpy arrays or tensors);
    without it the weights come from a generator seeded with 42, the
    reference's key. Runs in true float32 (TF32 off), as the reference's
    convolutions do."""

    def __init__(self, params: Optional[Mapping] = None,
                 device: Device = "cuda"):
        super().__init__()
        if params is None:
            params = hardnet_init_params(torch.Generator().manual_seed(42))
        self.params = nn.ParameterDict(
            {k: _frozen(v, device) for k, v in params.items()})

    @f32_matmul_precision
    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        if patches.shape[-1] != 32:
            patches = resize(patches, (32, 32))
        p = self.params
        x = as_float(patches)
        # per-patch standardisation with the biased std, as jnp.std
        mu = x.mean(dim=(1, 2, 3), keepdim=True)
        sd = x.std(dim=(1, 2, 3), keepdim=True, correction=0)
        x = (x - mu) / (sd + 1e-7)
        for i, (_, _, s, pad) in enumerate(_ARCH):
            x = F.conv2d(x, p[f"conv{i}_w"], stride=s, padding=pad)
            x = _running_bn(x, p[f"bn{i}_mean"], p[f"bn{i}_var"])
            if i < len(_ARCH) - 1:
                x = F.relu(x)
        x = x.reshape(x.shape[0], -1)
        return x / torch.clamp_min(torch.linalg.vector_norm(
            x, dim=-1, keepdim=True), 1e-8)


def load_torch_weights(state_dict) -> Dict[str, np.ndarray]:
    """The reference HardNet checkpoint (``features.N.*``) → the param dict
    (conv weights in the order of their layer index; each batch norm's
    running variance closes a layer)."""
    params = {}
    conv_i = 0
    for k in sorted(state_dict.keys(), key=_torch_key_order):
        v = _numpy(state_dict[k])
        if k.endswith("weight") and v.ndim == 4:
            params[f"conv{conv_i}_w"] = v
        elif k.endswith("running_mean"):
            params[f"bn{conv_i}_mean"] = v
        elif k.endswith("running_var"):
            params[f"bn{conv_i}_var"] = v
            conv_i += 1
    return params


def _torch_key_order(k: str):
    """Sort key of a ``features.N.leaf`` name: the first index, then the
    name."""
    nums = [int(p) for p in k.split(".") if p.isdigit()]
    return (nums[0] if nums else 0, k)
