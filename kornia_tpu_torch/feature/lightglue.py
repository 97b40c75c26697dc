"""LightGlue, the attention matcher (counterpart of
``kornia_tpu/feature/lightglue.py``): learnable Fourier rotary position
encoding, self blocks with the checkpoint's interleaved QKV packing, cross
blocks with a shared QK projection, and the last layer's match assignment
(sigmoid log double softmax). The weights keep the published checkpoint's
names as a module tree of frozen parameters, so ``*_lightglue.pth`` loads by
name (``LightGlue.from_torch``).

Depth and width are fixed, as in the reference: no early exit and no point
pruning, so the assignment is that of the full 9-layer stack. Attention is
written as products and a softmax in true float32 (TF32 off), as the
reference computes it; no TPU kernel computes it there, so there is no
hand-written kernel here either.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtype import as_float
from ..core.linalg import f32_matmul_precision
from .hardnet import _numpy, _register_tree

__all__ = ["LightGlue", "LightGlueConfig"]

Device = Union[str, torch.device]

_FEATURES: Dict[str, Dict[str, Any]] = {
    "superpoint": {"input_dim": 256},
    "dedodeb": {"input_dim": 256},
    "dedodeg": {"input_dim": 256},
    "disk": {"input_dim": 128},
    "aliked": {"input_dim": 128},
    "xfeat": {"input_dim": 64, "descriptor_dim": 96, "n_layers": 6,
              "num_heads": 1},
    "sift": {"input_dim": 128, "add_scale_ori": True},
    "doghardnet": {"input_dim": 128, "add_scale_ori": True,
                   "scale_coef": 1.0 / 6.0},
}


class LightGlueConfig:
    """The matcher's configuration; `features` picks a published preset
    (input width, scale and orientation inputs)."""

    def __init__(self, features: Optional[str] = None, input_dim: int = 256,
                 descriptor_dim: int = 256, n_layers: int = 9,
                 num_heads: int = 4, add_scale_ori: bool = False,
                 scale_coef: float = 1.0, filter_threshold: float = 0.1,
                 dim: Optional[int] = None, num_layers: Optional[int] = None):
        if dim is not None:  # legacy aliases
            input_dim = descriptor_dim = dim
        if num_layers is not None:
            n_layers = num_layers
        if features is not None:
            preset = dict(_FEATURES[features])
            input_dim = preset.pop("input_dim", input_dim)
            descriptor_dim = preset.pop("descriptor_dim", descriptor_dim)
            n_layers = preset.pop("n_layers", n_layers)
            num_heads = preset.pop("num_heads", num_heads)
            add_scale_ori = preset.pop("add_scale_ori", add_scale_ori)
            scale_coef = preset.pop("scale_coef", scale_coef)
        self.input_dim = input_dim
        self.descriptor_dim = descriptor_dim
        self.n_layers = n_layers
        self.num_heads = num_heads
        self.add_scale_ori = add_scale_ori
        self.scale_coef = scale_coef
        self.filter_threshold = filter_threshold


def _param_specs(cfg: LightGlueConfig) -> Dict[str, Tuple[int, ...]]:
    d = cfg.descriptor_dim
    head_dim = d // cfg.num_heads
    M = 2 + 2 * cfg.add_scale_ori
    specs: Dict[str, Tuple[int, ...]] = {}
    if cfg.input_dim != d:
        specs["input_proj.weight"] = (d, cfg.input_dim)
        specs["input_proj.bias"] = (d,)
    specs["posenc.Wr.weight"] = (head_dim // 2, M)
    for i in range(cfg.n_layers):
        sa = f"transformers.{i}.self_attn"
        specs[f"{sa}.Wqkv.weight"] = (3 * d, d)
        specs[f"{sa}.Wqkv.bias"] = (3 * d,)
        specs[f"{sa}.out_proj.weight"] = (d, d)
        specs[f"{sa}.out_proj.bias"] = (d,)
        ca = f"transformers.{i}.cross_attn"
        for proj in ("to_qk", "to_v", "to_out"):
            specs[f"{ca}.{proj}.weight"] = (d, d)
            specs[f"{ca}.{proj}.bias"] = (d,)
        for blk in (sa, ca):
            specs[f"{blk}.ffn.0.weight"] = (2 * d, 2 * d)
            specs[f"{blk}.ffn.0.bias"] = (2 * d,)
            specs[f"{blk}.ffn.1.weight"] = (2 * d,)
            specs[f"{blk}.ffn.1.bias"] = (2 * d,)
            specs[f"{blk}.ffn.3.weight"] = (d, 2 * d)
            specs[f"{blk}.ffn.3.bias"] = (d,)
        la = f"log_assignment.{i}"
        specs[f"{la}.matchability.weight"] = (1, d)
        specs[f"{la}.matchability.bias"] = (1,)
        specs[f"{la}.final_proj.weight"] = (d, d)
        specs[f"{la}.final_proj.bias"] = (d,)
        if i < cfg.n_layers - 1:
            specs[f"token_confidence.{i}.token.0.weight"] = (1, d)
            specs[f"token_confidence.{i}.token.0.bias"] = (1,)
    return specs


def lightglue_init_params(generator: torch.Generator,
                          cfg: Optional[LightGlueConfig] = None
                          ) -> Dict[str, torch.Tensor]:
    """Linear weights N(0, 1/fan_in) drawn from a CPU `generator` in the
    order of the checkpoint's names, unit LayerNorm scales, zero biases."""
    cfg = cfg or LightGlueConfig()
    params = {}
    for name, shape in _param_specs(cfg).items():
        if len(shape) == 2:
            params[name] = torch.randn(shape, generator=generator) \
                / shape[1] ** 0.5
        elif name.endswith("ffn.1.weight"):
            params[name] = torch.ones(shape)
        else:
            params[name] = torch.zeros(shape)
    return params


def load_torch_weights(state_dict, cfg: Optional[LightGlueConfig] = None
                       ) -> Dict[str, np.ndarray]:
    """A torch LightGlue state dict (the older ``self_attn.{i}`` and
    ``matcher.``-prefixed layouts too) → the param dict, shapes checked."""
    cfg = cfg or LightGlueConfig()
    sd = {}
    for k, v in state_dict.items():
        if k.startswith("matcher."):
            k = k[len("matcher."):]
        for i in range(cfg.n_layers):
            k = k.replace(f"self_attn.{i}", f"transformers.{i}.self_attn")
            k = k.replace(f"cross_attn.{i}", f"transformers.{i}.cross_attn")
        sd[k] = v
    params = {}
    for k, shape in _param_specs(cfg).items():
        v = _numpy(sd[k])
        if v.shape != tuple(shape):
            raise ValueError(f"{k}: shape {v.shape}, expected {shape}")
        params[k] = v
    return params


def normalize_keypoints(kpts: torch.Tensor, size) -> torch.Tensor:
    """Keypoints centred on the image and scaled by half its longer side;
    `size` (B, 2) or (2,) as (w, h)."""
    size = torch.as_tensor(size, dtype=kpts.dtype, device=kpts.device)
    if size.ndim == 1:
        size = size[None]
    shift = size / 2.0
    scale = size.max(dim=1).values / 2.0
    return (kpts - shift[:, None]) / scale[:, None, None]


def _posenc(p: Mapping, kpts: torch.Tensor):
    """(cos, sin), each (B, 1, N, head_dim), channels repeated in pairs."""
    proj = kpts @ p["posenc.Wr.weight"].T
    cos = torch.repeat_interleave(torch.cos(proj), 2, dim=-1)[:, None]
    sin = torch.repeat_interleave(torch.sin(proj), 2, dim=-1)[:, None]
    return cos, sin


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(*x.shape[:-1], -1, 2)
    x1, x2 = x[..., 0], x[..., 1]
    return torch.stack([-x2, x1], -1).reshape(*x1.shape[:-1], -1)


def _apply_rotary(enc, t: torch.Tensor) -> torch.Tensor:
    cos, sin = enc
    return t * cos + _rotate_half(t) * sin


def _linear(p: Mapping, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _ffn(p: Mapping, pre: str, x: torch.Tensor,
         message: torch.Tensor) -> torch.Tensor:
    """x + linear → LayerNorm → GELU → linear of cat([x, message])."""
    h = _linear(p, f"{pre}.ffn.0", torch.cat([x, message], -1))
    h = F.layer_norm(h, h.shape[-1:], p[f"{pre}.ffn.1.weight"],
                     p[f"{pre}.ffn.1.bias"], eps=1e-5)
    return x + _linear(p, f"{pre}.ffn.3", F.gelu(h))


def _self_block(p: Mapping, pre: str, x: torch.Tensor, enc,
                nhead: int) -> torch.Tensor:
    B, N, d = x.shape
    dh = d // nhead
    qkv = _linear(p, f"{pre}.Wqkv", x).reshape(B, N, nhead, dh, 3)
    qkv = qkv.permute(0, 2, 1, 3, 4)  # (B, h, N, dh, 3)
    q = _apply_rotary(enc, qkv[..., 0])
    k = _apply_rotary(enc, qkv[..., 1])
    attn = torch.softmax((q @ k.transpose(-1, -2)) * dh ** -0.5, -1)
    ctx = (attn @ qkv[..., 2]).transpose(1, 2).reshape(B, N, d)
    return _ffn(p, pre, x, _linear(p, f"{pre}.out_proj", ctx))


def _cross_block(p: Mapping, pre: str, x0: torch.Tensor, x1: torch.Tensor,
                 nhead: int):
    B, M, d = x0.shape
    N = x1.shape[1]
    dh = d // nhead

    def split(t):
        return t.reshape(B, -1, nhead, dh).transpose(1, 2)

    def unsplit(t, n):
        return t.transpose(1, 2).reshape(B, n, d)

    qk0 = split(_linear(p, f"{pre}.to_qk", x0)) * dh ** -0.25
    qk1 = split(_linear(p, f"{pre}.to_qk", x1)) * dh ** -0.25
    v0 = split(_linear(p, f"{pre}.to_v", x0))
    v1 = split(_linear(p, f"{pre}.to_v", x1))
    sim = qk0 @ qk1.transpose(-1, -2)
    m0 = torch.softmax(sim, -1) @ v1
    m1 = torch.softmax(sim.transpose(-1, -2), -1) @ v0
    m0 = _linear(p, f"{pre}.to_out", unsplit(m0, M))
    m1 = _linear(p, f"{pre}.to_out", unsplit(m1, N))
    return _ffn(p, pre, x0, m0), _ffn(p, pre, x1, m1)


def _sigmoid_log_double_softmax(sim: torch.Tensor, z0: torch.Tensor,
                                z1: torch.Tensor) -> torch.Tensor:
    """The log assignment matrix (B, M+1, N+1): both softmaxes of the
    similarity plus the matchabilities, and the dustbins' log
    probabilities."""
    B, M, N = sim.shape
    cert = F.logsigmoid(z0) + F.logsigmoid(z1).transpose(1, 2)
    s0 = F.log_softmax(sim, 2)
    s1 = F.log_softmax(sim.transpose(-1, -2), 2).transpose(-1, -2)
    scores = sim.new_zeros((B, M + 1, N + 1))
    scores[:, :M, :N] = s0 + s1 + cert
    scores[:, :-1, -1] = F.logsigmoid(-z0[..., 0])
    scores[:, -1, :-1] = F.logsigmoid(-z1[..., 0])
    return scores


def _assignment(p: Mapping, pre: str, desc0: torch.Tensor,
                desc1: torch.Tensor) -> torch.Tensor:
    d = desc0.shape[-1]
    md0 = _linear(p, f"{pre}.final_proj", desc0) / d ** 0.25
    md1 = _linear(p, f"{pre}.final_proj", desc1) / d ** 0.25
    sim = md0 @ md1.transpose(-1, -2)
    z0 = _linear(p, f"{pre}.matchability", desc0)
    z1 = _linear(p, f"{pre}.matchability", desc1)
    return _sigmoid_log_double_softmax(sim, z0, z1)


def filter_matches(scores: torch.Tensor, th: float):
    """Mutual argmax of the inner assignment and a threshold on its
    probability: (matches0, matches1, mscores0, mscores1), -1 where
    unmatched."""
    inner = scores[:, :-1, :-1]
    max0, m0 = inner.max(2)
    m1 = inner.argmax(1)
    idx0 = torch.arange(m0.shape[1], device=scores.device)[None]
    idx1 = torch.arange(m1.shape[1], device=scores.device)[None]
    mutual0 = idx0 == torch.gather(m1, 1, m0)
    mutual1 = idx1 == torch.gather(m0, 1, m1)
    mscores0 = torch.where(mutual0, torch.exp(max0), 0.0)
    mscores1 = torch.where(mutual1, torch.gather(mscores0, 1, m1), 0.0)
    valid0 = mutual0 & (mscores0 > th)
    valid1 = mutual1 & torch.gather(valid0, 1, m1)
    m0 = torch.where(valid0, m0, -1)
    m1 = torch.where(valid1, m1, -1)
    return m0, m1, mscores0, mscores1


class LightGlue(nn.Module):
    """Takes the reference's nested {"image0": {...}, "image1": {...}} dict
    (keypoints (B, N, 2), descriptors (B, N, D), and image_size (w, h) or
    an image) or the flat one (keypoints0/1, descriptors0/1, image_size);
    presets with scale and orientation read ``scales`` and ``oris`` too.
    Without `params` the weights come from `generator`, or one seeded
    with 0 (the reference's key)."""

    def __init__(self, cfg: Optional[LightGlueConfig] = None,
                 params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        super().__init__()
        self.cfg = cfg or LightGlueConfig()
        if params is None:
            params = lightglue_init_params(
                generator if generator is not None
                else torch.Generator().manual_seed(0), self.cfg)
        _register_tree(self, params, device)

    @classmethod
    def from_torch(cls, state_dict, cfg: Optional[LightGlueConfig] = None,
                   device: Device = "cuda") -> "LightGlue":
        cfg = cfg or LightGlueConfig()
        return cls(cfg, params=load_torch_weights(state_dict, cfg),
                   device=device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Checkpoint name → parameter."""
        return dict(self.named_parameters())

    @f32_matmul_precision
    def forward(self, data: Dict[str, Any]) -> Dict[str, Any]:
        cfg, p = self.cfg, self.params
        if "image0" in data:
            d0, d1 = data["image0"], data["image1"]
            kpts0, kpts1 = d0["keypoints"], d1["keypoints"]
            desc0, desc1 = d0["descriptors"], d1["descriptors"]
            size0, size1 = d0.get("image_size"), d1.get("image_size")
            if size0 is None:
                size0 = list(d0["image"].shape[-2:][::-1])
            if size1 is None:
                size1 = list(d1["image"].shape[-2:][::-1])
            extras0, extras1 = d0, d1
        else:  # the flat layout
            kpts0, kpts1 = data["keypoints0"], data["keypoints1"]
            desc0, desc1 = data["descriptors0"], data["descriptors1"]
            size0 = size1 = data["image_size"]
            extras0 = {k[:-1]: v for k, v in data.items() if k.endswith("0")}
            extras1 = {k[:-1]: v for k, v in data.items() if k.endswith("1")}

        kpts0 = normalize_keypoints(as_float(kpts0), size0)
        kpts1 = normalize_keypoints(as_float(kpts1), size1)
        if cfg.add_scale_ori:
            kpts0 = torch.cat(
                [kpts0, as_float(extras0["scales"])[..., None]
                 * cfg.scale_coef, as_float(extras0["oris"])[..., None]], -1)
            kpts1 = torch.cat(
                [kpts1, as_float(extras1["scales"])[..., None]
                 * cfg.scale_coef, as_float(extras1["oris"])[..., None]], -1)

        desc0, desc1 = as_float(desc0), as_float(desc1)
        if cfg.input_dim != cfg.descriptor_dim:
            desc0 = _linear(p, "input_proj", desc0)
            desc1 = _linear(p, "input_proj", desc1)
        enc0, enc1 = _posenc(p, kpts0), _posenc(p, kpts1)
        for i in range(cfg.n_layers):
            sa = f"transformers.{i}.self_attn"
            desc0 = _self_block(p, sa, desc0, enc0, cfg.num_heads)
            desc1 = _self_block(p, sa, desc1, enc1, cfg.num_heads)
            desc0, desc1 = _cross_block(p, f"transformers.{i}.cross_attn",
                                        desc0, desc1, cfg.num_heads)
        scores = _assignment(p, f"log_assignment.{cfg.n_layers - 1}",
                             desc0, desc1)
        m0, m1, ms0, ms1 = filter_matches(scores, cfg.filter_threshold)
        return {"log_assignment": scores, "matches0": m0, "matches1": m1,
                "matching_scores0": ms0, "matching_scores1": ms1,
                "valid": m0 > -1, "stop": cfg.n_layers}
