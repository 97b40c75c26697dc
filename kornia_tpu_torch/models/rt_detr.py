"""RT-DETR, the real-time detection transformer (counterpart of
``kornia_tpu/models/rt_detr.py``): ResNet-D or HGNetv2 backbone, the
hybrid encoder (AIFI on the coarsest map, then the CCFM's top-down and
bottom-up fusion), the deformable-DETR head with its query selection and
the post-processor.

The weights are frozen parameters under the reference state dict's names
(``backbone.conv1.conv1_1.conv.weight``, ...) in torch's layout (OIHW
convolutions, (out, in) linears), described by one table
(``_param_specs``): the seeded draw, the checkpoint loader's shape check
and ``convert.rtdetr_from_numpy`` (the JAX package's HWIO / (in, out)
dict) come from it. The network computes in NCHW in true float32 (TF32
off). The deformable attention samples each level with the port's
``ops/warp.grid_sample`` (bilinear, zero padding, align_corners False).
Every top-k is ``core/sort.py::top_k`` (the lower index first among equal
scores, as ``lax.top_k``). Static shapes: the decoder runs its full depth
and the post-processor returns a fixed (B, K, 6) table with the rows
below the threshold zeroed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtype import as_float, host_tensor
from ..core.linalg import f32_matmul_precision
from ..core.sort import top_k
from ..feature import _nets
from ..ops.warp import grid_sample, resize

__all__ = ["RTDETR", "RTDETRConfig", "HGNetStageConfig", "DETRPostProcessor",
           "rtdetr_init_params", "load_torch_weights"]

Device = Union[str, torch.device]

_BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class HGNetStageConfig:
    """An HGNetv2 stage (the reference's StageConfig)."""

    in_channels: int
    mid_channels: int
    out_channels: int
    num_blocks: int
    downsample: bool
    light_block: bool
    kernel_size: int
    layer_num: int


_HGNET_VARIANTS = {
    "L": ([3, 32, 48], [
        HGNetStageConfig(48, 48, 128, 1, False, False, 3, 6),
        HGNetStageConfig(128, 96, 512, 1, True, False, 3, 6),
        HGNetStageConfig(512, 192, 1024, 3, True, True, 5, 6),
        HGNetStageConfig(1024, 384, 2048, 1, True, True, 5, 6),
    ]),
    "X": ([3, 32, 64], [
        HGNetStageConfig(64, 64, 128, 1, False, False, 3, 6),
        HGNetStageConfig(128, 128, 512, 2, True, False, 3, 6),
        HGNetStageConfig(512, 256, 1024, 5, True, True, 5, 6),
        HGNetStageConfig(1024, 512, 2048, 2, True, True, 5, 6),
    ]),
}

_RESNET_VARIANTS = {  # depth -> (n_blocks, bottleneck)
    18: ([2, 2, 2, 2], False),
    34: ([3, 4, 6, 3], False),
    50: ([3, 4, 6, 3], True),
    101: ([3, 4, 23, 3], True),
    152: ([3, 8, 36, 3], True),
}

# model_type -> (backbone, neck_hidden, neck_ffn, dec_layers, expansion)
_MODEL_DEFAULTS = {
    "resnet18d": (("resnet", 18), 256, 1024, 3, 0.5),
    "resnet34d": (("resnet", 34), 256, 1024, 4, 0.5),
    "resnet50d": (("resnet", 50), 256, 1024, 6, 1.0),
    "resnet50d_m": (("resnet", 50), 256, 1024, 6, 0.5),
    "resnet101d": (("resnet", 101), 384, 2048, 6, 1.0),
    "hgnetv2_l": (("hgnet", "L"), 256, 1024, 6, 1.0),
    "hgnetv2_x": (("hgnet", "X"), 384, 2048, 6, 1.0),
}


@dataclasses.dataclass
class RTDETRConfig:
    """The reference's RTDETRConfig, with hooks for a custom backbone
    (``resnet_n_blocks``/``resnet_bottleneck`` or ``hgnet_stem``/
    ``hgnet_stages``) that override the model type's."""

    model_type: str = "resnet18d"
    num_classes: int = 80
    input_size: int = 640
    neck_hidden_dim: Optional[int] = None
    neck_dim_feedforward: Optional[int] = None
    neck_expansion: Optional[float] = None
    head_hidden_dim: int = 256
    head_num_queries: int = 300
    head_num_decoder_layers: Optional[int] = None
    head_num_heads: int = 8
    head_num_points: int = 4
    confidence_threshold: float = 0.3
    resnet_n_blocks: Optional[Sequence[int]] = None
    resnet_bottleneck: bool = False
    hgnet_stem: Optional[Sequence[int]] = None
    hgnet_stages: Optional[Sequence[HGNetStageConfig]] = None

    def __post_init__(self) -> None:
        if self.model_type not in _MODEL_DEFAULTS:
            raise ValueError(f"unknown model_type {self.model_type!r}")
        backbone, hid, ffn, dec, exp = _MODEL_DEFAULTS[self.model_type]
        if self.hgnet_stages is not None:
            self.backbone_kind = "hgnet"
            self.stem_channels = list(self.hgnet_stem or [3, 8, 16])
            self.stage_configs = list(self.hgnet_stages)
        elif self.resnet_n_blocks is not None:
            self.backbone_kind = "resnet"
            self.n_blocks = list(self.resnet_n_blocks)
            self.bottleneck = self.resnet_bottleneck
        elif backbone[0] == "resnet":
            self.backbone_kind = "resnet"
            self.n_blocks, self.bottleneck = _RESNET_VARIANTS[backbone[1]]
        else:
            self.backbone_kind = "hgnet"
            self.stem_channels, self.stage_configs = _HGNET_VARIANTS[
                backbone[1]]
        if self.neck_hidden_dim is None:
            self.neck_hidden_dim = hid
        if self.neck_dim_feedforward is None:
            self.neck_dim_feedforward = ffn
        if self.head_num_decoder_layers is None:
            self.head_num_decoder_layers = dec
        if self.neck_expansion is None:
            self.neck_expansion = exp

    @property
    def backbone_out_channels(self) -> List[int]:
        if self.backbone_kind == "hgnet":
            return [c.out_channels for c in self.stage_configs[-3:]]
        exp = 4 if self.bottleneck else 1
        return [128 * exp, 256 * exp, 512 * exp]


# -----------------------------------------------------------------------------
# Parameter table
# -----------------------------------------------------------------------------

def _param_specs(cfg: RTDETRConfig) -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    """State-dict name -> (kind, torch shape); kind conv, lin or vec."""
    s: Dict[str, Tuple[str, Tuple[int, ...]]] = {}

    def cna(prefix, cin, cout, k, groups=1, conv_name="conv",
            norm_name="norm"):
        s[f"{prefix}.{conv_name}.weight"] = ("conv",
                                             (cout, cin // groups, k, k))
        for suf in ("weight", "bias", "running_mean", "running_var"):
            s[f"{prefix}.{norm_name}.{suf}"] = ("vec", (cout,))

    def lin(prefix, cin, cout):
        s[f"{prefix}.weight"] = ("lin", (cout, cin))
        s[f"{prefix}.bias"] = ("vec", (cout,))

    def ln(prefix, dim):
        s[f"{prefix}.weight"] = ("vec", (dim,))
        s[f"{prefix}.bias"] = ("vec", (dim,))

    def mha(prefix, dim):
        s[f"{prefix}.in_proj_weight"] = ("lin", (3 * dim, dim))
        s[f"{prefix}.in_proj_bias"] = ("vec", (3 * dim,))
        lin(f"{prefix}.out_proj", dim, dim)

    def mlp(prefix, dims):
        for i in range(len(dims) - 1):
            lin(f"{prefix}.layers.{i}", dims[i], dims[i + 1])

    if cfg.backbone_kind == "resnet":
        cna("backbone.conv1.conv1_1", 3, 32, 3)
        cna("backbone.conv1.conv1_2", 32, 32, 3)
        cna("backbone.conv1.conv1_3", 32, 64, 3)
        exp = 4 if cfg.bottleneck else 1
        cin = 64
        for i, (cout, stride) in enumerate(zip((64, 128, 256, 512),
                                               (1, 2, 2, 2))):
            for j in range(cfg.n_blocks[i]):
                pre = f"backbone.res_layers.{i}.blocks.{j}"
                bin_ = cin if j == 0 else cout * exp
                if cfg.bottleneck:
                    cna(f"{pre}.convs.branch2a", bin_, cout, 1)
                    cna(f"{pre}.convs.branch2b", cout, cout, 3)
                    cna(f"{pre}.convs.branch2c", cout, cout * exp, 1)
                else:
                    cna(f"{pre}.convs.branch2a", bin_, cout, 3)
                    cna(f"{pre}.convs.branch2b", cout, cout, 3)
                if j == 0:  # projection shortcut
                    if stride == 2:
                        cna(f"{pre}.short.conv", bin_, cout * exp, 1)
                    else:
                        cna(f"{pre}.short", bin_, cout * exp, 1)
            cin = cout * exp
    else:
        c_in, c_mid, c_out = cfg.stem_channels
        cna("backbone.stem.stem1", c_in, c_mid, 3)
        cna("backbone.stem.stem2a", c_mid, c_mid // 2, 2)
        cna("backbone.stem.stem2b", c_mid // 2, c_mid, 2)
        cna("backbone.stem.stem3", c_mid * 2, c_mid, 3)
        cna("backbone.stem.stem4", c_mid, c_out, 1)
        for i, st in enumerate(cfg.stage_configs):
            pre = f"backbone.stages.{i}"
            if st.downsample:
                cna(f"{pre}.downsample", st.in_channels, st.in_channels, 3,
                    groups=st.in_channels)
            for j in range(st.num_blocks):
                bpre = f"{pre}.blocks.{j}"
                bin_ = st.in_channels if j == 0 else st.out_channels
                for k in range(st.layer_num):
                    ch = bin_ if k == 0 else st.mid_channels
                    if st.light_block:
                        cna(f"{bpre}.layers.{k}.conv1", ch, st.mid_channels,
                            1)
                        cna(f"{bpre}.layers.{k}.conv2", st.mid_channels,
                            st.mid_channels, st.kernel_size,
                            groups=st.mid_channels)
                    else:
                        cna(f"{bpre}.layers.{k}", ch, st.mid_channels,
                            st.kernel_size)
                total = bin_ + st.mid_channels * st.layer_num
                cna(f"{bpre}.aggregation_squeeze_conv", total,
                    st.out_channels // 2, 1)
                cna(f"{bpre}.aggregation_excitation_conv",
                    st.out_channels // 2, st.out_channels, 1)

    hid = cfg.neck_hidden_dim
    for i, ch in enumerate(cfg.backbone_out_channels):
        cna(f"encoder.input_proj.{i}", ch, hid, 1, conv_name="0",
            norm_name="1")
    aifi = "encoder.encoder.0.layers.0"
    mha(f"{aifi}.self_attn", hid)
    lin(f"{aifi}.linear1", hid, cfg.neck_dim_feedforward)
    lin(f"{aifi}.linear2", cfg.neck_dim_feedforward, hid)
    ln(f"{aifi}.norm1", hid)
    ln(f"{aifi}.norm2", hid)

    def csp_rep(prefix, cin, cout, n_blocks, expansion):
        hidden = int(cout * expansion)
        cna(f"{prefix}.conv1", cin, hidden, 1)
        cna(f"{prefix}.conv2", cin, hidden, 1)
        for j in range(n_blocks):
            cna(f"{prefix}.bottlenecks.{j}.conv1", hidden, hidden, 3)
            cna(f"{prefix}.bottlenecks.{j}.conv2", hidden, hidden, 1)
        if hidden != cout:
            cna(f"{prefix}.conv3", hidden, cout, 1)

    n_fmaps = len(cfg.backbone_out_channels)
    for i in range(n_fmaps - 1):
        cna(f"encoder.ccfm.lateral_convs.{i}", hid, hid, 1)
        csp_rep(f"encoder.ccfm.fpn_blocks.{i}", hid * 2, hid, 3,
                cfg.neck_expansion)
        cna(f"encoder.ccfm.downsample_convs.{i}", hid, hid, 3)
        csp_rep(f"encoder.ccfm.pan_blocks.{i}", hid * 2, hid, 3,
                cfg.neck_expansion)

    hd = cfg.head_hidden_dim
    for i in range(n_fmaps):
        cna(f"decoder.input_proj.{i}", hid, hd, 1)
    for i in range(cfg.head_num_decoder_layers):
        pre = f"decoder.decoder.layers.{i}"
        mha(f"{pre}.self_attn", hd)
        ln(f"{pre}.norm1", hd)
        lin(f"{pre}.cross_attn.sampling_offsets", hd,
            cfg.head_num_heads * n_fmaps * cfg.head_num_points * 2)
        lin(f"{pre}.cross_attn.attention_weights", hd,
            cfg.head_num_heads * n_fmaps * cfg.head_num_points)
        lin(f"{pre}.cross_attn.value_proj", hd, hd)
        lin(f"{pre}.cross_attn.output_proj", hd, hd)
        ln(f"{pre}.norm2", hd)
        lin(f"{pre}.linear1", hd, hd * 4)
        lin(f"{pre}.linear2", hd * 4, hd)
        ln(f"{pre}.norm3", hd)
        lin(f"decoder.dec_score_head.{i}", hd, cfg.num_classes)
        mlp(f"decoder.dec_bbox_head.{i}", (hd, hd, hd, 4))
    mlp("decoder.query_pos_head", (4, 2 * hd, hd))
    lin("decoder.enc_output.0", hd, hd)
    ln("decoder.enc_output.1", hd)
    lin("decoder.enc_score_head", hd, cfg.num_classes)
    mlp("decoder.enc_bbox_head", (hd, hd, hd, 4))
    return s


def rtdetr_init_params(generator: torch.Generator,
                       cfg: Optional[RTDETRConfig] = None,
                       dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Seeded parameters in the state dict's layout, drawn from a CPU
    `generator` in the table's order: He-normal convolutions, linears
    uniform in ±1/sqrt(fan-in), unit norm scales and running variances,
    zero biases and means (the JAX package's scheme; ``jax.random``'s
    values cannot be reproduced)."""
    cfg = cfg or RTDETRConfig()
    params: Dict[str, torch.Tensor] = {}
    for name, (kind, shape) in _param_specs(cfg).items():
        if kind == "conv":
            std = math.sqrt(2.0 / math.prod(shape[1:]))
            params[name] = torch.randn(shape, generator=generator,
                                       dtype=dtype) * std
        elif kind == "lin":
            bound = 1.0 / math.sqrt(shape[1])
            params[name] = (torch.rand(shape, generator=generator,
                                       dtype=dtype) * 2 - 1) * bound
        elif name.endswith("running_var") or name.endswith(".weight"):
            params[name] = torch.ones(shape, dtype=dtype)
        else:
            params[name] = torch.zeros(shape, dtype=dtype)
    return params


def load_torch_weights(state_dict, cfg: Optional[RTDETRConfig] = None
                       ) -> Dict[str, np.ndarray]:
    """A reference RTDETR state dict → the port's `params` (float32, each
    shape checked)."""
    cfg = cfg or RTDETRConfig()
    return _nets.check_params(
        [(k, shape, (k,), kind) for k, (kind, shape) in
         _param_specs(cfg).items()], state_dict)


# -----------------------------------------------------------------------------
# Layer primitives (NCHW; p = the flat param dict)
# -----------------------------------------------------------------------------

def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu":
        return F.relu(x)
    if act == "silu":
        return F.silu(x)
    return x


def _cna(p, prefix, x, stride=1, act="relu", groups=1, conv_name="conv",
         norm_name="norm"):
    """ConvNormAct: odd kernels pad symmetrically, even ones one more at
    the bottom and right; the batch norm folded into a scale and shift."""
    w = p[f"{prefix}.{conv_name}.weight"]
    k = w.shape[-1]
    p1, p2 = (k - 1) // 2, k - 1 - (k - 1) // 2
    if p1 == p2:
        y = F.conv2d(x, w, None, stride, p1, 1, groups)
    else:
        y = F.conv2d(F.pad(x, (p1, p2, p1, p2)), w, None, stride, 0, 1,
                     groups)
    pre = f"{prefix}.{norm_name}"
    scale = p[f"{pre}.weight"] * torch.rsqrt(p[f"{pre}.running_var"]
                                             + _BN_EPS)
    shift = p[f"{pre}.bias"] - p[f"{pre}.running_mean"] * scale
    return _act(y * scale[:, None, None] + shift[:, None, None], act)


def _linear(p, prefix, x):
    return F.linear(x, p[f"{prefix}.weight"], p[f"{prefix}.bias"])


def _layer_norm(p, prefix, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p[f"{prefix}.weight"],
                        p[f"{prefix}.bias"], eps)


def _mha(p, prefix, q, k, v, num_heads):
    """torch ``nn.MultiheadAttention`` on batch-first (B, L, E) rows."""
    E = q.shape[-1]
    w, b = p[f"{prefix}.in_proj_weight"], p[f"{prefix}.in_proj_bias"]
    B, Lq, _ = q.shape
    d = E // num_heads

    def heads(x, i):
        y = F.linear(x, w[i * E:(i + 1) * E], b[i * E:(i + 1) * E])
        return y.reshape(B, -1, num_heads, d).transpose(1, 2)

    out = F.scaled_dot_product_attention(heads(q, 0), heads(k, 1),
                                         heads(v, 2))
    return _linear(p, f"{prefix}.out_proj",
                   out.transpose(1, 2).reshape(B, Lq, E))


def _mlp(p, prefix, x, num_layers):
    """ReLU between the layers, the last linear."""
    for i in range(num_layers):
        x = _linear(p, f"{prefix}.layers.{i}", x)
        if i < num_layers - 1:
            x = F.relu(x)
    return x


# -----------------------------------------------------------------------------
# Backbones
# -----------------------------------------------------------------------------

def _resnetd_forward(p, cfg: RTDETRConfig, x) -> List[torch.Tensor]:
    """-> [res3, res4, res5]."""
    x = _cna(p, "backbone.conv1.conv1_1", x, stride=2)
    x = _cna(p, "backbone.conv1.conv1_2", x)
    x = _cna(p, "backbone.conv1.conv1_3", x)
    x = F.max_pool2d(x, 3, 2, 1)   # the padding is -inf
    outs = []
    for i, stride in enumerate((1, 2, 2, 2)):
        for j in range(cfg.n_blocks[i]):
            pre = f"backbone.res_layers.{i}.blocks.{j}"
            st = stride if j == 0 else 1
            if cfg.bottleneck:
                y = _cna(p, f"{pre}.convs.branch2a", x)
                y = _cna(p, f"{pre}.convs.branch2b", y, stride=st)
                y = _cna(p, f"{pre}.convs.branch2c", y, act="none")
            else:
                y = _cna(p, f"{pre}.convs.branch2a", x, stride=st)
                y = _cna(p, f"{pre}.convs.branch2b", y, act="none")
            if j == 0:
                if st == 2:  # un-padded 2x2 average pool, then 1x1
                    short = _cna(p, f"{pre}.short.conv",
                                 F.avg_pool2d(x, 2, 2), act="none")
                else:
                    short = _cna(p, f"{pre}.short", x, act="none")
            else:
                short = x
            x = F.relu(y + short)
        outs.append(x)
    return outs[1:]


def _hgnetv2_forward(p, cfg: RTDETRConfig, x) -> List[torch.Tensor]:
    """-> [s3, s4, s5]."""
    x = _cna(p, "backbone.stem.stem1", x, stride=2)
    branch = _cna(p, "backbone.stem.stem2b",
                  _cna(p, "backbone.stem.stem2a", x))
    # the reference zero-pads (right, bottom) before its 2x2 stride-1 pool
    pooled = F.max_pool2d(F.pad(x, (0, 1, 0, 1)), 2, 1)
    x = torch.cat([pooled, branch], 1)
    x = _cna(p, "backbone.stem.stem4",
             _cna(p, "backbone.stem.stem3", x, stride=2))
    outs = []
    for i, st in enumerate(cfg.stage_configs):
        pre = f"backbone.stages.{i}"
        if st.downsample:
            x = _cna(p, f"{pre}.downsample", x, stride=2, act="none",
                     groups=st.in_channels)
        for j in range(st.num_blocks):
            bpre = f"{pre}.blocks.{j}"
            feats = [x]
            for k in range(st.layer_num):
                h = feats[-1]
                if st.light_block:
                    h = _cna(p, f"{bpre}.layers.{k}.conv1", h, act="none")
                    h = _cna(p, f"{bpre}.layers.{k}.conv2", h,
                             groups=st.mid_channels)
                else:
                    h = _cna(p, f"{bpre}.layers.{k}", h)
                feats.append(h)
            out = torch.cat(feats, 1)
            out = _cna(p, f"{bpre}.aggregation_squeeze_conv", out)
            out = _cna(p, f"{bpre}.aggregation_excitation_conv", out)
            x = x + out if j > 0 else out
        outs.append(x)
    return outs[1:]


# -----------------------------------------------------------------------------
# Hybrid encoder
# -----------------------------------------------------------------------------

def _sincos_pos_emb(w: int, h: int, dim: int, device,
                    temp: float = 10_000.0) -> torch.Tensor:
    """(H·W, dim) 2-D sin-cos table in the reference's x-major flatten
    order (row i is x = i // h, y = i % h), kept as it is."""
    f32 = torch.float32
    grid_x, grid_y = torch.meshgrid(torch.arange(w, dtype=f32, device=device),
                                    torch.arange(h, dtype=f32, device=device),
                                    indexing="ij")
    pos_dim = dim // 4
    omega = 1.0 / (temp ** (torch.arange(pos_dim, dtype=f32, device=device)
                            / pos_dim))
    out_x = grid_x.reshape(-1, 1) * omega[None]
    out_y = grid_y.reshape(-1, 1) * omega[None]
    return torch.cat([out_x.sin(), out_x.cos(), out_y.sin(), out_y.cos()], 1)


def _csp_rep(p, prefix, x, expansion, cout):
    """CSPRepLayer of three RepVgg blocks."""
    hidden = int(cout * expansion)
    y = _cna(p, f"{prefix}.conv1", x, act="silu")
    for j in range(3):
        y = F.silu(_cna(p, f"{prefix}.bottlenecks.{j}.conv1", y, act="none")
                   + _cna(p, f"{prefix}.bottlenecks.{j}.conv2", y,
                          act="none"))
    y = y + _cna(p, f"{prefix}.conv2", x, act="silu")
    if hidden != cout:
        y = _cna(p, f"{prefix}.conv3", y, act="silu")
    return y


def _hybrid_encoder_forward(p, cfg: RTDETRConfig,
                            fmaps: List[torch.Tensor]) -> List[torch.Tensor]:
    hid = cfg.neck_hidden_dim
    proj = [_cna(p, f"encoder.input_proj.{i}", f, act="none",
                 conv_name="0", norm_name="1") for i, f in enumerate(fmaps)]

    # AIFI on the coarsest map (a post-norm transformer layer)
    x = proj[-1]
    B, C, H, W = x.shape
    tokens = x.flatten(2).transpose(1, 2)
    pos = _sincos_pos_emb(W, H, C, x.device)[None]
    aifi = "encoder.encoder.0.layers.0"
    q = tokens + pos
    attn = _mha(p, f"{aifi}.self_attn", q, q, tokens, 8)
    tokens = _layer_norm(p, f"{aifi}.norm1", tokens + attn)
    ffn = _linear(p, f"{aifi}.linear2",
                  F.gelu(_linear(p, f"{aifi}.linear1", tokens)))
    tokens = _layer_norm(p, f"{aifi}.norm2", tokens + ffn)
    proj[-1] = tokens.transpose(1, 2).reshape(B, C, H, W)

    # CCFM: top-down, then bottom-up
    fmaps = list(proj)
    new_fmaps = [fmaps.pop()]
    while fmaps:
        i = len(new_fmaps) - 1
        new_fmaps[-1] = _cna(p, f"encoder.ccfm.lateral_convs.{i}",
                             new_fmaps[-1], act="silu")
        up = F.interpolate(new_fmaps[-1], scale_factor=2, mode="nearest")
        cat = torch.cat([up, fmaps.pop()], 1)
        new_fmaps.append(_csp_rep(p, f"encoder.ccfm.fpn_blocks.{i}", cat,
                                  cfg.neck_expansion, hid))
    fmaps = [new_fmaps.pop()]
    while new_fmaps:
        i = len(fmaps) - 1
        down = _cna(p, f"encoder.ccfm.downsample_convs.{i}", fmaps[-1],
                    stride=2, act="silu")
        cat = torch.cat([down, new_fmaps.pop()], 1)
        fmaps.append(_csp_rep(p, f"encoder.ccfm.pan_blocks.{i}", cat,
                              cfg.neck_expansion, hid))
    return fmaps


# -----------------------------------------------------------------------------
# Head (deformable-DETR decoder)
# -----------------------------------------------------------------------------

def _inverse_sigmoid(x, eps=1e-5):
    out = x.clamp(0.0, 1.0)
    return torch.log(out.clamp_min(eps) / (1.0 - out).clamp_min(eps))


def _deformable_attention(p, prefix, query, ref_points, value, shapes,
                          num_heads, num_points):
    """Multi-scale deformable attention: each level's value map sampled
    by ``ops/warp.grid_sample`` at the predicted offsets."""
    N, Lq, C = query.shape
    L = len(shapes)
    M, P = num_heads, num_points
    D = C // M
    off = _linear(p, f"{prefix}.sampling_offsets", query).reshape(
        N, Lq, M, L, P, 2)
    w = _linear(p, f"{prefix}.attention_weights", query).reshape(
        N, Lq, M, L * P)
    w = F.softmax(w, -1).reshape(N, Lq, M, L, P)
    ref_cxcy = ref_points[:, :, None, :, None, :2]
    ref_wh = ref_points[:, :, None, :, None, 2:]
    loc = ref_cxcy + off / P * ref_wh * 0.5       # (N, Lq, M, L, P, 2)
    grids = 2.0 * loc - 1.0

    v = _linear(p, f"{prefix}.value_proj", value).reshape(N, -1, M, D)
    start = 0
    sampled = []
    for lvl, (h, wd) in enumerate(shapes):
        v_l = v[:, start:start + h * wd].reshape(N, h, wd, M, D)
        v_l = v_l.permute(0, 3, 4, 1, 2).reshape(N * M, D, h, wd)
        g_l = grids[:, :, :, lvl].transpose(1, 2).reshape(N * M, Lq, P, 2)
        sampled.append(grid_sample(v_l, g_l, "bilinear", "zeros",
                                   align_corners=False))  # (N*M, D, Lq, P)
        start += h * wd
    stacked = torch.stack(sampled, -2).reshape(N * M, D, Lq, L * P)
    w = w.transpose(1, 2).reshape(N * M, 1, Lq, L * P)
    out = (stacked * w).sum(-1).reshape(N, M * D, Lq).transpose(1, 2)
    return _linear(p, f"{prefix}.output_proj", out)


def _generate_anchors(shapes, device, grid_size=0.05, eps=0.01):
    """Logit anchors (1, ΣHW, 4) and their validity (1, ΣHW, 1): an anchor
    with a coordinate outside (eps, 1 - eps) is +inf."""
    f32 = torch.float32
    anchors_list = []
    for i, (h, w) in enumerate(shapes):
        gy, gx = torch.meshgrid(torch.arange(h, dtype=f32, device=device),
                                torch.arange(w, dtype=f32, device=device),
                                indexing="ij")
        gxy = (torch.stack([gx, gy], -1) + 0.5) / host_tensor([w, h], device)
        gwh = torch.full_like(gxy, grid_size * (2.0 ** i))
        anchors_list.append(torch.cat([gxy, gwh], -1).reshape(1, h * w, 4))
    anchors = torch.cat(anchors_list, 1)
    valid = ((anchors > eps) & (anchors < 1 - eps)).all(-1, keepdim=True)
    anchors = torch.log(anchors / (1 - anchors))
    anchors = torch.where(valid, anchors, torch.inf)
    return anchors, valid


def _head_forward(p, cfg: RTDETRConfig, fmaps: List[torch.Tensor],
                  queries: Optional[torch.Tensor] = None):
    """-> (logits (B, Q, classes), boxes (B, Q, 4) cxcywh normalised, the
    encoder's class maxima (B, ΣHW), the selected query indices (B, Q):
    the best maxima, the lower index first among equal ones). The decoder
    runs from `queries` where given, from the selection otherwise."""
    hd = cfg.head_hidden_dim
    proj = [_cna(p, f"decoder.input_proj.{i}", f, act="none")
            for i, f in enumerate(fmaps)]
    shapes = [tuple(f.shape[-2:]) for f in proj]
    memory = torch.cat([f.flatten(2).transpose(1, 2) for f in proj], 1)

    anchors, valid = _generate_anchors(shapes, memory.device)
    memory = torch.where(valid, memory, 0.0)
    out_mem = _layer_norm(p, "decoder.enc_output.1",
                          _linear(p, "decoder.enc_output.0", memory))
    enc_logits = _linear(p, "decoder.enc_score_head", out_mem)
    enc_coord = _mlp(p, "decoder.enc_bbox_head", out_mem, 3) + anchors

    nq = min(cfg.head_num_queries, enc_logits.shape[1])
    enc_max = enc_logits.max(-1).values
    selected = top_k(enc_max, nq)[1]
    idx = (selected if queries is None else queries)[..., None]
    ref_unact = torch.take_along_dim(enc_coord, idx, 1)
    target = torch.take_along_dim(out_mem, idx, 1)

    ref = torch.sigmoid(ref_unact)
    out = target
    logits = boxes = None
    for i in range(cfg.head_num_decoder_layers):
        pre = f"decoder.decoder.layers.{i}"
        qpos = _mlp(p, "decoder.query_pos_head", ref, 2)
        q = out + qpos
        attn = _mha(p, f"{pre}.self_attn", q, q, out, cfg.head_num_heads)
        out = _layer_norm(p, f"{pre}.norm1", out + attn)
        cross = _deformable_attention(
            p, f"{pre}.cross_attn", out + qpos, ref[:, :, None, :], memory,
            shapes, cfg.head_num_heads, cfg.head_num_points)
        out = _layer_norm(p, f"{pre}.norm2", out + cross)
        ffn = _linear(p, f"{pre}.linear2",
                      F.relu(_linear(p, f"{pre}.linear1", out)))
        out = _layer_norm(p, f"{pre}.norm3", out + ffn)
        inter_ref = torch.sigmoid(_mlp(p, f"decoder.dec_bbox_head.{i}",
                                       out, 3) + _inverse_sigmoid(ref))
        if i == cfg.head_num_decoder_layers - 1:
            logits = _linear(p, f"decoder.dec_score_head.{i}", out)
            boxes = inter_ref
        ref = inter_ref
    return logits, boxes, enc_max, selected


# -----------------------------------------------------------------------------
# Post-processing
# -----------------------------------------------------------------------------

class DETRPostProcessor:
    """(B, K, 6) rows (class, score, x, y, w, h) in pixels: the top K of
    every (query, class) score; rows at or below the confidence threshold
    are zeroed."""

    def __init__(self, confidence_threshold: Optional[float] = None,
                 num_classes: int = 80, num_top_queries: int = 300,
                 confidence_filtering: bool = True):
        self.confidence_threshold = confidence_threshold
        self.num_classes = num_classes
        self.num_top_queries = num_top_queries
        self.confidence_filtering = confidence_filtering

    def __call__(self, logits: torch.Tensor, boxes: torch.Tensor,
                 original_sizes) -> torch.Tensor:
        cxcy, wh = boxes[..., :2], boxes[..., 2:]
        boxes_xy = torch.cat([cxcy - wh * 0.5, wh], -1)
        # the reference scales every image by the first image's size
        h0, w0 = (float(v) for v in original_sizes[0])
        boxes_xy = boxes_xy * host_tensor([w0, h0, w0, h0], boxes.device,
                                          boxes.dtype)
        scores = torch.sigmoid(logits)
        B, Q, K = scores.shape
        k = min(self.num_top_queries, Q * K)
        top_scores, index = top_k(scores.reshape(B, -1), k)
        labels = index % self.num_classes
        qidx = index // self.num_classes
        top_boxes = torch.take_along_dim(boxes_xy, qidx[..., None], 1)
        out = torch.cat([labels[..., None].to(boxes.dtype),
                         top_scores[..., None], top_boxes], -1)
        if not self.confidence_filtering or not self.confidence_threshold:
            return out
        keep = top_scores > self.confidence_threshold
        return torch.where(keep[..., None], out, 0.0)


# -----------------------------------------------------------------------------
# Model
# -----------------------------------------------------------------------------

def rtdetr_forward(params: Mapping[str, torch.Tensor], cfg: RTDETRConfig,
                   images: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """images (B, 3, H, W) in [0, 1] -> (logits (B, Q, C), boxes (B, Q, 4)
    cxcywh normalised)."""
    return _forward(params, cfg, images)[:2]


@f32_matmul_precision
def _forward(params: Mapping[str, torch.Tensor], cfg: RTDETRConfig,
             images: torch.Tensor, queries: Optional[torch.Tensor] = None):
    """``rtdetr_forward``'s outputs, then the encoder's class maxima and
    its selected query indices; the decoder runs from `queries` (B, Q)
    where given (``_head_forward``)."""
    x = as_float(images)
    if cfg.backbone_kind == "resnet":
        fmaps = _resnetd_forward(params, cfg, x)
    else:
        fmaps = _hgnetv2_forward(params, cfg, x)
    fmaps = _hybrid_encoder_forward(params, cfg, fmaps)
    return _head_forward(params, cfg, fmaps, queries)


class RTDETR(nn.Module):
    """The RT-DETR detector. `params`: the state dict's names and layout;
    without it the weights come from `generator`, or one seeded with 0
    (the reference's key). ``__call__`` is the reference's forward;
    ``detect`` adds the resize to ``input_size`` and the post-processor.
    """

    def __init__(self, cfg: Optional[RTDETRConfig] = None,
                 params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        super().__init__()
        self.cfg = cfg or RTDETRConfig()
        if params is None:
            params = rtdetr_init_params(
                generator if generator is not None
                else torch.Generator().manual_seed(0), self.cfg)
        else:
            params = load_torch_weights(params, self.cfg)
        _nets._register_tree(self, params, device)
        self.post = DETRPostProcessor(
            self.cfg.confidence_threshold, self.cfg.num_classes,
            self.cfg.head_num_queries)

    @classmethod
    def from_torch(cls, state_dict, cfg: Optional[RTDETRConfig] = None,
                   device: Device = "cuda") -> "RTDETR":
        return cls(cfg, state_dict, device=device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """State-dict name → parameter."""
        return dict(self.named_parameters())

    def forward(self, images: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        return rtdetr_forward(self.params, self.cfg, images)

    def detect(self, images: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) -> (B, K, 6) rows (class, score, x, y, w, h) in the
        input's pixels."""
        H, W = images.shape[-2:]
        x = resize(as_float(images), (self.cfg.input_size,
                                      self.cfg.input_size))
        logits, boxes = self(x)
        return self.post(logits, boxes, [(H, W)] * images.shape[0])
