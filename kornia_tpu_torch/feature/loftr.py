"""LoFTR, the detector-free dense matcher (counterpart of
``kornia_tpu/feature/loftr.py``).

ResNet-FPN backbone (1/8 coarse and 1/2 fine maps), sine position encoding,
alternating self/cross linear-attention layers over the coarse tokens, a
dual-softmax confidence matrix, fixed-K coarse matches (threshold, border,
mutual maximum, top-K with a validity mask), and the fine refinement over
5×5 windows with a spatial expectation. Convolutions are NCHW with OIHW
weights; the coarse tokens are flattened row-major, as the reference's
NHWC reshape does. Parameters carry the published checkpoints' names
(``backbone.layer1.0.conv1.weight``, ...) as a module tree, and do not
require grad (see ``hardnet.py``). ``loftr_coarse_context_parallel`` runs
the coarse transformer with its tokens sharded over the ranks of a mesh
(``parallel/mesh.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtype import as_float
from ..core.linalg import f32_matmul_precision
from ..ops.warp import resize
from ..parallel.mesh import Mesh, NamedSharding, P
from .hardnet import _numpy, _register_tree, _running_bn

__all__ = ["LoFTR", "LoFTRConfig", "loftr_init_params", "load_torch_weights",
           "loftr_backbone", "position_encoding",
           "loftr_coarse_context_parallel"]

Device = Union[str, torch.device]
Params = Mapping[str, torch.Tensor]


class LoFTRConfig:
    """The reference's ``default_cfg``, with the variable-length outputs
    replaced by a fixed `top_k`."""

    def __init__(self, initial_dim: int = 128,
                 block_dims: Optional[Tuple[int, int, int]] = None,
                 coarse_dim: int = 256, fine_dim: int = 128,
                 num_coarse_layers: int = 4, num_fine_layers: int = 1,
                 num_heads: int = 8, fine_window: int = 5, top_k: int = 512,
                 temp_bug_fix: bool = False, thr: float = 0.2,
                 border_rm: int = 2, dsmax_temperature: float = 0.1,
                 cat_c_feat: bool = True):
        self.coarse_dim = coarse_dim
        self.fine_dim = fine_dim
        if block_dims is None:
            block_dims = (128, 196, 256) if coarse_dim == 256 else (
                fine_dim, (fine_dim + coarse_dim) // 2, coarse_dim)
        self.block_dims = block_dims
        self.initial_dim = initial_dim if coarse_dim == 256 else fine_dim
        self.num_coarse_layers = num_coarse_layers
        self.num_fine_layers = num_fine_layers
        self.num_heads = num_heads
        self.fine_window = fine_window
        self.top_k = top_k
        self.temp_bug_fix = temp_bug_fix
        self.thr = thr
        self.border_rm = border_rm
        self.dsmax_temperature = dsmax_temperature
        self.cat_c_feat = cat_c_feat


# -----------------------------------------------------------------------------
# Parameter table
# -----------------------------------------------------------------------------

def _param_specs(cfg: LoFTRConfig) -> Dict[str, Tuple[int, ...]]:
    """Every parameter's checkpoint name and torch shape (conv OIHW)."""
    specs: Dict[str, Tuple[int, ...]] = {}

    def bn(prefix: str, ch: int) -> None:
        for suffix in ("weight", "bias", "running_mean", "running_var"):
            specs[f"{prefix}.{suffix}"] = (ch,)

    bd = cfg.block_dims
    specs["backbone.conv1.weight"] = (cfg.initial_dim, 1, 7, 7)
    bn("backbone.bn1", cfg.initial_dim)
    in_planes = cfg.initial_dim
    for li, (dim, stride) in enumerate(zip(bd, (1, 2, 2)), start=1):
        for bi in range(2):
            pre = f"backbone.layer{li}.{bi}"
            cin = in_planes if bi == 0 else dim
            s = stride if bi == 0 else 1
            specs[f"{pre}.conv1.weight"] = (dim, cin, 3, 3)
            specs[f"{pre}.conv2.weight"] = (dim, dim, 3, 3)
            bn(f"{pre}.bn1", dim)
            bn(f"{pre}.bn2", dim)
            if s != 1:
                specs[f"{pre}.downsample.0.weight"] = (dim, cin, 1, 1)
                bn(f"{pre}.downsample.1", dim)
        in_planes = dim
    specs["backbone.layer3_outconv.weight"] = (bd[2], bd[2], 1, 1)
    specs["backbone.layer2_outconv.weight"] = (bd[2], bd[1], 1, 1)
    specs["backbone.layer2_outconv2.0.weight"] = (bd[2], bd[2], 3, 3)
    bn("backbone.layer2_outconv2.1", bd[2])
    specs["backbone.layer2_outconv2.3.weight"] = (bd[1], bd[2], 3, 3)
    specs["backbone.layer1_outconv.weight"] = (bd[1], bd[0], 1, 1)
    specs["backbone.layer1_outconv2.0.weight"] = (bd[1], bd[1], 3, 3)
    bn("backbone.layer1_outconv2.1", bd[1])
    specs["backbone.layer1_outconv2.3.weight"] = (bd[0], bd[1], 3, 3)

    def encoder(prefix: str, n_layers: int, d: int) -> None:
        for i in range(n_layers):
            pre = f"{prefix}.layers.{i}"
            for proj in ("q_proj", "k_proj", "v_proj", "merge"):
                specs[f"{pre}.{proj}.weight"] = (d, d)
            specs[f"{pre}.mlp.0.weight"] = (2 * d, 2 * d)
            specs[f"{pre}.mlp.2.weight"] = (d, 2 * d)
            for norm in ("norm1", "norm2"):
                specs[f"{pre}.{norm}.weight"] = (d,)
                specs[f"{pre}.{norm}.bias"] = (d,)

    encoder("loftr_coarse", 2 * cfg.num_coarse_layers, cfg.coarse_dim)
    encoder("loftr_fine", 2 * cfg.num_fine_layers, cfg.fine_dim)
    if cfg.cat_c_feat:
        specs["fine_preprocess.down_proj.weight"] = (cfg.fine_dim,
                                                     cfg.coarse_dim)
        specs["fine_preprocess.down_proj.bias"] = (cfg.fine_dim,)
        specs["fine_preprocess.merge_feat.weight"] = (cfg.fine_dim,
                                                      2 * cfg.fine_dim)
        specs["fine_preprocess.merge_feat.bias"] = (cfg.fine_dim,)
    return specs


def loftr_init_params(generator: torch.Generator,
                      cfg: Optional[LoFTRConfig] = None,
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """He-normal convs, 1/sqrt(fan_in) linears, unit BN/LN scales, zero
    biases and means, unit variances, drawn in the table's order from a CPU
    `generator` (not the reference's ``jax.random`` draws)."""
    cfg = cfg or LoFTRConfig()
    params: Dict[str, torch.Tensor] = {}
    for name, shape in _param_specs(cfg).items():
        if name.endswith("running_var"):
            params[name] = torch.ones(shape, dtype=dtype)
        elif len(shape) == 4:
            o, i, kh, kw = shape
            params[name] = torch.randn(shape, generator=generator,
                                       dtype=dtype) \
                * (2.0 / (i * kh * kw)) ** 0.5
        elif len(shape) == 2:
            params[name] = torch.randn(shape, generator=generator,
                                       dtype=dtype) * (1.0 / shape[1]) ** 0.5
        elif name.endswith(".weight"):  # BN / LN scales
            params[name] = torch.ones(shape, dtype=dtype)
        else:
            params[name] = torch.zeros(shape, dtype=dtype)
    return params


def load_torch_weights(state_dict, cfg: Optional[LoFTRConfig] = None
                       ) -> Dict[str, np.ndarray]:
    """A torch LoFTR ``state_dict`` (the published checkpoints'
    ['state_dict'], 'matcher.' prefix tolerated) → the param dict. The
    port's layout is torch's, so only the names and shapes are checked."""
    cfg = cfg or LoFTRConfig()
    sd = {(k[8:] if k.startswith("matcher.") else k): v
          for k, v in state_dict.items()}
    params: Dict[str, np.ndarray] = {}
    for k, shape in _param_specs(cfg).items():
        v = _numpy(sd[k])
        if v.shape != tuple(shape):
            raise ValueError(f"{k}: shape {v.shape}, expected {shape}")
        params[k] = v
    return params


# -----------------------------------------------------------------------------
# Backbone (NCHW)
# -----------------------------------------------------------------------------

def _conv(p: Params, name: str, x: torch.Tensor, stride: int = 1,
          pad: int = 0) -> torch.Tensor:
    return F.conv2d(x, p[f"{name}.weight"], stride=stride, padding=pad)


def _bn(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return _running_bn(x, p[f"{name}.running_mean"], p[f"{name}.running_var"],
                       p[f"{name}.weight"], p[f"{name}.bias"])


def _basic_block(p: Params, pre: str, x: torch.Tensor,
                 stride: int) -> torch.Tensor:
    y = F.relu(_bn(p, f"{pre}.bn1", _conv(p, f"{pre}.conv1", x, stride, 1)))
    y = _bn(p, f"{pre}.bn2", _conv(p, f"{pre}.conv2", y, 1, 1))
    if stride != 1:
        x = _bn(p, f"{pre}.downsample.1",
                _conv(p, f"{pre}.downsample.0", x, stride, 0))
    return F.relu(x + y)


def _up2(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear, align_corners=True, to `hw`."""
    return resize(x, hw, "bilinear", align_corners=True)


def loftr_backbone(p: Params, cfg: LoFTRConfig, images: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ResNetFPN_8_2: (B, 1, H, W) → (coarse (B, block_dims[2], H/8, W/8),
    fine (B, block_dims[0], H/2, W/2))."""
    x0 = F.relu(_bn(p, "backbone.bn1",
                    _conv(p, "backbone.conv1", as_float(images), 2, 3)))
    feats = []
    h = x0
    for li, stride in zip((1, 2, 3), (1, 2, 2)):
        h = _basic_block(p, f"backbone.layer{li}.0", h, stride)
        h = _basic_block(p, f"backbone.layer{li}.1", h, 1)
        feats.append(h)
    x1, x2, x3 = feats
    x3_out = _conv(p, "backbone.layer3_outconv", x3)
    t = _conv(p, "backbone.layer2_outconv", x2) \
        + _up2(x3_out, tuple(x2.shape[2:]))
    t = F.leaky_relu(_bn(p, "backbone.layer2_outconv2.1",
                         _conv(p, "backbone.layer2_outconv2.0", t, 1, 1)),
                     0.01)
    x2_out = _conv(p, "backbone.layer2_outconv2.3", t, 1, 1)
    t = _conv(p, "backbone.layer1_outconv", x1) \
        + _up2(x2_out, tuple(x1.shape[2:]))
    t = F.leaky_relu(_bn(p, "backbone.layer1_outconv2.1",
                         _conv(p, "backbone.layer1_outconv2.0", t, 1, 1)),
                     0.01)
    x1_out = _conv(p, "backbone.layer1_outconv2.3", t, 1, 1)
    return x3_out, x1_out


# -----------------------------------------------------------------------------
# Position encoding + transformer
# -----------------------------------------------------------------------------

def position_encoding(d_model: int, hw: Tuple[int, int], temp_bug_fix: bool,
                      dtype=torch.float32, device: Device = "cuda"
                      ) -> torch.Tensor:
    """PositionEncodingSine for exactly (H, W) → (1, d_model, H, W);
    positions are 1-indexed."""
    H, W = hw
    ar = torch.arange(0, d_model // 2, 2, dtype=dtype, device=device)
    if temp_bug_fix:
        div = torch.exp(ar * (-math.log(10000.0) / (d_model // 2)))
    else:  # the reference's floor-division variant (-1.0 for d_model 256)
        # that the published outdoor/indoor checkpoints were trained with
        div = torch.exp(ar * (-math.log(10000.0) / d_model // 2))
    y = torch.arange(1, H + 1, dtype=dtype, device=device)[None, :, None]
    x = torch.arange(1, W + 1, dtype=dtype, device=device)[None, None, :]
    div = div[:, None, None]
    pe = torch.zeros((d_model, H, W), dtype=dtype, device=device)
    pe[0::4] = torch.sin(x * div)
    pe[1::4] = torch.cos(x * div)
    pe[2::4] = torch.sin(y * div)
    pe[3::4] = torch.cos(y * div)
    return pe[None]


def _linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """elu(·)+1 linear attention over (B, L, H, D), v divided by its length
    and the result multiplied back, as the reference does."""
    Q = F.elu(q) + 1.0
    K = F.elu(k) + 1.0
    v_length = v.shape[1]
    v = v / v_length
    KV = torch.einsum("nshd,nshv->nhdv", K, v)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, K.sum(dim=1)) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * v_length


def _layer_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"],
                        p[f"{name}.bias"], eps=1e-5)


def _encoder_layer(p: Params, pre: str, x: torch.Tensor,
                   source: torch.Tensor, nhead: int,
                   attention=_linear_attention) -> torch.Tensor:
    """LoFTREncoderLayer: linear attention of x over source, merge, norm,
    then an MLP over [x, message], norm, residual."""
    B, L, C = x.shape
    d = C // nhead
    q = F.linear(x, p[f"{pre}.q_proj.weight"]).reshape(B, L, nhead, d)
    k = F.linear(source, p[f"{pre}.k_proj.weight"]).reshape(B, -1, nhead, d)
    v = F.linear(source, p[f"{pre}.v_proj.weight"]).reshape(B, -1, nhead, d)
    msg = attention(q, k, v).reshape(B, L, C)
    msg = _layer_norm(p, f"{pre}.norm1",
                      F.linear(msg, p[f"{pre}.merge.weight"]))
    msg = F.relu(F.linear(torch.cat([x, msg], -1), p[f"{pre}.mlp.0.weight"]))
    msg = F.linear(msg, p[f"{pre}.mlp.2.weight"])
    return x + _layer_norm(p, f"{pre}.norm2", msg)


def _transformer(p: Params, prefix: str, n_layers: int, nhead: int,
                 f0: torch.Tensor, f1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Alternating self and cross layers; in a cross layer f1 attends to
    the UPDATED f0, as the reference does."""
    for i in range(n_layers):
        pre = f"{prefix}.layers.{2 * i}"
        f0 = _encoder_layer(p, pre, f0, f0, nhead)
        f1 = _encoder_layer(p, pre, f1, f1, nhead)
        pre = f"{prefix}.layers.{2 * i + 1}"
        f0 = _encoder_layer(p, pre, f0, f1, nhead)
        f1 = _encoder_layer(p, pre, f1, f0, nhead)
    return f0, f1


# -----------------------------------------------------------------------------
# Coarse-attention context parallelism
# -----------------------------------------------------------------------------

def _linear_attention_dist(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mesh: Mesh, axis: str = "data",
                           eps: float = 1e-6) -> torch.Tensor:
    """Sequence-sharded elu+1 linear attention: queries, keys and values are
    this rank's token block; the only traffic is one all_reduce of the
    (B, H, D, D) KV moment packed with the (B, H, D) key sum, O(D²) bytes
    a layer instead of softmax ring attention's O(L²). The output needs no
    further collective."""
    Q = F.elu(q) + 1.0
    Kf = F.elu(k) + 1.0
    v_length = v.shape[1] * mesh.shape[axis]  # the GLOBAL source length
    v = v / v_length
    KV = torch.einsum("nshd,nshv->nhdv", Kf, v)
    Ksum = Kf.sum(dim=1)
    buf = mesh.all_reduce(torch.cat([KV.reshape(-1), Ksum.reshape(-1)]),
                          axis)
    KV = buf[:KV.numel()].view(KV.shape)
    Ksum = buf[KV.numel():].view(Ksum.shape)
    Z = 1.0 / (torch.einsum("nlhd,nhd->nlh", Q, Ksum) + eps)
    return torch.einsum("nlhd,nhdv,nlh->nlhv", Q, KV, Z) * v_length


def _encoder_layer_dist(p: Params, pre: str, x: torch.Tensor,
                        source: torch.Tensor, nhead: int, mesh: Mesh,
                        axis: str = "data") -> torch.Tensor:
    """``_encoder_layer`` on token blocks, its attention summed over
    `axis`."""
    return _encoder_layer(
        p, pre, x, source, nhead,
        lambda q, k, v: _linear_attention_dist(q, k, v, mesh, axis))


@f32_matmul_precision
def loftr_coarse_context_parallel(params: Params, cfg: LoFTRConfig,
                                  feat0: torch.Tensor, feat1: torch.Tensor,
                                  mesh: Mesh, axis: str = "data"
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The coarse LocalFeatureTransformer with BOTH token sequences sharded
    over ``mesh[axis]`` (sequence / context parallelism).

    feat0/feat1: global (B, L, C) coarse tokens (position encoding added),
    L divisible by the axis size; each rank takes its token block and the
    transformed (B, L, C) tokens come back on every rank, gathered once at
    the end. Layer for layer the math of ``_transformer``, with one
    all_reduce per attention."""
    sh = NamedSharding(mesh, P(None, axis, None))
    f0, f1 = sh.local(feat0), sh.local(feat1)
    nhead = cfg.num_heads
    for i in range(cfg.num_coarse_layers):
        pre = f"loftr_coarse.layers.{2 * i}"
        f0 = _encoder_layer_dist(params, pre, f0, f0, nhead, mesh, axis)
        f1 = _encoder_layer_dist(params, pre, f1, f1, nhead, mesh, axis)
        pre = f"loftr_coarse.layers.{2 * i + 1}"
        f0 = _encoder_layer_dist(params, pre, f0, f1, nhead, mesh, axis)
        f1 = _encoder_layer_dist(params, pre, f1, f0, nhead, mesh, axis)
    return mesh.all_gather(f0, axis, 1), mesh.all_gather(f1, axis, 1)


# -----------------------------------------------------------------------------
# Matching
# -----------------------------------------------------------------------------

def _inner(h: int, w: int, b: int, device) -> torch.Tensor:
    """(h·w,) bool: row-major cells at least b from every edge."""
    ys = torch.arange(h, device=device)
    xs = torch.arange(w, device=device)
    return (((ys >= b) & (ys < h - b))[:, None]
            & ((xs >= b) & (xs < w - b))[None, :]).reshape(-1)


def _coarse_match(cfg: LoFTRConfig, conf: torch.Tensor,
                  hw0: Tuple[int, int], hw1: Tuple[int, int], K: int):
    """Dual-softmax confidences (B, L, S) → fixed-K matches: threshold,
    border removal, mutual maximum (exact float equality), then the top K
    by confidence with a validity mask. → (i_ids, j_ids, scores, valid),
    each (B, K)."""
    mask = conf > cfg.thr
    b = cfg.border_rm
    if b > 0:
        mask = mask & (_inner(*hw0, b, conf.device)[:, None]
                       & _inner(*hw1, b, conf.device)[None, :])[None]
    mask = mask & (conf == conf.amax(2, keepdim=True)) \
        & (conf == conf.amax(1, keepdim=True))
    masked = torch.where(mask, conf, 0.0)
    j_ids = torch.argmax(masked, dim=2)  # (B, L), first maximum
    mconf = torch.gather(masked, 2, j_ids[..., None])[..., 0]
    scores, i_ids = torch.topk(mconf, K, dim=1)
    j_sel = torch.gather(j_ids, 1, i_ids)
    return i_ids, j_sel, scores, scores > 0


def _gather_windows(feat: torch.Tensor, ids: torch.Tensor, w_c: int, W: int,
                    stride: int) -> torch.Tensor:
    """``F.unfold(kernel=W, stride=stride, padding=W//2)`` at the selected
    coarse cells only: (B, C, Hf, Wf) + (B, K) → (B, K, W², C), each window
    row-major."""
    B, C, Hf, Wf = feat.shape
    r = W // 2
    fp = F.pad(feat, (r, r, r, r)).reshape(B, C, -1)
    cy = torch.div(ids, w_c, rounding_mode="floor") * stride  # padded top-left
    cx = (ids % w_c) * stride
    off = torch.arange(W, device=feat.device)
    yy = cy[..., None] + off.repeat_interleave(W)[None, None]  # (B, K, W²)
    xx = cx[..., None] + off.repeat(W)[None, None]
    idx = (yy * (Wf + 2 * r) + xx).reshape(B, 1, -1).expand(B, C, -1)
    out = torch.gather(fp, 2, idx)  # (B, C, K·W²)
    return out.reshape(B, C, ids.shape[1], W * W).permute(0, 2, 3, 1)


def _spatial_expectation(heat: torch.Tensor) -> torch.Tensor:
    """spatial_expectation2d(..., normalized=True) over (M, H, W) → (M, 2)
    (x, y) in [-1, 1]."""
    M, H, W = heat.shape
    xs = torch.linspace(-1.0, 1.0, W, dtype=heat.dtype, device=heat.device)
    ys = torch.linspace(-1.0, 1.0, H, dtype=heat.dtype, device=heat.device)
    ex = torch.sum(heat * xs[None, None, :], dim=(-2, -1))
    ey = torch.sum(heat * ys[None, :, None], dim=(-2, -1))
    return torch.stack([ex, ey], -1)


# -----------------------------------------------------------------------------
# Full model
# -----------------------------------------------------------------------------

class LoFTR(nn.Module):
    """The matcher: {"image0", "image1"} (grey (B, 1, H, W), H and W
    divisible by 8) → fixed-K padded correspondences, confidence and
    validity. Without `params` the weights come from `generator`, or one
    seeded with 0 (the reference's key). Runs in true float32 (TF32 off)."""

    def __init__(self, cfg: Optional[LoFTRConfig] = None,
                 params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        super().__init__()
        self.cfg = cfg or LoFTRConfig()
        if params is None:
            params = loftr_init_params(
                generator if generator is not None
                else torch.Generator().manual_seed(0), self.cfg)
        missing = set(_param_specs(self.cfg)) - set(params)
        if missing:
            raise ValueError(
                f"LoFTR parameters missing: {sorted(missing)[:4]}")
        _register_tree(self, params, device)

    @classmethod
    def from_torch(cls, state_dict, cfg: Optional[LoFTRConfig] = None,
                   device: Device = "cuda") -> "LoFTR":
        cfg = cfg or LoFTRConfig()
        return cls(cfg, params=load_torch_weights(state_dict, cfg),
                   device=device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Checkpoint name → parameter."""
        return dict(self.named_parameters())

    @f32_matmul_precision
    def coarse_stage(self, img0: torch.Tensor, img1: torch.Tensor) -> Dict:
        """Backbone maps, transformed coarse tokens and the confidence
        matrix of one batch of pairs."""
        cfg, p = self.cfg, self.params
        c0, f0 = loftr_backbone(p, cfg, img0)
        c1, f1 = loftr_backbone(p, cfg, img1)
        B, C = c0.shape[:2]
        hw0, hw1 = tuple(c0.shape[2:]), tuple(c1.shape[2:])
        t0 = (c0 + position_encoding(C, hw0, cfg.temp_bug_fix, c0.dtype,
                                     c0.device)).reshape(B, C, -1)
        t1 = (c1 + position_encoding(C, hw1, cfg.temp_bug_fix, c1.dtype,
                                     c1.device)).reshape(B, C, -1)
        t0, t1 = _transformer(p, "loftr_coarse", cfg.num_coarse_layers,
                              cfg.num_heads, t0.transpose(1, 2),
                              t1.transpose(1, 2))
        scale_c = cfg.coarse_dim ** 0.5
        sim = torch.einsum("nlc,nsc->nls", t0 / scale_c, t1 / scale_c) \
            / cfg.dsmax_temperature
        conf = F.softmax(sim, 1) * F.softmax(sim, 2)
        return dict(c0=c0, f0=f0, c1=c1, f1=f1, t0=t0, t1=t1, conf=conf,
                    hw0=hw0, hw1=hw1, image_hw=tuple(img0.shape[-2:]))

    @f32_matmul_precision
    def fine_stage(self, st: Dict, i_ids: torch.Tensor, j_ids: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Keypoints of the coarse matches (i_ids, j_ids) (B, K): cell
        centres in image 0, refined positions in image 1."""
        cfg, p = self.cfg, self.params
        f0, f1, t0, t1 = st["f0"], st["f1"], st["t0"], st["t1"]
        (h0c, w0c), (_, w1c) = st["hw0"], st["hw1"]
        B, K = i_ids.shape
        scale = st["image_hw"][0] // h0c  # 8
        mk0 = torch.stack([i_ids % w0c, torch.div(i_ids, w0c,
                                                  rounding_mode="floor")],
                          -1).to(f0.dtype) * scale
        mk1 = torch.stack([j_ids % w1c, torch.div(j_ids, w1c,
                                                  rounding_mode="floor")],
                          -1).to(f0.dtype) * scale
        W = cfg.fine_window
        stride = f0.shape[2] // h0c  # 4
        u0 = _gather_windows(f0, i_ids, w0c, W, stride)  # (B, K, W², Cf)
        u1 = _gather_windows(f1, j_ids, w1c, W, stride)
        if cfg.cat_c_feat:
            def merge(u, t, ids):
                sel = torch.gather(t, 1, ids[..., None].expand(
                    -1, -1, t.shape[-1]))
                cw = F.linear(sel, p["fine_preprocess.down_proj.weight"],
                              p["fine_preprocess.down_proj.bias"])
                return F.linear(torch.cat([u, cw[:, :, None].expand_as(u)],
                                          -1),
                                p["fine_preprocess.merge_feat.weight"],
                                p["fine_preprocess.merge_feat.bias"])
            u0, u1 = merge(u0, t0, i_ids), merge(u1, t1, j_ids)
        uf0, uf1 = _transformer(p, "loftr_fine", cfg.num_fine_layers,
                                cfg.num_heads,
                                u0.reshape(B * K, W * W, cfg.fine_dim),
                                u1.reshape(B * K, W * W, cfg.fine_dim))
        picked = uf0[:, (W * W) // 2]
        simf = torch.einsum("mc,mrc->mr", picked, uf1) / cfg.fine_dim ** 0.5
        heat = F.softmax(simf, -1).reshape(-1, W, W)
        coords = _spatial_expectation(heat).reshape(B, K, 2)
        scale_f = st["image_hw"][0] // f0.shape[2]  # 2
        return mk0, mk1 + coords * (W // 2) * scale_f

    def forward(self, data: Mapping[str, torch.Tensor]
                ) -> Dict[str, torch.Tensor]:
        img0, img1 = as_float(data["image0"]), as_float(data["image1"])
        st = self.coarse_stage(img0, img1)
        i_ids, j_ids, mconf, valid = _coarse_match(
            self.cfg, st["conf"], st["hw0"], st["hw1"], self.cfg.top_k)
        mk0, mk1 = self.fine_stage(st, i_ids, j_ids)
        B, K = i_ids.shape
        return {"keypoints0": mk0, "keypoints1": mk1, "confidence": mconf,
                "valid": valid,
                "batch_indexes": torch.arange(B, device=mk0.device)
                .repeat_interleave(K).reshape(B, K)}
