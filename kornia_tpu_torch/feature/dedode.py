"""DeDoDe, the detached detector and descriptors (counterpart of
``kornia_tpu/feature/dedode.py``): a VGG19-BN pyramid and a coarse-to-fine
walk of ConvRefiners give keypoint logits (detector L) or dense
descriptors (descriptor B; descriptor G adds frozen DINOv2 ViT-L/14 tokens
at stride 14). ``sample_keypoints`` reweights the softmax score map by a
51-tap separable Gaussian density and takes a fixed-N stable top-k.

- Between scales the logits of detector L go up by the bicubic
  ``ops/warp.py::resize``; everything else by ``jax.image.resize``'s
  bilinear rule (``ops/warp.py::_resize_antialias`` with the triangle
  kernel: at an upsampling it is the half-pixel lerp with the edge samples
  renormalised; G's 14 → 8 step is not an integer factor).
- The coverage density is ``ops/kernels.py::fused_separable_blur2d`` with a
  constant border: the port's hand-written blur kernel on the card, its
  plain version on the CPU.

The nets are ``nn.Module``s on NCHW tensors whose weights are frozen
parameters under the reference checkpoint's names (``encoder.layers.0.
weight``, ``decoder.layers.8.block1.0.weight``; G's ViT under
``dinov2.``); built without parameters, they are drawn from a CPU
generator seeded with 0. ``convert.dedode_from_numpy`` carries the JAX
variables across.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.check import check
from ..core.dtype import as_float, device_table, true_div
from ..core.grid import linspace
from ..core.linalg import f32_matmul_precision
from ..core.sort import top_k as _top_k
from ..ops import kernels as _kernels
from ..ops.warp import _resize_antialias, _triangle, grid_sample, resize
from . import _nets
from ._nets import Row, bn, bn_rows, conv, conv_rows

__all__ = ["DeDoDe", "DeDoDeDetector", "DeDoDeDescriptor",
           "DeDoDeDescriptorG", "sample_keypoints",
           "load_dedode_torch_weights", "load_dedode_detector_torch_weights",
           "load_dedode_descriptor_b_torch_weights",
           "load_dedode_descriptor_g_torch_weights"]

Device = Union[str, torch.device]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)

# vgg19_bn features[:40] conv indices per pyramid stage; the features are
# taken before each MaxPool
_VGG19_STAGES = (((0, 64), (3, 64)),
                 ((7, 128), (10, 128)),
                 ((14, 256), (17, 256), (20, 256), (23, 256)),
                 ((27, 512), (30, 512), (33, 512), (36, 512)))

# per scale (scale, hidden, ctx_out, hidden_blocks) of the reference's
# ConvRefiner walks: detector L, descriptor B and descriptor G
_DET_L_WALK = ((8, 512, 256, 8), (4, 256, 128, 8), (2, 128, 64, 8),
               (1, 64, 1, 8))
_DESC_B_WALK = ((8, 512, 256, 5), (4, 256, 128, 5), (2, 64, 32, 5),
                (1, 32, 1, 5))
_DESC_G_WALK = ((14, 768, 512, 5), (8, 512, 256, 5), (4, 256, 128, 5),
                (2, 64, 32, 5), (1, 32, 1, 5))
# the pyramid's channels at strides 1, 2, 4, 8
_VGG_CH = {1: 64, 2: 128, 4: 256, 8: 512}


def _vgg_rows(pre: str, fp: Sequence[str]) -> List[Row]:
    rows: List[Row] = []
    cin = 3
    for stage in _VGG19_STAGES:
        for idx, ch in stage:
            rows += conv_rows(f"{pre}.{idx}", ch, cin, 3, (*fp, f"conv{idx}"))
            rows += bn_rows(f"{pre}.{idx + 1}", ch, (*fp, f"bn{idx + 1}"))
            cin = ch
    return rows


def _refiner_rows(pre: str, cin: int, hidden: int, out: int, blocks: int,
                  fp: Sequence[str]) -> List[Row]:
    def block(bpre, fpath, c_in, k, groups):
        return (conv_rows(f"{bpre}.0", hidden, c_in, k, (*fpath, "conv1"),
                          groups=groups)
                + bn_rows(f"{bpre}.1", hidden, (*fpath, "bn"))
                + conv_rows(f"{bpre}.3", hidden, hidden, 1,
                            (*fpath, "conv2")))

    rows = block(f"{pre}.block1", (*fp, "block1"), cin, 1, 1)
    for i in range(blocks):
        rows += block(f"{pre}.hidden_blocks.{i}", (*fp, f"hidden{i}"),
                      hidden, 5, hidden)
    rows += conv_rows(f"{pre}.out_conv", out, hidden, 1, (*fp, "out_conv"))
    return rows


def _walk_in(walk, first: int) -> List[int]:
    """Each refiner's input channels: the first scale's features, then a
    scale's pyramid features and the previous context."""
    ins, ctx = [], None
    for scale, _h, ctx_out, _b in walk:
        feat = first if ctx is None else _VGG_CH[scale]
        ins.append(feat + (ctx or 0))
        ctx = ctx_out
    return ins


def _head_rows(walk, out: int, vgg_pre: str, first: int,
               fp: Sequence[str] = ()) -> List[Row]:
    rows = _vgg_rows(vgg_pre, (*fp, "vgg"))
    for (scale, hidden, ctx_out, blocks), cin in zip(walk,
                                                     _walk_in(walk, first)):
        rows += _refiner_rows(f"decoder.layers.{scale}", cin, hidden,
                              out + ctx_out, blocks, (*fp, f"r{scale}"))
    return rows


def _detector_rows(fp=()) -> List[Row]:
    return _head_rows(_DET_L_WALK, 1, "encoder.layers", 512, fp)


def _descriptor_b_rows(desc_dim: int = 256, fp=()) -> List[Row]:
    return _head_rows(_DESC_B_WALK, desc_dim, "encoder.layers", 512, fp)


def _descriptor_g_rows(desc_dim: int = 256, vit_dim: int = 1024,
                       fp=()) -> List[Row]:
    """G's refiners and VGG, without the ViT (a checkpoint of its own)."""
    return _head_rows(_DESC_G_WALK, desc_dim, "encoder.vgg.layers", vit_dim,
                      fp)


def load_dedode_torch_weights(state_dict, head: str = "detector"
                              ) -> Dict[str, np.ndarray]:
    """A reference DeDoDe checkpoint → the port's param dict of the head
    (the checkpoint's names, float32 arrays, each shape checked): head
    "detector" (detector L), "descriptor_b" or "descriptor_g" (its refiners
    and VGG; the DINOv2 backbone comes separately, see
    ``load_dedode_descriptor_g_torch_weights``)."""
    if head not in ("detector", "descriptor_b", "descriptor_g"):
        raise KeyError(f"unknown DeDoDe head {head!r}")
    if head == "descriptor_g":
        # the first refiner's input is the ViT's width
        vit_dim = int(np.shape(_nets._numpy(state_dict[
            "decoder.layers.14.block1.0.weight"]))[1])
        rows = _descriptor_g_rows(256, vit_dim)
    else:
        rows = (_detector_rows if head == "detector"
                else _descriptor_b_rows)()
    return _nets.check_params(rows, state_dict)


def load_dedode_detector_torch_weights(state_dict):
    """dedode_detector_L checkpoint → DeDoDeDetector's params."""
    return load_dedode_torch_weights(state_dict, "detector")


def load_dedode_descriptor_b_torch_weights(state_dict):
    """dedode_descriptor_B checkpoint → DeDoDeDescriptor's params."""
    return load_dedode_torch_weights(state_dict, "descriptor_b")


def load_dedode_descriptor_g_torch_weights(state_dict,
                                           dinov2_state_dict=None):
    """dedode_descriptor_G checkpoint (and the DINOv2 backbone's state
    dict, whose entries go under ``dinov2.``) → DeDoDeDescriptorG's
    params."""
    out = load_dedode_torch_weights(state_dict, "descriptor_g")
    if dinov2_state_dict is not None:
        from .dinov2 import load_dinov2_torch_weights
        out.update({f"dinov2.{k}": v for k, v in
                    load_dinov2_torch_weights(dinov2_state_dict).items()})
    return out


def _vgg(p: Mapping, pre: str, x: torch.Tensor) -> List[torch.Tensor]:
    """vgg19_bn features[:40]: conv-BN-ReLU chains, the features taken
    before each 2x2 max pool (strides 1, 2, 4, 8)."""
    feats = []
    for stage in _VGG19_STAGES:
        for idx, _ch in stage:
            x = F.relu(bn(p, f"{pre}.{idx + 1}",
                          conv(p, f"{pre}.{idx}", x, padding=1)))
        feats.append(x)
        x = F.max_pool2d(x, 2)
    return feats


def _refiner(p: Mapping, pre: str, x: torch.Tensor, blocks: int,
             out_logits: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ConvRefiner: block1 (1x1), depthwise 5x5 hidden
    blocks (conv → BN → ReLU → 1x1 conv), one residual (x + x0) / 1.4, a
    1x1 output split into logits and context."""
    def block(bpre, x, k):
        groups = x.shape[1] if k > 1 else 1
        x = conv(p, f"{bpre}.0", x, padding=k // 2, groups=groups)
        return conv(p, f"{bpre}.3", F.relu(bn(p, f"{bpre}.1", x)))

    x0 = block(f"{pre}.block1", x, 1)
    x = x0
    for i in range(blocks):
        x = block(f"{pre}.hidden_blocks.{i}", x, 5)
    out = conv(p, f"{pre}.out_conv", (x + x0) / 1.4)
    return out[:, :out_logits], out[:, out_logits:]


def _bilinear(t: torch.Tensor, hw) -> torch.Tensor:
    """``jax.image.resize(..., "bilinear")`` to `hw`."""
    return _resize_antialias(t, hw[0], hw[1], _triangle)


def _walk(p: Mapping, walk, firsts: List[torch.Tensor],
          feats: List[torch.Tensor], out_logits: int,
          logits_mode: str) -> torch.Tensor:
    """The coarse-to-fine walk: `firsts` the first scale's input, `feats`
    the pyramid (strides 1, 2, 4, 8); the logits of every scale summed,
    each carried up to the next scale's size with the context."""
    acc = ctx = None
    for i, (scale, _hidden, _ctx_out, blocks) in enumerate(walk):
        feat = firsts if i == 0 else feats[{8: 3, 4: 2, 2: 1, 1: 0}[scale]]
        inp = feat if ctx is None else torch.cat([feat, ctx], 1)
        logits, ctx = _refiner(p, f"decoder.layers.{scale}", inp, blocks,
                               out_logits)
        acc = logits if acc is None else acc + logits
        if i < len(walk) - 1:
            hw = feats[{8: 3, 4: 2, 2: 1, 1: 0}[walk[i + 1][0]]].shape[-2:]
            acc = (resize(acc, tuple(hw), "bicubic", align_corners=False)
                   if logits_mode == "bicubic" else _bilinear(acc, hw))
            ctx = _bilinear(ctx, hw)
    return acc


class DeDoDeDetector(nn.Module):
    """Detector L: (B, 3, H, W) normalised → keypoint logits (B, H, W).
    `parent` and `name` are flax's module-tree arguments, accepted for the
    reference's signature and unused; the weights are drawn from a
    generator seeded with 0 (``_nets.make`` builds one from a param
    dict)."""

    def __init__(self, parent=None, name: Optional[str] = None,
                 device: Device = "cuda"):
        super().__init__()
        self._setup(None, None, device)

    def _setup(self, params, generator, device):
        _nets.with_params(self, _detector_rows(), params, device, generator)

    @f32_matmul_precision
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = dict(self.named_parameters())
        feats = _vgg(p, "encoder.layers", x)
        return _walk(p, _DET_L_WALK, feats[3], feats, 1, "bicubic")[:, 0]


class DeDoDeDescriptor(nn.Module):
    """Descriptor B: (B, 3, H, W) normalised → dense descriptors
    (B, desc_dim, H, W). `parent` and `name` as DeDoDeDetector's."""

    def __init__(self, desc_dim: int = 256, parent=None,
                 name: Optional[str] = None, device: Device = "cuda"):
        super().__init__()
        self._setup(desc_dim, None, None, device)

    def _setup(self, desc_dim, params, generator, device):
        self.desc_dim = desc_dim
        _nets.with_params(self, _descriptor_b_rows(desc_dim), params, device,
                          generator)

    @f32_matmul_precision
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = dict(self.named_parameters())
        feats = _vgg(p, "encoder.layers", x)
        return _walk(p, _DESC_B_WALK, feats[3], feats, self.desc_dim,
                     "bilinear")


class DeDoDeDescriptorG(nn.Module):
    """Descriptor G: frozen DINOv2 tokens at stride 14 enter the walk over
    scales 14, 8, 4, 2, 1 (H, W multiples of 56). `vit_cfg` defaults to
    ViT-L/14 (``dinov2.VIT_LARGE_CFG``). `parent` and `name` as
    DeDoDeDetector's."""

    def __init__(self, desc_dim: int = 256, vit_cfg: Optional[dict] = None,
                 parent=None, name: Optional[str] = None,
                 device: Device = "cuda"):
        super().__init__()
        self._setup(desc_dim, vit_cfg, None, None, device)

    def _setup(self, desc_dim, vit_cfg, params, generator, device):
        from .dinov2 import VIT_LARGE_CFG, _vit
        self.desc_dim = desc_dim
        cfg = dict(VIT_LARGE_CFG, **(vit_cfg or {}))
        rows = _descriptor_g_rows(desc_dim, cfg["embed_dim"])
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        if params is None:
            params = _nets.init_params(rows, generator)
            vit_params = None
        else:
            vit_params = _nets.sub(params, "dinov2")
        _nets.with_params(self, rows, params, device)
        # drawn after the head, from the same generator
        self.dinov2 = _vit(cfg, vit_params, generator, device)

    @f32_matmul_precision
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = {k: v for k, v in self.named_parameters()
             if not k.startswith("dinov2.")}
        tokens = self.dinov2(x).detach()
        feats = _vgg(p, "encoder.vgg.layers", x)
        return _walk(p, _DESC_G_WALK, tokens, feats, self.desc_dim,
                     "bilinear")


@f32_matmul_precision
def sample_keypoints(scoremap: torch.Tensor, num_samples: int = 2048,
                     increase_coverage: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, H, W) softmax score map → ((B, N, 2) xy in [-1, 1], (B, N)
    scores): the score divided by the square root of its local density,
    (score + 1e-6) blurred by exp(-linspace(-2, 2, 51)²) in both directions
    with zero padding, then a stable top-N."""
    B, H, W = scoremap.shape
    score = scoremap
    if increase_coverage:
        w1d = torch.exp(-linspace(-2.0, 2.0, 51, scoremap.device) ** 2)
        density = _kernels.fused_separable_blur2d(
            (score + 1e-6)[:, None], w1d, w1d, "constant")[:, 0]
        score = score * torch.pow(density + 1e-8, -0.5)
    _, idx = _top_k(score.reshape(B, -1), min(num_samples, H * W))
    ys = torch.div(idx, W, rounding_mode="floor").to(scoremap.dtype)
    xs = (idx % W).to(scoremap.dtype)
    # divided as the CPU and the reference divide (a sampling coordinate)
    kps = torch.stack([true_div(xs + 0.5, W) * 2 - 1,
                       true_div(ys + 0.5, H) * 2 - 1], -1)
    return kps, torch.gather(scoremap.reshape(B, -1), 1, idx)


class DeDoDe(nn.Module):
    """Detect and describe. Call with (B, 3, H, W) in [0, 1] → ((B, N, 2)
    xy pixel keypoints, (B, N) scores, (B, N, D) descriptors); ``detect``
    and ``describe`` work on their own. `params_det` and `params_desc`: the
    heads' param dicts (the checkpoint's names, G's ViT under
    ``dinov2.``); the heads without them draw from `generator`, or one
    seeded with 0 (the reference's key): the detector first."""

    def __init__(self, desc_dim: int = 256, num_keypoints: int = 2048,
                 descriptor: str = "B",
                 params_det: Optional[Mapping] = None,
                 params_desc: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 vit_cfg: Optional[dict] = None, device: Device = "cuda"):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.descriptor_type = descriptor
        self.num_keypoints = num_keypoints
        self.detector = _nets.make(DeDoDeDetector, params_det, generator,
                                   device)
        if descriptor == "G":
            self.descriptor = _nets.make(DeDoDeDescriptorG, desc_dim,
                                         vit_cfg, params_desc, generator,
                                         device)
        else:
            self.descriptor = _nets.make(DeDoDeDescriptor, desc_dim,
                                         params_desc, generator, device)

    def _prep(self, images: torch.Tensor) -> torch.Tensor:
        B, C, H, W = images.shape
        check(C == 3, f"DeDoDe expects (B, 3, H, W) RGB input, got C={C}")
        div = 56 if self.descriptor_type == "G" else 8  # lcm(8, 14)
        check(H % div == 0 and W % div == 0,
              f"DeDoDe-{self.descriptor_type} needs H, W divisible by "
              f"{div}, got {H}x{W}")
        x = as_float(images)
        mean = device_table(self, "mean", _IMAGENET_MEAN, x.device)
        std = device_table(self, "std", _IMAGENET_STD, x.device)
        return (x - mean[:, None, None]) / std[:, None, None]

    def detect(self, images: torch.Tensor, n: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ ((B, N, 2) xy in [-1, 1], (B, N) scores)."""
        x = self._prep(images)
        B, _, H, W = x.shape
        logits = self.detector(x)
        scoremap = torch.softmax(logits.reshape(B, -1), -1).reshape(B, H, W)
        return sample_keypoints(scoremap, n or self.num_keypoints)

    def describe(self, images: torch.Tensor,
                 keypoints: Optional[torch.Tensor] = None) -> torch.Tensor:
        """keypoints (B, N, 2) xy in [-1, 1] → (B, N, D); None → the dense
        (B, D, H, W)."""
        dense = self.descriptor(self._prep(images))
        if keypoints is None:
            return dense
        sampled = grid_sample(dense, keypoints[:, :, None, :],
                              mode="bilinear", align_corners=False)
        return sampled[:, :, :, 0].transpose(1, 2)

    def forward(self, images: torch.Tensor, n: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        kps_norm, scores = self.detect(images, n)
        descs = self.describe(images, kps_norm)
        _, _, H, W = images.shape
        kps_px = torch.stack([(kps_norm[..., 0] + 1) / 2 * W,
                              (kps_norm[..., 1] + 1) / 2 * H], -1)
        return kps_px, scores, descs
