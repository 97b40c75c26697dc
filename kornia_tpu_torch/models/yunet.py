"""YuNet, the face-detection network (counterpart of
``kornia_tpu/models/yunet.py``): the network, its prior boxes and the
decode of its offsets.

The weights are frozen parameters under the reference state dict's names
(``model0.conv1.weight``, ...) in torch's layout; the table
(``_param_specs``) gives the seeded draw and the loader's shape check, and
``convert.yunet_from_numpy`` carries the JAX package's HWIO dict across.
The depthwise convolutions are grouped ``F.conv2d`` calls; the max pools
are 2x2 with no padding. The priors depend only on the image size and
are computed with numpy.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtype import as_float, host_tensor
from ..core.linalg import f32_matmul_precision
from ..feature import _nets
from ..feature._nets import bn_folded, conv

__all__ = ["YuNet", "yunet_init_params", "load_torch_weights",
           "prior_boxes", "decode", "MIN_SIZES", "STEPS", "VARIANCE"]

Device = Union[str, torch.device]

MIN_SIZES: Tuple[Tuple[int, ...], ...] = ((10, 16, 24), (32, 48), (64, 96),
                                          (128, 192, 256))
STEPS: Tuple[int, ...] = (8, 16, 32, 64)
VARIANCE: Tuple[float, float] = (0.1, 0.2)

_BLOCKS = (("model1", 16, 64), ("model2", 64, 64), ("model3", 64, 64),
           ("model4", 64, 64), ("model5", 64, 64), ("model6", 64, 64))
_HEAD_ANCHORS = (3, 2, 2, 3)  # x (14 loc + 2 conf + 1 iou) channels


def _param_specs() -> Dict[str, Tuple[str, Tuple[int, ...]]]:
    specs: Dict[str, Tuple[str, Tuple[int, ...]]] = {}

    def bn(prefix, ch):
        for suffix in ("weight", "bias", "running_mean", "running_var"):
            specs[f"{prefix}.{suffix}"] = ("vec", (ch,))

    def dp_unit(prefix, cin, cout, with_bn):
        specs[f"{prefix}.conv1.weight"] = ("conv_w", (cout, cin, 1, 1))
        specs[f"{prefix}.conv1.bias"] = ("vec", (cout,))
        specs[f"{prefix}.conv2.weight"] = ("dw_w", (cout, 1, 3, 3))
        specs[f"{prefix}.conv2.bias"] = ("vec", (cout,))
        if with_bn:
            bn(f"{prefix}.bn", cout)

    def block4(prefix, cin, cout, with_bn):
        dp_unit(f"{prefix}.conv1", cin, cin, True)
        dp_unit(f"{prefix}.conv2", cin, cout, with_bn)

    specs["model0.conv1.weight"] = ("conv_w", (16, 3, 3, 3))
    specs["model0.conv1.bias"] = ("vec", (16,))
    bn("model0.bn1", 16)
    dp_unit("model0.conv2", 16, 16, True)
    for name, cin, cout in _BLOCKS:
        block4(name, cin, cout, True)
    for i, a in enumerate(_HEAD_ANCHORS):
        block4(f"head.{i}", 64, a * 17, False)
    return specs


def _rows():
    return [(k, shape, (k,), kind) for k, (kind, shape) in
            _param_specs().items()]


def yunet_init_params(generator: torch.Generator,
                      dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Seeded parameters in the state dict's layout, from a CPU
    `generator` in the table's order: Xavier-normal convolutions
    (std sqrt(2 / ((in + out)·k²)) over the torch shape's in and out, as
    the JAX package draws them), unit scales and variances, zero biases
    and means."""
    params: Dict[str, torch.Tensor] = {}
    for name, (kind, shape) in _param_specs().items():
        if kind in ("conv_w", "dw_w"):
            o, i, kh, kw = shape
            std = math.sqrt(2.0 / ((i + o) * kh * kw))
            params[name] = torch.randn(shape, generator=generator,
                                       dtype=dtype) * std
        elif name.endswith("running_var") or name.endswith(".weight"):
            params[name] = torch.ones(shape, dtype=dtype)
        else:
            params[name] = torch.zeros(shape, dtype=dtype)
    return params


def load_torch_weights(state_dict) -> Dict[str, np.ndarray]:
    """The reference ``yunet_final.pth`` state dict → YuNet's `params`
    (each shape checked)."""
    return _nets.check_params(_rows(), state_dict)


def _dp_unit(p, prefix, x, with_bn):
    x = conv(p, f"{prefix}.conv1", x)
    x = conv(p, f"{prefix}.conv2", x, 1, 1, groups=x.shape[1])
    if with_bn:
        x = F.relu(bn_folded(p, f"{prefix}.bn", x))
    return x


def _block4(p, prefix, x, with_bn):
    x = _dp_unit(p, f"{prefix}.conv1", x, True)
    return _dp_unit(p, f"{prefix}.conv2", x, with_bn)


@f32_matmul_precision
def yunet_forward(params: Mapping[str, torch.Tensor], images: torch.Tensor,
                  phase: str = "test") -> Dict[str, torch.Tensor]:
    """(B, 3, H, W) -> {'loc': (B, N, 14), 'conf': (B, N, 2), 'iou':
    (B, N, 1)}; conf is softmaxed in the 'test' phase."""
    p = params
    x = as_float(images)
    x = F.relu(bn_folded(p, "model0.bn1", conv(p, "model0.conv1", x, 2, 1)))
    x = _dp_unit(p, "model0.conv2", x, True)
    x = F.max_pool2d(x, 2, 2)
    x = _block4(p, "model1", x, True)
    x = _block4(p, "model2", x, True)
    x = F.max_pool2d(x, 2, 2)
    sources = []
    x = _block4(p, "model3", x, True)
    sources.append(x)
    for name in ("model4", "model5", "model6"):
        x = F.max_pool2d(x, 2, 2)
        x = _block4(p, name, x, True)
        sources.append(x)
    heads = []
    for i, src in enumerate(sources):
        h = _block4(p, f"head.{i}", src, False)
        heads.append(h.permute(0, 2, 3, 1).reshape(h.shape[0], -1))
    data = torch.cat(heads, 1).reshape(images.shape[0], -1, 17)
    loc, conf, iou = data[..., :14], data[..., 14:16], data[..., 16:17]
    if phase == "test":
        conf = F.softmax(conf, -1)
    return {"loc": loc, "conf": conf, "iou": iou}


class YuNet(nn.Module):
    """(B, 3, H, W) -> dict of loc/conf/iou. `params`: the state dict's
    names and layout; without it the weights come from `generator`, or
    one seeded with 0."""

    def __init__(self, params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 phase: str = "test", device: Device = "cuda"):
        super().__init__()
        if params is None:
            params = yunet_init_params(generator if generator is not None
                                       else torch.Generator().manual_seed(0))
        else:
            params = load_torch_weights(params)
        _nets._register_tree(self, params, device)
        self.phase = phase

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_parameters())

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return yunet_forward(self.params, images, self.phase)


def prior_boxes(image_size: Tuple[int, int],
                min_sizes: Sequence[Sequence[int]] = MIN_SIZES,
                steps: Sequence[int] = STEPS, clip: bool = False,
                dtype=torch.float32, device: Device = "cuda"
                ) -> torch.Tensor:
    """(N, 4) normalised (cx, cy, w, h) anchors for an image of
    `image_size` (H, W), each cell's min sizes next to each other."""
    h, w = image_size
    f = [int(int((h + 1) / 2) / 2), int(int((w + 1) / 2) / 2)]
    out = []
    for k in range(4):
        f = [int(f[0] / 2), int(f[1] / 2)]
        ii, jj = np.meshgrid(np.arange(f[0]), np.arange(f[1]),
                             indexing="ij")
        cx = (jj + 0.5) * steps[k] / w
        cy = (ii + 0.5) * steps[k] / h
        group = [np.stack([cx, cy, np.full_like(cx, m / w),
                           np.full_like(cy, m / h)], -1)[:, :, None]
                 for m in min_sizes[k]]
        out.append(np.concatenate(group, 2).reshape(-1, 4))
    res = np.concatenate(out, 0).astype(np.float32)
    if clip:
        res = np.clip(res, 0.0, 1.0)
    return host_tensor(res, device, dtype)


def decode(loc: torch.Tensor, priors: torch.Tensor,
           variances: Tuple[float, float] = VARIANCE) -> torch.Tensor:
    """(…, N, 14) offsets and (N, 4) priors -> (…, N, 14): the xyxy box
    and the five landmark (x, y) pairs."""
    c, s = priors[..., 0:2], priors[..., 2:4]
    v0, v1 = variances
    center = c + loc[..., 0:2] * v0 * s
    size = s * torch.exp(loc[..., 2:4] * v1)
    lmk = [c + loc[..., 4 + 2 * i: 6 + 2 * i] * v0 * s for i in range(5)]
    tl = center - size / 2
    return torch.cat([tl, size + tl] + lmk, -1)
