"""Detection task APIs (counterpart of ``kornia_tpu/contrib/detection.py``):
ObjectDetector with its default single-level head, BoxFiltering,
FaceDetector (YuNet) with its result container, and EdgeDetector
(DexiNed).

Outputs keep the reference's static shapes: padded detection tables with
the rows that are not kept zeroed. Every top-k and sort is stable (the
lower index first among equal scores, as ``lax.top_k`` and the reference's
stable argsort); the NMS is ``geometry/bbox.py::nms``, N steps of tensor
operations with no host read. Each class takes a trailing `device` (the
card unless the caller asks for the CPU) and a ``torch.Generator`` in the
place of the JAX key; the default nets draw from one seeded with 0.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, List, Mapping, Optional, Sequence, Union

import torch
import torch.nn.functional as F

from ..core.dtype import as_float, host_tensor
from ..core.linalg import f32_matmul_precision
from ..core.sort import top_k
from ..feature._nets import Row, conv_rows, norm_rows
from ..geometry.bbox import nms as bbox_nms
from ..models.common import LazyNet, group_norm, same_conv
from ..ops.warp import resize

__all__ = ["ObjectDetector", "BoxFiltering", "FaceDetector", "FaceKeypoint",
           "FaceDetectorResult", "EdgeDetector"]

Device = Union[str, torch.device]


# -----------------------------------------------------------------------------
# Object detection
# -----------------------------------------------------------------------------

class _TinyDetHead(LazyNet):
    """Anchor-free single-level head on NCHW: three stride-2 convolutions
    ("SAME" padding, no bias) with GroupNorm(4) and ReLU, then 1x1 class
    logits and softplus (l, t, r, b) distances, both (B, C, H/8, W/8).
    Parameters under flax's names (``Conv_0.weight``, ``GroupNorm_0
    .weight``, ...)."""

    def __init__(self, num_classes: int, parent=None,
                 name: Optional[str] = None, device: Device = "cuda"):
        super().__init__()
        self.num_classes = num_classes
        self._lazy(device)

    def _rows(self, cin: int) -> List[Row]:
        rows = []
        for j, ch in enumerate((32, 64, 128)):
            rows += conv_rows(f"Conv_{j}", ch, cin, 3, (f"Conv_{j}",),
                              bias=False)
            rows += norm_rows(f"GroupNorm_{j}", ch, (f"GroupNorm_{j}",))
            cin = ch
        rows += conv_rows("Conv_3", self.num_classes, 128, 1, ("Conv_3",))
        return rows + conv_rows("Conv_4", 4, 128, 1, ("Conv_4",))

    @f32_matmul_precision
    def forward(self, x: torch.Tensor):
        self._ensure(x.shape[1])
        p = dict(self.named_parameters())
        for j in range(3):
            x = F.relu(group_norm(same_conv(x, p[f"Conv_{j}.weight"],
                                            stride=2), p, f"GroupNorm_{j}"))
        cls = F.conv2d(x, p["Conv_3.weight"], p["Conv_3.bias"])
        reg = F.softplus(F.conv2d(x, p["Conv_4.weight"], p["Conv_4.bias"]))
        return cls, reg


class BoxFiltering:
    """Confidence and class filtering of padded detections (B, N, 6) rows
    (class, score, x, y, w, h): rows that fail are zeroed."""

    def __init__(self, confidence_threshold: float = 0.3,
                 classes_to_keep: Optional[Sequence[int]] = None):
        self.confidence_threshold = confidence_threshold
        self.classes_to_keep = classes_to_keep

    def __call__(self, detections: torch.Tensor) -> torch.Tensor:
        keep = detections[..., 1] > self.confidence_threshold
        if self.classes_to_keep is not None:
            cls = detections[..., 0].to(torch.int32)
            in_set = torch.zeros_like(keep)
            for c in self.classes_to_keep:
                in_set = in_set | (cls == c)
            keep = keep & in_set
        return torch.where(keep[..., None], detections, 0.0)


class ObjectDetector:
    """Resize to ``input_size``², the head, the centre-distance decode,
    NMS per image (the first `max_detections` of the score order, the
    suppressed zeroed), then BoxFiltering: (B, max_detections, 6) rows
    (class, score, x, y, w, h) in the input's pixels. `model` maps the
    resized NCHW image to NCHW (class logits, distances) maps (the default
    ``_TinyDetHead`` draws from `generator`, or one seeded with 0, at its
    first call; `params` are its parameters, flax's names in torch's
    layout)."""

    def __init__(self, model=None, num_classes: int = 80,
                 input_size: int = 320, confidence: float = 0.3,
                 iou_threshold: float = 0.5, max_detections: int = 100,
                 params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        self.num_classes = num_classes
        self.input_size = input_size
        if model is None:
            model = _TinyDetHead(num_classes, device=device)
            model.load_params(params, generator)
        self.module = model
        self.filtering = BoxFiltering(confidence)
        self.iou_threshold = iou_threshold
        self.max_detections = max_detections

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        images = as_float(images)
        B, C, H, W = images.shape
        x = resize(images, (self.input_size, self.input_size))
        cls, reg = self.module(x)
        Hc, Wc = cls.shape[-2:]
        stride = self.input_size / Hc
        scores = torch.sigmoid(cls).permute(0, 2, 3, 1).reshape(
            B, -1, self.num_classes)
        best_score, best_cls = scores.max(-1)
        dev = images.device
        ys, xs = torch.meshgrid(torch.arange(Hc, dtype=torch.float32,
                                             device=dev),
                                torch.arange(Wc, dtype=torch.float32,
                                             device=dev), indexing="ij")
        cx = ((xs + 0.5) * stride).reshape(-1)
        cy = ((ys + 0.5) * stride).reshape(-1)
        reg = reg.permute(0, 2, 3, 1).reshape(B, -1, 4) * stride
        sx, sy = W / self.input_size, H / self.input_size
        boxes = torch.stack([(cx[None] - reg[..., 0]) * sx,
                             (cy[None] - reg[..., 1]) * sy,
                             (cx[None] + reg[..., 2]) * sx,
                             (cy[None] + reg[..., 3]) * sy], -1)
        K = min(self.max_detections, boxes.shape[1])
        out = []
        for b in range(B):
            keep = bbox_nms(boxes[b], best_score[b], self.iou_threshold,
                            max_output=K)
            valid = keep >= 0
            idx = keep.clamp_min(0)
            bx = boxes[b][idx]
            out.append(torch.stack([
                best_cls[b][idx].to(torch.float32),
                torch.where(valid, best_score[b][idx], 0.0),
                bx[:, 0], bx[:, 1], bx[:, 2] - bx[:, 0], bx[:, 3] - bx[:, 1]],
                -1))
        return self.filtering(torch.stack(out))


# -----------------------------------------------------------------------------
# Face detection
# -----------------------------------------------------------------------------

class FaceKeypoint(enum.Enum):
    """Facial keypoint ids."""

    EYE_LEFT = 0
    EYE_RIGHT = 1
    NOSE = 2
    MOUTH_LEFT = 3
    MOUTH_RIGHT = 4


@dataclasses.dataclass
class FaceDetectorResult:
    """data (..., 15): the xyxy box, five landmark (x, y) pairs, the
    score; padded rows have score 0."""

    data: torch.Tensor

    @property
    def xmin(self):
        return self.data[..., 0]

    @property
    def ymin(self):
        return self.data[..., 1]

    @property
    def xmax(self):
        return self.data[..., 2]

    @property
    def ymax(self):
        return self.data[..., 3]

    @property
    def score(self):
        return self.data[..., 14]

    @property
    def width(self):
        return self.xmax - self.xmin

    @property
    def height(self):
        return self.ymax - self.ymin

    @property
    def top_left(self):
        return self.data[..., 0:2]

    @property
    def bottom_right(self):
        return self.data[..., 2:4]

    def get_keypoint(self, keypoint) -> torch.Tensor:
        i = keypoint.value if isinstance(keypoint, FaceKeypoint) \
            else int(keypoint)
        return self.data[..., 4 + 2 * i: 6 + 2 * i]


class FaceDetector:
    """YuNet, the prior decode, sqrt(cls · iou) scores, the `top_k` best,
    NMS, and a FaceDetectorResult per image: `keep_top_k` rows, the kept
    ones first in score order, the rest zeroed. `params`: YuNet's (the
    state dict's names and layout); without them it draws from
    `generator`, or one seeded with 0."""

    def __init__(self, top_k: int = 5000, confidence_threshold: float = 0.3,
                 nms_threshold: float = 0.3, keep_top_k: Optional[int] = None,
                 params: Optional[Any] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        from ..models.yunet import YuNet
        self.confidence_threshold = confidence_threshold
        self.nms_threshold = nms_threshold
        self.top_k = top_k
        self.keep_top_k = keep_top_k if keep_top_k is not None else top_k
        self.model = YuNet(params, generator, device=device)

    def __call__(self, images: torch.Tensor) -> List[FaceDetectorResult]:
        from ..models.yunet import VARIANCE, decode, prior_boxes
        images = as_float(images)
        H, W = images.shape[-2:]
        out = self.model(images)
        priors = prior_boxes((H, W), device=images.device)
        boxes = decode(out["loc"], priors, VARIANCE)
        boxes = boxes * host_tensor([W, H] * 7, boxes.device, boxes.dtype)
        scores = torch.sqrt(out["conf"][..., 1]
                            * out["iou"][..., 0].clamp(0.0, 1.0))
        scores = torch.where(scores > self.confidence_threshold, scores, 0.0)
        return [FaceDetectorResult(self.postprocess_one(boxes[b], scores[b]))
                for b in range(scores.shape[0])]

    def postprocess_one(self, boxes: torch.Tensor,
                        scores: torch.Tensor) -> torch.Tensor:
        """One image's top-k → NMS → (keep_top_k, 15) rows, the kept ones
        first in score order."""
        K = min(self.top_k, scores.shape[0])
        keep_k = min(self.keep_top_k, K)
        s_k, idx = top_k(scores, K)
        b_k = boxes[idx]
        keep = bbox_nms(b_k[:, :4], s_k, self.nms_threshold)
        valid = keep >= 0
        order = torch.argsort((~valid).to(torch.uint8), stable=True)[:keep_k]
        sel = keep[order].clamp_min(0)
        ok = valid[order] & (s_k[sel] > 0)
        data = torch.cat([b_k[sel], s_k[sel][:, None]], -1)
        return torch.where(ok[:, None], data, 0.0)


# -----------------------------------------------------------------------------
# Edge detection
# -----------------------------------------------------------------------------

class EdgeDetector:
    """Resize to ``image_size``², subtract the ImageNet mean and scale by
    255, DexiNed, sigmoid, resize back: (B, 3, H, W) → (B, 1, H, W).
    `params`: DexiNed's (the state dict's names and layout); without them
    it draws from `generator`, or one seeded with 0."""

    _MEAN = (0.485, 0.456, 0.406)

    def __init__(self, params: Optional[Any] = None,
                 generator: Optional[torch.Generator] = None,
                 image_size: int = 352, device: Device = "cuda"):
        from ..models.dexined import DexiNed
        self.model = DexiNed(params, generator, device=device)
        self.image_size = image_size

    def __call__(self, images: torch.Tensor) -> torch.Tensor:
        images = as_float(images)
        H, W = images.shape[-2:]
        x = resize(images, (self.image_size, self.image_size), "bilinear",
                   align_corners=False)
        mean = host_tensor(self._MEAN, x.device, x.dtype).reshape(1, 3, 1, 1)
        out = torch.sigmoid(self.model((x - mean) * 255.0))
        return resize(out, (H, W), "bilinear", align_corners=False)
