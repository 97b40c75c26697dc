"""Integrated local-feature pipelines (counterpart of
``kornia_tpu/feature/integrated.py``, the part the two-view path reaches):
detector → orientation → patch extraction → descriptor on padded fixed-K
sets, and the two-image matcher front end."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.check import check
from ..core.dtype import as_float
from ..ops.pyramid import ScalePyramid
from .detector import ScaleSpaceDetector
from .laf import extract_patches_from_pyramid, get_laf_center
from .matching import DescriptorMatcher
from .orientation import LAFOrienter
from .siftdesc import SIFTDescriptor

__all__ = ["LAFDescriptor", "LocalFeature", "SIFTFeature",
           "LocalFeatureMatcher"]


def _gray(img: torch.Tensor) -> torch.Tensor:
    check(img.shape[1] == 1,
          "only grayscale (B, 1, H, W) input is ported; colour waits for "
          "ops/color.py")
    return img


class LAFDescriptor:
    """Extract a patch per LAF and run a patch descriptor."""

    def __init__(self, patch_descriptor=None, patch_size: int = 41,
                 patch_mode: Optional[str] = None):
        self.descriptor = patch_descriptor or SIFTDescriptor(patch_size)
        self.patch_size = patch_size
        self.patch_mode = patch_mode

    def __call__(self, img: torch.Tensor, lafs: torch.Tensor) -> torch.Tensor:
        B, N = lafs.shape[:2]
        patches = extract_patches_from_pyramid(_gray(img), lafs,
                                               self.patch_size,
                                               self.patch_mode)
        descs = self.descriptor(patches.reshape(B * N, *patches.shape[2:]))
        return descs.reshape(B, N, -1)


class LocalFeature:
    """detector → orientation → description."""

    def __init__(self, detector, descriptor: LAFDescriptor,
                 orienter: Optional[LAFOrienter] = None):
        self.detector = detector
        self.descriptor = descriptor
        self.orienter = orienter

    def __call__(self, img: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
        """→ (lafs, responses, descriptors, valid)."""
        gray = _gray(as_float(img))
        lafs, resps, valid = self.detector(gray)
        if self.orienter is not None:
            lafs = self.orienter(lafs, gray)
        return lafs, resps, self.descriptor(gray, lafs), valid


class SIFTFeature(LocalFeature):
    """DoG + orientation + (Root)SIFT. ``fast_patches=True`` samples the
    orientation and descriptor patches in the TPU kernel's bf16 mode."""

    def __init__(self, num_features: int = 500, rootsift: bool = True,
                 fast_patches: bool = False):
        detector = ScaleSpaceDetector(
            num_features, scale_pyr=ScalePyramid(3, 1.6, 32),
            minima_are_also_good=True, mr_size=6.0)
        desc = SIFTDescriptor(patch_size=41, rootsift=rootsift)
        pm = "bf16" if fast_patches else None
        super().__init__(detector, LAFDescriptor(desc, 41, patch_mode=pm),
                         LAFOrienter(19, patch_mode=pm))


class LocalFeatureMatcher:
    """Two-view front end: features of both images, then matching."""

    def __init__(self, local_feature: LocalFeature,
                 matcher: DescriptorMatcher):
        self.local_feature = local_feature
        self.matcher = matcher

    def __call__(self, data: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        img0 = data["image0"]
        img1 = data["image1"]
        lafs0, _, d0, v0 = self.local_feature(img0)
        lafs1, _, d1, v1 = self.local_feature(img1)
        B = img0.shape[0]
        per_b = [self.matcher(d0[b], d1[b], v0[b], v1[b]) for b in range(B)]
        dists = torch.stack([p[0] for p in per_b])
        idx = torch.stack([p[1] for p in per_b])
        valid = torch.stack([p[2] for p in per_b])
        kp0 = get_laf_center(lafs0)
        kp1 = torch.gather(get_laf_center(lafs1), 1,
                           idx[..., 1:2].expand(-1, -1, 2))
        return {
            "keypoints0": kp0,
            "keypoints1": kp1,
            "lafs0": lafs0,
            "lafs1": lafs1,
            "descriptors0": d0,
            "descriptors1": d1,
            "confidence": 1.0 - dists[..., 0].clamp(0.0, 1.0),
            "batch_indexes": torch.arange(B, device=idx.device)
            .repeat_interleave(idx.shape[1]),
            "matches": idx,
            "valid": valid,
        }
