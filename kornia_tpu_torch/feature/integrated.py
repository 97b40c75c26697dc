"""Integrated local-feature pipelines (counterpart of
``kornia_tpu/feature/integrated.py``): detector → orientation → patch
extraction → descriptor on padded fixed-K sets, the SIFT and GFTT presets,
and the two-image matcher front end."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..core.check import check
from ..core.dtype import as_float
from ..ops.pyramid import ScalePyramid
from .detector import ScaleSpaceDetector
from .laf import extract_patches_from_pyramid, get_laf_center, scale_laf
from .matching import DescriptorMatcher
from .orientation import LAFOrienter
from .responses import gftt_response
from .siftdesc import SIFTDescriptor

__all__ = ["LAFDescriptor", "LocalFeature", "SIFTFeature",
           "GFTTSIFTFeature", "SIFTFeatureScaleSpace", "LocalFeatureMatcher"]


def _gray(img: torch.Tensor) -> torch.Tensor:
    check(img.shape[1] == 1,
          "only grayscale (B, 1, H, W) input is ported; colour waits for "
          "ops/color.py")
    return img


class LAFDescriptor:
    """Extract a patch per LAF and run a patch descriptor.
    `grayscale_descriptor` describes the grey image; input is grey (1
    channel) until colour conversion is ported, so both settings read the
    same patches."""

    def __init__(self, patch_descriptor=None, patch_size: int = 41,
                 grayscale_descriptor: bool = True,
                 patch_mode: Optional[str] = None):
        self.descriptor = patch_descriptor or SIFTDescriptor(patch_size)
        self.patch_size = patch_size
        self.grayscale = grayscale_descriptor
        self.patch_mode = patch_mode

    def __call__(self, img: torch.Tensor, lafs: torch.Tensor) -> torch.Tensor:
        B, N = lafs.shape[:2]
        patches = extract_patches_from_pyramid(_gray(img), lafs,
                                               self.patch_size,
                                               patch_mode=self.patch_mode)
        descs = self.descriptor(patches.reshape(B * N, *patches.shape[2:]))
        return descs.reshape(B, N, -1)


class LocalFeature:
    """detector → orientation → description; `scale_laf_coef` scales the
    LAFs before description. An affine shape module (`aff_module`) waits
    for AffNet's port."""

    def __init__(self, detector, descriptor: LAFDescriptor,
                 orienter: Optional[LAFOrienter] = None,
                 aff_module=None, scale_laf_coef: float = 1.0):
        if aff_module is not None:
            raise NotImplementedError(
                "LocalFeature(aff_module=) is not ported yet")
        self.detector = detector
        self.descriptor = descriptor
        self.orienter = orienter
        self.aff_module = aff_module
        self.scale_laf_coef = scale_laf_coef

    def __call__(self, img: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
        """→ (lafs, responses, descriptors, valid)."""
        gray = _gray(as_float(img))
        lafs, resps, valid = self.detector(gray)
        if self.orienter is not None:
            lafs = self.orienter(lafs, gray)
        if self.scale_laf_coef != 1.0:
            lafs = scale_laf(lafs, self.scale_laf_coef)
        return lafs, resps, self.descriptor(gray, lafs), valid


class SIFTFeature(LocalFeature):
    """DoG + orientation + (Root)SIFT. `double_image` starts the pyramid
    at twice the input size; ``fast_patches=True`` samples the orientation
    and descriptor patches in the TPU kernel's bf16 mode."""

    def __init__(self, num_features: int = 500, rootsift: bool = True,
                 double_image: bool = False, fast_patches: bool = False):
        detector = ScaleSpaceDetector(
            num_features, resp="dog",
            scale_pyr=ScalePyramid(3, 1.6, 32, double_image=double_image),
            nms_size=3, minima_are_also_good=True, mr_size=6.0)
        desc = SIFTDescriptor(patch_size=41, rootsift=rootsift)
        pm = "bf16" if fast_patches else None
        super().__init__(detector, LAFDescriptor(desc, 41, patch_mode=pm),
                         LAFOrienter(19, patch_mode=pm))


class GFTTSIFTFeature(LocalFeature):
    """GFTT corners + orientation + (Root)SIFT: the dense-corner front end
    of the planar tracker and of odometry."""

    def __init__(self, num_features: int = 500, rootsift: bool = True,
                 fast_patches: bool = False):
        detector = ScaleSpaceDetector(
            num_features, resp=gftt_response,
            scale_pyr=ScalePyramid(3, 1.6, 32, double_image=False),
            mr_size=6.0)
        desc = SIFTDescriptor(patch_size=41, rootsift=rootsift)
        pm = "bf16" if fast_patches else None
        super().__init__(detector, LAFDescriptor(desc, 41, patch_mode=pm),
                         LAFOrienter(19, patch_mode=pm))


class SIFTFeatureScaleSpace(LocalFeature):
    """DoG over a pyramid that starts at twice the input size, then
    (Root)SIFT; `upright` skips the orientation."""

    def __init__(self, num_features: int = 500, upright: bool = False,
                 rootsift: bool = True):
        detector = ScaleSpaceDetector(
            num_features, resp="dog",
            scale_pyr=ScalePyramid(3, 1.6, 32, double_image=True),
            nms_size=3, minima_are_also_good=True, mr_size=6.0)
        desc = SIFTDescriptor(patch_size=41, rootsift=rootsift)
        super().__init__(detector, LAFDescriptor(desc, 41),
                         None if upright else LAFOrienter(19))


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
