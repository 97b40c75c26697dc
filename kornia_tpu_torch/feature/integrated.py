"""Integrated local-feature pipelines (counterpart of
``kornia_tpu/feature/integrated.py``): detector → affine shape →
orientation → patch extraction → descriptor on padded fixed-K sets, the
SIFT, GFTT and AffNet + HardNet presets, and the two-image matcher front
end; and the KeyNet presets, whose multi-resolution detector refines its
LAFs with AffNet and OriNet before HardNet describes them."""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from ..core.dtype import as_float
from ..ops.color import rgb_to_grayscale
from ..ops.pyramid import ScalePyramid
from .affnet import LAFAffNetShapeEstimator, OriNet
from .detector import ScaleSpaceDetector
from .hardnet import HardNet
from .laf import extract_patches_from_pyramid, get_laf_center, scale_laf
from .matching import DescriptorMatcher
from .multires_detector import KeyNetDetector
from .orientation import LAFOrienter
from .responses import gftt_response, hessian_response
from .siftdesc import SIFTDescriptor

__all__ = ["LAFDescriptor", "LocalFeature", "SIFTFeature",
           "GFTTSIFTFeature", "SIFTFeatureScaleSpace", "GFTTAffNetHardNet",
           "HesAffNetHardNet", "KeyNetHardNet", "KeyNetAffNetHardNet",
           "LocalFeatureMatcher"]

Device = Union[str, torch.device]


class LAFDescriptor:
    """Extract a patch per LAF and run a patch descriptor;
    `grayscale_descriptor` converts a colour image to grey first."""

    def __init__(self, patch_descriptor=None, patch_size: int = 41,
                 grayscale_descriptor: bool = True,
                 patch_mode: Optional[str] = None):
        self.descriptor = patch_descriptor or SIFTDescriptor(patch_size)
        self.patch_size = patch_size
        self.grayscale = grayscale_descriptor
        self.patch_mode = patch_mode

    def __call__(self, img: torch.Tensor, lafs: torch.Tensor) -> torch.Tensor:
        B, N = lafs.shape[:2]
        if self.grayscale and img.shape[1] == 3:
            img = rgb_to_grayscale(img)
        patches = extract_patches_from_pyramid(img, lafs, self.patch_size,
                                               patch_mode=self.patch_mode)
        descs = self.descriptor(patches.reshape(B * N, *patches.shape[2:]))
        return descs.reshape(B, N, -1)


class LocalFeature:
    """detector → affine shape (`aff_module`) → orientation → description
    of the grey image (colour input is converted); `scale_laf_coef` scales
    the LAFs before description."""

    def __init__(self, detector, descriptor: LAFDescriptor,
                 orienter: Optional[LAFOrienter] = None,
                 aff_module=None, scale_laf_coef: float = 1.0):
        self.detector = detector
        self.descriptor = descriptor
        self.orienter = orienter
        self.aff_module = aff_module
        self.scale_laf_coef = scale_laf_coef

    def __call__(self, img: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
        """→ (lafs, responses, descriptors, valid)."""
        gray = as_float(img)
        if gray.shape[1] == 3:
            gray = rgb_to_grayscale(gray)
        lafs, resps, valid = self.detector(gray)
        if self.aff_module is not None:
            lafs = self.aff_module(lafs, gray)
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


class GFTTAffNetHardNet(LocalFeature):
    """GFTT corners over a pyramid that starts at twice the input size,
    AffNet shapes (upright), the gradient-histogram orientation (unless
    `upright`) and HardNet descriptors of 32² patches. `params` are
    HardNet's, `affnet_params` AffNet's (the reference's dicts); without
    them each net is initialised from its seeded generator."""

    def __init__(self, num_features: int = 500, upright: bool = False,
                 params: Optional[Mapping] = None,
                 affnet_params: Optional[Mapping] = None,
                 device: Device = "cuda"):
        super().__init__(*_affnet_hardnet(gftt_response, num_features,
                                          upright, params, affnet_params,
                                          device))


class HesAffNetHardNet(LocalFeature):
    """GFTTAffNetHardNet's pipeline over Hessian blobs."""

    def __init__(self, num_features: int = 500, upright: bool = False,
                 params: Optional[Mapping] = None,
                 affnet_params: Optional[Mapping] = None,
                 device: Device = "cuda"):
        super().__init__(*_affnet_hardnet(hessian_response, num_features,
                                          upright, params, affnet_params,
                                          device))


def _affnet_hardnet(resp, num_features, upright, params, affnet_params,
                    device):
    """(detector, descriptor, orienter, aff_module) of the AffNet + HardNet
    presets."""
    detector = ScaleSpaceDetector(
        num_features, resp=resp,
        scale_pyr=ScalePyramid(3, 1.6, 32, double_image=True), mr_size=6.0)
    return (detector, LAFDescriptor(HardNet(params, device), 32),
            None if upright else LAFOrienter(19),
            LAFAffNetShapeEstimator(affnet_params,
                                    preserve_orientation=False,
                                    device=device))


class KeyNetHardNet(LocalFeature):
    """The Key.Net multi-resolution detector, OriNet orientation (unless
    `upright`) and HardNet descriptors of 32² patches. Each net takes the
    reference's dict, or without it its seeded default."""

    def __init__(self, num_features: int = 2048, upright: bool = False,
                 scale_laf_coef: float = 1.0,
                 keynet_params: Optional[Mapping] = None,
                 orinet_params: Optional[Mapping] = None,
                 hardnet_params: Optional[Mapping] = None,
                 device: Device = "cuda"):
        detector = KeyNetDetector(
            keynet_params, num_features,
            ori_module=_orinet_orienter(upright, orinet_params, device),
            device=device)
        super().__init__(detector,
                         LAFDescriptor(HardNet(hardnet_params, device), 32),
                         scale_laf_coef=scale_laf_coef)


class KeyNetAffNetHardNet(LocalFeature):
    """KeyNetHardNet with AffNet's affine shapes before the orientation."""

    def __init__(self, num_features: int = 2048, upright: bool = False,
                 scale_laf_coef: float = 1.0,
                 keynet_params: Optional[Mapping] = None,
                 orinet_params: Optional[Mapping] = None,
                 affnet_params: Optional[Mapping] = None,
                 hardnet_params: Optional[Mapping] = None,
                 device: Device = "cuda"):
        detector = KeyNetDetector(
            keynet_params, num_features,
            ori_module=_orinet_orienter(upright, orinet_params, device),
            aff_module=LAFAffNetShapeEstimator(affnet_params,
                                               preserve_orientation=False,
                                               device=device),
            device=device)
        super().__init__(detector,
                         LAFDescriptor(HardNet(hardnet_params, device), 32),
                         scale_laf_coef=scale_laf_coef)


def _orinet_orienter(upright, orinet_params, device):
    return None if upright else LAFOrienter(
        angle_detector=OriNet(orinet_params, device=device))


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
