"""Planar homography tracker (counterpart of
``kornia_tpu/tracking/planar_tracker.py``): GFTT corners with RootSIFT
descriptors on the target and on each frame, mutual-nearest-neighbour
matching with the ratio test, and DLT-homography RANSAC, the matches
seeded by the previous frame's homography.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..core.dtype import as_float
from ..core.linalg import f32_precision
from ..feature.integrated import GFTTSIFTFeature, LocalFeatureMatcher
from ..feature.matching import DescriptorMatcher
from ..geometry.homography import oneway_transfer_error
from ..geometry.ransac import ransac

__all__ = ["HomographyTracker"]

# matches farther than this from the previous homography's prediction
# (pixels) are dropped before RANSAC
_CHAIN_GATE_PX = 30.0


class HomographyTracker:
    """Track a planar target through a video: each frame is matched
    against the target and its target → frame homography estimated by
    RANSAC (512 samples a round, up to 8 rounds). Frames are chained
    through the last successful homography."""

    def __init__(self, num_features: int = 512, inl_th: float = 3.0,
                 min_inliers: int = 15,
                 device: Union[str, torch.device] = "cuda"):
        self.matcher = LocalFeatureMatcher(
            GFTTSIFTFeature(num_features=num_features),
            DescriptorMatcher("smnn", 0.95))
        self.inl_th = inl_th
        self.min_inliers = min_inliers
        self.device = torch.device(device)
        self.target: Optional[torch.Tensor] = None
        self.previous_homography: Optional[torch.Tensor] = None
        self._frame_idx = 0

    def set_target(self, target: torch.Tensor) -> None:
        """The (1, 1, H, W) image of the planar target."""
        self.target = as_float(torch.as_tensor(target)).to(self.device)
        self.previous_homography = None
        self._frame_idx = 0

    def match_and_estimate(self, frame: torch.Tensor,
                           generator: Optional[torch.Generator] = None, *,
                           gumbel: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (H (1, 3, 3) target → frame, success flag).

        RANSAC's sampling noise comes from `generator`, or is injected as
        `gumbel` (8, 512, num_features); with neither, from a generator
        seeded by the frame's index (the reference folds the index into
        PRNGKey(7))."""
        if self.target is None:
            raise RuntimeError("call set_target first")
        if generator is None and gumbel is None:
            generator = torch.Generator(self.device).manual_seed(
                (7 << 32) + self._frame_idx)
        self._frame_idx += 1
        with f32_precision():
            out = self.matcher({"image0": self.target,
                                "image1": as_float(torch.as_tensor(frame))
                                .to(self.device)})
            kp0 = out["keypoints0"][0]
            kp1 = out["keypoints1"][0]
            valid = out["valid"][0]
            if self.previous_homography is not None:
                err = oneway_transfer_error(kp0[None], kp1[None],
                                            self.previous_homography,
                                            False)[0]
                valid = valid & (err < _CHAIN_GATE_PX)
            res = ransac(kp0, kp1, generator, model_type="homography",
                         inl_th=self.inl_th, batch_size=512,
                         max_iterations=8, mask=valid, gumbel=gumbel)
        success = res.inlier_count >= self.min_inliers
        H = res.model[None]
        if bool(success):
            self.previous_homography = H
        return H, success

    __call__ = match_and_estimate
