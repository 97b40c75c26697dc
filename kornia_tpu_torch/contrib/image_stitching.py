"""Two-image stitching (counterpart of
``kornia_tpu/contrib/image_stitching.py``): GFTT + RootSIFT features, SMNN
matching, homography RANSAC, then the right image warped into the left
one's frame and blended onto a canvas twice as wide.

Randomness: ``estimate_homography`` and ``__call__`` take a
``torch.Generator`` in the place of the reference's key, or injected
Gumbel noise (keyword-only `gumbel`, (8, 512, num_features)); with
neither, a generator seeded with 0 stands for the reference's
``PRNGKey(0)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..core.dtype import as_float
from ..feature.integrated import GFTTSIFTFeature, LocalFeatureMatcher
from ..feature.matching import DescriptorMatcher
from ..geometry.ransac import ransac
from ..ops.warp import warp_perspective

__all__ = ["ImageStitcher"]


class ImageStitcher:
    """Stitch a (1, C, H, W) right image onto the frame of a left one:
    output (1, C, H, 2W). `blending_method` "naive" takes the warped right
    image wherever its mask covers; any other value feathers by the
    mask. The left image is kept wherever it lies."""

    def __init__(self, matcher=None, estimator: str = "ransac",
                 blending_method: str = "naive", num_features: int = 512):
        self.matcher = matcher or LocalFeatureMatcher(
            GFTTSIFTFeature(num_features=num_features),
            DescriptorMatcher("smnn", 0.95))
        self.blending_method = blending_method

    def estimate_homography(self, img_left: torch.Tensor,
                            img_right: torch.Tensor,
                            generator: Optional[torch.Generator] = None, *,
                            gumbel: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
        """(1, 3, 3) homography from right-image to left-image pixels."""
        out = self.matcher({"image0": img_right, "image1": img_left})
        if generator is None and gumbel is None:
            generator = torch.Generator(
                device=out["keypoints0"].device).manual_seed(0)
        res = ransac(out["keypoints0"][0], out["keypoints1"][0], generator,
                     "homography", inl_th=3.0, batch_size=512,
                     max_iterations=8, mask=out["valid"][0], gumbel=gumbel)
        return res.model[None]

    def blend_image(self, src: torch.Tensor, dst: torch.Tensor,
                    mask_src: torch.Tensor) -> torch.Tensor:
        if self.blending_method == "naive":
            return torch.where(mask_src > 0.5, src, dst)
        return src * mask_src + dst * (1.0 - mask_src)

    def __call__(self, img_left: torch.Tensor, img_right: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 gumbel: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Stitch `img_right` onto `img_left`'s frame, 2x wider."""
        img_left = as_float(img_left)
        img_right = as_float(img_right)
        H_img, W_img = img_left.shape[-2:]
        out_w = 2 * W_img
        H = self.estimate_homography(img_left, img_right, generator,
                                     gumbel=gumbel)
        warped = warp_perspective(img_right, H, (H_img, out_w))
        warped_mask = warp_perspective(torch.ones_like(img_right[:, :1]), H,
                                       (H_img, out_w))
        base = F.pad(img_left, (0, out_w - W_img))
        base_mask = F.pad(torch.ones_like(img_left[:, :1]), (0, out_w - W_img))
        return torch.where(base_mask > 0.5, base,
                           self.blend_image(warped, base, warped_mask))
