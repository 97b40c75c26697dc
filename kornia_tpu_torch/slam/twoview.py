"""Two-view relative pose (counterpart of ``kornia_tpu/slam/twoview.py``):
detect → describe → match → essential RANSAC → cheirality-checked (R, t).

``two_view_pose`` runs on ``cuda`` unless the caller passes
``device="cpu"``; with no CUDA device and no CPU asked for, torch raises.
The whole path runs in true float32 (TF32 off for matrix products and
cuDNN convolutions).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from ..core.linalg import f32_precision
from ..feature.integrated import LocalFeatureMatcher, SIFTFeature
from ..feature.matching import DescriptorMatcher
from ..geometry.conversions import normalize_points_with_intrinsics
from ..geometry.epipolar import motion_from_essential_choose_solution
from ..geometry.ransac import ransac

__all__ = ["TwoViewResult", "match_pair", "two_view_pose"]

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class TwoViewResult:
    R: torch.Tensor  # (3, 3) relative rotation
    t: torch.Tensor  # (3, 1) relative translation (unit scale)
    E: torch.Tensor  # (3, 3) essential matrix
    inliers: torch.Tensor  # (N,) bool over matches
    keypoints0: torch.Tensor  # (N, 2)
    keypoints1: torch.Tensor  # (N, 2)
    num_inliers: torch.Tensor


def _on(x, device: Device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def match_pair(img0: torch.Tensor, img1: torch.Tensor,
               num_features: int = 512, matcher_th: float = 0.95,
               feature: Optional[object] = None,
               device: Device = "cuda") -> Dict[str, torch.Tensor]:
    """Detect, describe and match one (1, 1, H, W) image pair."""
    feat = feature or SIFTFeature(num_features=num_features)
    matcher = LocalFeatureMatcher(feat, DescriptorMatcher("smnn", matcher_th))
    with f32_precision():
        return matcher({"image0": _on(img0, device),
                        "image1": _on(img1, device)})


def two_view_pose(img0: torch.Tensor, img1: torch.Tensor, K: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  num_features: int = 512, ransac_batch: int = 256,
                  ransac_iters: int = 32, inl_th_px: float = 1.5,
                  feature: Optional[object] = None,
                  device: Device = "cuda", *,
                  gumbel: Optional[torch.Tensor] = None) -> TwoViewResult:
    """Relative pose between two calibrated (1, 1, H, W) views.

    `generator` (a ``torch.Generator`` on `device`) draws RANSAC's Gumbel
    sampling noise; `gumbel` (ransac_iters, ransac_batch, num_features)
    injects it instead."""
    K = _on(K, device)
    out = match_pair(img0, img1, num_features, 0.95, feature, device)
    kp0 = out["keypoints0"][0]
    kp1 = out["keypoints1"][0]
    valid = out["valid"][0]
    with f32_precision():
        x0 = normalize_points_with_intrinsics(kp0, K)
        x1 = normalize_points_with_intrinsics(kp1, K)
        f = 0.5 * (K[0, 0] + K[1, 1])
        res = ransac(x0, x1, model_type="essential",
                     inl_th=float(inl_th_px / f),
                     batch_size=ransac_batch, max_iterations=ransac_iters,
                     mask=valid, generator=generator, gumbel=gumbel)
        eye = torch.eye(3, dtype=torch.float32, device=K.device)[None]
        R, t, _ = motion_from_essential_choose_solution(
            res.model[None], eye, eye, x0[None], x1[None],
            mask=res.inliers[None])
    return TwoViewResult(R=R[0], t=t[0], E=res.model, inliers=res.inliers,
                         keypoints0=kp0, keypoints1=kp1,
                         num_inliers=res.inlier_count)
