"""Multi-scale keypoint detection (counterpart of
``kornia_tpu/feature/detector.py``).

Per octave: the response over all levels at once (the DoG of adjacent
levels, or a response function such as GFTT on every level folded into the
batch), one quadratic fit over the (level, y, x) volume, 3-D NMS, and a
fixed-K top-k; then one global top-k over all octaves. Output is padded to
K with a validity mask: (lafs (B, K, 2, 3), responses (B, K), valid (B, K)).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple, Union

import torch

from ..core.dtype import as_float
from ..core.sort import top_k
from ..geometry.subpix import max_pool3d_same, nms2d, nms3d, quad_fit3d_planes
from ..ops.pyramid import ScalePyramid
from .laf import laf_from_center_scale_ori
from .responses import dog_response, gftt_response

__all__ = ["ScaleSpaceDetector", "detect_features_single_scale"]


def detect_features_single_scale(resp: torch.Tensor, num_features: int,
                                 nms_size: int = 3,
                                 minima_are_also_good: bool = False
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Single-scale detection: (B, 1, H, W) response → the top-K after NMS
    (xy (B, K, 2), response (B, K), valid (B, K))."""
    resp = as_float(resp)
    B, _, H, W = resp.shape
    r = resp.abs() if minima_are_also_good else resp
    vals, idx = top_k(nms2d(r, (nms_size, nms_size)).reshape(B, -1),
                      num_features)
    xy = torch.stack([(idx % W).to(torch.float32),
                      (idx // W).to(torch.float32)], dim=-1)
    return xy, vals, vals > 0


class ScaleSpaceDetector:
    """SIFT-style multi-scale detector. `resp` is "dog" (adjacent-level
    differences) or a response function called on every level with its
    sigma in octave pixels; GFTT by default, as in the reference."""

    def __init__(self, num_features: int = 500, mr_size: float = 6.0,
                 resp: Optional[Union[str, Callable]] = None,
                 scale_pyr: Optional[ScalePyramid] = None,
                 nms_size: int = 3, minima_are_also_good: bool = False,
                 strict_maxima_bonus: float = 10.0):
        self.num_features = num_features
        self.mr_size = mr_size
        self.resp = resp if resp is not None else gftt_response
        self.scale_pyr = scale_pyr if scale_pyr is not None else ScalePyramid(
            3, 1.6, 15, double_image=False)
        self.nms_size = nms_size
        self.minima_are_also_good = minima_are_also_good
        self.strict_maxima_bonus = strict_maxima_bonus

    def __call__(self, img: torch.Tensor, n_feats: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, 1, H, W) → (lafs (B, K, 2, 3), responses (B, K), valid)."""
        img = as_float(img)
        K_out = n_feats or self.num_features
        B = img.shape[0]
        octaves, sigmas, dists = self.scale_pyr(img)
        all_x, all_y, all_resp, all_scale = [], [], [], []
        for stack, sig, dist in zip(octaves, sigmas, dists):
            _, L, C, h, w = stack.shape
            if self.resp == "dog":
                d = dog_response(stack)  # (B, L-1, C, h, w)
                resp = torch.cat([d, d[:, -1:]], dim=1)[:, :, 0]
            else:
                # every level at once, folded into the batch, with
                # scale-normalised scores (sigma in octave pixels) so that
                # extrema stay comparable across levels
                resp = self.resp(stack.reshape(B * L, C, h, w),
                                 sigmas=(sig / dist).reshape(B * L))
                resp = resp.reshape(B, L, C, h, w)[:, :, 0]  # (B, L, h, w)
            vol = resp[:, None]  # (B, 1, L, h, w)
            # one fit serves both signs: fitting -vol negates dval only
            ox, oy, osc, dval = quad_fit3d_planes(vol)
            refined = vol + dval + self.strict_maxima_bonus * (
                vol == max_pool3d_same(vol)).to(vol.dtype)
            if self.minima_are_also_good:
                pooled_min = -max_pool3d_same(-vol)
                refined_min = -(vol + dval) + self.strict_maxima_bonus * (
                    vol == pooled_min).to(vol.dtype)
                refined = torch.where(refined_min > refined, refined_min,
                                      refined)
            nmsed = nms3d(refined, (3, 3, 3))[:, 0]  # (B, L, h, w)
            # border levels are excluded (the fit is invalid there)
            level_ok = torch.zeros(L, dtype=torch.bool, device=img.device)
            level_ok[1:L - 1] = True
            nmsed = torch.where(level_ok[None, :, None, None], nmsed,
                                -torch.inf)
            flat = nmsed.reshape(B, -1)
            vals, idx = top_k(flat, min(K_out, flat.shape[-1]))
            iz = idx // (h * w)
            iy = (idx // w) % h
            ix = idx % w
            cx = ix.to(img.dtype) + torch.gather(ox[:, 0].reshape(B, -1), 1,
                                                 idx)
            cy = iy.to(img.dtype) + torch.gather(oy[:, 0].reshape(B, -1), 1,
                                                 idx)
            cs = iz.to(img.dtype) + torch.gather(osc[:, 0].reshape(B, -1), 1,
                                                 idx)
            # sigma from the fractional level index, in original pixels
            kp_sigma = sig[:, 0:1] * torch.pow(self.scale_pyr.sigma_step, cs)
            pixel_dist = dist[:, 0:1]
            all_x.append(cx * pixel_dist)
            all_y.append(cy * pixel_dist)
            all_resp.append(torch.where(vals > -torch.inf, vals, -torch.inf))
            all_scale.append(self.mr_size * kp_sigma)
        cx_all = torch.cat(all_x, dim=1)
        cy_all = torch.cat(all_y, dim=1)
        resp_all = torch.cat(all_resp, dim=1)
        scale_all = torch.cat(all_scale, dim=1)
        k_final = min(K_out, resp_all.shape[-1])
        vals, idx = top_k(resp_all, k_final)
        xy = torch.stack([torch.gather(cx_all, 1, idx),
                          torch.gather(cy_all, 1, idx)], dim=-1)
        scale = torch.gather(scale_all, 1, idx)
        valid = vals > 0
        if k_final < K_out:  # pad to the requested K
            pad = K_out - k_final
            xy = torch.nn.functional.pad(xy, (0, 0, 0, pad))
            scale = torch.nn.functional.pad(scale, (0, pad))
            vals = torch.nn.functional.pad(vals, (0, pad))
            valid = torch.nn.functional.pad(valid, (0, pad))
        lafs = laf_from_center_scale_ori(xy, scale[..., None, None])
        return lafs, vals, valid
