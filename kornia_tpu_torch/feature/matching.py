"""Descriptor matching (counterpart of ``kornia_tpu/feature/matching.py``
and of the streaming matchers of ``kornia_tpu/ops/pallas_kernels.py``).

Matchers work on fixed-size descriptor sets with validity masks and return
(distances (N, 1), matches (N, 2), valid (N,)). The dense matchers compute
the distance matrix as one matrix product, as the reference does outside
any Pallas kernel. The streaming matchers (`match_nn_streaming`,
`match_smnn_streaming`, and ``DescriptorMatcher(..., streaming=True)`` for
unmasked "nn" and "smnn") go through the ``streaming_min2`` kernel, which
never stores the (N, M) matrix: the choice for large sets (N ≥ ~4k, as in
SfM's exhaustive matching).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.dtype import as_float
from ..ops.kernels import streaming_min2
from .laf import get_laf_center

__all__ = [
    "distance_matrix",
    "match_nn",
    "match_mnn",
    "match_snn",
    "match_smnn",
    "match_fginn",
    "match_nn_streaming",
    "match_smnn_streaming",
    "DescriptorMatcher",
]

_BIG = 1e9
_MODES = ("nn", "mnn", "snn", "smnn")
_STREAMING_MODES = ("nn", "smnn")


def distance_matrix(desc1: torch.Tensor, desc2: torch.Tensor,
                    mask1: Optional[torch.Tensor] = None,
                    mask2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Squared L2 distances (N, M) by the matmul identity; padded entries
    get _BIG."""
    desc1 = as_float(desc1)
    desc2 = as_float(desc2)
    n1 = (desc1 * desc1).sum(-1, keepdim=True)
    n2 = (desc2 * desc2).sum(-1, keepdim=True)
    dm = n1 + n2.transpose(-1, -2) - 2.0 * (desc1 @ desc2.transpose(-1, -2))
    dm = dm.clamp_min(0.0)
    if mask1 is not None:
        dm = torch.where(mask1[..., :, None], dm, _BIG)
    if mask2 is not None:
        dm = torch.where(mask2[..., None, :], dm, _BIG)
    return dm


def _two_smallest(dm: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per row: smallest value, its index (first among ties) and the second
    smallest — ``top_k(-dm, 2)`` of the reference."""
    v1, i1 = dm.min(dim=-1)
    v2 = dm.scatter(-1, i1[..., None], torch.inf).min(dim=-1).values
    return v1, i1, v2


def _ratio(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(d1.clamp_min(0.0) / d2.clamp_min(1e-12))


def _pack(dists: torch.Tensor, idx2: torch.Tensor, valid: torch.Tensor,
          mask1: Optional[torch.Tensor] = None):
    """kornia-style (dists (N, 1), matches (N, 2), valid (N,))."""
    rows = torch.arange(dists.shape[-1], device=dists.device)
    if mask1 is not None:
        valid = valid & mask1
    return dists[..., None], torch.stack([rows, idx2], dim=-1), valid


def match_nn(desc1: torch.Tensor, desc2: torch.Tensor,
             mask1: Optional[torch.Tensor] = None,
             mask2: Optional[torch.Tensor] = None):
    """Nearest neighbour."""
    dm = distance_matrix(desc1, desc2, mask1, mask2)
    dists, idx2 = dm.min(dim=-1)
    return _pack(dists, idx2, dists < _BIG / 2, mask1)


def match_mnn(desc1: torch.Tensor, desc2: torch.Tensor,
              mask1: Optional[torch.Tensor] = None,
              mask2: Optional[torch.Tensor] = None):
    """Mutual nearest neighbour."""
    dm = distance_matrix(desc1, desc2, mask1, mask2)
    dists, idx12 = dm.min(dim=-1)
    idx21 = dm.argmin(dim=-2)
    rows = torch.arange(dm.shape[-2], device=dm.device)
    valid = (idx21[idx12] == rows) & (dists < _BIG / 2)
    return _pack(dists, idx12, valid, mask1)


def match_snn(desc1: torch.Tensor, desc2: torch.Tensor, th: float = 0.8,
              mask1: Optional[torch.Tensor] = None,
              mask2: Optional[torch.Tensor] = None):
    """Lowe's ratio test."""
    dm = distance_matrix(desc1, desc2, mask1, mask2)
    d1, idx, d2 = _two_smallest(dm)
    ratio = _ratio(d1, d2)
    return _pack(ratio, idx, (ratio <= th) & (d1 < _BIG / 2), mask1)


def match_smnn(desc1: torch.Tensor, desc2: torch.Tensor, th: float = 0.95,
               mask1: Optional[torch.Tensor] = None,
               mask2: Optional[torch.Tensor] = None):
    """Symmetric ratio test + mutual nearest neighbour, (N, D) x (M, D)."""
    dm = distance_matrix(desc1, desc2, mask1, mask2)
    f1, idx12, f2 = _two_smallest(dm)
    ratio_f = _ratio(f1, f2)
    b1, idx21, b2 = _two_smallest(dm.transpose(-1, -2))
    ratio_b = _ratio(b1, b2)
    rows = torch.arange(dm.shape[-2], device=dm.device)
    mutual = idx21[idx12] == rows
    ratio_max = torch.maximum(ratio_f, ratio_b[idx12])
    valid = mutual & (ratio_f <= th) & (ratio_b[idx12] <= th) & (f1 < _BIG / 2)
    return _pack(ratio_max, idx12, valid, mask1)


def match_fginn(desc1: torch.Tensor, desc2: torch.Tensor,
                lafs1: torch.Tensor, lafs2: torch.Tensor,
                th: float = 0.8, spatial_th: float = 10.0,
                mutual: bool = False,
                mask1: Optional[torch.Tensor] = None,
                mask2: Optional[torch.Tensor] = None):
    """First geometrically inconsistent nearest-neighbour ratio: the second
    neighbour of the ratio is the best match at least `spatial_th` pixels
    from the first (lafs2 (1, M, 2, 3))."""
    dm = distance_matrix(desc1, desc2, mask1, mask2)
    d_best, idx1_best = dm.min(dim=-1)
    xy2 = get_laf_center(lafs2)
    if xy2.ndim == 3:
        xy2 = xy2[0]
    best_xy = xy2[idx1_best]  # (N, 2)
    spatial_d = torch.linalg.vector_norm(
        xy2[None, :, :] - best_xy[:, None, :], dim=-1)
    dm_far = torch.where(spatial_d >= spatial_th, dm, _BIG)
    ratio = _ratio(d_best, dm_far.min(dim=-1).values)
    valid = (ratio <= th) & (d_best < _BIG / 2)
    if mutual:
        idx21 = dm.argmin(dim=-2)
        rows = torch.arange(dm.shape[-2], device=dm.device)
        valid = valid & (idx21[idx1_best] == rows)
    return _pack(ratio, idx1_best, valid, mask1)


def match_nn_streaming(desc1: torch.Tensor, desc2: torch.Tensor):
    """Nearest neighbour through the streaming kernel (``match_nn_pallas``;
    `valid` as `match_nn` without masks)."""
    m1, _, idx = streaming_min2(as_float(desc1), as_float(desc2))
    return _pack(m1, idx, m1 < _BIG / 2)


def match_smnn_streaming(desc1: torch.Tensor, desc2: torch.Tensor,
                         th: float = 0.95):
    """Symmetric ratio test + mutual nearest neighbour with both passes
    through the streaming kernel (``match_smnn_pallas``): no (N, M) matrix
    is ever stored."""
    desc1 = as_float(desc1)
    desc2 = as_float(desc2)
    f1, f2, f_idx = streaming_min2(desc1, desc2)
    b1, b2, b_idx = streaming_min2(desc2, desc1)
    ratio_f = _ratio(f1, f2)
    ratio_b = _ratio(b1, b2)[f_idx]
    rows = torch.arange(desc1.shape[0], device=desc1.device)
    mutual = b_idx[f_idx] == rows
    valid = mutual & (ratio_f <= th) & (ratio_b <= th) & (f1 < _BIG / 2)
    return _pack(torch.maximum(ratio_f, ratio_b), f_idx, valid)


class DescriptorMatcher:
    """Descriptor matcher in mode "nn", "mnn", "snn" or "smnn". With
    ``streaming=True`` (the reference's ``use_pallas=True``) unmasked "nn"
    and "smnn" matching goes through the streaming kernel; masked calls and
    the other modes use the dense distance matrix."""

    def __init__(self, match_mode: str = "snn", th: float = 0.8,
                 streaming: bool = False):
        if match_mode not in _MODES:
            raise ValueError(f"unknown match mode {match_mode!r}")
        self.match_mode = match_mode
        self.th = th
        self.streaming = streaming

    def __call__(self, desc1: torch.Tensor, desc2: torch.Tensor,
                 mask1: Optional[torch.Tensor] = None,
                 mask2: Optional[torch.Tensor] = None):
        mode = self.match_mode
        if (self.streaming and mode in _STREAMING_MODES and mask1 is None
                and mask2 is None):
            if mode == "nn":
                return match_nn_streaming(desc1, desc2)
            return match_smnn_streaming(desc1, desc2, self.th)
        if mode == "nn":
            return match_nn(desc1, desc2, mask1, mask2)
        if mode == "mnn":
            return match_mnn(desc1, desc2, mask1, mask2)
        if mode == "snn":
            return match_snn(desc1, desc2, self.th, mask1, mask2)
        return match_smnn(desc1, desc2, self.th, mask1, mask2)
