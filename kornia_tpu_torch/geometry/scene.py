"""Synthetic epipolar scene (counterpart of
``kornia_tpu/geometry/scene.py``): a random camera ring looking at a point
cloud, the fixture of the two-view and SfM tests and benchmarks.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Union

import torch

from .conversions import axis_angle_to_rotation_matrix
from .epipolar import (essential_from_Rt, fundamental_from_essential,
                       projection_from_KRt)

__all__ = ["generate_scene"]


def generate_scene(generator: Optional[torch.Generator] = None,
                   num_views: int = 2, num_points: int = 30,
                   image_size=(120.0, 160.0), rotation_scale: float = 0.2,
                   translation_scale: float = 0.5,
                   device: Union[str, torch.device] = "cuda", *,
                   draws: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Dict[str, torch.Tensor]:
    """Random cameras (camera 0 at the origin) looking at N points.

    The three standard-normal draws come from `generator`, or are injected
    as `draws` = {"aa": (V, 3), "t": (V, 3, 1), "X": (N, 3)} (the
    reference's ``jax.random.normal`` draws, before scaling). Returns K
    (V, 3, 3), R (V, 3, 3), t (V, 3, 1), P (V, 3, 4), points3d (N, 3),
    points2d (V, N, 2), and E_01 / F_01 between views 0 and 1."""
    V, N = num_views, num_points
    h, w = image_size
    if draws is None:
        draws = {k: torch.randn(shape, generator=generator, device=device)
                 for k, shape in (("aa", (V, 3)), ("t", (V, 3, 1)),
                                  ("X", (N, 3)))}
    draws = {k: v.to(device=device, dtype=torch.float32)
             for k, v in draws.items()}
    f = 0.8 * max(h, w)
    K = torch.tensor([[f, 0.0, w / 2], [0.0, f, h / 2], [0.0, 0.0, 1.0]],
                     device=device).expand(V, 3, 3)
    R = axis_angle_to_rotation_matrix(draws["aa"] * rotation_scale)
    R = torch.cat([torch.eye(3, device=device)[None], R[1:]])
    t = draws["t"] * translation_scale
    t = torch.cat([torch.zeros_like(t[:1]), t[1:]])
    X = draws["X"] * 1.5 + torch.tensor([0.0, 0.0, 6.0], device=device)
    P = projection_from_KRt(K, R, t)
    Xh = torch.cat([X, torch.ones_like(X[:, :1])], -1)
    x_h = torch.einsum("vij,nj->vni", P, Xh)
    E01 = essential_from_Rt(R[0], t[0], R[1], t[1])
    return {"K": K, "R": R, "t": t, "P": P, "points3d": X,
            "points2d": x_h[..., :2] / x_h[..., 2:], "E_01": E01,
            "F_01": fundamental_from_essential(E01, K[0], K[1])}
