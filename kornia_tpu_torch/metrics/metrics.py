"""Trajectory metrics (counterpart of the ATE/RPE part of
``kornia_tpu/metrics/metrics.py``)."""

from __future__ import annotations

from typing import Tuple

import torch

from ..core.dtype import as_float
from ..geometry.linalg import relative_transformation

__all__ = ["ate_rmse", "rpe"]


def _umeyama_alignment(src: torch.Tensor, dst: torch.Tensor,
                       with_scale: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Closed-form similarity (s, R, t) aligning src to dst ((N, 3) each)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    sc = src - mu_s
    dc = dst - mu_d
    cov = dc.T @ sc / src.shape[0]
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    R = (U * diag) @ Vt
    if with_scale:
        var_s = (sc * sc).sum(-1).mean()
        s = (S * diag).sum() / var_s.clamp_min(1e-12)
    else:
        s = torch.ones((), dtype=src.dtype, device=src.device)
    return s, R, mu_d - (s * R) @ mu_s


def ate_rmse(traj_est: torch.Tensor, traj_gt: torch.Tensor,
             align: bool = True, with_scale: bool = False) -> torch.Tensor:
    """Absolute trajectory error RMSE of (N, 3) positions after an SE(3)
    (or, with_scale, Sim(3)) alignment: the TUM-RGBD / ETH3D metric."""
    traj_est = as_float(traj_est)
    traj_gt = as_float(traj_gt)
    if align:
        s, R, t = _umeyama_alignment(traj_est, traj_gt, with_scale)
        traj_est = s * traj_est @ R.T + t
    err = torch.linalg.vector_norm(traj_est - traj_gt, dim=-1)
    return torch.sqrt((err * err).mean())


def rpe(poses_est: torch.Tensor, poses_gt: torch.Tensor, delta: int = 1
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Relative pose error over a frame delta: (N, 4, 4) poses →
    (translation RMSE, rotation RMSE in radians)."""
    T_est = relative_transformation(poses_est[:-delta], poses_est[delta:])
    T_gt = relative_transformation(poses_gt[:-delta], poses_gt[delta:])
    E = relative_transformation(T_gt, T_est)
    trans = torch.linalg.vector_norm(E[..., :3, 3], dim=-1)
    tr = torch.diagonal(E[..., :3, :3], dim1=-2, dim2=-1).sum(-1)
    rot = torch.acos(((tr - 1.0) / 2.0).clamp(-1.0, 1.0))
    return torch.sqrt((trans ** 2).mean()), torch.sqrt((rot ** 2).mean())
