"""AdaLAM-style geometric filtering of matches (counterpart of
``kornia_tpu/feature/adalam.py``).

A fixed number of seed matches vote over every match with soft spatial
weights; each seed fits a local affine map from image 0 to image 1 by three
rounds of reweighted least squares, and a match survives if some seed with
enough support, near it, finds it consistent. Shapes are static: the result
is a mask over the input rows. The 3x3 solves use
``solve_ex(check_errors=False)``, so a forward reads nothing back to the
host (a singular system gives a non-finite fit, as ``jnp.linalg.solve``
does).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.dtype import as_float
from ..core.linalg import f32_matmul_precision

__all__ = ["adalam_filter"]


@f32_matmul_precision
def adalam_filter(
    kp0: torch.Tensor,
    kp1: torch.Tensor,
    valid: Optional[torch.Tensor] = None,
    num_seeds: int = 64,
    neighborhood: float = 40.0,
    inlier_th: float = 10.0,
    min_support: int = 4,
) -> torch.Tensor:
    """kp0, kp1: (N, 2) matched coordinates (row i ↔ row i); `valid` (N,)
    the putative matches. Returns the refined mask (N,)."""
    kp0 = as_float(kp0)
    kp1 = as_float(kp1)
    N = kp0.shape[0]
    if valid is None:
        valid = torch.ones(N, dtype=torch.bool, device=kp0.device)
    vf = valid.to(kp0.dtype)

    # seeds: every stride-th match, valid ones first (a stable order)
    order = torch.argsort(-vf, stable=True)
    stride = max(N // num_seeds, 1)
    seed_idx = order[::stride][:num_seeds]
    s0 = kp0[seed_idx]  # (S, 2)

    # spatial affinity of every match to every seed, in image 0
    d0 = torch.linalg.vector_norm(kp0[None, :, :] - s0[:, None, :], dim=-1)
    w = torch.exp(-0.5 * (d0 / neighborhood) ** 2) * vf[None, :]  # (S, N)

    X = torch.cat([kp0, torch.ones_like(kp0[:, :1])], -1)  # (N, 3)
    eye = torch.eye(3, dtype=kp0.dtype, device=kp0.device)
    w_robust = w
    for _ in range(3):
        XtW = X[None, :, :] * w_robust[:, :, None]  # (S, N, 3)
        G = torch.einsum("sni,nj->sij", XtW, X) + 1e-3 * eye
        rhs = torch.einsum("sni,nk->sik", XtW, kp1)  # (S, 3, 2)
        theta = torch.linalg.solve_ex(G, rhs, check_errors=False)[0]
        pred = torch.einsum("ni,sik->snk", X, theta)  # (S, N, 2)
        err = torch.linalg.vector_norm(pred - kp1[None], dim=-1)  # (S, N)
        w_robust = w / (1.0 + (err / inlier_th) ** 2)  # Cauchy reweighting

    consistent = (err < inlier_th) & valid[None, :]
    support = (consistent * w).sum(dim=1)  # (S,)
    good_seed = support >= min_support
    near = w > 0.05
    keep = (consistent & near & good_seed[:, None]).any(dim=0)
    return keep & valid
