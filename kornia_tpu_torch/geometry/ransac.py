"""Batched RANSAC for homographies, fundamental and essential matrices
(counterpart of ``kornia_tpu/geometry/ransac.py``).

One round draws `batch_size` minimal samples at once (Gumbel top-k over the
valid correspondences, optionally biased toward high `scores` in early
rounds: the PROSAC schedule), solves each with the model's minimal solver
(4-point DLT, 8-point, 7-point or 5-point), and, where a sample gives K > 1
candidates and there are more than 192 points, picks each sample's best
candidate on a strided ~128-point prescore (two-stage MSAC). The winners
are scored on all points and the best is kept. Rounds repeat until the
confidence bound of the best inlier count is met — a Python loop with one
host sync a round. The best model is then refined by `polish_iters` rounds
of local optimisation on its inliers (the reweighted DLT for homographies,
the weighted 8-point for fundamental matrices, the weighted 8-point
projected to the essential manifold and ``polish_essential``'s
Gauss-Newton for essential ones), accepting only improvements.

Randomness: the Gumbel noise comes from a ``torch.Generator`` (in the
place of the reference's ``key``), or is injected as a (T, S, N) tensor
(round r uses ``gumbel[r]``) so that tests can replay the reference's
``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.dtype import as_float
from ..core.linalg import f32_precision
from ..core.sort import top_k
from .epipolar import (polish_essential, run_5point, run_7point, run_8point,
                       symmetrical_epipolar_distance)
from .homography import (find_homography_dlt, find_homography_dlt_iterated,
                         sample_is_valid_for_homography,
                         symmetric_transfer_error)

__all__ = ["RansacResult", "ransac", "RANSAC", "max_samples_by_conf"]


@dataclasses.dataclass(frozen=True)
class RansacResult:
    model: torch.Tensor  # (3, 3) best model
    inliers: torch.Tensor  # (N,) bool
    score: torch.Tensor  # scalar MSAC score
    inlier_count: torch.Tensor  # scalar
    # sampling rounds run before the confidence bound held (set by ransac)
    rounds: int = dataclasses.field(default=0, init=False, compare=False)


_CONFIGS = {
    "homography": dict(minimal=4, models_per_sample=1),
    "fundamental": dict(minimal=8, models_per_sample=1),
    "fundamental_7pt": dict(minimal=7, models_per_sample=3),
    "essential": dict(minimal=5, models_per_sample=20),
}


def _estimate(model_type: str, p1: torch.Tensor,
              p2: torch.Tensor) -> torch.Tensor:
    """(S, m, 2) x2 → (S, K, 3, 3) candidate models per sample."""
    if model_type == "homography":
        return find_homography_dlt(p1, p2)[:, None]
    if model_type == "fundamental":
        return run_8point(p1, p2)[:, None]
    if model_type == "fundamental_7pt":
        return run_7point(p1, p2)
    return run_5point(p1, p2)


def _error(model_type: str, p1: torch.Tensor, p2: torch.Tensor,
           M: torch.Tensor) -> torch.Tensor:
    """Squared residual of every point under every model: M (K, 3, 3),
    points (N, 2) → (K, N); the symmetric transfer error for homographies,
    the symmetric epipolar distance otherwise."""
    if model_type == "homography":
        return symmetric_transfer_error(p1[None], p2[None], M, squared=True)
    return symmetrical_epipolar_distance(p1[None], p2[None], M, squared=True)


def _sample_validity(model_type: str, p1: torch.Tensor,
                     p2: torch.Tensor) -> torch.Tensor:
    if model_type == "homography":
        return sample_is_valid_for_homography(p1, p2)
    return torch.ones(p1.shape[0], dtype=torch.bool, device=p1.device)


def _msac_scores(model_type: str, p1: torch.Tensor, p2: torch.Tensor,
                 models: torch.Tensor, mask: torch.Tensor, th2: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(M, 3, 3) models → (MSAC score (M,), inlier count (M,)). The (M, N)
    error matrix is formed whole (5120 x 128 on the two-view path's
    prescore); the reference chunks it past 2^24 entries for a TPU's HBM."""
    errs = torch.where(mask[None, :], _error(model_type, p1, p2, models),
                       th2)
    return (errs.clamp(0.0, th2).sum(-1),
            ((errs < th2) & mask[None, :]).sum(-1))


def max_samples_by_conf(n_inl: torch.Tensor, num_tc: torch.Tensor,
                        sample_size: int, conf: float) -> torch.Tensor:
    """Confidence bound on the number of samples (float32)."""
    eps = 1e-9
    ratio = (n_inl.to(torch.float32) / num_tc).clamp(eps, 1.0 - eps)
    log_fail = torch.log(torch.tensor(1.0 - conf, dtype=torch.float32,
                                      device=n_inl.device))
    return log_fail / torch.clamp_max(torch.log1p(-(ratio ** sample_size)),
                                      -eps)


def _gumbel(shape, generator: Optional[torch.Generator],
            device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U uniform in (0, 1)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device).clamp_min(tiny)
    return -torch.log(-torch.log(u))


def _prosac_beta(r: int, T: int) -> float:
    """The PROSAC weight of round r, 3·max(1 - r / (T - 1), 0), in float32
    arithmetic as the reference computes it."""
    f32 = np.float32
    return float(f32(3.0) * np.maximum(
        f32(1.0) - f32(r) / f32(max(T - 1, 1)), f32(0.0)))


def ransac(points1: torch.Tensor, points2: torch.Tensor,
           generator: Optional[torch.Generator] = None,
           model_type: str = "homography", inl_th: float = 2.0,
           batch_size: int = 2048, max_iterations: int = 10,
           confidence: float = 0.99, polish_iters: int = 3,
           mask: Optional[torch.Tensor] = None,
           scores: Optional[torch.Tensor] = None, *,
           gumbel: Optional[torch.Tensor] = None) -> RansacResult:
    """Single-pair robust estimation of a 3x3 model ("homography",
    "fundamental", "fundamental_7pt" or "essential") from (N, 2)
    correspondences. `mask` (N,) marks the valid ones; `scores` (N,)
    biases the early rounds' samples toward high-scoring ones (PROSAC)."""
    if model_type not in _CONFIGS:
        raise ValueError(f"unknown model type {model_type}")
    with f32_precision():
        return _ransac(as_float(points1), as_float(points2), model_type,
                       inl_th, batch_size, max_iterations, confidence,
                       polish_iters, mask, scores, generator, gumbel)


def _refit(model_type: str, points1, points2, model, w, mask, th2):
    """One local-optimisation refit of `model` on the weights w."""
    if model_type == "homography":
        return find_homography_dlt_iterated(points1[None], points2[None],
                                            w[None], n_iter=2)[0]
    F = run_8point(points1[None], points2[None], w[None])[0]
    if model_type != "essential":
        return F
    U, _, Vt = torch.linalg.svd(F)
    svals = torch.tensor([1.0, 1.0, 0.0], dtype=F.dtype, device=F.device)
    E8 = (U * svals[None, :]) @ Vt
    # the better of {8-point refit, current} after the manifold polish
    cand = polish_essential(torch.stack([E8, model])[None], points1[None],
                            points2[None], iters=2, weights=w[None])[0]
    e_c = _error(model_type, points1, points2, cand)
    msac_c = torch.where(mask[None], e_c.clamp(0, th2), th2).sum(-1)
    return cand[torch.argmin(msac_c)]


def _ransac(points1, points2, model_type, inl_th, batch_size, max_iterations,
            confidence, polish_iters, mask, scores, generator, gumbel):
    N = points1.shape[0]
    dev, dt = points1.device, points1.dtype
    cfg = _CONFIGS[model_type]
    m = cfg["minimal"]
    if mask is None:
        mask = torch.ones(N, dtype=torch.bool, device=dev)
    T, S = max_iterations, batch_size
    if gumbel is not None and tuple(gumbel.shape) != (T, S, N):
        raise ValueError(f"gumbel must be {(T, S, N)}, got "
                         f"{tuple(gumbel.shape)}")
    th2 = inl_th * inl_th
    valid_count = mask.sum().clamp_min(1)
    base_logits = torch.where(mask, 0.0, -math.inf).to(dt)
    z = None
    if scores is not None:
        # PROSAC: round 0 sharply biased toward high scores, the last
        # round uniform (std with ddof 0, as jnp.std)
        scores = as_float(scores).to(dev)
        z = (scores - scores.mean()) / (scores.std(correction=0) + 1e-6)
    rows = torch.arange(S, device=dev)

    def one_round(r: int):
        noise = (gumbel[r].to(device=dev, dtype=dt) if gumbel is not None
                 else _gumbel((S, N), generator, dev))
        logits = base_logits if z is None else \
            base_logits + _prosac_beta(r, T) * z
        _, idx = top_k(noise + logits[None], m)  # (S, m) distinct
        p1s, p2s = points1[idx], points2[idx]
        sample_ok = _sample_validity(model_type, p1s, p2s)
        models = _estimate(model_type, p1s, p2s)  # (S, K, 3, 3)
        K = models.shape[1]
        models = models.reshape(S * K, 3, 3)
        model_ok = sample_ok.repeat_interleave(K) & (
            torch.linalg.vector_norm(models.reshape(-1, 9), dim=-1) > 1e-6)
        if K > 1 and N > 192:
            # two-stage scoring: each sample's K candidates fit its points
            # exactly; a strided ~128-point prescore picks the sample's
            # winner, and only the S winners see all N points
            step = max(N // 128, 1)
            msac_s, _ = _msac_scores(model_type, points1[::step],
                                     points2[::step], models, mask[::step],
                                     th2)
            msac_s = torch.where(model_ok, msac_s, math.inf)
            bk = torch.argmin(msac_s.reshape(S, K), dim=1)
            models = models.reshape(S, K, 3, 3)[rows, bk]
            model_ok = model_ok.reshape(S, K)[rows, bk]
        msac, cnt = _msac_scores(model_type, points1, points2, models, mask,
                                 th2)
        msac = torch.where(model_ok, msac, math.inf)
        b = torch.argmin(msac)
        return models[b], msac[b], cnt[b]

    best_model = torch.eye(3, dtype=dt, device=dev)
    best_msac = torch.tensor(math.inf, dtype=dt, device=dev)
    best_cnt = torch.tensor(0, dtype=torch.int64, device=dev)
    r = 0
    while r < T:
        # the confidence ratio is inliers / VALID correspondences
        bound = max_samples_by_conf(best_cnt, valid_count, m, confidence)
        if not bool(float(r * S) <= bound):
            break
        mdl, ms, ct = one_round(r)
        better = ms < best_msac
        best_model = torch.where(better, mdl, best_model)
        best_cnt = torch.where(better, ct, best_cnt)
        best_msac = torch.minimum(ms, best_msac)
        r += 1

    # local optimisation: refit on the inliers, accept only improvements
    model, score = best_model, best_msac
    for _ in range(polish_iters):
        err = _error(model_type, points1, points2, model[None])[0]
        w = torch.where((err < th2) & mask, 1.0, 0.0)
        refit = _refit(model_type, points1, points2, model, w, mask, th2)
        err_r = _error(model_type, points1, points2, refit[None])[0]
        msac_r = torch.where(mask, err_r.clamp(0, th2), th2).sum()
        model = torch.where(msac_r < score, refit, model)
        score = torch.minimum(msac_r, score)
    inliers = (_error(model_type, points1, points2, model[None])[0]
               < th2) & mask
    res = RansacResult(model=model, inliers=inliers, score=score,
                       inlier_count=inliers.sum())
    object.__setattr__(res, "rounds", r)
    return res


class RANSAC:
    """Module-style wrapper of :func:`ransac` with the reference's
    parameter names."""

    def __init__(self, model_type: str = "homography", inl_th: float = 2.0,
                 batch_size: int = 2048, max_iter: int = 10,
                 confidence: float = 0.99, max_lo_iters: int = 5):
        self.model_type = model_type
        self.inl_th = inl_th
        self.batch_size = batch_size
        self.max_iter = max_iter
        self.confidence = confidence
        self.max_lo_iters = max_lo_iters

    def __call__(self, kp1: torch.Tensor, kp2: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 mask: Optional[torch.Tensor] = None, *,
                 gumbel: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """→ (model (3, 3), inliers (N,))."""
        res = ransac(kp1, kp2, generator, self.model_type, self.inl_th,
                     self.batch_size, self.max_iter, self.confidence,
                     self.max_lo_iters, mask, gumbel=gumbel)
        return res.model, res.inliers
