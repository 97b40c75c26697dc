"""Quality metrics (counterpart of ``kornia_tpu/metrics/metrics.py``):
classification accuracy, the confusion matrix and IoU of segmentations,
box IoU and detection mAP, optical-flow endpoint error, the disparity
errors, and the trajectory metrics ATE and RPE.

Counts are integers until the end: the confusion matrix is a ``bincount``
(int64) cast to float32, so it is exact on both devices. ``mean_average_
precision`` reads class counts and matches on the host, as the reference
does.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..core.dtype import as_float
from ..geometry.linalg import relative_transformation
from ..losses.losses import psnr, ssim  # noqa: F401  (re-exported)

__all__ = ["accuracy", "confusion_matrix", "mean_iou", "mean_iou_bbox",
           "mean_average_precision", "aepe", "psnr", "ssim", "AverageMeter",
           "ate_rmse", "rpe", "mean_absolute_disparity_error",
           "root_mean_squared_disparity_error", "mean_bad_pixel_error",
           "average_endpoint_error"]


def accuracy(pred: torch.Tensor, target: torch.Tensor,
             topk: Tuple[int, ...] = (1,)) -> List[torch.Tensor]:
    """Top-k accuracy, in percent, of (B, C) logits (ties ranked in index
    order, as ``lax.top_k`` ranks them)."""
    idx = torch.sort(pred, dim=-1, descending=True,
                     stable=True).indices[:, :max(topk)]
    correct = idx == target[:, None]
    return [correct[:, :k].any(dim=1).sum() * 100.0 / pred.shape[0]
            for k in topk]


def confusion_matrix(pred: torch.Tensor, target: torch.Tensor,
                     num_classes: int, normalized: bool = False
                     ) -> torch.Tensor:
    """(B, N...) predicted and true labels → (B, C, C) float32 counts, row
    the true class, column the predicted one. A pair's cell is
    true · C + predicted, indexed as the reference's scatter indexes it
    (a negative cell counts from the end, one beyond C² is dropped)."""
    B = pred.shape[0]
    C2 = num_classes * num_classes
    idx = (target.reshape(B, -1).long() * num_classes
           + pred.reshape(B, -1).long())
    idx = torch.where(idx < 0, idx + C2, idx)
    idx = torch.where((idx >= 0) & (idx < C2), idx + C2 * torch.arange(
        B, device=idx.device)[:, None], B * C2)
    cm = torch.bincount(idx.reshape(-1), minlength=B * C2 + 1)[:B * C2]
    cm = cm.reshape(B, num_classes, num_classes).to(torch.float32)
    if normalized:
        cm = cm / cm.sum(-1, keepdim=True).clamp_min(1.0)
    return cm


def mean_iou(pred: torch.Tensor, target: torch.Tensor, num_classes: int,
             eps: float = 1e-6) -> torch.Tensor:
    """Per-class IoU (B, C)."""
    cm = confusion_matrix(pred, target, num_classes)
    tp = torch.diagonal(cm, dim1=-2, dim2=-1)
    total = cm.sum(-1) + cm.sum(-2) - tp
    return (tp + eps) / (total + eps)


def mean_iou_bbox(boxes1: torch.Tensor, boxes2: torch.Tensor
                  ) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes (N, 4) x (M, 4) → (N, M)."""
    boxes1 = as_float(boxes1)
    boxes2 = as_float(boxes2)
    area1 = (boxes1[:, 2] - boxes1[:, 0]) * (boxes1[:, 3] - boxes1[:, 1])
    area2 = (boxes2[:, 2] - boxes2[:, 0]) * (boxes2[:, 3] - boxes2[:, 1])
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    return inter / (area1[:, None] + area2[None, :] - inter).clamp_min(1e-8)


def mean_average_precision(
    pred_boxes: torch.Tensor, pred_labels: torch.Tensor,
    pred_scores: torch.Tensor, gt_boxes: torch.Tensor,
    gt_labels: torch.Tensor, n_classes: int, iou_threshold: float = 0.5,
) -> Tuple[torch.Tensor, dict]:
    """Single-image detection mAP of xyxy boxes, 101-point interpolated:
    (mAP, {class: AP}). The IoUs are computed on the boxes' device; the
    greedy matching runs on the host over one copy of them, in the
    reference's order (scores descending, ties in index order)."""
    ious = mean_iou_bbox(pred_boxes, gt_boxes)
    dev = ious.device
    ious = ious.cpu()
    pred_labels, pred_scores = pred_labels.cpu(), pred_scores.cpu()
    gt_labels = gt_labels.cpu()
    aps = {}
    for c in range(n_classes):
        cls_mask = pred_labels == c
        gt_mask = gt_labels == c
        n_gt = int(gt_mask.sum())
        if n_gt == 0:
            continue
        scores = torch.where(cls_mask, pred_scores, -torch.inf)
        order = torch.argsort(-scores, stable=True)
        matched = torch.zeros(gt_boxes.shape[0], dtype=torch.bool)
        tp, fp = [], []
        for i in order.tolist():
            if not bool(cls_mask[i]):
                continue
            iou_row = torch.where(gt_mask, ious[i], 0.0)
            j = int(torch.argmax(iou_row))
            hit = float(iou_row[j]) >= iou_threshold and not bool(matched[j])
            if hit:
                matched[j] = True
            tp.append(1.0 if hit else 0.0)
            fp.append(0.0 if hit else 1.0)
        if not tp:
            aps[c] = 0.0
            continue
        tp_c = torch.cumsum(torch.tensor(tp), 0)
        fp_c = torch.cumsum(torch.tensor(fp), 0)
        recall = tp_c / n_gt
        precision = tp_c / (tp_c + fp_c).clamp_min(1e-8)
        ap = 0.0
        for r in torch.linspace(0, 1, 101):
            ap += float(torch.where(recall >= r, precision, 0.0).max()) / 101.0
        aps[c] = ap
    return torch.tensor(sum(aps.values()) / max(len(aps), 1),
                        dtype=torch.float32, device=dev), aps


def aepe(flow_pred: torch.Tensor, flow_gt: torch.Tensor,
         reduction: str = "mean") -> torch.Tensor:
    """Average endpoint error of (..., 2) flows."""
    epe = torch.linalg.vector_norm(as_float(flow_pred) - as_float(flow_gt),
                                   dim=-1)
    if reduction == "mean":
        return epe.mean()
    if reduction == "sum":
        return epe.sum()
    return epe


average_endpoint_error = aepe


class AverageMeter:
    """Running value, sum, count and mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def _masked_reduce(err: torch.Tensor, valid_mask,
                   reduction: str) -> torch.Tensor:
    if valid_mask is not None:
        m = (torch.as_tensor(valid_mask, device=err.device) != 0).expand(
            err.shape)
        err = torch.where(m, err, 0.0)
        denom = m.sum().clamp_min(1)
    else:
        denom = err.numel()
    if reduction == "none":
        return err
    s = err.sum()
    return s / denom if reduction == "mean" else s


def mean_absolute_disparity_error(input: torch.Tensor, target: torch.Tensor,
                                  valid_mask=None,
                                  reduction: str = "mean") -> torch.Tensor:
    """Masked disparity MAE."""
    return _masked_reduce((as_float(input) - as_float(target)).abs(),
                          valid_mask, reduction)


def root_mean_squared_disparity_error(input: torch.Tensor,
                                      target: torch.Tensor, valid_mask=None,
                                      reduction: str = "mean"
                                      ) -> torch.Tensor:
    """Masked disparity RMSE."""
    out = _masked_reduce((as_float(input) - as_float(target)) ** 2,
                         valid_mask, reduction)
    return torch.sqrt(out) if reduction != "none" else out


def mean_bad_pixel_error(input: torch.Tensor, target: torch.Tensor,
                         threshold: float = 3.0, valid_mask=None,
                         reduction: str = "mean") -> torch.Tensor:
    """Share of pixels with |error| above `threshold` (the KITTI and
    Middlebury bad-pixel ratio, as a fraction)."""
    bad = ((as_float(input) - as_float(target)).abs()
           > threshold).to(torch.float32)
    return _masked_reduce(bad, valid_mask, reduction)


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
