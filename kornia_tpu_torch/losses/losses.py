"""Task losses (counterpart of ``kornia_tpu/losses/losses.py``): SSIM in
2-D, 3-D and at five scales, PSNR, total variation, depth smoothness, the
focal, Dice, Tversky and Lovász losses on class scores, the KL and JS
divergences of spatial distributions, and the Hausdorff loss by distance
transforms.

SSIM blurs five images with an 11-tap reflect Gaussian through
``gaussian_blur2d``, so on the card its forward and backward run the banded
blur kernel and its adjoint (``ops/kernels.py``); ``ms_ssim_loss`` does so
at each of its scales. ``ssim3d`` blurs with ``filter3d`` (no kernel of its
own). The Lovász losses sort their errors with a stable descending sort,
ties in index order, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from ..core.dtype import as_float
from ..ops.filters import filter3d, gaussian_blur2d, get_gaussian_kernel3d
from ..ops.warp import rescale

__all__ = ["one_hot", "ssim", "ssim_loss", "ssim3d", "ssim3d_loss",
           "ms_ssim_loss", "psnr", "psnr_loss", "total_variation",
           "inverse_depth_smoothness_loss", "focal_loss",
           "binary_focal_loss_with_logits", "dice_loss", "tversky_loss",
           "lovasz_hinge_loss", "lovasz_softmax_loss", "kl_div_loss_2d",
           "js_div_loss_2d", "hausdorff_distance_loss"]


def _reduce(x: torch.Tensor, reduction: str) -> torch.Tensor:
    if reduction == "mean":
        return x.mean()
    if reduction == "sum":
        return x.sum()
    return x


def _one_hot(labels: torch.Tensor, num_classes: int,
             dtype: torch.dtype) -> torch.Tensor:
    """(B, ...) labels → (B, C, ...); a label outside [0, C) gives a row of
    zeros, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(num_classes, device=labels.device).reshape(
        1, num_classes, *([1] * (labels.ndim - 1)))
    return (labels.unsqueeze(1) == classes).to(dtype)


def one_hot(labels: torch.Tensor, num_classes: int,
            dtype: torch.dtype = torch.float32,
            eps: float = 1e-6) -> torch.Tensor:
    """(B, ...) integer labels → (B, C, ...) one-hot plus `eps`."""
    return _one_hot(labels, num_classes, dtype) + eps


def ssim(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
         max_val: float = 1.0, eps: float = 1e-12) -> torch.Tensor:
    """Per-pixel SSIM map (B, C, H, W)."""
    img1 = as_float(img1)
    img2 = as_float(img2)
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2

    def blur(t):
        return gaussian_blur2d(t, window_size, 1.5, border_type="reflect")

    mu1 = blur(img1)
    mu2 = blur(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    s1 = blur(img1 * img1) - mu1_sq
    s2 = blur(img2 * img2) - mu2_sq
    s12 = blur(img1 * img2) - mu12
    num = (2.0 * mu12 + C1) * (2.0 * s12 + C2)
    den = (mu1_sq + mu2_sq + C1) * (s1 + s2 + C2)
    return num / (den + eps)


def ssim_loss(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
              max_val: float = 1.0, reduction: str = "mean") -> torch.Tensor:
    return _reduce((1.0 - ssim(img1, img2, window_size, max_val)) / 2.0,
                   reduction)


def psnr(image: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    image = as_float(image)
    target = as_float(target)
    mse = ((image - target) ** 2).mean()
    return 10.0 * torch.log10(max_val ** 2 / mse.clamp_min(1e-12))


def psnr_loss(image: torch.Tensor, target: torch.Tensor,
              max_val: float = 1.0) -> torch.Tensor:
    return -psnr(image, target, max_val)


def ssim3d(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11,
           max_val: float = 1.0, eps: float = 1e-12) -> torch.Tensor:
    """(B, C, D, H, W) SSIM map (σ 1.5 Gaussian, replicate border)."""
    img1 = as_float(img1)
    img2 = as_float(img2)
    C1 = (0.01 * max_val) ** 2
    C2 = (0.03 * max_val) ** 2
    kern = get_gaussian_kernel3d(window_size, 1.5, img1.dtype, img1.device)

    def blur(t):
        return filter3d(t, kern, border_type="replicate")

    mu1, mu2 = blur(img1), blur(img2)
    s1 = blur(img1 * img1) - mu1 * mu1
    s2 = blur(img2 * img2) - mu2 * mu2
    s12 = blur(img1 * img2) - mu1 * mu2
    num = (2 * mu1 * mu2 + C1) * (2 * s12 + C2)
    den = (mu1 ** 2 + mu2 ** 2 + C1) * (s1 + s2 + C2)
    return num / (den + eps)


def ssim3d_loss(img1: torch.Tensor, img2: torch.Tensor,
                window_size: int = 11, max_val: float = 1.0,
                eps: float = 1e-12, reduction: str = "mean") -> torch.Tensor:
    return _reduce((1.0 - ssim3d(img1, img2, window_size, max_val, eps))
                   / 2.0, reduction)


def ms_ssim_loss(img1: torch.Tensor, img2: torch.Tensor,
                 weights: Optional[Sequence[float]] = None,
                 window_size: int = 11,
                 reduction: str = "mean") -> torch.Tensor:
    """1 - the product over scales of |mean SSIM| ** weight, each next
    scale the antialiased half of the last."""
    if weights is None:
        weights = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
    a, b = as_float(img1), as_float(img2)
    vals = []
    for i, w in enumerate(weights):
        s = ssim(a, b, window_size).mean((1, 2, 3))
        vals.append(s.abs() ** w)
        if i < len(weights) - 1:
            a = rescale(a, 0.5, antialias=True)
            b = rescale(b, 0.5, antialias=True)
    return _reduce(1.0 - torch.stack(vals, -1).prod(-1), reduction)


def total_variation(img: torch.Tensor, reduction: str = "sum"
                    ) -> torch.Tensor:
    """Absolute neighbour differences, reduced over the two spatial axes
    only (the leading axes stay)."""
    img = as_float(img)
    dh = (img[..., 1:, :] - img[..., :-1, :]).abs()
    dw = (img[..., :, 1:] - img[..., :, :-1]).abs()
    if reduction == "sum":
        return dh.sum((-2, -1)) + dw.sum((-2, -1))
    return dh.mean((-2, -1)) + dw.mean((-2, -1))


def inverse_depth_smoothness_loss(idepth: torch.Tensor,
                                  image: torch.Tensor) -> torch.Tensor:
    """Inverse-depth gradients weighted by exp(-|image gradient|)."""
    idepth = as_float(idepth)
    image = as_float(image)
    didx = (idepth[..., :, 1:] - idepth[..., :, :-1]).abs()
    didy = (idepth[..., 1:, :] - idepth[..., :-1, :]).abs()
    imgdx = (image[..., :, 1:] - image[..., :, :-1]).abs().mean(
        1, keepdim=True)
    imgdy = (image[..., 1:, :] - image[..., :-1, :]).abs().mean(
        1, keepdim=True)
    return (didx * torch.exp(-imgdx)).mean() + (didy * torch.exp(-imgdy)).mean()


def focal_loss(pred: torch.Tensor, target: torch.Tensor, alpha: float = 0.5,
               gamma: float = 2.0, reduction: str = "none",
               weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-class focal loss on (B, C, ...) logits and integer targets:
    the per-class map (zero off the true class), reduced over every axis."""
    pred = as_float(pred)
    log_p = torch.log_softmax(pred, dim=1)
    p = torch.exp(log_p)
    oh = _one_hot(target, pred.shape[1], pred.dtype)
    loss_map = -alpha * torch.pow(1.0 - p, gamma) * log_p * oh
    if weight is not None:
        loss_map = loss_map * weight.reshape(1, -1, *([1] * (pred.ndim - 2)))
    return _reduce(loss_map, reduction)


def binary_focal_loss_with_logits(pred: torch.Tensor, target: torch.Tensor,
                                  alpha: float = 0.25, gamma: float = 2.0,
                                  reduction: str = "none",
                                  pos_weight: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    pred = as_float(pred)
    target = as_float(target)
    p = torch.sigmoid(pred)
    pos = -alpha * torch.pow(1 - p, gamma) * F.logsigmoid(pred) * target
    neg = -(1 - alpha) * torch.pow(p, gamma) * F.logsigmoid(-pred) \
        * (1 - target)
    if pos_weight is not None:
        pos = pos * pos_weight
    return _reduce(pos + neg, reduction)


def dice_loss(pred: torch.Tensor, target: torch.Tensor,
              average: str = "micro", eps: float = 1e-8) -> torch.Tensor:
    """Soft Dice on (B, C, H, W) logits and (B, H, W) labels; "micro" pools
    the classes, otherwise each class scores on its own."""
    pred = as_float(pred)
    p = torch.softmax(pred, dim=1)
    oh = _one_hot(target, pred.shape[1], pred.dtype)
    dims = (1, 2, 3) if average == "micro" else (2, 3)
    inter = (p * oh).sum(dims)
    card = (p + oh).sum(dims)
    return (1.0 - 2.0 * inter / (card + eps)).mean()


def tversky_loss(pred: torch.Tensor, target: torch.Tensor,
                 alpha: float = 0.5, beta: float = 0.5,
                 eps: float = 1e-8) -> torch.Tensor:
    pred = as_float(pred)
    p = torch.softmax(pred, dim=1)
    oh = _one_hot(target, pred.shape[1], pred.dtype)
    dims = (1, 2, 3)
    inter = (p * oh).sum(dims)
    fps = (p * (1.0 - oh)).sum(dims)
    fns = ((1.0 - p) * oh).sum(dims)
    return (1.0 - inter / (inter + alpha * fps + beta * fns + eps)).mean()


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    gts = gt_sorted.sum(-1, keepdim=True)
    intersection = gts - torch.cumsum(gt_sorted, -1)
    union = gts + torch.cumsum(1.0 - gt_sorted, -1)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[..., :1], jaccard[..., 1:] - jaccard[..., :-1]],
                     dim=-1)


def _sorted_desc(errors: torch.Tensor, labels: torch.Tensor):
    """Errors in descending order and the labels in that order."""
    errors_sorted, perm = torch.sort(errors, dim=-1, descending=True,
                                     stable=True)
    return errors_sorted, torch.gather(labels, -1, perm)


def lovasz_hinge_loss(pred: torch.Tensor, target: torch.Tensor
                      ) -> torch.Tensor:
    """Binary Lovász hinge on (B, 1, H, W) logits and (B, H, W) {0, 1}
    masks."""
    pred = as_float(pred).reshape(pred.shape[0], -1)
    target = as_float(target).reshape(target.shape[0], -1)
    errors = 1.0 - pred * (2.0 * target - 1.0)
    errors_sorted, gt_sorted = _sorted_desc(errors, target)
    return (torch.relu(errors_sorted) * _lovasz_grad(gt_sorted)).sum(-1).mean()


def lovasz_softmax_loss(pred: torch.Tensor, target: torch.Tensor
                        ) -> torch.Tensor:
    """Multi-class Lovász-softmax on (B, C, H, W) logits and labels."""
    pred = as_float(pred)
    B, C = pred.shape[:2]
    p = torch.softmax(pred, dim=1).reshape(B, C, -1)
    t = target.reshape(B, -1)
    losses = []
    for c in range(C):
        fg = (t == c).to(pred.dtype)
        errors_sorted, fg_sorted = _sorted_desc((fg - p[:, c]).abs(), fg)
        losses.append((errors_sorted * _lovasz_grad(fg_sorted)).sum(-1))
    return torch.stack(losses, dim=-1).mean()


def kl_div_loss_2d(pred: torch.Tensor, target: torch.Tensor,
                   reduction: str = "mean") -> torch.Tensor:
    """KL(target ‖ pred) of (B, C, H, W) spatial distributions, summed over
    H, W."""
    pred = as_float(pred)
    target = as_float(target)
    kl = target * (torch.log(target.clamp_min(1e-12))
                   - torch.log(pred.clamp_min(1e-12)))
    return _reduce(kl.sum((-2, -1)), reduction)


def js_div_loss_2d(pred: torch.Tensor, target: torch.Tensor,
                   reduction: str = "mean") -> torch.Tensor:
    m = 0.5 * (as_float(pred) + as_float(target))
    return 0.5 * (kl_div_loss_2d(m, pred, reduction)
                  + kl_div_loss_2d(m, target, reduction))


def hausdorff_distance_loss(pred: torch.Tensor, target: torch.Tensor,
                            k: float = 2.0, reduction: str = "mean"
                            ) -> torch.Tensor:
    """Soft Hausdorff loss by distance transforms: (B, C, H, W) logits and
    (B, H, W) labels; (B, C) before the reduction."""
    from ..contrib.ops import distance_transform
    pred = as_float(pred)
    C = pred.shape[1]
    p = torch.softmax(pred, dim=1)
    oh = _one_hot(target, C, pred.dtype)
    losses = []
    for c in range(C):
        gt = oh[:, c:c + 1]
        pr = p[:, c:c + 1]
        dist = distance_transform(1.0 - gt) ** k \
            + distance_transform(1.0 - pr) ** k
        losses.append(((pr - gt) ** 2 * dist).mean((1, 2, 3)))
    return _reduce(torch.stack(losses, -1), reduction)
