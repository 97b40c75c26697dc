"""Shared model helpers (counterpart of the layout helpers of
``kornia_tpu/models/common.py``; its flax building blocks are still to
port). The port's convolutions take NCHW; these move the channel axis
where a block works on (..., C) rows, as attention does."""

from __future__ import annotations

import torch

__all__ = ["nchw_to_nhwc", "nhwc_to_nchw"]


def nchw_to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nhwc_to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)
