"""Tensor / image interop (counterpart of ``kornia_tpu/utils/misc.py``)."""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

__all__ = ["image_to_tensor", "tensor_to_image", "batched_forward"]


def image_to_tensor(image: np.ndarray, keepdim: bool = True,
                    device: Union[str, torch.device] = "cuda"
                    ) -> torch.Tensor:
    """HWC (or HW) numpy → CHW tensor on `device`, dtype kept; NHWC →
    NCHW; with ``keepdim=False`` an HWC image gains a batch dim."""
    a = np.asarray(image)
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim == 3:
        out = torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 0)))
        out = out.to(device)
        return out if keepdim else out[None]
    if a.ndim == 4:
        return torch.from_numpy(
            np.ascontiguousarray(np.moveaxis(a, -1, 1))).to(device)
    raise ValueError(f"unsupported image ndim {a.ndim}")


def tensor_to_image(tensor: torch.Tensor, keepdim: bool = False
                    ) -> np.ndarray:
    """CHW / NCHW tensor → HWC (or NHWC) numpy; a single image of a batch
    loses the batch dim unless `keepdim`, one channel its channel dim."""
    a = tensor.detach().cpu().numpy() if torch.is_tensor(tensor) \
        else np.asarray(tensor)
    if a.ndim == 3:
        out = np.moveaxis(a, 0, -1)
    elif a.ndim == 4:
        out = np.moveaxis(a, 1, -1)
        if out.shape[0] == 1 and not keepdim:
            out = out[0]
    else:
        raise ValueError(f"unsupported tensor ndim {a.ndim}")
    if out.shape[-1] == 1:
        out = out[..., 0]
    return out


def batched_forward(fn: Callable, x: torch.Tensor, chunk: int = 16
                    ) -> torch.Tensor:
    """fn over equal chunks of `chunk` along the batch dim, to bound peak
    memory; the tail chunk is padded with copies of the first item, as the
    reference's ``lax.map`` over equal chunks is, and cut off after."""
    B = x.shape[0]
    pad = (-B) % chunk
    if pad:
        x = torch.cat([x, x[:1].expand(pad, *x.shape[1:])], 0)
    out = torch.cat([fn(c) for c in x.split(chunk)], 0)
    return out[:B]
