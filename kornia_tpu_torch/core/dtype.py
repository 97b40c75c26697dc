"""Dtype policy (counterpart of ``kornia_tpu/core/dtype.py``): images and
geometry compute in float32; integral inputs are promoted."""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

__all__ = ["compute_dtype", "as_float", "float32_on"]

#: dtype used for general image compute
compute_dtype = torch.float32


def as_float(x: Any, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Promote integral tensors to the compute dtype; pass floats through."""
    x = torch.as_tensor(x)
    if x.is_floating_point():
        return x if dtype is None else x.to(dtype)
    return x.to(dtype or compute_dtype)


def float32_on(x: Any, device: Union[str, torch.device]) -> torch.Tensor:
    """A tensor, array or nested list as float32 on `device` (host arrays
    are copied, so a read-only numpy array is accepted)."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, np.float32))
    return x.to(device=device, dtype=torch.float32)
