"""Dtype policy (counterpart of ``kornia_tpu/core/dtype.py``): images and
geometry compute in float32; integral inputs are promoted."""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

__all__ = ["compute_dtype", "as_float", "float32_on", "solve_dtype",
           "bf16_storage", "true_div", "host_tensor", "device_table"]

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


def true_div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d rounded as a division on every device. PyTorch's CUDA division
    by a Python number multiplies by its reciprocal, up to one ulp off the
    quotient that the CPU and the JAX reference compute; where a floor, a
    bin or a sampling coordinate follows, the port divides by a 0-dim
    tensor (filled on the device, so no host copy) instead."""
    x = as_float(x)
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def host_tensor(values, device, dtype: torch.dtype = torch.float32
                ) -> torch.Tensor:
    """Host numbers (nested tuples or a numpy array) as a new tensor on
    `device`. To a card they go through pinned memory by an asynchronous
    copy: a copy from pageable memory would wait for the card to drain.
    Not for use while a CUDA graph is captured: the graph would keep the
    pinned buffer's address, which is reused once the copy is done."""
    t = torch.tensor(np.asarray(values), dtype=dtype)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def solve_dtype() -> torch.dtype:
    """Dtype for linear solves: float32. The JAX package returns float64
    when its x64 switch is on (its CPU tests); the port has no such switch
    and conditions its float32 solves instead (core/linalg.py)."""
    return torch.float32


def bf16_storage(x: torch.Tensor) -> torch.Tensor:
    """Cast to bfloat16 for storage in device memory."""
    return x.to(torch.bfloat16)


def device_table(owner: Any, name: Any, values, device,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`values`, a table that `owner` holds on the host, on `device`:
    copied there at first use and kept on `owner`, one copy per device,
    copied again if the host values change (a public attribute such as
    ``Normalize.mean`` may be set). It is built outside inference mode, so
    a table first used there still serves a later backward. Callers index
    it or compute from it; they never hand the table itself out."""
    values = np.asarray(values)
    stamp = (values.dtype.str, values.shape, values.tobytes())
    tables = owner.__dict__.setdefault("_device_tables", {})
    key = (name, torch.device(device), dtype)
    if key not in tables or tables[key][0] != stamp:
        with torch.inference_mode(False):
            tables[key] = (stamp, host_tensor(values, device, dtype))
    return tables[key][1]
