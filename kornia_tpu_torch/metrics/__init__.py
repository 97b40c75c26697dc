"""Metrics (counterpart of ``kornia_tpu/metrics/__init__.py``), with the
reference's ``AEPE``, ``SSIM`` and ``SSIM3D`` classes."""

from .metrics import *  # noqa: F401,F403
from ..losses.losses import ssim, ssim3d  # noqa: F401
from ..core.module import fn_module as _fn_module
from . import metrics as _m
from ..losses import losses as _l

AEPE = _fn_module(_m.aepe, "AEPE")
SSIM = _fn_module(_l.ssim, "SSIM")
SSIM3D = _fn_module(_l.ssim3d, "SSIM3D")
