"""Losses (counterpart of ``kornia_tpu/losses/__init__.py``): the task
losses, the robust kernels and the mutual-information losses, with the
reference's module classes as callables over the functionals."""

from .losses import *  # noqa: F401,F403
from .robust import *  # noqa: F401,F403
from .mutual_information import *  # noqa: F401,F403

from . import losses as _l
from . import robust as _r
from ..core.module import fn_module as _fn_module

_CLASS_TO_FN = {
    "SSIMLoss": (_l, "ssim_loss"),
    "SSIM3DLoss": (_l, "ssim3d_loss"),
    "MS_SSIMLoss": (_l, "ms_ssim_loss"),
    "PSNRLoss": (_l, "psnr_loss"),
    "TotalVariation": (_l, "total_variation"),
    "InverseDepthSmoothnessLoss": (_l, "inverse_depth_smoothness_loss"),
    "FocalLoss": (_l, "focal_loss"),
    "BinaryFocalLossWithLogits": (_l, "binary_focal_loss_with_logits"),
    "DiceLoss": (_l, "dice_loss"),
    "TverskyLoss": (_l, "tversky_loss"),
    "LovaszHingeLoss": (_l, "lovasz_hinge_loss"),
    "LovaszSoftmaxLoss": (_l, "lovasz_softmax_loss"),
    "HausdorffERLoss": (_l, "hausdorff_distance_loss"),
    "CharbonnierLoss": (_r, "charbonnier_loss"),
    "CauchyLoss": (_r, "cauchy_loss"),
    "GemanMcclureLoss": (_r, "geman_mcclure_loss"),
    "WelschLoss": (_r, "welsch_loss"),
}

for _cls, (_mod, _fname) in _CLASS_TO_FN.items():
    globals()[_cls] = _fn_module(getattr(_mod, _fname), _cls)
del _cls, _mod, _fname

# the distance-transform formulation is the same in 3-D
HausdorffERLoss3D = _fn_module(_l.hausdorff_distance_loss, "HausdorffERLoss3D")
