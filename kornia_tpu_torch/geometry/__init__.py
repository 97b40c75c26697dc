"""Geometry (counterpart of ``kornia_tpu/geometry/__init__.py``): every
public name of the reference's ``geometry`` package resolves here, the
camera models from ``camera`` (the reference's ``sensors`` shim), the
reference's module classes as callables over the functionals
(``fn_module``), and ``Affine`` and ``AdaptiveQuadInterp3d``."""

from . import (
    bbox,
    boxes,
    calibration,
    camera,
    conversions,
    depth,
    epipolar,
    homography,
    liegroup,
    line,
    linalg,
    pointcloud,
    pose,
    ransac,
    registration,
    scene,
    solvers,
    subpix,
    transform,
)
from .boxes import Boxes, Keypoints, VideoBoxes  # noqa: F401
from .pose import NamedPose, check_matrix_shape  # noqa: F401
from .scene import generate_scene  # noqa: F401
from .bbox import *  # noqa: F401,F403
from .calibration import *  # noqa: F401,F403
from .camera import *  # noqa: F401,F403
from .conversions import *  # noqa: F401,F403
from .depth import *  # noqa: F401,F403
from .epipolar import *  # noqa: F401,F403
from .homography import *  # noqa: F401,F403
from .line import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .pointcloud import *  # noqa: F401,F403
from .solvers import *  # noqa: F401,F403
from .subpix import *  # noqa: F401,F403
from .liegroup import Quaternion, Se2, Se3, So2, So3  # noqa: F401
from .ransac import RANSAC, RansacResult  # noqa: F401
from .registration import (  # noqa: F401
    BaseModel,
    Homography,
    ImageRegistrator,
    Similarity,
)
from ..ops.warp import *  # noqa: F401,F403
from ..ops.warp3d import *  # noqa: F401,F403
from ..ops.pyramid import (  # noqa: F401
    ScalePyramid,
    build_laplacian_pyramid,
    build_pyramid,
    pyrdown,
    pyrup,
)
from ..ops.warp import HomographyWarper, BaseWarper, warp_grid  # noqa: F401
from ..core.grid import create_meshgrid, create_meshgrid3d  # noqa: F401
from ..core.check import check_shape as KORNIA_CHECK_SHAPE  # noqa: F401
from ..core.linalg import (  # noqa: F401
    safe_inverse_with_mask,
    safe_solve_with_mask,
)
from ..core.module import fn_module as _fn_module
from ..ops import warp as _w
from ..ops import pyramid as _pyr
from . import subpix as _sp

_CLASS_TO_FN = {
    # transform modules
    "Rotate": _w.rotate,
    "Translate": _w.translate,
    "Scale": _w.scale,
    "Shear": _w.shear,
    "Resize": _w.resize,
    "Rescale": _w.rescale,
    "Hflip": _w.hflip,
    "Vflip": _w.vflip,
    "Rot180": _w.rot180,
    "CenterCrop2D": _w.center_crop,
    "PyrDown": _pyr.pyrdown,
    "PyrUp": _pyr.pyrup,
    # subpix modules
    "NonMaximaSuppression2d": _sp.nms2d,
    "NonMaximaSuppression3d": _sp.nms3d,
    "ConvQuadInterp3d": _sp.conv_quad_interp3d,
    "IterativeQuadInterp3d": _sp.iterative_quad_interp3d,
    "ConvSoftArgmax2d": _sp.conv_soft_argmax2d,
    "ConvSoftArgmax3d": _sp.conv_soft_argmax3d,
    "SpatialSoftArgmax2d": _sp.spatial_soft_argmax2d,
}

for _cls, _fn in _CLASS_TO_FN.items():
    globals()[_cls] = _fn_module(_fn, _cls)
del _cls, _fn


class Affine:
    """Compose the elementary affines (angle in degrees, translation,
    scale, shear, about `center`, default the image centre) and warp."""

    def __init__(self, angle=None, translation=None, scale_factor=None,
                 shear=None, center=None, mode: str = "bilinear",
                 padding_mode: str = "zeros", align_corners: bool = True):
        if all(a is None for a in (angle, translation, scale_factor, shear)):
            raise RuntimeError(
                "Affine needs at least one of angle, translation, "
                "scale_factor, or shear")
        self.angle = angle
        self.translation = translation
        self.scale_factor = scale_factor
        self.shear = shear
        self.center = center
        self.mode = mode
        self.padding_mode = padding_mode
        self.align_corners = align_corners

    def __call__(self, tensor):
        import torch
        from ..core.dtype import as_float
        x = as_float(tensor)
        B = x.shape[0]
        H, W = x.shape[-2:]

        def full(v, shape, default):
            if v is None:
                return torch.full(shape, default, dtype=x.dtype,
                                  device=x.device)
            return torch.as_tensor(v, dtype=x.dtype,
                                   device=x.device).expand(shape)

        angle = full(self.angle, (B,), 0.0)
        translation = full(self.translation, (B, 2), 0.0)
        scale_factor = full(self.scale_factor, (B, 2), 1.0)
        center = (torch.tensor([[(W - 1) / 2.0, (H - 1) / 2.0]],
                               dtype=x.dtype, device=x.device).expand(B, 2)
                  if self.center is None else full(self.center, (B, 2), 0.0))
        sx = sy = None
        if self.shear is not None:
            sh = full(self.shear, (B, 2), 0.0)
            sx, sy = sh[:, 0], sh[:, 1]
        M = _w.get_affine_matrix2d(translation, center, scale_factor, angle,
                                   sx, sy)
        return _w.warp_affine(x, M[:, :2], (H, W), self.mode,
                              self.padding_mode, self.align_corners)

    forward = __call__


class AdaptiveQuadInterp3d:
    """Subpixel refinement with a chosen backend: "patch" the iterative
    fit, "conv" (and "auto", as in the reference) the one-pass fit."""

    MODES = ("patch", "conv", "auto")

    def __init__(self, mode: str = "auto", n_iters: int = 5,
                 strict_maxima_bonus: float = 10.0,
                 max_subpixel_shift: float = 0.6, dilation_radius: int = 1,
                 allow_scale_steps: bool = True, max_candidates=None):
        if mode not in self.MODES:
            raise ValueError(f"mode must be one of {self.MODES}, got {mode}")
        self.mode = mode
        self.n_iters = n_iters
        self.strict_maxima_bonus = strict_maxima_bonus
        self.max_subpixel_shift = max_subpixel_shift
        self.allow_scale_steps = allow_scale_steps
        self.max_candidates = max_candidates

    def __call__(self, x, precomputed_nms_mask=None):
        if self.mode == "patch":
            return _sp.iterative_quad_interp3d(
                x, self.n_iters, self.strict_maxima_bonus,
                self.max_subpixel_shift, self.allow_scale_steps,
                precomputed_nms_mask, self.max_candidates)
        return _sp.conv_quad_interp3d(x, self.strict_maxima_bonus)

    forward = __call__
