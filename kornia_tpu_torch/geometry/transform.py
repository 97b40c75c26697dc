"""The kornia layout's ``geometry.transform`` (counterpart of
``kornia_tpu/geometry/transform.py``): warps, crops, resizing, pyramids
and registration under one name."""
from ..ops.pyramid import (  # noqa: F401
    ScalePyramid,
    build_laplacian_pyramid,
    build_pyramid,
    pyrdown,
    pyrup,
)
from ..ops.warp import *  # noqa: F401,F403
from ..ops.warp3d import (  # noqa: F401
    center_crop3d,
    crop3d,
    crop_by_boxes3d,
    get_projective_transform,
    warp_affine3d,
    warp_perspective3d,
)
from .registration import Homography, ImageRegistrator, Similarity  # noqa: F401
