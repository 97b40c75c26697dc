"""Core helpers: dtype policy, checks, grids, conditioned linear algebra."""
from .check import (
    check,
    check_is_color,
    check_is_gray,
    check_is_image,
    check_laf,
    check_same_dtype,
    check_same_shape,
    check_shape,
    disable_checks,
    enable_checks,
)
from .dtype import as_float, compute_dtype, solve_dtype
from .grid import (
    create_meshgrid,
    create_meshgrid3d,
    denormalize_pixel_coordinates,
    normalize_pixel_coordinates,
)
from .linalg import (
    det_2x2,
    det_3x3,
    inverse_2x2,
    inverse_3x3,
    lstsq_nullspace,
    safe_inverse_with_mask,
    safe_solve_with_mask,
    solve_refined,
)
from .module import fn_module  # noqa: F401
