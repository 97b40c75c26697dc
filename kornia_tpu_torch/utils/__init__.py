"""Utilities: the ray-traced scene renderer and camera trajectories,
checkpoints and restartable jobs, and the helpers the reference's
``utils`` re-exports."""
from .checkpoint import load_checkpoint, save_checkpoint
from .elastic import latest_checkpoint, run_restartable
from .misc import batched_forward, image_to_tensor, tensor_to_image
from ..core.grid import create_meshgrid, create_meshgrid3d  # noqa: F401
from ..geometry.pointcloud import (  # noqa: F401
    load_pointcloud_ply,
    save_pointcloud_ply,
)
from ..image.draw import (  # noqa: F401
    draw_convex_polygon,
    draw_line,
    draw_point2d,
    draw_rectangle,
)
from ..image.image_print import image_to_string, print_image  # noqa: F401
from ..losses.losses import one_hot  # noqa: F401


def deprecated(replace_with=None, version=None, extra_reason=None):
    """Decorator marking an API as deprecated: each call warns with a
    DeprecationWarning that names the replacement."""
    import functools
    import warnings

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            msg = f"`{fn.__name__}` is deprecated"
            if version:
                msg += f" since {version}"
            if replace_with:
                msg += f"; use `{replace_with}` instead"
            if extra_reason:
                msg += f". {extra_reason}"
            warnings.warn(msg, DeprecationWarning, stacklevel=2)
            return fn(*args, **kwargs)
        return wrapper
    return decorator
