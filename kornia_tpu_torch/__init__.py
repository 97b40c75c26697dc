"""kornia_tpu_torch: the PyTorch / CUDA port of kornia_tpu for one NVIDIA
H100.

The package mirrors ``kornia_tpu``'s module tree (``ops/filters.py`` ↔
``ops/filters.py`` and so on) and is held against it by the tests. It
imports ``torch``, ``numpy`` and ``ctypes`` and nothing of JAX or of
``kornia_tpu``. The TPU kernels on its path are hand-written CUDA kernels
(``csrc/``), compiled at first use; see ``ops/kernels.py``.

Entry points such as ``slam.twoview.two_view_pose`` run on ``cuda`` unless
the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from .config import kornia_tpu_config
from . import (
    augmentation,
    config,
    contrib,
    core,
    feature,
    geometry,
    image,
    io,
    losses,
    metrics,
    models,
    ops,
    parallel,
    slam,
    tracking,
    utils,
)
from .core.grid import create_meshgrid, create_meshgrid3d  # noqa: F401
from .geometry.pointcloud import (  # noqa: F401
    load_pointcloud_ply,
    save_pointcloud_ply,
)
from .image.draw import (  # noqa: F401
    draw_convex_polygon,
    draw_line,
    draw_point2d,
    draw_rectangle,
)
from .image.image_print import image_to_string, print_image  # noqa: F401
from .losses.losses import one_hot  # noqa: F401
from .utils import deprecated  # noqa: F401
from .utils.misc import image_to_tensor, tensor_to_image  # noqa: F401
