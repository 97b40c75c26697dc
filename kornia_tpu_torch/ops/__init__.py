"""Dense image ops and the hand-written kernels behind them."""
from . import (color, colormap, deform_conv, enhance, filters, jpeg, kernels,
               morphology, warp)
from .deform_conv import deform_conv2d  # noqa: F401
from .kernels import fused_separable_blur2d  # noqa: F401
from .color import *  # noqa: F401,F403
from .enhance import *  # noqa: F401,F403
from .filters import *  # noqa: F401,F403
from .morphology import *  # noqa: F401,F403
from .warp import *  # noqa: F401,F403
