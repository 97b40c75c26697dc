"""Image containers, drawing, layout utilities and terminal printing."""
from .image import ChannelsOrder, ColorSpace, Image, ImageLayout, ImageSize, PixelFormat
from .draw import draw_convex_polygon, draw_line, draw_point2d, draw_rectangle
from .image_print import image_to_string, print_image  # noqa: F401
from .utils import (  # noqa: F401
    image_list_to_tensor,
    make_grid,
    perform_keep_shape_image,
    perform_keep_shape_video,
)
from ..utils.misc import image_to_tensor, tensor_to_image  # noqa: F401
from ..core.module import fn_module as _fn_module

ImageToTensor = _fn_module(image_to_tensor, "ImageToTensor")
