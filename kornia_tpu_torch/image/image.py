"""Image container (counterpart of ``kornia_tpu/image/image.py``): a
(B?, C, H, W) tensor with its pixel format. File IO goes through PIL."""

from __future__ import annotations

import dataclasses
import enum
from typing import Union

import numpy as np
import torch

from ..core.dtype import as_float

__all__ = ["ColorSpace", "ChannelsOrder", "ImageSize", "PixelFormat",
           "ImageLayout", "Image"]


class ColorSpace(enum.Enum):
    UNKNOWN = 0
    GRAY = 1
    RGB = 2
    BGR = 3
    RGBA = 4


class ChannelsOrder(enum.Enum):
    CHANNELS_FIRST = 0
    CHANNELS_LAST = 1


@dataclasses.dataclass(frozen=True)
class ImageSize:
    height: int
    width: int


@dataclasses.dataclass(frozen=True)
class PixelFormat:
    color_space: ColorSpace = ColorSpace.RGB
    bit_depth: int = 8


@dataclasses.dataclass(frozen=True)
class ImageLayout:
    image_size: ImageSize
    channels: int
    channels_order: ChannelsOrder = ChannelsOrder.CHANNELS_FIRST


@dataclasses.dataclass(frozen=True)
class Image:
    """Channels-first (C, H, W) or (B, C, H, W) data and its format."""

    data: torch.Tensor
    pixel_format: PixelFormat = PixelFormat()

    @property
    def is_batch(self) -> bool:
        return self.data.ndim == 4

    @property
    def channels(self) -> int:
        return self.data.shape[-3]

    @property
    def height(self) -> int:
        return self.data.shape[-2]

    @property
    def width(self) -> int:
        return self.data.shape[-1]

    @property
    def shape(self):
        return tuple(self.data.shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def layout(self) -> ImageLayout:
        return ImageLayout(ImageSize(self.height, self.width), self.channels)

    @classmethod
    def from_numpy(cls, arr: np.ndarray,
                   color_space: ColorSpace = ColorSpace.RGB,
                   channels_order: ChannelsOrder = ChannelsOrder.CHANNELS_LAST,
                   device: Union[str, torch.device] = "cuda") -> "Image":
        a = np.asarray(arr)
        bit_depth = 8 if a.dtype == np.uint8 else (
            16 if a.dtype == np.uint16 else 32)
        if a.ndim == 2:
            a = a[..., None]
        if channels_order == ChannelsOrder.CHANNELS_LAST:
            a = np.moveaxis(a, -1, -3)
        data = torch.from_numpy(np.ascontiguousarray(a)).to(device)
        return cls(data, PixelFormat(color_space, bit_depth))

    @classmethod
    def from_file(cls, path: str, device: Union[str, torch.device] = "cuda"
                  ) -> "Image":
        from PIL import Image as PILImage
        pil = PILImage.open(path)
        mode_to_cs = {"L": ColorSpace.GRAY, "RGB": ColorSpace.RGB,
                      "RGBA": ColorSpace.RGBA}
        cs = mode_to_cs.get(pil.mode)
        if cs is None:
            pil = pil.convert("RGB")
            cs = ColorSpace.RGB
        return cls.from_numpy(np.asarray(pil), cs, device=device)

    @classmethod
    def from_dlpack(cls, capsule) -> "Image":
        return cls(torch.from_dlpack(capsule))

    def to_numpy(self) -> np.ndarray:
        return self.data.detach().cpu().numpy()

    def to_float(self) -> "Image":
        scale = 1.0 if self.data.is_floating_point() else \
            float(2**self.pixel_format.bit_depth - 1)
        return Image(as_float(self.data) / scale,
                     PixelFormat(self.pixel_format.color_space, 32))

    def to_uint8(self) -> "Image":
        if self.data.is_floating_point():
            d = (self.data * 255.0).clamp(0, 255).to(torch.uint8)
        else:
            d = self.data.to(torch.uint8)
        return Image(d, PixelFormat(self.pixel_format.color_space, 8))

    def to_gray(self) -> "Image":
        from ..ops.color import bgr_to_grayscale, rgb_to_grayscale
        img = self.to_float()
        if self.pixel_format.color_space == ColorSpace.GRAY:
            return img
        fn = (bgr_to_grayscale
              if self.pixel_format.color_space == ColorSpace.BGR
              else rgb_to_grayscale)
        data = img.data if img.is_batch else img.data[None]
        out = fn(data if data.shape[-3] == 3 else data[..., :3, :, :])
        out = out if img.is_batch else out[0]
        return Image(out, PixelFormat(ColorSpace.GRAY, 32))

    def to_rgb(self) -> "Image":
        from ..ops.color import bgr_to_rgb, grayscale_to_rgb
        img = self.to_float()
        cs = self.pixel_format.color_space
        data = img.data if img.is_batch else img.data[None]
        if cs == ColorSpace.GRAY:
            out = grayscale_to_rgb(data)
        elif cs == ColorSpace.BGR:
            out = bgr_to_rgb(data)
        elif cs == ColorSpace.RGBA:
            out = data[..., :3, :, :]
        else:
            out = data
        out = out if img.is_batch else out[0]
        return Image(out, PixelFormat(ColorSpace.RGB, 32))

    def write(self, path: str) -> None:
        from PIL import Image as PILImage
        a = self.to_uint8().to_numpy()
        if a.ndim == 4:
            a = a[0]
        a = np.moveaxis(a, 0, -1)
        if a.shape[-1] == 1:
            a = a[..., 0]
        PILImage.fromarray(a).save(path)
