"""Image file IO (counterpart of ``kornia_tpu/io/io.py``): the native
libjpeg / libpng decoder where it is built, PIL otherwise; the decoded
array moves to the device once. PIL is imported when it is used."""

from __future__ import annotations

import enum
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["ImageLoadType", "load_image", "write_image"]


class ImageLoadType(enum.Enum):
    UNCHANGED = 0
    GRAY8 = 1
    RGB8 = 2
    RGBA8 = 3
    GRAY32 = 4
    RGB32 = 5


_FLOAT_TYPES = (ImageLoadType.GRAY32, ImageLoadType.RGB32)
_GRAY_TYPES = (ImageLoadType.GRAY8, ImageLoadType.GRAY32)


def _decode(path: str, desired_type: ImageLoadType) -> np.ndarray:
    """The file as a (C, H, W) uint8 array of the desired channels."""
    from .native import native_available, read_image_native
    if native_available() and path.lower().endswith(
            (".jpg", ".jpeg", ".png")) and desired_type in (
            ImageLoadType.RGB8, ImageLoadType.RGB32, ImageLoadType.GRAY8,
            ImageLoadType.GRAY32):
        arr = read_image_native(path)  # (H, W, 3) uint8
        if desired_type in _GRAY_TYPES:
            arr = (0.299 * arr[..., 0] + 0.587 * arr[..., 1]
                   + 0.114 * arr[..., 2]).astype(np.uint8)[..., None]
        return np.moveaxis(arr, -1, 0)
    from PIL import Image as PILImage
    with PILImage.open(path) as pil:
        if desired_type in _GRAY_TYPES:
            pil = pil.convert("L")
        elif desired_type in (ImageLoadType.RGB8, ImageLoadType.RGB32):
            pil = pil.convert("RGB")
        elif desired_type == ImageLoadType.RGBA8:
            pil = pil.convert("RGBA")
        arr = np.asarray(pil)
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.moveaxis(arr, -1, 0)


def load_image(path: str, desired_type: ImageLoadType = ImageLoadType.RGB32,
               device: Optional[Union[str, torch.device]] = None
               ) -> torch.Tensor:
    """A file → (C, H, W) tensor on `device` (the card when None): uint8
    for the 8-bit types and UNCHANGED, float32 in [0, 1] for GRAY32 and
    RGB32."""
    arr = _decode(path, desired_type)
    if desired_type in _FLOAT_TYPES:
        arr = arr.astype(np.float32) / 255.0
    out = torch.from_numpy(np.array(arr))  # PIL's arrays are read-only
    return out.to("cuda" if device is None else device)


def write_image(path: str, image: torch.Tensor) -> None:
    """(C, H, W) (or the first of a batch) uint8, or float in [0, 1] →
    file, its format from the suffix."""
    from PIL import Image as PILImage
    a = image.detach().cpu().numpy() if torch.is_tensor(image) \
        else np.asarray(image)
    if a.ndim == 4:
        a = a[0]
    if np.issubdtype(a.dtype, np.floating):
        a = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    a = np.moveaxis(a, 0, -1)
    if a.shape[-1] == 1:
        a = a[..., 0]
    PILImage.fromarray(a).save(path)
