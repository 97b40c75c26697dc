"""Colour maps (counterpart of ``kornia_tpu/ops/colormap.py``): the port's
own copy of the reference's tables (a 16-anchor viridis cut to 11, and
analytic jet, gray, autumn and hot), resampled to `num_colors` and applied
by ``ops/color.py::apply_colormap``."""

from __future__ import annotations

import enum
from typing import Optional, Union

import numpy as np
import torch

from .color import apply_colormap

__all__ = ["ColorMapType", "ColorMap", "ApplyColorMap"]

Device = Optional[Union[str, torch.device]]

# 16-anchor viridis (matplotlib data, subsampled)
_VIRIDIS = np.array([
    [0.267004, 0.004874, 0.329415], [0.282623, 0.140926, 0.457517],
    [0.253935, 0.265254, 0.529983], [0.206756, 0.371758, 0.553117],
    [0.163625, 0.471133, 0.558148], [0.127568, 0.566949, 0.550556],
    [0.134692, 0.658636, 0.517649], [0.266941, 0.748751, 0.440573],
    [0.477504, 0.821444, 0.318195], [0.741388, 0.873449, 0.149561],
    [0.993248, 0.906157, 0.143936],
], np.float32)


def _ramp(n: int = 64) -> np.ndarray:
    return np.linspace(0, 1, n)


def _jet(n: int = 64) -> np.ndarray:
    t = _ramp(n)
    return np.stack([np.clip(1.5 - np.abs(4 * t - c), 0, 1)
                     for c in (3, 2, 1)], -1).astype(np.float32)


def _gray(n: int = 64) -> np.ndarray:
    t = _ramp(n).astype(np.float32)
    return np.stack([t, t, t], -1)


def _autumn(n: int = 64) -> np.ndarray:
    t = _ramp(n).astype(np.float32)
    return np.stack([np.ones_like(t), t, np.zeros_like(t)], -1)


def _hot(n: int = 64) -> np.ndarray:
    t = _ramp(n)
    return np.stack([np.clip(3 * t - c, 0, 1) for c in (0, 1, 2)],
                    -1).astype(np.float32)


class ColorMapType(enum.Enum):
    viridis = "viridis"
    jet = "jet"
    gray = "gray"
    autumn = "autumn"
    hot = "hot"


_TABLES = {
    ColorMapType.viridis: _VIRIDIS,
    ColorMapType.jet: _jet(),
    ColorMapType.gray: _gray(),
    ColorMapType.autumn: _autumn(),
    ColorMapType.hot: _hot(),
}


class ColorMap:
    """A base table resampled (linearly, on the host) to `num_colors`
    colours, held as an (N, 3) float32 tensor on `device`."""

    def __init__(self, base: Union[ColorMapType, str] = ColorMapType.viridis,
                 num_colors: int = 64, device: Device = "cuda"):
        if isinstance(base, str):
            base = ColorMapType(base)
        table = _TABLES[base]
        t = np.linspace(0, 1, num_colors)
        src = np.linspace(0, 1, table.shape[0])
        out = np.stack([np.interp(t, src, table[:, i]) for i in range(3)], -1)
        self.colors = torch.as_tensor(out, dtype=torch.float32,
                                      device=device)

    def __len__(self):
        return self.colors.shape[0]

    def __call__(self, gray: torch.Tensor) -> torch.Tensor:
        return apply_colormap(gray, self.colors)


class ApplyColorMap:
    def __init__(self, colormap: ColorMap):
        self.colormap = colormap

    def __call__(self, gray: torch.Tensor) -> torch.Tensor:
        return self.colormap(gray)
