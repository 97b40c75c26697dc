"""Terminal image rendering (counterpart of
``kornia_tpu/image/image_print.py``): 24-bit ANSI half-block art."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["image_to_string", "print_image"]


def image_to_string(image, max_width: int = 80) -> str:
    """(C, H, W) float in [0, 1] or uint8 → ANSI string of ▀ blocks (two
    rows a character cell)."""
    a = image.detach().cpu().numpy() if torch.is_tensor(image) \
        else np.asarray(image)
    if a.ndim == 2:
        a = a[None]
    if a.dtype != np.uint8:
        a = np.clip(a * 255.0, 0, 255).astype(np.uint8)
    if a.shape[0] == 1:
        a = np.repeat(a, 3, axis=0)
    scale = max(1, int(np.ceil(a.shape[2] / max_width)))
    a = a[:, ::scale, ::scale]
    if a.shape[1] % 2:
        a = a[:, :-1]
    lines = []
    for y in range(0, a.shape[1], 2):
        row = []
        for x in range(a.shape[2]):
            tr, tg, tb = a[:, y, x]
            br, bg, bb = a[:, y + 1, x]
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    return "\n".join(lines)


def print_image(image, max_width: int = 80) -> None:
    print(image_to_string(image, max_width))
