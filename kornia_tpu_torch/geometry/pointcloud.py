"""Point clouds in ASCII PLY files (counterpart of
``kornia_tpu/geometry/pointcloud.py``). The files are the reference's, byte
for byte: each coordinate is written as numpy prints a float32 scalar, so
either library reads back what the other wrote."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["save_pointcloud_ply", "load_pointcloud_ply"]


def save_pointcloud_ply(filename: str, pointcloud: torch.Tensor) -> None:
    """(N, 3) or (H, W, 3) points; non-finite points are dropped."""
    pts = pointcloud.detach().to("cpu", torch.float32).numpy().reshape(-1, 3)
    pts = pts[np.isfinite(pts).all(axis=1)]
    with open(filename, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {pts.shape[0]}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def load_pointcloud_ply(filename: str, device="cuda") -> torch.Tensor:
    """(N, 3) float32 points of an ASCII PLY file as written above."""
    with open(filename) as f:
        lines = f.readlines()
    n, start = 0, 0
    for i, line in enumerate(lines):
        if line.startswith("element vertex"):
            n = int(line.split()[-1])
        if line.strip() == "end_header":
            start = i + 1
            break
    pts = np.loadtxt(lines[start:start + n], dtype=np.float32)
    return torch.from_numpy(pts.reshape(-1, 3)).to(device)
