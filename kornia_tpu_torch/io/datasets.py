"""SLAM / odometry dataset readers (counterpart of
``kornia_tpu/io/datasets.py``): TUM RGB-D (and ETH3D, which shares its
trajectory format) and KITTI odometry, read on the host into numpy arrays
with a fixed frame count a window.

Formats:
- TUM RGB-D: `groundtruth.txt` rows `t tx ty tz qx qy qz qw`;
  `rgb.txt` / `depth.txt` rows `t path`; associate by nearest timestamp.
- KITTI odometry: `poses/NN.txt` rows are flattened 3x4 [R|t]; left
  images under `image_2/`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["TrajectoryData", "read_tum_trajectory", "read_tum_rgbd",
           "associate_timestamps", "read_kitti_poses", "TUMSequence",
           "KittiOdometrySequence"]


@dataclasses.dataclass
class TrajectoryData:
    """timestamps (N,), positions (N, 3), quaternions (N, 4) wxyz."""

    timestamps: np.ndarray
    positions: np.ndarray
    quaternions_wxyz: np.ndarray

    def __len__(self) -> int:
        return self.timestamps.shape[0]


def read_tum_trajectory(path: str) -> TrajectoryData:
    """Parse a TUM/ETH3D trajectory file: `t tx ty tz qx qy qz qw`."""
    ts, pos, quat = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split()
            if len(v) < 8:
                continue
            ts.append(float(v[0]))
            pos.append([float(v[1]), float(v[2]), float(v[3])])
            # file order is (qx, qy, qz, qw); store wxyz
            quat.append([float(v[7]), float(v[4]), float(v[5]), float(v[6])])
    return TrajectoryData(np.asarray(ts), np.asarray(pos), np.asarray(quat))


def _read_file_list(path: str) -> Tuple[np.ndarray, List[str]]:
    ts, files = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = line.split()
            if len(v) < 2:
                continue
            ts.append(float(v[0]))
            files.append(v[1])
    return np.asarray(ts), files


def associate_timestamps(t_a: np.ndarray, t_b: np.ndarray,
                         max_dt: float = 0.02
                         ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (the standard TUM
    associate.py policy). Returns index arrays (ia, ib) of equal length."""
    ia, ib = [], []
    used = np.zeros(t_b.shape[0], bool)
    order = np.searchsorted(t_b, t_a)
    for i, o in enumerate(order):
        cands = [c for c in (o - 1, o) if 0 <= c < t_b.shape[0]
                 and not used[c]]
        if not cands:
            continue
        best = min(cands, key=lambda c: abs(t_b[c] - t_a[i]))
        if abs(t_b[best] - t_a[i]) <= max_dt:
            ia.append(i)
            ib.append(best)
            used[best] = True
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def read_tum_rgbd(root: str, max_dt: float = 0.02):
    """Associate rgb.txt / depth.txt / groundtruth.txt of a TUM sequence.

    Returns (rgb_files, depth_files, gt: TrajectoryData) aligned 1:1.
    """
    t_rgb, rgb_files = _read_file_list(os.path.join(root, "rgb.txt"))
    t_d, d_files = _read_file_list(os.path.join(root, "depth.txt"))
    gt = read_tum_trajectory(os.path.join(root, "groundtruth.txt"))
    ir, idp = associate_timestamps(t_rgb, t_d, max_dt)
    ig1, ig2 = associate_timestamps(t_rgb[ir], gt.timestamps, max_dt)
    sel_rgb = ir[ig1]
    sel_d = idp[ig1]
    sel_gt = ig2
    return ([os.path.join(root, rgb_files[i]) for i in sel_rgb],
            [os.path.join(root, d_files[i]) for i in sel_d],
            TrajectoryData(gt.timestamps[sel_gt], gt.positions[sel_gt],
                           gt.quaternions_wxyz[sel_gt]))


def read_kitti_poses(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """KITTI odometry pose file: rows of flattened 3x4 [R|t].

    Returns (R (N, 3, 3), t (N, 3))."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    return rows[:, :, :3], rows[:, :, 3]


class TUMSequence:
    """Windowed iterator over an associated TUM RGB-D sequence.

    Yields dicts with fixed-shape numpy stacks (window, H, W[, C]) plus the
    aligned ground-truth slice. Images load through ``io.load_image`` on
    the host (the native JPEG/PNG decoder where it is built)."""

    def __init__(self, root: str, window: int = 5, stride: int = 1,
                 grayscale: bool = True, max_dt: float = 0.02):
        self.rgb, self.depth, self.gt = read_tum_rgbd(root, max_dt)
        self.window = window
        self.stride = stride
        self.grayscale = grayscale

    def __len__(self) -> int:
        n = len(self.rgb) - self.window + 1
        return max(0, (n + self.stride - 1) // self.stride)

    def _load(self, path: str) -> np.ndarray:
        from .io import load_image
        img = load_image(path, device="cpu").numpy()
        if self.grayscale and img.ndim == 3 and img.shape[0] == 3:
            img = (0.299 * img[0] + 0.587 * img[1] + 0.114 * img[2])[None]
        return img

    def __getitem__(self, i: int):
        s = i * self.stride
        idx = range(s, s + self.window)
        return {
            "images": np.stack([self._load(self.rgb[j]) for j in idx]),
            "positions": self.gt.positions[s:s + self.window],
            "quaternions_wxyz":
                self.gt.quaternions_wxyz[s:s + self.window],
            "timestamps": self.gt.timestamps[s:s + self.window],
        }


class KittiOdometrySequence:
    """Windowed KITTI odometry reader: images from `image_2/`, poses from
    the flattened-3x4 pose file."""

    def __init__(self, image_dir: str, pose_file: str, window: int = 5,
                 stride: int = 1):
        self.files = sorted(
            os.path.join(image_dir, f) for f in os.listdir(image_dir)
            if f.endswith((".png", ".jpg")))
        self.R, self.t = read_kitti_poses(pose_file)
        n = min(len(self.files), self.R.shape[0])
        self.files, self.R, self.t = self.files[:n], self.R[:n], self.t[:n]
        self.window = window
        self.stride = stride

    def __len__(self) -> int:
        n = len(self.files) - self.window + 1
        return max(0, (n + self.stride - 1) // self.stride)

    def __getitem__(self, i: int):
        from .io import load_image
        s = i * self.stride
        idx = range(s, s + self.window)
        return {
            "images": np.stack(
                [load_image(self.files[j], device="cpu").numpy()
                 for j in idx]),
            "R": self.R[s:s + self.window],
            "t": self.t[s:s + self.window],
        }
