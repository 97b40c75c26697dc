"""A pose with frame semantics (counterpart of
``kornia_tpu/geometry/pose.py``): ``NamedPose`` and ``check_matrix_shape``."""

from __future__ import annotations

import dataclasses

import torch

from .liegroup import Se3, So3

__all__ = ["NamedPose", "check_matrix_shape"]


@dataclasses.dataclass(frozen=True)
class NamedPose:
    """An Se3 pose annotated with (frame_src ← frame_dst): it maps points
    expressed in `frame_dst` into `frame_src`. Composition checks that the
    frames chain."""

    pose: Se3
    frame_src: str = "a"
    frame_dst: str = "b"

    @classmethod
    def from_rt(cls, rotation: So3, translation: torch.Tensor,
                frame_src: str = "a", frame_dst: str = "b") -> "NamedPose":
        return cls(Se3(rotation, translation), frame_src, frame_dst)

    @property
    def rotation(self) -> So3:
        return self.pose.r

    @property
    def translation(self) -> torch.Tensor:
        return self.pose.t

    def inverse(self) -> "NamedPose":
        return NamedPose(self.pose.inverse(), self.frame_dst, self.frame_src)

    def __mul__(self, other: "NamedPose") -> "NamedPose":
        if self.frame_dst != other.frame_src:
            raise ValueError(
                f"frame mismatch: {self.frame_src}<-{self.frame_dst} cannot "
                f"compose with {other.frame_src}<-{other.frame_dst}")
        return NamedPose(self.pose * other.pose, self.frame_src,
                         other.frame_dst)

    def transform(self, points: torch.Tensor) -> torch.Tensor:
        """Points in frame_dst → frame_src."""
        return self.pose.act(points)

    def matrix(self) -> torch.Tensor:
        return self.pose.matrix()


def check_matrix_shape(matrix, matrix_type: str = "R") -> None:
    """Raise unless `matrix` is a rotation ("R": 2x2 or 3x3) or a rigid
    transform ("RT": 3x3 or 4x4), batched at most once."""
    targets = {"R": ((2, 2), (3, 3)), "RT": ((3, 3), (4, 4))}[matrix_type]
    if (matrix.ndim > 3 or matrix.ndim < 2
            or tuple(matrix.shape[-2:]) not in targets):
        raise ValueError(f"{matrix_type} must have trailing shape in "
                         f"{targets}, got {tuple(matrix.shape)}")
