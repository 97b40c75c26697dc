"""Lie groups So2/Se2/So3/Se3 and Quaternion (counterpart of
``kornia_tpu/geometry/liegroup.py``).

Each element is a frozen dataclass of tensors, batched over any leading
dimensions. Quaternions are wxyz; So3 is a unit quaternion and Se3 is
(So3, t). The exp/log maps keep the reference's guards (a floor inside
every ``sqrt``, Taylor branches behind ``torch.where``), so that their
values and ``torch.func.jacfwd`` Jacobians are finite at tangent zero,
where bundle adjustment and the pose graph linearise. Nothing here reads a
tensor on the host or writes in place, so every operation composes with
``torch.func.vmap`` and ``jacfwd``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .conversions import (
    angle_axis_to_quaternion,
    normalize_quaternion,
    quaternion_to_angle_axis,
    quaternion_to_rotation_matrix,
    rotation_matrix_to_quaternion,
    vector_to_skew_symmetric_matrix,
)

__all__ = ["Quaternion", "So3", "Se3", "So2", "Se2"]

_EPS = 1e-8


def _qmul(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    pw, px, py, pz = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        pw * qw - px * qx - py * qy - pz * qz,
        pw * qx + px * qw + py * qz - pz * qy,
        pw * qy - px * qz + py * qw + pz * qx,
        pw * qz + px * qy - py * qx + pz * qw,
    ], dim=-1)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., i, j) · (..., j) → (..., i)."""
    return (M @ v[..., None])[..., 0]


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


@dataclasses.dataclass(frozen=True)
class Quaternion:
    """Quaternion (..., 4) wxyz."""

    data: torch.Tensor

    @classmethod
    def identity(cls, batch_shape: Tuple[int, ...] = (),
                 dtype=torch.float32, device=None) -> "Quaternion":
        q = torch.zeros((*batch_shape, 4), dtype=dtype, device=device)
        q[..., 0] = 1.0
        return cls(q)

    @classmethod
    def from_coeffs(cls, w, x, y, z) -> "Quaternion":
        return cls(torch.stack([torch.as_tensor(c, dtype=torch.float32)
                                for c in (w, x, y, z)], dim=-1))

    @classmethod
    def from_axis_angle(cls, axis_angle: torch.Tensor) -> "Quaternion":
        return cls(angle_axis_to_quaternion(axis_angle))

    @classmethod
    def from_matrix(cls, R: torch.Tensor) -> "Quaternion":
        return cls(rotation_matrix_to_quaternion(R))

    @classmethod
    def random(cls, batch_shape: Tuple[int, ...] = (),
               generator: Optional[torch.Generator] = None,
               device=None) -> "Quaternion":
        """Uniform random unit quaternion (Shoemake)."""
        r1, r2, r3 = torch.rand((3, *batch_shape), generator=generator,
                                device=device)
        s1 = torch.sqrt(1.0 - r1)
        s2 = torch.sqrt(r1)
        t1 = 2.0 * math.pi * r2
        t2 = 2.0 * math.pi * r3
        return cls(torch.stack([torch.cos(t2) * s2, torch.sin(t1) * s1,
                                torch.cos(t1) * s1, torch.sin(t2) * s2],
                               dim=-1))

    @property
    def w(self):
        return self.data[..., 0]

    @property
    def x(self):
        return self.data[..., 1]

    @property
    def y(self):
        return self.data[..., 2]

    @property
    def z(self):
        return self.data[..., 3]

    @property
    def vec(self):
        return self.data[..., 1:]

    @property
    def real(self):
        return self.w

    @property
    def shape(self):
        return self.data.shape[:-1]

    def __mul__(self, other: "Quaternion") -> "Quaternion":
        return Quaternion(_qmul(self.data, other.data))

    def __add__(self, other: "Quaternion") -> "Quaternion":
        return Quaternion(self.data + other.data)

    def __sub__(self, other: "Quaternion") -> "Quaternion":
        return Quaternion(self.data - other.data)

    def __neg__(self) -> "Quaternion":
        return Quaternion(-self.data)

    def conj(self) -> "Quaternion":
        return Quaternion(torch.cat([self.data[..., :1], -self.data[..., 1:]],
                                    dim=-1))

    def inv(self) -> "Quaternion":
        n2 = (self.data * self.data).sum(-1, keepdim=True)
        return Quaternion(self.conj().data / n2.clamp_min(_EPS))

    def norm(self) -> torch.Tensor:
        return torch.linalg.vector_norm(self.data, dim=-1)

    def normalize(self) -> "Quaternion":
        return Quaternion(normalize_quaternion(self.data))

    def matrix(self) -> torch.Tensor:
        return quaternion_to_rotation_matrix(self.data)

    def to_axis_angle(self) -> torch.Tensor:
        return quaternion_to_angle_axis(self.data)

    def slerp(self, other: "Quaternion", t) -> "Quaternion":
        """Spherical interpolation; normalised lerp for nearly parallel
        quaternions."""
        q0 = normalize_quaternion(self.data)
        q1 = normalize_quaternion(other.data)
        dot = (q0 * q1).sum(-1, keepdim=True)
        q1 = torch.where(dot < 0, -q1, q1)
        dot = dot.abs()
        theta = torch.acos(dot.clamp(-1.0, 1.0))
        sin_theta = torch.sin(theta).clamp_min(_EPS)
        t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
        w0 = torch.where(dot > 1.0 - 1e-6, 1.0 - t,
                         torch.sin((1.0 - t) * theta) / sin_theta)
        w1 = torch.where(dot > 1.0 - 1e-6, t,
                         torch.sin(t * theta) / sin_theta)
        return Quaternion(normalize_quaternion(w0 * q0 + w1 * q1))

    @staticmethod
    def average(quats: torch.Tensor,
                weights: Optional[torch.Tensor] = None) -> "Quaternion":
        """Markley average of (N, 4): the largest eigenvector of the
        weighted outer-product sum."""
        q = quats
        if weights is None:
            weights = torch.full((q.shape[0],), 1.0 / q.shape[0],
                                 dtype=q.dtype, device=q.device)
        A = torch.einsum("n,ni,nj->ij", weights, q, q)
        _, vecs = torch.linalg.eigh(A)
        avg = vecs[:, -1]
        return Quaternion(torch.where(avg[0] < 0, -avg, avg))


@dataclasses.dataclass(frozen=True)
class So3:
    """3-D rotation as a unit quaternion."""

    q: Quaternion

    @property
    def shape(self):
        return self.q.shape

    @classmethod
    def identity(cls, batch_shape: Tuple[int, ...] = (),
                 dtype=torch.float32, device=None) -> "So3":
        return cls(Quaternion.identity(batch_shape, dtype, device))

    @classmethod
    def from_matrix(cls, R: torch.Tensor) -> "So3":
        return cls(Quaternion.from_matrix(R))

    @classmethod
    def from_wxyz(cls, wxyz: torch.Tensor) -> "So3":
        return cls(Quaternion(normalize_quaternion(wxyz)))

    @classmethod
    def random(cls, batch_shape: Tuple[int, ...] = (),
               generator: Optional[torch.Generator] = None,
               device=None) -> "So3":
        return cls(Quaternion.random(batch_shape, generator, device))

    @staticmethod
    def exp(v: torch.Tensor) -> "So3":
        """Tangent (..., 3) → group element."""
        return So3(Quaternion(angle_axis_to_quaternion(v)))

    def log(self) -> torch.Tensor:
        return quaternion_to_angle_axis(self.q.normalize().data)

    @staticmethod
    def hat(v: torch.Tensor) -> torch.Tensor:
        return vector_to_skew_symmetric_matrix(v)

    @staticmethod
    def vee(omega: torch.Tensor) -> torch.Tensor:
        return torch.stack([omega[..., 2, 1], omega[..., 0, 2],
                            omega[..., 1, 0]], dim=-1)

    def __mul__(self, other):
        if isinstance(other, So3):
            return So3(self.q * other.q)
        return self.act(other)

    def act(self, pts: torch.Tensor) -> torch.Tensor:
        """Rotate points (..., 3) or (..., N, 3)."""
        R = self.matrix()
        if pts.ndim == R.ndim - 1:
            return _matvec(R, pts)
        return pts @ R.transpose(-1, -2)

    def inverse(self) -> "So3":
        return So3(self.q.conj())

    def matrix(self) -> torch.Tensor:
        return self.q.matrix()

    def adjoint(self) -> torch.Tensor:
        return self.matrix()


@dataclasses.dataclass(frozen=True)
class Se3:
    """3-D rigid transform (So3, t (..., 3))."""

    r: So3
    t: torch.Tensor

    @property
    def shape(self):
        return self.t.shape[:-1]

    @property
    def rotation(self) -> So3:
        return self.r

    @property
    def translation(self) -> torch.Tensor:
        return self.t

    @classmethod
    def identity(cls, batch_shape: Tuple[int, ...] = (),
                 dtype=torch.float32, device=None) -> "Se3":
        return cls(So3.identity(batch_shape, dtype, device),
                   torch.zeros((*batch_shape, 3), dtype=dtype,
                               device=device))

    @classmethod
    def from_matrix(cls, M: torch.Tensor) -> "Se3":
        return cls(So3.from_matrix(M[..., :3, :3]), M[..., :3, 3])

    @classmethod
    def from_qt(cls, q: torch.Tensor, t: torch.Tensor) -> "Se3":
        return cls(So3.from_wxyz(q), t)

    @classmethod
    def random(cls, batch_shape: Tuple[int, ...] = (),
               generator: Optional[torch.Generator] = None,
               device=None) -> "Se3":
        r = So3.random(batch_shape, generator, device)
        return cls(r, torch.randn((*batch_shape, 3), generator=generator,
                                  device=device))

    @staticmethod
    def exp(v: torch.Tensor) -> "Se3":
        """Tangent (..., 6) = (rho, omega) → group element: the closed-form
        V matrix with Taylor branches below θ² < 1e-8."""
        rho = v[..., :3]
        omega = v[..., 3:]
        theta2 = (omega * omega).sum(-1)[..., None, None]
        theta = torch.sqrt(theta2.clamp_min(1e-20))
        K = vector_to_skew_symmetric_matrix(omega)
        K2 = K @ K
        small = theta2 < 1e-8
        A = torch.where(small, 0.5 - theta2 / 24.0,
                        (1.0 - torch.cos(theta)) / theta2.clamp_min(1e-20))
        B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                        (theta - torch.sin(theta))
                        / (theta2 * theta).clamp_min(1e-20))
        V = _eye(3, v) + A * K + B * K2
        return Se3(So3.exp(omega), _matvec(V, rho))

    def log(self) -> torch.Tensor:
        """Group element → (..., 6) = (rho, omega)."""
        omega = self.r.log()
        theta2 = (omega * omega).sum(-1)[..., None, None]
        theta = torch.sqrt(theta2.clamp_min(1e-20))
        K = vector_to_skew_symmetric_matrix(omega)
        K2 = K @ K
        half_theta = 0.5 * theta
        # V⁻¹ = I - K/2 + (1/θ² - cot(θ/2)/(2θ)) K²
        cot_term = 1.0 / theta2.clamp_min(1e-20) - torch.cos(half_theta) / (
            2.0 * (theta * torch.sin(half_theta)).clamp_min(1e-20))
        coeff = torch.where(theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0,
                            cot_term)
        V_inv = _eye(3, omega) - 0.5 * K + coeff * K2
        return torch.cat([_matvec(V_inv, self.t), omega], dim=-1)

    @staticmethod
    def hat(v: torch.Tensor) -> torch.Tensor:
        """(..., 6) → (..., 4, 4)."""
        K = vector_to_skew_symmetric_matrix(v[..., 3:])
        top = torch.cat([K, v[..., :3, None]], dim=-1)
        bottom = torch.zeros((*v.shape[:-1], 1, 4), dtype=v.dtype,
                             device=v.device)
        return torch.cat([top, bottom], dim=-2)

    @staticmethod
    def vee(omega: torch.Tensor) -> torch.Tensor:
        return torch.cat([omega[..., :3, 3], So3.vee(omega[..., :3, :3])],
                         dim=-1)

    def __mul__(self, other):
        if isinstance(other, Se3):
            return Se3(self.r * other.r, self.r.act(other.t) + self.t)
        return self.act(other)

    def act(self, pts: torch.Tensor) -> torch.Tensor:
        out = self.r.act(pts)
        if pts.ndim == self.t.ndim:
            return out + self.t
        return out + self.t[..., None, :]

    def inverse(self) -> "Se3":
        rinv = self.r.inverse()
        return Se3(rinv, -rinv.act(self.t))

    def matrix(self) -> torch.Tensor:
        R = self.r.matrix()
        top = torch.cat([R, self.t[..., :, None]], dim=-1)
        bottom = torch.zeros((*self.shape, 1, 4), dtype=self.t.dtype,
                             device=self.t.device)
        bottom[..., 0, 3] = 1.0
        return torch.cat([top, bottom], dim=-2)

    def adjoint(self) -> torch.Tensor:
        R = self.r.matrix()
        tK = vector_to_skew_symmetric_matrix(self.t)
        top = torch.cat([R, tK @ R], dim=-1)
        bottom = torch.cat([torch.zeros_like(R), R], dim=-1)
        return torch.cat([top, bottom], dim=-2)


@dataclasses.dataclass(frozen=True)
class So2:
    """2-D rotation as a unit complex number, stored (..., 2) = (re, im)."""

    z: torch.Tensor

    @property
    def shape(self):
        return self.z.shape[:-1]

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32,
                 device=None) -> "So2":
        z = torch.zeros((*batch_shape, 2), dtype=dtype, device=device)
        z[..., 0] = 1.0
        return cls(z)

    @staticmethod
    def exp(theta: torch.Tensor) -> "So2":
        return So2(torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1))

    def log(self) -> torch.Tensor:
        return torch.atan2(self.z[..., 1], self.z[..., 0])

    @staticmethod
    def hat(theta: torch.Tensor) -> torch.Tensor:
        zeros = torch.zeros_like(theta)
        return torch.stack([torch.stack([zeros, -theta], -1),
                            torch.stack([theta, zeros], -1)], dim=-2)

    @staticmethod
    def vee(omega: torch.Tensor) -> torch.Tensor:
        return omega[..., 1, 0]

    def matrix(self) -> torch.Tensor:
        c, s = self.z[..., 0], self.z[..., 1]
        return torch.stack([torch.stack([c, -s], -1),
                            torch.stack([s, c], -1)], dim=-2)

    def __mul__(self, other):
        if isinstance(other, So2):
            a, b = self.z[..., 0], self.z[..., 1]
            c, d = other.z[..., 0], other.z[..., 1]
            return So2(torch.stack([a * c - b * d, a * d + b * c], dim=-1))
        return self.act(other)

    def act(self, pts: torch.Tensor) -> torch.Tensor:
        R = self.matrix()
        if pts.shape[-1] == 2 and pts.ndim == R.ndim - 1:
            return _matvec(R, pts)
        return pts @ R.transpose(-1, -2)

    def inverse(self) -> "So2":
        return So2(torch.stack([self.z[..., 0], -self.z[..., 1]], dim=-1))


@dataclasses.dataclass(frozen=True)
class Se2:
    """2-D rigid transform (So2, t (..., 2))."""

    r: So2
    t: torch.Tensor

    @property
    def shape(self):
        return self.t.shape[:-1]

    @classmethod
    def identity(cls, batch_shape=(), dtype=torch.float32,
                 device=None) -> "Se2":
        return cls(So2.identity(batch_shape, dtype, device),
                   torch.zeros((*batch_shape, 2), dtype=dtype,
                               device=device))

    @staticmethod
    def _v_coeffs(theta: torch.Tensor):
        small = theta.abs() < 1e-6
        theta_safe = torch.where(small, 1.0, theta)
        a = torch.where(small, 1.0 - theta ** 2 / 6.0,
                        torch.sin(theta) / theta_safe)
        b = torch.where(small, theta / 2.0,
                        (1.0 - torch.cos(theta)) / theta_safe)
        return a, b

    @staticmethod
    def exp(v: torch.Tensor) -> "Se2":
        """(..., 3) = (tx, ty, theta)."""
        theta = v[..., 2]
        a, b = Se2._v_coeffs(theta)
        V = torch.stack([torch.stack([a, -b], -1),
                         torch.stack([b, a], -1)], dim=-2)
        return Se2(So2.exp(theta), _matvec(V, v[..., :2]))

    def log(self) -> torch.Tensor:
        theta = self.r.log()
        a, b = Se2._v_coeffs(theta)
        det = a * a + b * b
        Vinv = torch.stack([torch.stack([a, b], -1),
                            torch.stack([-b, a], -1)], dim=-2) \
            / det.clamp_min(_EPS)[..., None, None]
        return torch.cat([_matvec(Vinv, self.t), theta[..., None]], dim=-1)

    def __mul__(self, other):
        if isinstance(other, Se2):
            return Se2(self.r * other.r, self.r.act(other.t) + self.t)
        return self.act(other)

    def act(self, pts: torch.Tensor) -> torch.Tensor:
        out = self.r.act(pts)
        if pts.ndim == self.t.ndim:
            return out + self.t
        return out + self.t[..., None, :]

    def inverse(self) -> "Se2":
        rinv = self.r.inverse()
        return Se2(rinv, -rinv.act(self.t))

    def matrix(self) -> torch.Tensor:
        R = self.r.matrix()
        top = torch.cat([R, self.t[..., :, None]], dim=-1)
        bottom = torch.zeros((*self.shape, 1, 3), dtype=self.t.dtype,
                             device=self.t.device)
        bottom[..., 0, 2] = 1.0
        return torch.cat([top, bottom], dim=-2)
