"""Conditioned float32 linear algebra (counterpart of
``kornia_tpu/core/linalg.py``).

The JAX package has no float64 on its device and conditions its small
systems instead: closed-form 2x2/3x3 inverses, unrolled Gaussian
elimination with partial pivoting, Householder nullspaces, row
equilibration with iterative refinement. The port keeps the same
arithmetic, step for step, so that its results stay comparable with the
reference; it does not promote to float64 ``torch.linalg``.

All functions are batched over leading dimensions.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch

__all__ = [
    "det_2x2",
    "det_3x3",
    "inverse_2x2",
    "inverse_3x3",
    "safe_solve_with_mask",
    "safe_inverse_with_mask",
    "solve_refined",
    "lstsq_nullspace",
    "eigh_smallest",
    "symeig_3x3",
    "gauss_det",
    "gauss_solve",
    "nullspace_qr",
    "nullspace_inverse_iteration",
    "f32_precision",
    "f32_matmul_precision",
]

_EPS = 1e-12


def det_2x2(m: torch.Tensor) -> torch.Tensor:
    return m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]


def det_3x3(m: torch.Tensor) -> torch.Tensor:
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _signed_eps(det: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(det >= 0, eps, -eps)


def inverse_2x2(m: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    det = det_2x2(m)[..., None, None]
    adj = torch.stack([
        torch.stack([m[..., 1, 1], -m[..., 0, 1]], dim=-1),
        torch.stack([-m[..., 1, 0], m[..., 0, 0]], dim=-1),
    ], dim=-2)
    return adj / (det + _signed_eps(det, eps))


def inverse_3x3(m: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """Closed-form cofactor inverse."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    D = -(b * i - c * h)
    E = a * i - c * g
    F = -(a * h - b * g)
    G = b * f - c * e
    H = -(a * f - c * d)
    I = a * e - b * d
    det = (a * A + b * B + c * C)[..., None, None]
    adj_t = torch.stack([
        torch.stack([A, D, G], dim=-1),
        torch.stack([B, E, H], dim=-1),
        torch.stack([C, F, I], dim=-1),
    ], dim=-2)
    return adj_t / (det + _signed_eps(det, eps))


def _equilibrate(A: torch.Tensor, b: torch.Tensor):
    """Rows of A (and b) scaled by their largest |entry|, so that the f32
    LU is better conditioned."""
    scale = A.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(scale > 0, scale, 1.0)
    return A / scale, b / scale


def solve_refined(A: torch.Tensor, b: torch.Tensor,
                  iters: int = 1) -> torch.Tensor:
    """f32 solve with row equilibration and `iters` steps of iterative
    refinement. b: (..., n, k). A singular system is not checked (no
    host read): its solution is not finite, as the reference's is."""
    As, bs = _equilibrate(A, b)
    x = torch.linalg.solve_ex(As, bs, check_errors=False)[0]
    for _ in range(iters):
        x = x + torch.linalg.solve_ex(As, bs - As @ x,
                                      check_errors=False)[0]
    return x


def safe_solve_with_mask(B: torch.Tensor, A: torch.Tensor):
    """Solve A X = B without raising on a singular system: (X, the system
    solved (equilibrated A, the identity where singular), valid mask). X is
    zero where A is singular or the solve is not finite; one step of
    iterative refinement."""
    As, Bs = _equilibrate(A, B)
    ok = torch.linalg.det(As).abs() > _EPS
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    A_safe = torch.where(ok[..., None, None], As, eye)
    X = torch.linalg.solve(A_safe, Bs)
    X = X + torch.linalg.solve(A_safe, Bs - A_safe @ X)
    X = torch.where(ok[..., None, None], X, 0.0)
    ok = ok & torch.isfinite(X).all(dim=-1).all(dim=-1)
    return X, A_safe, ok


def safe_inverse_with_mask(A: torch.Tensor):
    """Batched inverse and validity mask: the closed forms for 2x2 and 3x3,
    else LU on the systems whose determinant is not ~0; zero where
    singular."""
    n = A.shape[-1]
    if n == 2:
        inv, ok = inverse_2x2(A), det_2x2(A).abs() > _EPS
    elif n == 3:
        inv, ok = inverse_3x3(A), det_3x3(A).abs() > _EPS
    else:
        ok = torch.linalg.det(A).abs() > _EPS
        eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)
        inv = torch.linalg.inv(torch.where(ok[..., None, None], A, eye))
    return torch.where(ok[..., None, None], inv, 0.0), ok


def lstsq_nullspace(A: torch.Tensor) -> torch.Tensor:
    """Unit null vector of A (..., M, N): the eigenvector of AᵀA with the
    smallest eigenvalue (callers Hartley-normalize first). Its sign is
    LAPACK's choice and may differ from the reference's."""
    AtA = torch.einsum("...mi,...mj->...ij", A, A)
    _, vecs = torch.linalg.eigh(AtA)
    return vecs[..., :, 0]


def eigh_smallest(S: torch.Tensor):
    """(eigenvalue, eigenvector) of the smallest eigenvalue of symmetric S;
    the vector's sign is LAPACK's choice."""
    vals, vecs = torch.linalg.eigh(S)
    return vals[..., 0], vecs[..., :, 0]


def symeig_3x3(S: torch.Tensor):
    """Eigendecomposition of batched symmetric 3x3 (ascending values; each
    vector's sign is LAPACK's choice)."""
    return torch.linalg.eigh(S)


def _pivot_rows(a: torch.Tensor, k: int, rows: torch.Tensor):
    """One partial-pivot step of the unrolled elimination: swap the row
    with the largest |a[:, k]| (rows >= k) into row k, by the same
    add/subtract arithmetic as the reference. Returns (a, pivot index)."""
    n = a.shape[-2]
    col = torch.where(rows >= k, a[..., :, k].abs(), -math.inf)
    p = col.argmax(dim=-1)
    onehot_p = torch.nn.functional.one_hot(p, n).to(a.dtype)
    rp = torch.gather(a, -2, p[..., None, None].expand(*p.shape, 1,
                                                       a.shape[-1]))[..., 0, :]
    diff = rp - a[..., k, :]
    ek = torch.zeros(n, dtype=a.dtype, device=a.device)
    ek[k] = 1.0
    a = a + ek[:, None] * diff[..., None, :] \
        - onehot_p[..., :, None] * diff[..., None, :]
    return a, p


def _eliminate(a: torch.Tensor, k: int, rows: torch.Tensor) -> torch.Tensor:
    piv = a[..., k, k]
    safe = torch.where(piv.abs() > 1e-30, piv, 1e-30)
    m = a[..., :, k] / safe[..., None]
    m = torch.where(rows > k, m, 0.0)
    return a - m[..., :, None] * a[..., k:k + 1, :]


def gauss_det(A: torch.Tensor) -> torch.Tensor:
    """Determinant of small batched matrices by unrolled Gaussian
    elimination with partial pivoting."""
    n = A.shape[-1]
    a = A
    det = torch.ones(A.shape[:-2], dtype=A.dtype, device=A.device)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        a, p = _pivot_rows(a, k, rows)
        det = det * torch.where(p == k, 1.0, -1.0).to(A.dtype)
        det = det * a[..., k, k]
        a = _eliminate(a, k, rows)
    return det


def gauss_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for small batched A (..., n, n), b (..., n) by
    unrolled partial-pivot Gaussian elimination and back substitution."""
    n = A.shape[-1]
    aug = torch.cat([A, b[..., :, None]], dim=-1)  # (..., n, n + 1)
    rows = torch.arange(n, device=A.device)
    for k in range(n):
        aug, _ = _pivot_rows(aug, k, rows)
        aug = _eliminate(aug, k, rows)
    x = torch.zeros(A.shape[:-2] + (n,), dtype=A.dtype, device=A.device)
    for k in range(n - 1, -1, -1):
        rhs = aug[..., k, n] - torch.sum(aug[..., k, :n] * x, dim=-1)
        piv = aug[..., k, k]
        safe = torch.where(piv.abs() > 1e-30, piv, 1e-30)
        x = x.clone()
        x[..., k] = rhs / safe
    return x


def nullspace_qr(A: torch.Tensor) -> torch.Tensor:
    """Orthonormal nullspace basis of wide batched A (..., R, C), R < C →
    (..., C, C - R), by unrolled Householder QR of Aᵀ (no Gram matrix, so
    the condition number is not squared)."""
    R, C = A.shape[-2], A.shape[-1]
    if R >= C:
        raise ValueError("nullspace_qr expects a wide matrix (R < C)")
    M = A.transpose(-1, -2)  # (..., C, R)
    rows = torch.arange(C, device=A.device)
    vs = []
    for k in range(R):
        x = torch.where(rows >= k, M[..., :, k], 0.0)
        xk = M[..., k, k]
        nrm = torch.linalg.vector_norm(x, dim=-1)
        alpha = -torch.sign(torch.where(xk == 0, 1.0, xk)) * nrm
        ek = torch.zeros(C, dtype=A.dtype, device=A.device)
        ek[k] = 1.0
        v = x - alpha[..., None] * ek
        vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        v = torch.where(vn > 1e-30, v / vn.clamp_min(1e-30), 0.0)
        vs.append(v)
        M = M - 2.0 * v[..., :, None] * torch.einsum(
            "...c,...cr->...r", v, M)[..., None, :]
    eye = torch.eye(C, dtype=A.dtype, device=A.device)[:, R:]
    V = torch.zeros(A.shape[:-2] + (C, C - R), dtype=A.dtype,
                    device=A.device) + eye
    for v in reversed(vs):
        V = V - 2.0 * v[..., :, None] * torch.einsum(
            "...c,...cn->...n", v, V)[..., None, :]
    return V


def nullspace_inverse_iteration(A: torch.Tensor,
                                iters: int = 2) -> torch.Tensor:
    """Unit null vector of small batched A (..., m, n) by inverse iteration
    on the regularized Gram matrix (two unrolled Gaussian solves)."""
    G = torch.einsum("...mi,...mj->...ij", A, A)
    n = G.shape[-1]
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    Greg = G + (1e-7 / n) * tr * torch.eye(n, dtype=G.dtype, device=G.device)
    v = torch.ones(G.shape[:-2] + (n,), dtype=G.dtype,
                   device=G.device) / math.sqrt(n)
    for _ in range(iters):
        v = gauss_solve(Greg, v)
        v = v / torch.linalg.vector_norm(v, dim=-1,
                                         keepdim=True).clamp_min(1e-30)
    return v


@contextlib.contextmanager
def f32_precision():
    """Run the block in true float32: TF32 off for CUDA matrix products and
    for cuDNN convolutions (cuDNN's default TF32 keeps about three decimal
    digits). Restores the previous settings on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def f32_matmul_precision(fn):
    """Decorator: run `fn` under :func:`f32_precision` — the counterpart of
    the reference's ``jax.default_matmul_precision("highest")`` guard."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with f32_precision():
            return fn(*args, **kwargs)

    return wrapped
