"""Multiple Kernel local Descriptor, MKD (counterpart of
``kornia_tpu/feature/mkd.py``; "Understanding and Improving Kernel Local
Descriptors", Mukundan et al. 2019).

The descriptor is a 5x5 Gaussian blur (the fused blur kernel on the card),
polar gradients, a von Mises embedding of the orientations and a fixed
spatial embedding, contracted over the patch, then an optional whitening.
Every embedding table is fixed at construction: the classes keep them on
the host and copy each to a device once, at first use there
(``core/dtype.py::device_table``), one copy per device and per object.
The trained whitening models are not in the repository, so
``whitening_model`` is an explicit argument (dict[algo] of 'mean',
'eigvecs', 'eigvals'; ``load_whitening_from_torch`` reads the published
file's layout).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..core.dtype import as_float, device_table
from ..core.grid import create_meshgrid
from ..core.linalg import f32_matmul_precision
from ..geometry.conversions import cart2pol
from ..ops.filters import gaussian_blur2d, spatial_gradient

__all__ = [
    "MKDGradients", "VonMisesKernel", "EmbedGradients",
    "ExplicitSpacialEncoding", "Whitening", "MKDDescriptor", "SimpleKD",
    "get_grid_dict", "get_kron_order", "spatial_kernel_embedding",
    "load_whitening_from_torch",
]

Device = Optional[Union[str, torch.device]]

_SQRT2 = 1.4142135623730951
COEFFS: Dict[str, List[float]] = {
    "xy": [0.38214156, 0.48090413],
    "rhophi": [0.14343168, 0.268285, 0.21979234],
    "theta": [0.14343168, 0.268285, 0.21979234, 0.15838885],
}


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def get_grid_dict(patch_size: int = 32,
                  device: Device = None) -> Dict[str, torch.Tensor]:
    """The patch grid in cartesian ('x', 'y') and polar ('rho', 'phi')
    form, each (PS, PS), on `device` (default the CPU)."""
    kgrid = create_meshgrid(patch_size, patch_size,
                            normalized_coordinates=True,
                            device=torch.device(device or "cpu"))
    x = kgrid[0, :, :, 0]
    y = kgrid[0, :, :, 1]
    rho, phi = cart2pol(x, y)
    return {"x": x, "y": y, "rho": rho, "phi": phi}


def get_kron_order(d1: int, d2: int) -> torch.Tensor:
    """(d1·d2, 2) index pairs of a Kronecker product, the first index
    major."""
    g1, g2 = torch.meshgrid(torch.arange(d1), torch.arange(d2),
                            indexing="ij")
    return torch.stack([g1, g2], dim=2).reshape(-1, 2)


class MKDGradients:
    """(B, 1, H, W) patches → (B, 2, H, W): gradient magnitude and
    orientation (central differences, negated, not normalised)."""

    eps = 1e-8

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = as_float(x)
        grads = -spatial_gradient(x, "diff", 1, normalized=False)
        mags, oris = cart2pol(grads[:, :, 0], grads[:, :, 1], self.eps)
        return torch.cat([mags, oris], dim=1)

    forward = __call__


class VonMisesKernel:
    """The von Mises kernel's feature map: weights · [1, cos kx, sin kx],
    k = 1..n, along the channels ((B, 1, ...) → (B, 2n + 1, ...))."""

    def __init__(self, patch_size: int, coeffs):
        self.patch_size = patch_size
        b = np.asarray(coeffs, np.float32)
        n = len(coeffs) - 1
        self.n = n
        self.d = 2 * n + 1
        self._frange = (np.arange(n, dtype=np.float32) + 1).reshape(-1, 1, 1)
        w = np.concatenate([np.sqrt(b), np.sqrt(b[1:])])
        self._weights = w.reshape(-1, 1, 1).astype(np.float32)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = as_float(x)
        fr = device_table(self, "frange", self._frange, x.device) * x
        emb = torch.cat([torch.ones_like(x), torch.cos(fr), torch.sin(fr)],
                        dim=1)
        return device_table(self, "weights", self._weights, x.device) * emb

    forward = __call__


class EmbedGradients:
    """The von Mises embedding of the orientations (relative to the polar
    angle of each pixel when `relative`), weighted by the square root of
    the magnitudes: (B, 2, H, W) → (B, 7, H, W)."""

    eps = 1e-8

    def __init__(self, patch_size: int = 32, relative: bool = False):
        self.patch_size = patch_size
        self.relative = relative
        self.kernel = VonMisesKernel(patch_size, COEFFS["theta"])
        kgrid = create_meshgrid(patch_size, patch_size,
                                normalized_coordinates=True,
                                device=torch.device("cpu"))
        self._phi = _host(cart2pol(kgrid[..., 0], kgrid[..., 1])[1])

    def __call__(self, grads: torch.Tensor) -> torch.Tensor:
        mags = grads[:, :1]
        oris = grads[:, 1:]
        if self.relative:
            oris = oris - device_table(self, "phi", self._phi, grads.device)
        return self.kernel(oris) * torch.sqrt(mags + self.eps)

    forward = __call__


def spatial_kernel_embedding(kernel_type: str,
                             grids: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The position embedding of the patch grid, cartesian ('cart') or
    polar: the Kronecker product of two von Mises feature maps,
    (d², PS, PS)."""
    factors = {"phi": 1.0, "rho": np.pi / _SQRT2, "x": np.pi / 2,
               "y": np.pi / 2}
    if kernel_type == "cart":
        coeffs_, params_ = "xy", ["x", "y"]
    else:
        coeffs_, params_ = "rhophi", ["phi", "rho"]
    patch_size = next(iter(grids.values())).shape[-1]
    normed = {k: (v * factors[k])[None, None] for k, v in grids.items()}
    vm = VonMisesKernel(patch_size, COEFFS[coeffs_])
    emb_a = vm(normed[params_[0]])[0]
    emb_b = vm(normed[params_[1]])[0]
    kron = get_kron_order(vm.d, vm.d).to(emb_a.device)
    return emb_a[kron[:, 0]] * emb_b[kron[:, 1]]


class ExplicitSpacialEncoding:
    """The Kronecker product of the feature embedding (in_dims channels)
    and the position embedding, summed over the patch: (B, in_dims, H, W)
    → (B, in_dims · d_emb), L2-normalised when `do_l2`. The sum over the
    patch is one (B, in_dims, HW) x (HW, d_emb) product."""

    def __init__(self, kernel_type: str = "polar", fmap_size: int = 32,
                 in_dims: int = 7, do_gmask: bool = True,
                 do_l2: bool = True):
        if kernel_type not in ("polar", "cart"):
            raise NotImplementedError(
                f"{kernel_type} is not valid, use polar or cart")
        self.kernel_type = kernel_type
        self.fmap_size = fmap_size
        self.in_dims = in_dims
        self.do_gmask = do_gmask
        self.do_l2 = do_l2
        self.grid = get_grid_dict(fmap_size)
        emb = spatial_kernel_embedding(kernel_type, self.grid)
        if do_gmask:
            norm_rho = self.grid["rho"] / self.grid["rho"].max()
            emb = emb * torch.exp(-(norm_rho ** 2))
        self.d_emb = emb.shape[0]
        self.out_dims = self.odims = in_dims * self.d_emb
        # (HW, d_emb): the embedding as the right factor of the contraction
        self._emb = _host(emb.reshape(self.d_emb, -1).T.contiguous())

    @f32_matmul_precision
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        B, C = x.shape[:2]
        emb = device_table(self, "emb", self._emb, x.device, x.dtype)
        out = (x.reshape(B, C, -1) @ emb).reshape(B, -1)
        if self.do_l2:
            out = out / torch.linalg.vector_norm(
                out, dim=1, keepdim=True).clamp_min(1e-12)
        return out

    forward = __call__


class Whitening:
    """Descriptor whitening: supervised ('lw') or unsupervised ('pca',
    'pcaws', 'pcawt'), from `whitening_model` (dict[algo] of 'mean',
    'eigvecs', 'eigvals'; without it the identity); then a signed power
    and an L2 normalisation."""

    def __init__(self, xform: str, whitening_model, in_dims: int,
                 output_dims: int = 128, keval: int = 40, t: float = 0.7):
        self.xform = xform
        self.in_dims = in_dims
        self.keval = keval
        self.t = t
        self.pval = 1.0
        output_dims = min(output_dims, in_dims)
        self.output_dims = output_dims
        mean = np.zeros(in_dims, np.float32)
        evecs = np.eye(in_dims, dtype=np.float32)[:, :output_dims]
        if whitening_model is not None:
            m = whitening_model["lw" if xform == "lw" else "pca"]
            mean = np.asarray(m["mean"], np.float32)
            evecs = np.asarray(m["eigvecs"], np.float32)[:, :output_dims]
            evals = np.asarray(m["eigvals"], np.float32)[:output_dims]
            if xform == "pca":
                self.pval = 0.5
            elif xform == "pcaws":
                alpha = evals[keval]
                evecs = evecs @ np.diag(((1 - alpha) * evals + alpha)
                                        ** -0.5).astype(np.float32)
            elif xform == "pcawt":
                evecs = evecs @ np.diag(evals ** (-0.5 * t)).astype(
                    np.float32)
        self.mean, self.evecs = mean, evecs

    @f32_matmul_precision
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = as_float(x)
        x = (x - device_table(self, "mean", self.mean, x.device)) \
            @ device_table(self, "evecs", self.evecs, x.device)
        x = torch.sign(x) * x.abs() ** self.pval
        return x / torch.linalg.vector_norm(x, dim=1,
                                            keepdim=True).clamp_min(1e-12)

    forward = __call__


class MKDDescriptor:
    """The full MKD descriptor, (B, 1, PS, PS) → (B, output_dims): polar
    and cartesian encodings ('concat'), or one of them. Whitening applies
    only when `whitening_model` is given (the reference downloads it)."""

    def __init__(self, patch_size: int = 32, kernel_type: str = "concat",
                 whitening: Optional[str] = "pcawt",
                 training_set: str = "liberty", output_dims: int = 128,
                 whitening_model=None):
        self.patch_size = patch_size
        self.kernel_type = kernel_type
        self.whitening = whitening if whitening_model is not None else None
        self.training_set = training_set
        self.sigma = 1.4 * (patch_size / 64)
        self.gradients = MKDGradients()
        params = (["polar", "cart"] if kernel_type == "concat"
                  else [kernel_type])
        self.parametrizations = params
        relative = {"polar": True, "cart": False}
        self.feats = {}
        self.odims = 0
        for p in params:
            ge = EmbedGradients(patch_size, relative=relative[p])
            se = ExplicitSpacialEncoding(p, patch_size, in_dims=ge.kernel.d)
            self.feats[p] = (ge, se)
            self.odims += se.odims
        self.output_dims = min(output_dims, self.odims)
        if self.whitening is not None:
            self.whitening_layer = Whitening(
                whitening, whitening_model, in_dims=self.odims,
                output_dims=self.output_dims)
            self.odims = self.output_dims

    def __call__(self, patches: torch.Tensor) -> torch.Tensor:
        g = gaussian_blur2d(as_float(patches), (5, 5),
                            (self.sigma, self.sigma), "replicate")
        g = self.gradients(g)
        y = torch.cat([se(ge(g)) for ge, se in
                       (self.feats[p] for p in self.parametrizations)], dim=1)
        y = y / torch.linalg.vector_norm(y, dim=1,
                                         keepdim=True).clamp_min(1e-12)
        if self.whitening is not None:
            y = self.whitening_layer(y)
        return y

    forward = __call__


class SimpleKD:
    """MKD with one parametrisation and whitening."""

    def __init__(self, patch_size: int = 32, kernel_type: str = "polar",
                 whitening: str = "pcawt", training_set: str = "liberty",
                 output_dims: int = 128, whitening_model=None):
        self.mkd = MKDDescriptor(patch_size, kernel_type, whitening,
                                 training_set, output_dims, whitening_model)

    def __call__(self, patches: torch.Tensor) -> torch.Tensor:
        return self.mkd(patches)

    forward = __call__


def load_whitening_from_torch(state) -> Dict:
    """A torch MKD whitening file (dict[training_set][algo] of tensors) →
    the same dict of float32 numpy arrays."""
    return {tset: {a: {k: np.asarray(v.detach().cpu().numpy()
                                     if hasattr(v, "detach") else v,
                                     np.float32)
                       for k, v in m.items()}
                   for a, m in algos.items()}
            for tset, algos in state.items()}
