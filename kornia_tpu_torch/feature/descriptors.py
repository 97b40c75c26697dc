"""Patch descriptors, shape estimators and Key.Net (counterpart of
``kornia_tpu/feature/descriptors.py``).

The CNNs (TFeat, SOSNet, HyNet, Key.Net) keep the published checkpoints'
names (``features.1.weight``, ...) as a module tree of parameters that do
not require grad (see ``hardnet.py``), so a torch checkpoint loads by name.
Key.Net: per pyramid level (``pyrdown`` by 1.2, `num_levels` levels) a
handcrafted block computes 10 maps from iterated Sobel gradients and a
learnable block runs three conv → batch norm → ReLU layers; every level is
resized back to the input size, the levels are concatenated and a final
conv → ReLU gives the (B, 1, H, W) response.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.dtype import as_float, device_table
from ..core.linalg import f32_matmul_precision
from ..ops.color import rgb_to_grayscale
from ..ops.filters import get_gaussian_kernel2d, spatial_gradient
from ..ops.pyramid import pyrdown
from ..ops.warp import resize
from .hardnet import _numpy, _register_tree, _running_bn

__all__ = ["TFeat", "SOSNet", "HyNet", "MKDGradientDescriptor",
           "PatchAffineShapeEstimator", "LAFAffineShapeEstimator", "KeyNet",
           "DiscreteSteerer", "load_tfeat_torch_weights",
           "load_sosnet_torch_weights", "load_hynet_torch_weights",
           "load_keynet_torch_weights"]

Device = Union[str, torch.device]


def _convert_torch(state_dict, specs) -> Dict[str, np.ndarray]:
    """A torch state dict → the param dict under the same names, each
    entry's shape checked against `specs`."""
    params = {}
    for k, shape in specs.items():
        v = _numpy(state_dict[k])
        if v.shape != tuple(shape):
            raise ValueError(f"{k}: shape {v.shape}, expected {shape}")
        params[k] = v
    return params


def _init_from_specs(generator: torch.Generator, specs,
                     dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """He-normal conv and linear weights drawn from a CPU `generator` in
    the order of `specs`, unit running variances and norm scales, TLU
    thresholds of -1, FRN epsilons of 1e-6, zero means and biases."""
    params = {}
    for name, shape in specs.items():
        if name.endswith("running_var"):
            params[name] = torch.ones(shape, dtype=dtype)
        elif name.endswith(".tau"):  # TLU thresholds
            params[name] = -torch.ones(shape, dtype=dtype)
        elif name.endswith(".eps"):  # FRN epsilons
            params[name] = torch.full(shape, 1e-6, dtype=dtype)
        elif len(shape) >= 2:
            fan_in = math.prod(shape[1:])
            params[name] = torch.randn(shape, generator=generator,
                                       dtype=dtype) * math.sqrt(2.0 / fan_in)
        elif name.endswith(".weight"):
            params[name] = torch.ones(shape, dtype=dtype)
        else:
            params[name] = torch.zeros(shape, dtype=dtype)
    return params


class KeyNet(nn.Module):
    """Key.Net response map: (B, 1, H, W) → (B, 1, H, W). `params` is the
    reference's dict (checkpoint names; numpy arrays or tensors); without
    it the weights come from `generator`, or one seeded with 3 (the
    reference's key). With `sigmas` the response is scaled by σ² (the
    scale-space detector's convention). Runs in true float32 (TF32 off)."""

    def __init__(self, params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 num_filters: int = 8, num_levels: int = 3,
                 kernel_size: int = 5, device: Device = "cuda"):
        super().__init__()
        self.num_filters = num_filters
        self.num_levels = num_levels
        self.kernel_size = kernel_size
        if params is None:
            params = _init_from_specs(
                generator if generator is not None
                else torch.Generator().manual_seed(3),
                self._specs(num_filters, num_levels, kernel_size))
        _register_tree(self, params, device)

    @staticmethod
    def _specs(num_filters: int = 8, num_levels: int = 3,
               kernel_size: int = 5) -> Dict[str, Tuple[int, ...]]:
        specs: Dict[str, Tuple[int, ...]] = {}
        cin = 10
        for i in range(3):
            pre = f"feature_extractor.lb_block.conv{i}"
            specs[f"{pre}.0.weight"] = (num_filters, cin, kernel_size,
                                        kernel_size)
            specs[f"{pre}.0.bias"] = (num_filters,)
            for suffix in ("weight", "bias", "running_mean", "running_var"):
                specs[f"{pre}.1.{suffix}"] = (num_filters,)
            cin = num_filters
        specs["last_conv.0.weight"] = (1, num_filters * num_levels,
                                       kernel_size, kernel_size)
        specs["last_conv.0.bias"] = (1,)
        return specs

    @classmethod
    def from_torch(cls, state_dict, num_filters: int = 8,
                   num_levels: int = 3, kernel_size: int = 5,
                   device: Device = "cuda") -> "KeyNet":
        return cls(_convert_torch(
            state_dict, cls._specs(num_filters, num_levels, kernel_size)),
            num_filters=num_filters, num_levels=num_levels,
            kernel_size=kernel_size, device=device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Checkpoint name → parameter."""
        return dict(self.named_parameters())

    @staticmethod
    def _handcrafted(x: torch.Tensor) -> torch.Tensor:
        """The 10 gradient maps, in the reference's order."""
        g = spatial_gradient(x, "sobel", 1)
        dx, dy = g[:, :, 0], g[:, :, 1]
        gx2 = spatial_gradient(dx, "sobel", 1)
        dxx, dxy = gx2[:, :, 0], gx2[:, :, 1]
        dyy = spatial_gradient(dy, "sobel", 1)[:, :, 1]
        return torch.cat([dx, dy, dx * dx, dy * dy, dx * dy, dxy, dxy * dxy,
                          dxx, dyy, dxx * dyy], dim=1)

    def _extract(self, x: torch.Tensor, p: Mapping) -> torch.Tensor:
        h = self._handcrafted(x)
        pad = self.kernel_size // 2
        for i in range(3):
            pre = f"feature_extractor.lb_block.conv{i}"
            h = F.conv2d(h, p[f"{pre}.0.weight"], p[f"{pre}.0.bias"],
                         padding=pad)
            # batch norm on the running statistics in every mode
            h = F.relu(_running_bn(h, p[f"{pre}.1.running_mean"],
                                   p[f"{pre}.1.running_var"],
                                   p[f"{pre}.1.weight"], p[f"{pre}.1.bias"]))
        return h

    @f32_matmul_precision
    def forward(self, x: torch.Tensor,
                sigmas: Optional[torch.Tensor] = None) -> torch.Tensor:
        p = self.params
        x = as_float(x)
        H, W = x.shape[-2:]
        feats = [self._extract(x, p)]
        for _ in range(1, self.num_levels):
            x = pyrdown(x, factor=1.2)
            feats.append(resize(self._extract(x, p), (H, W), "bilinear",
                                align_corners=False))
        out = F.relu(F.conv2d(torch.cat(feats, dim=1),
                              p["last_conv.0.weight"], p["last_conv.0.bias"],
                              padding=self.kernel_size // 2))
        if sigmas is not None:
            s = torch.as_tensor(sigmas, dtype=out.dtype,
                                device=out.device).reshape(-1, 1, 1, 1)
            out = out * (s * s)
        return out


def load_keynet_torch_weights(state_dict) -> Dict[str, np.ndarray]:
    """The published Key.Net checkpoint → the param dict (shapes
    checked)."""
    return _convert_torch(state_dict, KeyNet._specs())


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d without affine: each sample's channel standardised
    with its biased variance."""
    mu = x.mean(dim=(-2, -1), keepdim=True)
    var = x.var(dim=(-2, -1), keepdim=True, correction=0)
    return (x - mu) * torch.rsqrt(var + eps)


def _lrn_l2(x: torch.Tensor) -> torch.Tensor:
    """LocalResponseNorm over all 2C channels of a (B, C, 1, 1) map, which
    is an L2 normalisation over the channels."""
    return x * torch.rsqrt((x * x).sum(dim=1, keepdim=True))


def _patches32(patches: torch.Tensor) -> torch.Tensor:
    x = as_float(patches)
    return resize(x, (32, 32)) if x.shape[-1] != 32 else x


def _default_params(params, generator, seed: int, specs) -> Mapping:
    if params is not None:
        return params
    return _init_from_specs(generator if generator is not None
                            else torch.Generator().manual_seed(seed), specs)


class _CheckpointNet(nn.Module):
    """A net whose weights are a frozen module tree under the published
    checkpoint's names; `params` gives them back as a dict."""

    def __init__(self, params: Mapping, device: Device):
        super().__init__()
        _register_tree(self, params, device)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        """Checkpoint name → parameter."""
        return dict(self.named_parameters())


class TFeat(_CheckpointNet):
    """TFeat: InstanceNorm → conv7 → tanh → maxpool 2 → conv6 → tanh →
    linear → tanh. (B, 1, 32, 32) → (B, 128); other patch sizes are resized
    to 32² first. Without `params` the weights come from `generator`, or
    one seeded with 0 (the reference's key). True float32 (TF32 off)."""

    patch_size = 32
    _SPECS = {
        "features.1.weight": (32, 1, 7, 7), "features.1.bias": (32,),
        "features.4.weight": (64, 32, 6, 6), "features.4.bias": (64,),
        "descr.0.weight": (128, 64 * 8 * 8), "descr.0.bias": (128,),
    }

    def __init__(self, params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        super().__init__(_default_params(params, generator, 0, self._SPECS),
                         device)

    @classmethod
    def from_torch(cls, state_dict, device: Device = "cuda") -> "TFeat":
        return cls(_convert_torch(state_dict, cls._SPECS), device=device)

    @f32_matmul_precision
    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        p = self.params
        x = _instance_norm(_patches32(patches))
        x = torch.tanh(F.conv2d(x, p["features.1.weight"],
                                p["features.1.bias"]))
        x = F.max_pool2d(x, 2, 2)
        x = torch.tanh(F.conv2d(x, p["features.4.weight"],
                                p["features.4.bias"]))
        return torch.tanh(F.linear(x.reshape(x.shape[0], -1),
                                   p["descr.0.weight"], p["descr.0.bias"]))


# (conv layer idx, bn layer idx, out, stride)
_SOS_LAYERS = ((1, 2, 32, 1), (4, 5, 32, 1), (7, 8, 64, 2), (10, 11, 64, 1),
               (13, 14, 128, 2), (16, 17, 128, 1))


class SOSNet(_CheckpointNet):
    """SOSNet: InstanceNorm → 6 × (conv3 → batch norm without affine →
    ReLU) → conv8 → batch norm → L2 over the channels. (B, 1, 32, 32) →
    (B, 128); seeded with 1 without `params`. True float32."""

    patch_size = 32

    @classmethod
    def _specs(cls) -> Dict[str, Tuple[int, ...]]:
        specs: Dict[str, Tuple[int, ...]] = {}
        cin = 1
        for ci, bi, cout, _s in _SOS_LAYERS:
            specs[f"layers.{ci}.weight"] = (cout, cin, 3, 3)
            specs[f"layers.{bi}.running_mean"] = (cout,)
            specs[f"layers.{bi}.running_var"] = (cout,)
            cin = cout
        specs["layers.20.weight"] = (128, 128, 8, 8)
        specs["layers.21.running_mean"] = (128,)
        specs["layers.21.running_var"] = (128,)
        return specs

    def __init__(self, params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 device: Device = "cuda"):
        super().__init__(_default_params(params, generator, 1,
                                         self._specs()), device)

    @classmethod
    def from_torch(cls, state_dict, device: Device = "cuda") -> "SOSNet":
        return cls(_convert_torch(state_dict, cls._specs()), device=device)

    @f32_matmul_precision
    def forward(self, patches: torch.Tensor,
                eps: float = 1e-10) -> torch.Tensor:
        p = self.params
        x = _instance_norm(_patches32(patches))
        for ci, bi, _cout, s in _SOS_LAYERS:
            x = F.conv2d(x, p[f"layers.{ci}.weight"], stride=s, padding=1)
            x = F.relu(_running_bn(x, p[f"layers.{bi}.running_mean"],
                                   p[f"layers.{bi}.running_var"]))
        x = _running_bn(F.conv2d(x, p["layers.20.weight"]),
                        p["layers.21.running_mean"],
                        p["layers.21.running_var"])
        return _lrn_l2(x + eps).reshape(x.shape[0], -1)


def _frn(p: Mapping, name: str, x: torch.Tensor) -> torch.Tensor:
    """FilterResponseNorm2d: x·rsqrt(E[x²]_HW + |eps|)·w + b."""
    nu2 = (x * x).mean(dim=(-2, -1), keepdim=True)
    y = x * torch.rsqrt(nu2 + p[f"{name}.eps"].abs())
    return y * p[f"{name}.weight"] + p[f"{name}.bias"]


def _tlu(p: Mapping, name: str, x: torch.Tensor) -> torch.Tensor:
    """TLU: max(x, tau) with a per-channel tau."""
    return torch.maximum(x, p[f"{name}.tau"])


# layerN -> (conv idx within the Sequential, cin, cout, stride)
_HYNET_LAYERS = (("layer2", 0, 32, 32, 1), ("layer3", 0, 32, 64, 2),
                 ("layer4", 0, 64, 64, 1), ("layer5", 0, 64, 128, 2),
                 ("layer6", 0, 128, 128, 1))


class HyNet(_CheckpointNet):
    """HyNet: FRN/TLU-normalised conv stack → conv8 → batch norm → L2 over
    the channels (after adding `eps_l2_norm`, as the reference does).
    (B, 1, 32, 32) → (B, 128); seeded with 2 without `params`. True
    float32."""

    patch_size = 32

    @classmethod
    def _specs(cls) -> Dict[str, Tuple[int, ...]]:
        def frn(prefix: str, ch: int, specs) -> None:
            specs[f"{prefix}.weight"] = (1, ch, 1, 1)
            specs[f"{prefix}.bias"] = (1, ch, 1, 1)
            specs[f"{prefix}.eps"] = (1,)

        specs: Dict[str, Tuple[int, ...]] = {}
        frn("layer1.0", 1, specs)
        specs["layer1.1.tau"] = (1, 1, 1, 1)
        specs["layer1.2.weight"] = (32, 1, 3, 3)
        specs["layer1.2.bias"] = (32,)
        frn("layer1.3", 32, specs)
        specs["layer1.4.tau"] = (1, 32, 1, 1)
        for name, ci, cin, cout, _s in _HYNET_LAYERS:
            specs[f"{name}.{ci}.weight"] = (cout, cin, 3, 3)
            specs[f"{name}.{ci}.bias"] = (cout,)
            frn(f"{name}.{ci + 1}", cout, specs)
            specs[f"{name}.{ci + 2}.tau"] = (1, cout, 1, 1)
        specs["layer7.1.weight"] = (128, 128, 8, 8)
        specs["layer7.2.running_mean"] = (128,)
        specs["layer7.2.running_var"] = (128,)
        return specs

    def __init__(self, params: Optional[Mapping] = None,
                 generator: Optional[torch.Generator] = None,
                 eps_l2_norm: float = 1e-10, device: Device = "cuda"):
        super().__init__(_default_params(params, generator, 2,
                                         self._specs()), device)
        self.eps_l2_norm = eps_l2_norm

    @classmethod
    def from_torch(cls, state_dict, device: Device = "cuda") -> "HyNet":
        return cls(_convert_torch(state_dict, cls._specs()), device=device)

    @f32_matmul_precision
    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        p = self.params
        x = _patches32(patches)
        x = _tlu(p, "layer1.1", _frn(p, "layer1.0", x))
        x = F.conv2d(x, p["layer1.2.weight"], p["layer1.2.bias"], padding=1)
        x = _tlu(p, "layer1.4", _frn(p, "layer1.3", x))
        for name, ci, _cin, _cout, s in _HYNET_LAYERS:
            x = F.conv2d(x, p[f"{name}.{ci}.weight"], p[f"{name}.{ci}.bias"],
                         stride=s, padding=1)
            x = _tlu(p, f"{name}.{ci + 2}", _frn(p, f"{name}.{ci + 1}", x))
        x = _running_bn(F.conv2d(x, p["layer7.1.weight"]),
                        p["layer7.2.running_mean"],
                        p["layer7.2.running_var"])
        return _lrn_l2(x + self.eps_l2_norm).reshape(x.shape[0], -1)


class MKDGradientDescriptor:
    """The light multiple-kernel descriptor: gradient orientations embedded
    in three harmonics, positions in polar harmonics, summed over the patch
    and projected to `output_dims` (by `whitening`, or else by a fixed
    random projection), then L2-normalised. (B, C, H, W) → (B,
    output_dims).

    The fixed projection is the reference's only random draw: it draws
    from ``jax.random.PRNGKey(12)``, which torch cannot reproduce, so the
    port draws its own from a CPU generator seeded with 12 and keeps it in
    ``projection`` (host numpy, columns of unit norm), which a caller may
    replace with the reference's."""

    def __init__(self, patch_size: int = 32, output_dims: int = 128,
                 whitening=None):
        self.patch_size = patch_size
        self.output_dims = output_dims
        self.whitening = whitening
        self.projection: Optional[np.ndarray] = None

    def _projection(self, rows: int) -> np.ndarray:
        if self.projection is None or self.projection.shape[0] != rows:
            proj = torch.randn((rows, self.output_dims),
                               generator=torch.Generator().manual_seed(12))
            proj = proj / torch.linalg.vector_norm(proj, dim=0, keepdim=True)
            self.projection = proj.numpy()
        return self.projection

    @f32_matmul_precision
    def __call__(self, patches: torch.Tensor) -> torch.Tensor:
        x = as_float(patches)
        B, C, H, W = x.shape
        dt, dev = x.dtype, x.device
        grads = spatial_gradient(x, "diff")
        gx, gy = grads[:, :, 0], grads[:, :, 1]
        mag = torch.sqrt(gx * gx + gy * gy + 1e-10)
        ori = torch.atan2(gy, gx)
        gk = get_gaussian_kernel2d((H, W), (H / 3.0, W / 3.0), dt, dev)[0]
        mag = mag * gk
        gyy, gxx = torch.meshgrid(torch.linspace(-1, 1, H, device=dev),
                                  torch.linspace(-1, 1, W, device=dev),
                                  indexing="ij")
        rho = torch.sqrt(gxx ** 2 + gyy ** 2 + 1e-10)
        phi = torch.atan2(gyy, gxx)
        feats = []
        for k_ori in range(1, 4):
            for trig_o in (torch.cos, torch.sin):
                o_emb = trig_o(k_ori * ori) * mag
                for k_pos in range(3):
                    for trig_p in (torch.cos, torch.sin):
                        p_emb = trig_p(k_pos * phi) * torch.exp(-2.0 * rho)
                        feats.append((o_emb * p_emb).sum(dim=(-2, -1)))
        f = torch.cat(feats, dim=-1).reshape(B, -1)  # (B, C·36)
        if self.whitening is not None:
            wm = self.whitening
            wm = wm.to(dev, dt) if isinstance(wm, torch.Tensor) else \
                device_table(self, "whitening", wm, dev, dt)
            f = f @ wm[: f.shape[-1], : self.output_dims]
        else:
            f = f @ device_table(self, "projection",
                                 self._projection(f.shape[-1]), dev, dt)
        return f / torch.linalg.vector_norm(f, dim=-1,
                                            keepdim=True).clamp_min(1e-8)

    forward = __call__


class PatchAffineShapeEstimator:
    """The second-moment matrix of a patch's gradients, Gaussian weighted:
    (B, 1, PS, PS) → (B, 3), the ellipse's (a, b, c) scaled to unit
    determinant."""

    def __init__(self, patch_size: int = 19):
        self.patch_size = patch_size

    def __call__(self, patches: torch.Tensor) -> torch.Tensor:
        x = as_float(patches)
        B, C, H, W = x.shape
        grads = spatial_gradient(x, "diff")
        gx, gy = grads[:, 0, 0], grads[:, 0, 1]
        gk = get_gaussian_kernel2d((H, W), (H / 3.0, W / 3.0), x.dtype,
                                   x.device)[0]
        a = (gx * gx * gk).sum(dim=(-2, -1))
        b = (gx * gy * gk).sum(dim=(-2, -1))
        c = (gy * gy * gk).sum(dim=(-2, -1))
        norm = torch.sqrt(a * c - b * b + 1e-10).clamp_min(1e-10)
        return torch.stack([a, b, c], -1) / norm[:, None]

    forward = __call__


def _inverse_sqrt_2x2(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """The inverse square root of the symmetric [[a, b], [b, c]] with its
    eigenvalues clamped at 1e-9, and its determinant, in closed form: the
    eigenvectors at angle ½·atan2(2b, a − c). ``torch.linalg.eigh`` on the
    card checks its result on the host; this makes no host read."""
    th = 0.5 * torch.atan2(2.0 * b, a - c)
    cs, sn = torch.cos(th), torch.sin(th)
    l1 = a * cs * cs + 2.0 * b * cs * sn + c * sn * sn
    l2 = a * sn * sn - 2.0 * b * cs * sn + c * cs * cs
    f1 = torch.rsqrt(l1.clamp_min(1e-9))
    f2 = torch.rsqrt(l2.clamp_min(1e-9))
    off = (f1 - f2) * cs * sn
    m = torch.stack([torch.stack([f1 * cs * cs + f2 * sn * sn, off], -1),
                     torch.stack([off, f1 * sn * sn + f2 * cs * cs], -1)],
                    -2)
    return m, f1 * f2


class LAFAffineShapeEstimator:
    """Shape-adapt each LAF: the patch's second-moment matrix M at the LAF
    gives the frame A·M^(-1/2), scaled to keep det A, then made upright.
    `laf` (B, N, 2, 3), `img` (B, C, H, W) → (B, N, 2, 3)."""

    def __init__(self, patch_size: int = 32):
        self.patch_size = patch_size
        self.estimator = PatchAffineShapeEstimator(patch_size)

    @f32_matmul_precision
    def __call__(self, laf: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
        from .laf import extract_patches_from_pyramid, make_upright
        B, N = laf.shape[:2]
        patches = extract_patches_from_pyramid(img, laf, self.patch_size)
        flat = patches.reshape(B * N, *patches.shape[2:])
        if flat.shape[1] == 3:
            flat = rgb_to_grayscale(flat)
        abc = self.estimator(flat).reshape(B, N, 3)
        inv_sqrt, det = _inverse_sqrt_2x2(abc[..., 0], abc[..., 1],
                                          abc[..., 2])
        inv_sqrt = inv_sqrt / torch.sqrt(det.clamp_min(1e-9))[..., None,
                                                               None]
        A_new = laf[..., :2, :2] @ inv_sqrt
        return make_upright(torch.cat([A_new, laf[..., :2, 2:]], dim=-1))

    forward = __call__


class DiscreteSteerer:
    """Rotation-steerable descriptors: desc' = desc · Gᵀ for a generator
    G."""

    def __init__(self, generator: torch.Tensor):
        self.generator = generator

    def __call__(self, descriptions: torch.Tensor) -> torch.Tensor:
        g = torch.as_tensor(self.generator, dtype=descriptions.dtype,
                            device=descriptions.device)
        return descriptions @ g.T

    def steer_descriptions(self, descriptions: torch.Tensor,
                           steerer_power: int = 1,
                           normalize: bool = False) -> torch.Tensor:
        out = descriptions
        for _ in range(steerer_power):
            out = self(out)
        if normalize:
            out = out / torch.linalg.vector_norm(
                out, dim=-1, keepdim=True).clamp_min(1e-8)
        return out


def load_tfeat_torch_weights(state_dict) -> Dict[str, np.ndarray]:
    """A torch TFeat checkpoint → TFeat's param dict (shapes checked)."""
    return _convert_torch(state_dict, TFeat._SPECS)


def load_sosnet_torch_weights(state_dict) -> Dict[str, np.ndarray]:
    """A torch SOSNet checkpoint → SOSNet's param dict (shapes checked)."""
    return _convert_torch(state_dict, SOSNet._specs())


def load_hynet_torch_weights(state_dict) -> Dict[str, np.ndarray]:
    """A torch HyNet checkpoint → HyNet's param dict (shapes checked)."""
    return _convert_torch(state_dict, HyNet._specs())
