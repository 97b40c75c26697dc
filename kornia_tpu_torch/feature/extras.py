"""The rest of the feature API (counterpart of
``kornia_tpu/feature/extras.py``, without the ALIKED and XFeat families,
which wait for their modules): HardNet8, the FRN and TLU layers, the
response-module wrappers, patch orientation as a module, descriptors at
LAFs, and the LAF-aware matchers (AdaLAM, FGINN, LightGlue).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..core.check import check_laf as KORNIA_CHECK_LAF  # noqa: F401
from ..core.dtype import as_float
from ..core.linalg import f32_matmul_precision
from ..core.module import fn_module as _fn_module
from ..ops.color import rgb_to_grayscale
from ..ops.warp import resize
from . import responses as _resp
from .adalam import adalam_filter
from .hardnet import _frozen, _numpy, _running_bn
from .laf import extract_patches_from_pyramid, get_laf_center
from .lightglue import LightGlue, LightGlueConfig
from .matching import match_fginn, match_smnn
from .orientation import patch_dominant_gradient_orientation

__all__ = [
    "HardNet8", "hardnet8_init_params", "load_hardnet8_torch_weights",
    "FilterResponseNorm2d", "TLU",
    "CornerHarris", "CornerGFTT", "BlobHessian", "BlobDoG", "BlobDoGSingle",
    "PatchDominantGradientOrientation",
    "get_laf_descriptors", "GeometryAwareDescriptorMatcher", "match_adalam",
    "LightGlueMatcher", "KORNIA_CHECK_LAF",
]

Device = Union[str, torch.device]

# (out_ch, kernel, stride, pad); batch norm without affine and ReLU after
# each but the last
_HARDNET8_ARCH = [
    (32, 3, 1, 1), (32, 3, 1, 1), (64, 3, 2, 1), (64, 3, 1, 1),
    (128, 3, 2, 1), (128, 3, 1, 1), (256, 3, 1, 1), (512, 8, 1, 0),
]


def hardnet8_init_params(generator: torch.Generator,
                         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """He-normal convolutions drawn from a CPU `generator`, zero means and
    unit variances, and the learned PCA as its identity part (mean 0,
    components eye(512, 128))."""
    params = {}
    in_ch = 1
    for i, (out_ch, k, _s, _p) in enumerate(_HARDNET8_ARCH):
        params[f"conv{i}_w"] = torch.randn(
            (out_ch, in_ch, k, k), generator=generator, dtype=dtype) \
            * (2.0 / (in_ch * k * k)) ** 0.5
        params[f"bn{i}_mean"] = torch.zeros(out_ch, dtype=dtype)
        params[f"bn{i}_var"] = torch.ones(out_ch, dtype=dtype)
        in_ch = out_ch
    params["pca_mean"] = torch.zeros(512, dtype=dtype)
    params["pca_components"] = torch.eye(512, 128, dtype=dtype)
    return params


def load_hardnet8_torch_weights(state_dict) -> Dict:
    """A torch HardNet8 checkpoint (``features.{i}.weight`` convolutions,
    their batch norms' running statistics, ``mean`` and ``components``)
    → the param dict."""
    t = {k: _numpy(v) for k, v in state_dict.items()}
    conv_layers = sorted(
        int(k.split(".")[1]) for k in t
        if k.startswith("features.") and k.endswith(".weight")
        and t[k].ndim == 4)
    params = {}
    for conv_i, idx in enumerate(conv_layers):
        params[f"conv{conv_i}_w"] = t[f"features.{idx}.weight"]
        params[f"bn{conv_i}_mean"] = t[f"features.{idx + 1}.running_mean"]
        params[f"bn{conv_i}_var"] = t[f"features.{idx + 1}.running_var"]
    params["pca_mean"] = t["mean"]
    params["pca_components"] = t["components"]
    return params


class HardNet8(nn.Module):
    """HardNet8: an 8-conv trunk to 512, L2-normalised, then the learned
    PCA to 128 and L2 again. (B, 1, 32, 32) → (B, 128); other sizes are
    resized to 32² first. Without `params` the weights come from a
    generator seeded with 8 (the reference's key). True float32."""

    patch_size = 32

    def __init__(self, params: Optional[Mapping] = None,
                 device: Device = "cuda"):
        super().__init__()
        if params is None:
            params = hardnet8_init_params(torch.Generator().manual_seed(8))
        self.params = nn.ParameterDict(
            {k: _frozen(v, device) for k, v in params.items()})

    @f32_matmul_precision
    def forward(self, patches: torch.Tensor) -> torch.Tensor:
        p = self.params
        x = as_float(patches)
        if x.shape[-1] != 32:
            x = resize(x, (32, 32))
        mu = x.mean(dim=(1, 2, 3), keepdim=True)
        sd = x.std(dim=(1, 2, 3), keepdim=True, correction=0)
        x = (x - mu) / (sd + 1e-7)
        n = len(_HARDNET8_ARCH)
        for i, (_out, _k, s, pad) in enumerate(_HARDNET8_ARCH):
            x = F.conv2d(x, p[f"conv{i}_w"], stride=s, padding=pad)
            x = _running_bn(x, p[f"bn{i}_mean"], p[f"bn{i}_var"])
            if i < n - 1:
                x = F.relu(x)
        x = x.reshape(x.shape[0], -1)
        x = x / torch.linalg.vector_norm(x, dim=1,
                                         keepdim=True).clamp_min(1e-12)
        pca = (x - p["pca_mean"]) @ p["pca_components"]
        return pca / torch.linalg.vector_norm(pca, dim=1,
                                              keepdim=True).clamp_min(1e-12)


class FilterResponseNorm2d:
    """y = gamma · x / sqrt(E[x²] + |eps|) + beta, per channel."""

    def __init__(self, num_features: int, eps: float = 1e-6,
                 is_bias: bool = True, is_scale: bool = True,
                 drop_rate: float = 0.0, is_eps_leanable: bool = False):
        self.num_features = num_features
        self.eps = eps
        self.is_bias = is_bias
        self.is_scale = is_scale
        self.weight = torch.ones((1, num_features, 1, 1))
        self.bias = torch.zeros((1, num_features, 1, 1))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = as_float(x)
        nu2 = (x * x).mean(dim=(2, 3), keepdim=True)
        x = x * torch.rsqrt(nu2 + abs(float(self.eps)))
        if self.is_scale:
            x = self.weight.to(x.device) * x
        if self.is_bias:
            x = x + self.bias.to(x.device)
        return x

    forward = __call__


class TLU:
    """y = max(x, tau), a threshold per channel (initially -1)."""

    def __init__(self, num_features: int):
        self.num_features = num_features
        self.tau = -torch.ones((1, num_features, 1, 1))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        x = as_float(x)
        return torch.maximum(x, self.tau.to(x.device))

    forward = __call__


# the response functions as modules
CornerHarris = _fn_module(_resp.harris_response, "CornerHarris")
CornerGFTT = _fn_module(_resp.gftt_response, "CornerGFTT")
BlobHessian = _fn_module(_resp.hessian_response, "BlobHessian")
BlobDoG = _fn_module(_resp.dog_response, "BlobDoG")
BlobDoGSingle = _fn_module(_resp.dog_response_single, "BlobDoGSingle")


class PatchDominantGradientOrientation:
    """``patch_dominant_gradient_orientation`` as a module."""

    def __init__(self, patch_size: int = 32, num_angular_bins: int = 36):
        self.patch_size = patch_size
        self.num_angular_bins = num_angular_bins

    def __call__(self, patch: torch.Tensor) -> torch.Tensor:
        return patch_dominant_gradient_orientation(patch,
                                                   self.num_angular_bins)

    forward = __call__


def get_laf_descriptors(img: torch.Tensor, lafs: torch.Tensor,
                        patch_descriptor, patch_size: int = 32,
                        grayscale_descriptor: bool = True) -> torch.Tensor:
    """Patches at the LAFs (the ``patch_sample`` kernel on the card), then
    `patch_descriptor` on them: (B, N, D). Colour images go grey first
    when `grayscale_descriptor`."""
    KORNIA_CHECK_LAF(lafs)
    timg = as_float(img)
    if grayscale_descriptor and timg.shape[1] == 3:
        timg = rgb_to_grayscale(timg)
    patches = extract_patches_from_pyramid(timg, lafs, patch_size)
    B, N, CH, H, W = patches.shape
    return patch_descriptor(patches.reshape(B * N, CH, H, W)).reshape(
        B, N, -1)


def match_adalam(desc1: torch.Tensor, desc2: torch.Tensor,
                 lafs1: torch.Tensor, lafs2: torch.Tensor,
                 config: Optional[dict] = None,
                 hw1: Optional[Tuple[int, int]] = None,
                 hw2: Optional[Tuple[int, int]] = None,
                 dm: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SMNN matching, then AdaLAM's local affine filter. Fixed shapes:
    (N1, 1) distances and (N1, 2) index pairs, where a row filtered out
    has distance inf and indices -1. `dm` is accepted and recomputed."""
    config = config or {}
    del dm
    dists, idxs, valid = match_smnn(desc1, desc2,
                                    th=float(config.get("th", 0.95)))
    kp1 = get_laf_center(lafs1)[0]
    kp2 = get_laf_center(lafs2)[0]
    keep = adalam_filter(
        kp1[idxs[:, 0]], kp2[idxs[:, 1]], valid,
        num_seeds=int(config.get("num_seeds", 64)),
        inlier_th=float(config.get("inlier_th", 10.0)),
        min_support=int(config.get("min_confidence", 4)))
    dists = torch.where(keep[:, None], dists, torch.inf)
    idxs = torch.where(keep[:, None], idxs, -1)
    return dists, idxs


class GeometryAwareDescriptorMatcher:
    """A LAF-aware matcher: 'fginn' or 'adalam'."""

    known_modes = ("fginn", "adalam")

    def __init__(self, match_mode: str = "fginn",
                 params: Optional[dict] = None):
        mode = match_mode.lower()
        if mode not in self.known_modes:
            raise NotImplementedError(
                f"{match_mode} not supported; use one of {self.known_modes}")
        self.match_mode = mode
        self.params = params or {}

    def __call__(self, desc1, desc2, lafs1, lafs2):
        if self.match_mode == "fginn":
            out = match_fginn(desc1, desc2, lafs1, lafs2, **self.params)
            return out[0], out[1]
        return match_adalam(desc1, desc2, lafs1, lafs2, self.params)

    forward = __call__


class LightGlueMatcher(GeometryAwareDescriptorMatcher):
    """LightGlue behind the LAF interface: LAF centres as keypoints, the
    image size from `hw1`/`hw2` or, as in the reference, from the
    keypoints' largest coordinates (one read to the host). Returns (N1, 1)
    distances 1 − score and (N1, 2) index pairs, -1 and inf where
    unmatched. `params`: "cfg" (a LightGlueConfig) and "weights"."""

    known_modes = ("lightglue",)

    def __init__(self, feature_name: str = "disk",
                 params: Optional[dict] = None, device: Device = "cuda"):
        self.feature_name = feature_name
        self.params = params or {}
        self.match_mode = "lightglue"
        cfg = self.params.get("cfg") or LightGlueConfig()
        self.matcher = LightGlue(cfg, params=self.params.get("weights"),
                                 device=device)

    def __call__(self, desc1, desc2, lafs1, lafs2, hw1=None, hw2=None):
        kp1 = get_laf_center(lafs1)
        kp2 = get_laf_center(lafs2)
        if hw1 is None:
            m = kp1.reshape(-1, 2).amax(dim=0).tolist()
            hw1 = (int(m[1]) + 1, int(m[0]) + 1)
        if hw2 is None:
            m = kp2.reshape(-1, 2).amax(dim=0).tolist()
            hw2 = (int(m[1]) + 1, int(m[0]) + 1)
        out = self.matcher({
            "image0": {"keypoints": kp1, "descriptors": desc1[None],
                       "image_size": [float(hw1[1]), float(hw1[0])]},
            "image1": {"keypoints": kp2, "descriptors": desc2[None],
                       "image_size": [float(hw2[1]), float(hw2[0])]},
        })
        matches = out["matches0"][0]
        scores = out["matching_scores0"][0]
        n1 = matches.shape[0]
        idxs = torch.stack([torch.arange(n1, device=matches.device),
                            matches], dim=-1)
        valid = matches >= 0
        dists = torch.where(valid, 1.0 - scores, torch.inf)[:, None]
        idxs = torch.where(valid[:, None], idxs, -1)
        return dists, idxs

    forward = __call__
