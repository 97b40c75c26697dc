"""State carried across from the JAX package.

For the front end without learned weights, what must agree is the
configuration and the precomputed filters (Gaussian kernels, band
operators). ``state_from_numpy`` turns a nested dict of numpy arrays,
exported from the JAX side, into tensors on a device.

The back end's state crosses as the arrays of its pytrees: an Se3 as its
quaternion data (wxyz, kept as stored, not renormalised) and translation,
a ``BAState``, ``BAProblem`` or ``PoseGraph`` as its fields. Index arrays
become int64. A rendered scene crosses as its four arrays
(``plane_scene_from_numpy``), so that both packages render the same room.

A ``TrackState`` crosses as its eight arrays
(``track_state_from_numpy``), so that both trackers resume from one state.
An ``ImageRegistrator``'s parameters and optax Adam state (count, mu, nu)
cross as arrays (``registration_state_from_numpy``), so that both
optimisers continue from one step; ``KMeans`` crosses as its centres
(``kmeans_from_numpy``).

An augmentation's parameters cross as the arrays of its params dict, a
container's as the list of its ops' dicts, ``PatchSequential``'s as its
``PatchParamItem`` records (``aug_params_from_numpy``), dtypes kept, so
that the port replays the draws of the JAX package.

The learned nets cross as their parameter dicts (``*_from_numpy``): HardNet,
HardNet8, OriNet, AffNet, KeyNet, TFeat, SOSNet, HyNet and LightGlue store
OIHW conv weights and torch-layout linears, as torch does; LoFTR and DISK
store their convs HWIO, which become OIHW. An MKD whitening model crosses
as its arrays (``mkd_whitening_from_numpy``). The dissolving diffusion model
crosses as its flax parameter tree (``diffusion_from_numpy``): convs HWIO
→ OIHW, transposed convs to torch's (in, out, kH, kW) with the taps
flipped, dense kernels transposed.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from .augmentation.video import PatchParamItem
from .contrib.ops import KMeans
from .feature.affnet import AffNet, OriNet
from .feature.descriptors import HyNet, KeyNet, SOSNet, TFeat
from .feature.disk import DISK
from .feature.extras import HardNet8
from .feature.hardnet import HardNet
from .feature.lightglue import LightGlue, LightGlueConfig
from .feature.loftr import LoFTR, LoFTRConfig
from .geometry.liegroup import Quaternion, Se3, So3
from .geometry.registration import AdamState
from .models.diffusion import DiffusionConfig, StableDiffusionDissolving
from .slam.ba import BAProblem, BAState
from .slam.posegraph import PoseGraph
from .tracking.bytetrack import TrackState
from .utils.render import PlaneScene

__all__ = ["registration_state_from_numpy", "kmeans_from_numpy",
           "state_from_numpy", "se3_from_numpy", "ba_state_from_numpy",
           "ba_problem_from_numpy", "pose_graph_from_numpy",
           "plane_scene_from_numpy", "hardnet_from_numpy",
           "orinet_from_numpy", "affnet_from_numpy", "keynet_from_numpy",
           "loftr_from_numpy", "track_state_from_numpy",
           "aug_params_from_numpy", "diffusion_from_numpy"]

Device = Union[str, torch.device]


def state_from_numpy(tree: Union[Mapping[str, Any], Any],
                     device: Union[str, torch.device] = "cuda") -> Any:
    """Nested dict (or list/tuple) of numpy arrays → the same structure of
    tensors on `device`, dtypes kept."""
    if isinstance(tree, Mapping):
        return {k: state_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(state_from_numpy(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype == object:
        raise TypeError(f"cannot convert a leaf of type {type(tree)!r}")
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def _tensor(a, device: Device, dtype=None) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype, copy=True)
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a)).copy())
    return t.to(device=device, dtype=dtype)


def se3_from_numpy(wxyz, t, device: Device = "cuda"):
    """Quaternion data (..., 4) wxyz and translation (..., 3) → Se3."""
    return Se3(So3(Quaternion(_tensor(wxyz, device, torch.float32))),
               _tensor(t, device, torch.float32))


def ba_state_from_numpy(wxyz, t, points, device: Device = "cuda"):
    """Camera poses (C, 4) wxyz + (C, 3), points (P, 3) → BAState."""
    return BAState(se3_from_numpy(wxyz, t, device),
                   _tensor(points, device, torch.float32))


def ba_problem_from_numpy(cam_idx, pt_idx, uv, valid, K,
                          device: Device = "cuda"):
    """Observation arrays (O,), (O,), (O, 2), (O,) and K (3, 3) →
    BAProblem."""
    return BAProblem(_tensor(cam_idx, device, torch.int64),
                     _tensor(pt_idx, device, torch.int64),
                     _tensor(uv, device, torch.float32),
                     _tensor(valid, device, torch.bool),
                     _tensor(K, device, torch.float32))


def pose_graph_from_numpy(src, dst, meas_wxyz, meas_t, weight, valid,
                          device: Device = "cuda"):
    """Edges (E,) src/dst, measured relative poses (E, 4) wxyz + (E, 3),
    weights (E,) and validity (E,) → PoseGraph."""
    return PoseGraph(_tensor(src, device, torch.int64),
                     _tensor(dst, device, torch.int64),
                     se3_from_numpy(meas_wxyz, meas_t, device),
                     _tensor(weight, device, torch.float32),
                     _tensor(valid, device, torch.bool))


def plane_scene_from_numpy(origins, edge_u, edge_v, textures,
                           device: Device = "cuda") -> PlaneScene:
    """Rectangles (P, 3) origins, u and v edges and (P, Ht, Wt) textures →
    PlaneScene (float32)."""
    return PlaneScene(_tensor(origins, device, torch.float32),
                      _tensor(edge_u, device, torch.float32),
                      _tensor(edge_v, device, torch.float32),
                      _tensor(textures, device, torch.float32))


def hardnet_from_numpy(params: Mapping[str, Any],
                       device: Device = "cuda") -> HardNet:
    """The JAX HardNet's param dict → HardNet."""
    return HardNet(params, device)


def orinet_from_numpy(params: Mapping[str, Any],
                      device: Device = "cuda") -> OriNet:
    """The JAX OriNet's param dict → OriNet."""
    return OriNet(params, device=device)


def affnet_from_numpy(params: Mapping[str, Any],
                      device: Device = "cuda") -> AffNet:
    """The JAX AffNet's param dict → AffNet."""
    return AffNet(params, device)


def keynet_from_numpy(params: Mapping[str, Any], num_filters: int = 8,
                      num_levels: int = 3, kernel_size: int = 5,
                      device: Device = "cuda") -> KeyNet:
    """The JAX KeyNet's param dict (checkpoint names, OIHW) → KeyNet."""
    return KeyNet({k: np.asarray(v) for k, v in params.items()},
                  num_filters=num_filters, num_levels=num_levels,
                  kernel_size=kernel_size, device=device)


def hardnet8_from_numpy(params: Mapping[str, Any],
                        device: Device = "cuda") -> HardNet8:
    """The JAX HardNet8's param dict (flat names, OIHW, PCA buffers) →
    HardNet8."""
    return HardNet8({k: np.asarray(v) for k, v in params.items()}, device)


def tfeat_from_numpy(params: Mapping[str, Any],
                     device: Device = "cuda") -> TFeat:
    """The JAX TFeat's param dict (checkpoint names) → TFeat."""
    return TFeat({k: np.asarray(v) for k, v in params.items()},
                 device=device)


def sosnet_from_numpy(params: Mapping[str, Any],
                      device: Device = "cuda") -> SOSNet:
    """The JAX SOSNet's param dict (checkpoint names) → SOSNet."""
    return SOSNet({k: np.asarray(v) for k, v in params.items()},
                  device=device)


def hynet_from_numpy(params: Mapping[str, Any], eps_l2_norm: float = 1e-10,
                     device: Device = "cuda") -> HyNet:
    """The JAX HyNet's param dict (checkpoint names) → HyNet."""
    return HyNet({k: np.asarray(v) for k, v in params.items()},
                 eps_l2_norm=eps_l2_norm, device=device)


def mkd_whitening_from_numpy(model: Mapping[str, Any]) -> dict:
    """A JAX MKD whitening model (dict[algo] of 'mean', 'eigvecs',
    'eigvals', or one more level keyed by training set) → the same dict
    of float32 numpy arrays, which ``MKDDescriptor(whitening_model=...)``
    takes."""
    return {k: (mkd_whitening_from_numpy(v) if isinstance(v, Mapping)
                else np.asarray(v, np.float32)) for k, v in model.items()}


def lightglue_from_numpy(params: Mapping[str, Any],
                         cfg: Optional[LightGlueConfig] = None,
                         device: Device = "cuda") -> LightGlue:
    """The JAX LightGlue's param dict (checkpoint names) → LightGlue."""
    return LightGlue(cfg, {k: np.asarray(v) for k, v in params.items()},
                     device=device)


def disk_from_numpy(params: Mapping[str, Any],
                    device: Device = "cuda") -> DISK:
    """The JAX DISK's param dict (HWIO convolutions) → DISK (OIHW inside)."""
    return DISK(params={k: np.asarray(v) for k, v in params.items()},
                device=device)


def loftr_from_numpy(params: Mapping[str, Any],
                     cfg: Optional[LoFTRConfig] = None,
                     device: Device = "cuda") -> LoFTR:
    """The JAX LoFTR's param dict (4-D conv weights HWIO) → LoFTR."""
    out = {k: np.asarray(v) for k, v in params.items()}
    return LoFTR(cfg, {k: v.transpose(3, 2, 0, 1) if v.ndim == 4 else v
                       for k, v in out.items()}, device=device)


def track_state_from_numpy(mean, cov, score, cls, track_id, alive, misses,
                           next_id, device: Device = "cuda") -> TrackState:
    """A track table's arrays (T, 8), (T, 8, 8), (T,) x 5 and () →
    TrackState (float32, int32 ids, misses and next_id, bool alive)."""
    f32, i32 = torch.float32, torch.int32
    return TrackState(_tensor(mean, device, f32), _tensor(cov, device, f32),
                      _tensor(score, device, f32), _tensor(cls, device, f32),
                      _tensor(track_id, device, i32),
                      _tensor(alive, device, torch.bool),
                      _tensor(misses, device, i32),
                      _tensor(next_id, device, i32))


def registration_state_from_numpy(params, count, mu, nu,
                                  device: Device = "cuda"):
    """A registrator's (P,) parameters and its optax ``ScaleByAdamState``
    arrays → (params float32, AdamState with an int32 count)."""
    return (_tensor(params, device, torch.float32),
            AdamState(_tensor(count, device, torch.int32),
                      _tensor(mu, device, torch.float32),
                      _tensor(nu, device, torch.float32)))


def kmeans_from_numpy(cluster_centers, num_clusters: Optional[int] = None,
                      max_iterations: int = 20, seed: int = 0,
                      device: Device = "cuda") -> KMeans:
    """A fitted ``KMeans`` from its (K, D) centres."""
    centers = _tensor(cluster_centers, device, torch.float32)
    km = KMeans(num_clusters or centers.shape[0],
                max_iterations=max_iterations, seed=seed)
    km.cluster_centers = centers
    return km


def aug_params_from_numpy(params: Any, device: Device = "cuda") -> Any:
    """A JAX augmentation's params dict (or a container's list of them, or
    ``PatchSequential``'s records) → the same structure of tensors on
    `device`, dtypes kept (bool masks, int32 indices, float32 values).
    The port's own params, on any device, are copied the same way."""
    if isinstance(params, Mapping):
        return {k: aug_params_from_numpy(v, device)
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(aug_params_from_numpy(v, device) for v in params)
    if hasattr(params, "indices") and hasattr(params, "op_index"):
        return PatchParamItem(tuple(int(i) for i in params.indices),
                              int(params.op_index),
                              aug_params_from_numpy(params.data, device))
    return _tensor(params, device)


def _diffusion_state(params: Mapping[str, Any], cfg: DiffusionConfig
                     ) -> dict:
    """The flax tree of ``_DissolveModel`` → the port's state dict."""
    tree = params.get("params", params)
    state = {}

    def arr(v):
        return np.asarray(v, np.float32)

    def conv(dst, src):
        state[f"{dst}.weight"] = arr(src["kernel"]).transpose(3, 2, 0, 1)
        state[f"{dst}.bias"] = arr(src["bias"])

    def conv_t(dst, src):
        k = arr(src["kernel"]).transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
        state[f"{dst}.weight"] = k
        state[f"{dst}.bias"] = arr(src["bias"])

    def dense(dst, src):
        state[f"{dst}.weight"] = arr(src["kernel"]).T
        state[f"{dst}.bias"] = arr(src["bias"])

    def norm(dst, src):
        state[f"{dst}.weight"] = arr(src["scale"])
        state[f"{dst}.bias"] = arr(src["bias"])

    def res(dst, src):
        norm(f"{dst}.norm0", src["GroupNorm_0"])
        conv(f"{dst}.conv0", src["Conv_0"])
        dense(f"{dst}.dense", src["Dense_0"])
        norm(f"{dst}.norm1", src["GroupNorm_1"])
        conv(f"{dst}.conv1", src["Conv_1"])
        if "Conv_2" in src:
            conv(f"{dst}.skip", src["Conv_2"])

    vae = tree["vae"]
    for i in range(4):
        conv(f"vae.enc.{i}", vae[f"e{i}"])
    conv("vae.to_latent", vae["to_latent"])
    conv("vae.from_latent", vae["from_latent"])
    for i in range(3):
        conv_t(f"vae.dec.{i}", vae[f"d{i}"])
    conv("vae.to_rgb", vae["to_rgb"])
    unet = tree["unet"]
    n = len(cfg.unet_channels)
    # flax names the time MLP's inner Dense second: Dense_0(silu(Dense_1))
    dense("unet.time_in", unet["Dense_1"])
    dense("unet.time_out", unet["Dense_0"])
    conv("unet.conv_in", unet["Conv_0"])
    for i in range(n):
        res(f"unet.down.{i}", unet[f"_ResBlock_{i}"])
        res(f"unet.up.{i}", unet[f"_ResBlock_{n + 2 + i}"])
    for i in range(n - 1):
        conv(f"unet.downsample.{i}", unet[f"Conv_{1 + i}"])
        conv(f"unet.upsample.{i}", unet[f"Conv_{n + i}"])
    res("unet.mid0", unet[f"_ResBlock_{n}"])
    res("unet.mid1", unet[f"_ResBlock_{n + 1}"])
    attn = unet["_SelfAttention2d_0"]
    c = cfg.unet_channels[-1]
    norm("unet.attn.norm", attn["GroupNorm_0"])
    mha = attn["MultiHeadDotProductAttention_0"]
    for part in ("query", "key", "value"):
        # (C, heads, head_dim) → a (C, C) product
        k = arr(mha[part]["kernel"]).reshape(c, c)
        state[f"unet.attn.{part}.weight"] = k.T
        state[f"unet.attn.{part}.bias"] = arr(mha[part]["bias"]).reshape(c)
    state["unet.attn.out.weight"] = arr(mha["out"]["kernel"]).reshape(c, c).T
    state["unet.attn.out.bias"] = arr(mha["out"]["bias"])
    norm("unet.norm_out", unet["GroupNorm_0"])
    conv("unet.conv_out", unet[f"Conv_{2 * n - 1}"])
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in state.items()}


def diffusion_from_numpy(params: Mapping[str, Any],
                         cfg: Optional[DiffusionConfig] = None,
                         device: Device = "cuda"
                         ) -> StableDiffusionDissolving:
    """The JAX ``StableDiffusionDissolving``'s flax parameter tree (with
    or without its "params" level) → StableDiffusionDissolving."""
    cfg = cfg or DiffusionConfig()
    return StableDiffusionDissolving(cfg, _diffusion_state(params, cfg),
                                     device=device)
