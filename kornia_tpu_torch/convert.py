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

XFeat crosses as its param dict (checkpoint names, HWIO convolutions, as
DISK). ALIKED, DINOv2, DeDoDe (the detector, descriptors B and G), SOLD2
and DeFMO cross as their flax variables (``params`` and ``batch_stats``):
each port module's parameter table (``feature/_nets.py``) names, for every
checkpoint entry, the flax path it comes from (HWIO → OIHW, dense kernels
transposed).

The detection and dense-prediction models cross as their JAX parameters:
RT-DETR, YuNet, DexiNed and RRDBNet as flat dicts under the state dict's
names (``_from_jax_specs``: HWIO → OIHW, (in, out) → (out, in), DexiNed's
gather convolutions back to transposed ones); SmallSR, the UNet segmentor,
Depth Anything and the ObjectDetector's head as flax variables through
their tables.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from .augmentation.video import PatchParamItem
from .contrib.ops import KMeans
from .feature import _nets
from .feature.affnet import AffNet, OriNet
from .feature.aliked import ALIKED
from .feature.aliked import _param_rows as _aliked_rows
from .feature.dedode import (DeDoDe, _descriptor_b_rows, _descriptor_g_rows,
                             _detector_rows)
from .feature.defmo import DeFMO
from .feature.defmo import _param_rows as _defmo_rows
from .feature.dinov2 import VIT_LARGE_CFG, DinoV2ViT, _vit
from .feature.dinov2 import _param_rows as _dinov2_rows
from .feature.descriptors import HyNet, KeyNet, SOSNet, TFeat
from .feature.disk import DISK
from .feature.extras import HardNet8
from .feature.hardnet import HardNet
from .feature.lightglue import LightGlue, LightGlueConfig
from .feature.loftr import LoFTR, LoFTRConfig
from .feature.sold2 import SOLD2
from .feature.sold2 import _param_rows as _sold2_rows
from .feature.xfeat import XFeat
from .feature.xfeat import _param_rows as _xfeat_rows
from .geometry.liegroup import Quaternion, Se3, So3
from .geometry.registration import AdamState
from .contrib.detection import ObjectDetector, _TinyDetHead
from .models import dexined as _dexined
from .models import rrdbnet as _rrdbnet
from .models import rt_detr as _rt_detr
from .models import yunet as _yunet
from .models.depth_anything import (DepthAnything, DepthAnythingConfig,
                                    _param_rows as _depth_anything_rows)
from .models.diffusion import DiffusionConfig, StableDiffusionDissolving
from .models.small_sr import (SmallSR, UNetSegmentor, _SmallSRModule,
                              _UNetModule)
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
           "aug_params_from_numpy", "diffusion_from_numpy",
           "xfeat_from_numpy", "aliked_from_numpy", "dinov2_from_numpy",
           "dedode_from_numpy", "sold2_from_numpy", "defmo_from_numpy",
           "rtdetr_from_numpy", "yunet_from_numpy", "dexined_from_numpy",
           "rrdbnet_from_numpy", "small_sr_from_numpy",
           "unet_segmentor_from_numpy", "depth_anything_from_numpy",
           "object_detector_from_numpy"]

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


def xfeat_from_numpy(params: Mapping[str, Any], device: Device = "cuda",
                     **kw) -> XFeat:
    """The JAX XFeat's param dict (HWIO convolutions) → XFeat; `kw`:
    XFeat's other arguments (top_k, detection_threshold)."""
    return XFeat(params=_nets.from_flax(_xfeat_rows(), params),
                 device=device, **kw)


def aliked_from_numpy(variables: Mapping[str, Any],
                      model_name: str = "aliked-n16",
                      device: Device = "cuda", **kw) -> ALIKED:
    """The JAX ALIKED's flax variables → ALIKED; `kw`: its other
    arguments (num_keypoints, detection_threshold, nms_radius)."""
    return ALIKED(model_name, params=_nets.from_flax(
        _aliked_rows(model_name), variables), device=device, **kw)


def _dinov2_state(variables: Mapping[str, Any], cfg: Mapping,
                  fp=()) -> dict:
    c = dict(VIT_LARGE_CFG, **cfg)
    return _nets.from_flax(_dinov2_rows(
        c["patch_size"], c["embed_dim"], c["depth"], c["mlp_ratio"],
        c["pos_grid"], fp), variables)


def dinov2_from_numpy(variables: Mapping[str, Any],
                      cfg: Optional[Mapping] = None,
                      device: Device = "cuda") -> DinoV2ViT:
    """A JAX DinoV2ViT's flax variables (of `cfg`, VIT_LARGE_CFG's keys)
    → DinoV2ViT."""
    cfg = dict(cfg or {})
    return _vit(cfg, _dinov2_state(variables, cfg), device=device)


def dedode_from_numpy(params_det: Mapping[str, Any],
                      params_desc: Mapping[str, Any],
                      descriptor: str = "B", desc_dim: int = 256,
                      vit_cfg: Optional[Mapping] = None,
                      device: Device = "cuda", **kw) -> DeDoDe:
    """The JAX DeDoDe's flax variables of its detector and its descriptor
    (B, or G with its "dinov2" subtree) → DeDoDe; `kw`: num_keypoints."""
    det = _nets.from_flax(_detector_rows(), params_det)
    if descriptor == "G":
        cfg = dict(VIT_LARGE_CFG, **(vit_cfg or {}))
        desc = _nets.from_flax(_descriptor_g_rows(desc_dim,
                                                  cfg["embed_dim"]),
                               params_desc)
        desc.update({f"dinov2.{k}": v for k, v in _dinov2_state(
            params_desc, cfg, ("dinov2",)).items()})
    else:
        desc = _nets.from_flax(_descriptor_b_rows(desc_dim), params_desc)
    return DeDoDe(desc_dim, descriptor=descriptor, params_det=det,
                  params_desc=desc, vit_cfg=vit_cfg, device=device, **kw)


def sold2_from_numpy(variables: Mapping[str, Any], device: Device = "cuda",
                     cls=SOLD2, **kw) -> SOLD2:
    """The JAX SOLD2Net's flax variables → SOLD2 (or `cls`, e.g.
    SOLD2_detector); `kw`: its other arguments."""
    return cls(params=_nets.from_flax(_sold2_rows(), variables),
               device=device, **kw)


def defmo_from_numpy(variables: Mapping[str, Any], tsr_steps: int = 24,
                     device: Device = "cuda") -> DeFMO:
    """The JAX DeFMO's flax variables → DeFMO."""
    return DeFMO(tsr_steps, params=_nets.from_flax(_defmo_rows(),
                                                   variables),
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


# -- the detection and dense-prediction models ---------------------------------

# a JAX flat dict's kind → the transform into torch's layout
_FROM_JAX = {
    "conv": lambda v: v.transpose(3, 2, 0, 1),       # HWIO → OIHW
    "conv_w": lambda v: v.transpose(3, 2, 0, 1),
    "dw_w": lambda v: v.transpose(3, 2, 0, 1),
    "lin": lambda v: v.T,                            # (in, out) → (out, in)
    # DexiNed's transposed convolutions, held as the equivalent gather
    # convolution (HWIO, kernel flipped) → ConvTranspose2d's (in, out, k, k)
    "convT_w": lambda v: v[::-1, ::-1].transpose(2, 3, 0, 1),
}


def _from_jax_specs(specs: Mapping[str, Any], params: Mapping[str, Any]
                    ) -> dict:
    """A JAX flat param dict → torch's layout, by its table's kinds."""
    return {k: np.ascontiguousarray(_FROM_JAX.get(kind, lambda a: a)(
        np.asarray(params[k], np.float32))) for k, (kind, _) in specs.items()}


def rtdetr_from_numpy(params: Mapping[str, Any],
                      cfg: Optional["_rt_detr.RTDETRConfig"] = None,
                      device: Device = "cuda") -> "_rt_detr.RTDETR":
    """The JAX RT-DETR's param dict (HWIO convolutions, (in, out)
    linears) → RTDETR."""
    cfg = cfg or _rt_detr.RTDETRConfig()
    return _rt_detr.RTDETR(cfg, _from_jax_specs(_rt_detr._param_specs(cfg),
                                                params), device=device)


def yunet_from_numpy(params: Mapping[str, Any], device: Device = "cuda",
                     phase: str = "test") -> "_yunet.YuNet":
    """The JAX YuNet's param dict → YuNet."""
    return _yunet.YuNet(_from_jax_specs(_yunet._param_specs(), params),
                        phase=phase, device=device)


def dexined_from_numpy(params: Mapping[str, Any],
                       device: Device = "cuda") -> "_dexined.DexiNed":
    """The JAX DexiNed's param dict (the transposed convolutions as gather
    convolutions) → DexiNed."""
    return _dexined.DexiNed(_from_jax_specs(_dexined._param_specs(), params),
                            device=device)


def rrdbnet_from_numpy(params: Mapping[str, Any],
                       cfg: Optional["_rrdbnet.RRDBNetConfig"] = None,
                       device: Device = "cuda") -> "_rrdbnet.RRDBNet":
    """The JAX RRDBNet's param dict → RRDBNet."""
    cfg = cfg or _rrdbnet.RRDBNetConfig()
    return _rrdbnet.RRDBNet(cfg, _from_jax_specs(_rrdbnet._param_specs(cfg),
                                                 params), device=device)


def _params_of(variables: Mapping[str, Any]) -> Mapping[str, Any]:
    """A flax variable tree with its "params" level."""
    return variables if "params" in variables else {"params": variables}


def small_sr_from_numpy(variables: Mapping[str, Any], scale: int = 2,
                        device: Device = "cuda") -> SmallSR:
    """The JAX SmallSR's flax variables → SmallSR."""
    v = _params_of(variables)
    cin = int(np.shape(v["params"]["Conv_0"]["kernel"])[2])
    rows = _SmallSRModule(scale, device=device)._rows(cin)
    return SmallSR(scale, params=_nets.from_flax(rows, v), device=device)


def unet_segmentor_from_numpy(variables: Mapping[str, Any],
                              num_classes: int = 21,
                              device: Device = "cuda") -> UNetSegmentor:
    """The JAX UNetSegmentor's flax variables → UNetSegmentor."""
    v = _params_of(variables)
    cin = int(np.shape(v["params"]["Conv_0"]["kernel"])[2])
    rows = _UNetModule(num_classes, device=device)._rows(cin)
    return UNetSegmentor(num_classes, params=_nets.from_flax(rows, v),
                         device=device)


def depth_anything_from_numpy(variables: Mapping[str, Any],
                              cfg: Optional[DepthAnythingConfig] = None,
                              device: Device = "cuda") -> DepthAnything:
    """The JAX DepthAnythingNet's flax variables → DepthAnything (its
    position table keeps its size)."""
    cfg = cfg or DepthAnythingConfig()
    v = _params_of(variables)
    n_pos = int(np.shape(v["params"]["pos_embed"])[0])
    return DepthAnything(cfg, _nets.from_flax(
        _depth_anything_rows(cfg, n_pos), v), device=device)


def object_detector_from_numpy(variables: Mapping[str, Any],
                               device: Device = "cuda",
                               **kw) -> ObjectDetector:
    """The flax variables of the JAX ObjectDetector's default head
    (``_TinyDetHead``) → ObjectDetector; `kw`: its other arguments
    (num_classes, input_size, confidence, ...)."""
    v = _params_of(variables)
    cin = int(np.shape(v["params"]["Conv_0"]["kernel"])[2])
    rows = _TinyDetHead(kw.get("num_classes", 80), device=device)._rows(cin)
    return ObjectDetector(params=_nets.from_flax(rows, v), device=device,
                          **kw)
