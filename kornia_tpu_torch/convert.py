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

The learned nets cross as their parameter dicts (``*_from_numpy``): HardNet,
OriNet, AffNet and KeyNet store OIHW conv weights, as torch does; LoFTR
stores its convs HWIO, which become OIHW.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from .feature.affnet import AffNet, OriNet
from .feature.descriptors import KeyNet
from .feature.hardnet import HardNet
from .feature.loftr import LoFTR, LoFTRConfig
from .geometry.liegroup import Quaternion, Se3, So3
from .slam.ba import BAProblem, BAState
from .slam.posegraph import PoseGraph
from .tracking.bytetrack import TrackState
from .utils.render import PlaneScene

__all__ = ["state_from_numpy", "se3_from_numpy", "ba_state_from_numpy",
           "ba_problem_from_numpy", "pose_graph_from_numpy",
           "plane_scene_from_numpy", "hardnet_from_numpy",
           "orinet_from_numpy", "affnet_from_numpy", "keynet_from_numpy",
           "loftr_from_numpy", "track_state_from_numpy"]

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
