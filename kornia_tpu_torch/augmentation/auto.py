"""Auto-augmentation policies (counterpart of
``kornia_tpu/augmentation/auto.py``): RandAugment, TrivialAugment,
AutoAugment with its exact policy tables, and ``Operation``, an op with a
differentiable magnitude and a straight-through probability gate.

Each policy step evaluates every candidate op on the whole batch and
selects one per sample (``_apply_indexed``): choosing per sample on the
host would need a host read of the drawn op indices. The policies draw
inside ``__call__`` from a generator on the input's device, or take the
draws injected (keyword-only ``draws``): RandAugment a list of one dict a
step ``{"op_idx", "signs"}`` (and ``"mag01"``, else m / 30),
TrivialAugment ``{"op_idx", "mag01", "signs"}``, AutoAugment
``{"sub_idx", "steps": [{"u", "gate"}, ...]}``. The policy tables move to
the input's device at first use (cached per device).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.dtype import as_float
from ..ops import enhance as E
from ..ops import warp as W
from .base import default_generator, device_table, eye_batch

__all__ = ["RandAugment", "TrivialAugment", "AutoAugment", "Operation",
           "IMAGENET_POLICY", "CIFAR10_POLICY", "SVHN_POLICY"]


def _shear(x, coef, axis: int):
    """Shear by `coef` (one a sample) along x (axis 0) or y (axis 1)."""
    B = x.shape[0]
    M = eye_batch(B, x.device).clone()
    if axis == 0:
        M[:, 0, 1] = coef
    else:
        M[:, 1, 0] = coef
    return W.warp_perspective(x, M, tuple(x.shape[-2:]), align_corners=True)


def _shear_x(x, mag):
    return _shear(x, mag, 0)


def _shear_y(x, mag):
    return _shear(x, mag, 1)


def _translate_x(x, mag):
    return W.translate(x, torch.stack([mag * x.shape[-1],
                                       torch.zeros_like(mag)], -1))


def _translate_y(x, mag):
    return W.translate(x, torch.stack([torch.zeros_like(mag),
                                       mag * x.shape[-2]], -1))


def _rotate(x, mag):
    return W.rotate(x, mag)


def _posterize_bits(m) -> torch.Tensor:
    return m.clamp(1, 8).to(torch.int32)


# op table: name → (fn(x, magnitude), magnitude range, signed)
_OPS: List[Tuple[str, Callable, Tuple[float, float], bool]] = [
    ("identity", lambda x, m: x, (0.0, 0.0), False),
    ("auto_contrast", lambda x, m: E.normalize_min_max(x), (0.0, 0.0), False),
    ("equalize", lambda x, m: E.equalize(x), (0.0, 0.0), False),
    ("invert", lambda x, m: E.invert(x), (0.0, 0.0), False),
    ("brightness", lambda x, m: E.adjust_brightness(x, 1.0 + m), (0.0, 0.9),
     True),
    ("contrast", lambda x, m: E.adjust_contrast_with_mean_subtraction(
        x, 1.0 + m), (0.0, 0.9), True),
    ("saturation", lambda x, m: E.adjust_saturation(x, 1.0 + m), (0.0, 0.9),
     True),
    ("sharpness", lambda x, m: E.sharpness(x, m.abs()), (0.0, 0.9), True),
    ("posterize", lambda x, m: E.posterize(x, _posterize_bits(8.0 - m)),
     (0.0, 4.0), False),
    ("solarize", lambda x, m: E.solarize(x, 1.0 - m), (0.0, 1.0), False),
    ("rotate", _rotate, (0.0, 30.0), True),
    ("shear_x", _shear_x, (0.0, 0.3), True),
    ("shear_y", _shear_y, (0.0, 0.3), True),
    ("translate_x", _translate_x, (0.0, 0.3), True),
    ("translate_y", _translate_y, (0.0, 0.3), True),
]


def _select(outs: List[torch.Tensor], op_idx: torch.Tensor) -> torch.Tensor:
    """outs[op_idx[b]][b] for each sample b: every candidate evaluated,
    one kept per sample on the device."""
    stack = torch.stack(outs)  # (n_ops, B, C, H, W)
    sel = op_idx.long().reshape(1, -1, *([1] * (stack.ndim - 2)))
    return torch.take_along_dim(stack, sel, dim=0)[0]


def _apply_indexed(x: torch.Tensor, op_idx: torch.Tensor,
                   mag01: torch.Tensor, signs: torch.Tensor,
                   ops=None) -> torch.Tensor:
    """Every candidate op, selected per sample by op_idx; mag01 in [0, 1]
    mapped to each op's own magnitude range."""
    outs = []
    for _, fn, (lo, hi), signed in (ops if ops is not None else _OPS):
        mag = lo + mag01 * (hi - lo)
        outs.append(fn(x, mag * signs if signed else mag))
    return _select(outs, op_idx)


def _signs(generator, B: int) -> torch.Tensor:
    u = torch.rand(B, generator=generator, device=generator.device)
    return torch.where(u < 0.5, 1.0, -1.0)


def _draw_op_idx(generator, B: int, n: int) -> torch.Tensor:
    return torch.randint(0, n, (B,), generator=generator,
                         device=generator.device, dtype=torch.int32)


class RandAugment:
    """n ops at the shared magnitude m (of 30)."""

    def __init__(self, n: int = 2, m: int = 10):
        self.n = n
        self.m = m

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 draws: Optional[Sequence[Dict]] = None) -> torch.Tensor:
        x = as_float(x)
        B = x.shape[0]
        if draws is None:
            generator = generator or default_generator(x.device)
            draws = [{"op_idx": _draw_op_idx(generator, B, len(_OPS)),
                      "signs": _signs(generator, B)} for _ in range(self.n)]
        for d in draws:
            mag01 = d.get("mag01")
            if mag01 is None:
                mag01 = torch.full((B,), self.m / 30.0, device=x.device)
            x = _apply_indexed(x, d["op_idx"], mag01, d["signs"])
        return x


class TrivialAugment:
    """One random op at a random magnitude."""

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 draws: Optional[Dict] = None) -> torch.Tensor:
        x = as_float(x)
        B = x.shape[0]
        if draws is None:
            generator = generator or default_generator(x.device)
            draws = {"op_idx": _draw_op_idx(generator, B, len(_OPS)),
                     "mag01": torch.rand(B, generator=generator,
                                         device=x.device),
                     "signs": _signs(generator, B)}
        return _apply_indexed(x, draws["op_idx"], draws["mag01"],
                              draws["signs"])


class Operation:
    """An auto-augmentation op with an explicit, differentiable magnitude:
    gradients flow through it because every op in the tables is
    differentiable, and the probability gate is straight-through: out =
    x + gate · (op(x) - x)."""

    def __init__(self, name: str, fn: Callable, probability: float = 0.5,
                 magnitude_range: Optional[Tuple[float, float]] = None):
        self.name = name
        self.fn = fn
        self.probability = probability
        self.magnitude_range = magnitude_range

    def __call__(self, x: torch.Tensor, generator: torch.Generator,
                 magnitude: Optional[torch.Tensor] = None,
                 probability: Optional[torch.Tensor] = None, *,
                 draws: Optional[Dict] = None) -> torch.Tensor:
        """draws: the injected ``{"gate": (B,)}`` (and ``"magnitude"``
        when the op draws its own)."""
        B = x.shape[0]
        if draws is None:
            dev = generator.device
            draws = {}
            if magnitude is None and self.magnitude_range is not None:
                lo, hi = self.magnitude_range
                draws["magnitude"] = torch.rand(
                    B, generator=generator, device=dev) * (hi - lo) + lo
            p = self.probability if probability is None else probability
            draws["gate"] = torch.rand(B, generator=generator,
                                       device=dev) < p
        if magnitude is None:
            magnitude = draws.get("magnitude")
        gate = draws["gate"].to(x.dtype)
        mag = (torch.zeros((B,), dtype=x.dtype, device=x.device)
               if magnitude is None else torch.as_tensor(
                   magnitude, dtype=x.dtype, device=x.device).expand(B))
        out = self.fn(x, mag)
        return x + gate[:, None, None, None] * (out - x)


# -----------------------------------------------------------------------------
# AutoAugment: the exact policy tables; each (op, p, level) draws its
# magnitude uniformly in [linspace[level], linspace[level + 1]]
# -----------------------------------------------------------------------------


def _deg2shear(x, deg, axis):
    return _shear(x, torch.tan(torch.deg2rad(deg)), 0 if axis == "x" else 1)


# native-unit op table of the AutoAugment policies: name → fn(x, magnitude)
_AA_FNS: Dict[str, Callable] = {
    "shear_x": lambda x, m: _deg2shear(x, m, "x"),
    "shear_y": lambda x, m: _deg2shear(x, m, "y"),
    "translate_x": _translate_x,
    "translate_y": _translate_y,
    "rotate": _rotate,
    "auto_contrast": lambda x, m: E.normalize_min_max(x),
    "invert": lambda x, m: E.invert(x),
    "equalize": lambda x, m: E.equalize(x),
    "solarize": lambda x, m: E.solarize(x, m),
    "posterize": lambda x, m: E.posterize(x, _posterize_bits(torch.round(m))),
    "contrast": lambda x, m: E.adjust_contrast_with_mean_subtraction(x, m),
    "brightness": lambda x, m: E.adjust_brightness(x, m - 1.0),
    "sharpness": lambda x, m: E.sharpness(x, m),
    "color": lambda x, m: E.adjust_saturation(x, m),
}

# level → magnitude bin edges (11 edges, 10 bins)
_AA_BINS: Dict[str, Optional[Tuple[float, float]]] = {
    "shear_x": (-0.3 * 180.0, 0.3 * 180.0),
    "shear_y": (-0.3 * 180.0, 0.3 * 180.0),
    "translate_x": (-0.5, 0.5),
    "translate_y": (-0.5, 0.5),
    "rotate": (-30.0, 30.0),
    "solarize": (0.0, 1.0),
    "posterize": (4.0, 8.0),
    "contrast": (0.1, 1.9),
    "brightness": (0.1, 1.9),
    "sharpness": (0.1, 1.9),
    "color": (0.1, 1.9),
    "auto_contrast": None,
    "invert": None,
    "equalize": None,
}


def _bin_edges(name: str, level) -> Tuple[float, float]:
    rng = _AA_BINS[name]
    if rng is None or level is None:
        return (0.0, 0.0)
    lo, hi = rng
    step = (hi - lo) / 10.0
    return (lo + step * level, lo + step * (level + 1))


# exact tables: (op, probability, level 0-10 or None)
IMAGENET_POLICY = [
    [("posterize", 0.4, 8), ("rotate", 0.6, 9)],
    [("solarize", 0.6, 5), ("auto_contrast", 0.6, None)],
    [("equalize", 0.8, None), ("equalize", 0.6, None)],
    [("posterize", 0.6, 7), ("posterize", 0.6, 6)],
    [("equalize", 0.4, None), ("solarize", 0.2, 4)],
    [("equalize", 0.4, None), ("rotate", 0.8, 8)],
    [("solarize", 0.6, 3), ("equalize", 0.6, None)],
    [("posterize", 0.8, 5), ("equalize", 1.0, None)],
    [("rotate", 0.2, 3), ("solarize", 0.6, 8)],
    [("equalize", 0.6, None), ("posterize", 0.4, 6)],
    [("rotate", 0.8, 8), ("color", 0.4, 0)],
    [("rotate", 0.4, 9), ("equalize", 0.6, None)],
    [("equalize", 0.0, None), ("equalize", 0.8, None)],
    [("invert", 0.6, None), ("equalize", 1.0, None)],
    [("color", 0.6, 4), ("contrast", 1.0, 8)],
    [("rotate", 0.8, 8), ("color", 1.0, 2)],
    [("color", 0.8, 8), ("solarize", 0.8, 7)],
    [("sharpness", 0.4, 7), ("invert", 0.6, None)],
    [("shear_x", 0.6, 5), ("equalize", 1.0, None)],
    [("color", 0.4, 0), ("equalize", 0.6, None)],
    [("equalize", 0.4, None), ("solarize", 0.2, 4)],
    [("solarize", 0.6, 5), ("auto_contrast", 0.6, None)],
    [("invert", 0.6, None), ("equalize", 1.0, None)],
    [("color", 0.6, 4), ("contrast", 1.0, 8)],
    [("equalize", 0.8, None), ("equalize", 0.6, None)],
]

CIFAR10_POLICY = [
    [("invert", 0.1, None), ("contrast", 0.2, 6)],
    [("rotate", 0.7, 2), ("translate_x", 0.3, 9)],
    [("sharpness", 0.8, 1), ("sharpness", 0.9, 3)],
    [("shear_y", 0.5, 8), ("translate_y", 0.7, 9)],
    [("auto_contrast", 0.5, None), ("equalize", 0.9, None)],
    [("shear_y", 0.2, 7), ("posterize", 0.3, 7)],
    [("color", 0.4, 3), ("brightness", 0.6, 7)],
    [("sharpness", 0.3, 9), ("brightness", 0.7, 9)],
    [("equalize", 0.6, None), ("equalize", 0.5, None)],
    [("contrast", 0.6, 7), ("sharpness", 0.6, 5)],
    [("color", 0.7, 7), ("translate_x", 0.5, 8)],
    [("equalize", 0.3, None), ("auto_contrast", 0.4, None)],
    [("translate_y", 0.4, 3), ("sharpness", 0.2, 6)],
    [("brightness", 0.9, 6), ("color", 0.2, 8)],
    [("solarize", 0.5, 2), ("invert", 0.0, None)],
    [("equalize", 0.2, None), ("auto_contrast", 0.6, None)],
    [("equalize", 0.2, None), ("equalize", 0.6, None)],
    [("color", 0.9, 9), ("equalize", 0.6, None)],
    [("auto_contrast", 0.8, None), ("solarize", 0.2, 8)],
    [("brightness", 0.1, 3), ("color", 0.7, 0)],
    [("solarize", 0.4, 5), ("auto_contrast", 0.9, None)],
    [("translate_y", 0.9, 9), ("translate_y", 0.7, 9)],
    [("auto_contrast", 0.9, None), ("solarize", 0.8, 3)],
    [("equalize", 0.8, None), ("invert", 0.1, None)],
    [("translate_y", 0.7, 9), ("auto_contrast", 0.9, None)],
]

SVHN_POLICY = [
    [("shear_x", 0.9, 4), ("invert", 0.2, None)],
    [("shear_y", 0.9, 8), ("invert", 0.7, None)],
    [("equalize", 0.6, None), ("solarize", 0.6, 6)],
    [("invert", 0.9, None), ("equalize", 0.6, None)],
    [("equalize", 0.6, None), ("rotate", 0.9, 3)],
    [("shear_x", 0.9, 4), ("auto_contrast", 0.8, None)],
    [("shear_y", 0.9, 8), ("invert", 0.4, None)],
    [("shear_y", 0.9, 5), ("solarize", 0.2, 6)],
    [("invert", 0.9, None), ("auto_contrast", 0.8, None)],
    [("equalize", 0.6, None), ("rotate", 0.9, 3)],
    [("shear_x", 0.9, 4), ("solarize", 0.3, 3)],
    [("shear_y", 0.8, 8), ("invert", 0.7, None)],
    [("equalize", 0.9, None), ("translate_y", 0.6, 6)],
    [("invert", 0.9, None), ("equalize", 0.6, None)],
    [("contrast", 0.3, 3), ("rotate", 0.8, 4)],
    [("invert", 0.8, None), ("translate_y", 0.0, 2)],
    [("shear_y", 0.7, 6), ("solarize", 0.4, 8)],
    [("invert", 0.6, None), ("rotate", 0.8, 4)],
    [("shear_y", 0.3, 7), ("translate_x", 0.9, 3)],
    [("shear_x", 0.1, 6), ("invert", 0.6, None)],
    [("solarize", 0.7, 2), ("translate_y", 0.6, 7)],
    [("shear_y", 0.8, 4), ("invert", 0.8, None)],
    [("shear_x", 0.7, 9), ("translate_y", 0.8, 3)],
    [("shear_y", 0.8, 5), ("auto_contrast", 0.7, None)],
    [("shear_x", 0.7, 2), ("invert", 0.1, None)],
]

_POLICIES = {"imagenet": IMAGENET_POLICY, "cifar10": CIFAR10_POLICY,
             "svhn": SVHN_POLICY}
_AA_NAMES = list(_AA_FNS)
_AA_INDEX = {n: i for i, n in enumerate(_AA_NAMES)}


def _apply_aa_indexed(x: torch.Tensor, op_idx: torch.Tensor,
                      mag: torch.Tensor) -> torch.Tensor:
    """Every policy op at its native-unit magnitude, selected per sample
    by op_idx."""
    return _select([fn(x, mag) for fn in _AA_FNS.values()], op_idx)


class AutoAugment:
    """AutoAugment's searched policies, entry for entry.

    policy: 'imagenet' | 'cifar10' | 'svhn' | a custom list of
    subpolicies [(op_name, probability, level or None), ...]."""

    def __init__(self, policy="imagenet"):
        table = _POLICIES[policy] if isinstance(policy, str) else policy
        self.policy = table
        self.n_steps = max(len(sp) for sp in table)
        # per-step tables (op index, probability, magnitude bin), on the
        # host; device_table keeps one copy per device
        self._tables = []
        for step in range(self.n_steps):
            rows = []
            for sp in table:
                name, p, level = (sp[step] if step < len(sp)
                                  else ("equalize", 0.0, None))
                rows.append((_AA_INDEX[name], p, *_bin_edges(name, level)))
            arr = np.asarray(rows, np.float64)
            self._tables.append((arr[:, 0].astype(np.int32),
                                 arr[:, 1].astype(np.float32),
                                 arr[:, 2].astype(np.float32),
                                 arr[:, 3].astype(np.float32)))

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 draws: Optional[Dict] = None) -> torch.Tensor:
        x = as_float(x)
        B = x.shape[0]
        dev = x.device
        if draws is None:
            generator = generator or default_generator(dev)
            sub_idx = torch.randint(0, len(self.policy), (B,),
                                    generator=generator, device=dev,
                                    dtype=torch.int32)
            steps = []
            for step, (_, prob_t, _, _) in enumerate(self._tables):
                prob = device_table(self, ("prob", step), prob_t,
                                    dev)[sub_idx.long()]
                gate = torch.rand(B, generator=generator, device=dev) < prob
                steps.append({"u": torch.rand(B, generator=generator,
                                              device=dev), "gate": gate})
            draws = {"sub_idx": sub_idx, "steps": steps}
        sub = draws["sub_idx"].long()
        for step, ((op_t, _, lo_t, hi_t), d) in enumerate(
                zip(self._tables, draws["steps"])):
            op_idx = device_table(self, ("op", step), op_t, dev,
                                  torch.int32)[sub]
            lo = device_table(self, ("lo", step), lo_t, dev)[sub]
            hi = device_table(self, ("hi", step), hi_t, dev)[sub]
            applied = _apply_aa_indexed(x, op_idx, lo + d["u"] * (hi - lo))
            x = torch.where(d["gate"][:, None, None, None], applied, x)
        return x
