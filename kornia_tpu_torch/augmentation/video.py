"""Video and patch augmentation containers (counterpart of
``kornia_tpu/augmentation/video.py``).

``VideoSequential`` is an ``AugmentationSequential`` over clips: one
parameter set per clip repeated across its frames (``same_on_frame``), every
data key, and the exact inverse. ``PatchSequential`` applies a different
op selection per patch with replayable ``PatchParamItem`` records; as in
the JAX package, the records are host-side Python data (their op choice is
drawn by numpy from a seed that is read once from the generator), and
replay merges the records that share a round and an op into one call.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as TF

from ..core.dtype import as_float
from .base import (AugmentationBase2D, IntensityAugmentationBase2D,
                   default_generator)
from .container import AugmentationSequential, ImageSequential

__all__ = ["VideoSequential", "PatchSequential", "PatchParamItem"]


def _repeat_batch(p: Dict, n: int, B: Optional[int] = None) -> Dict:
    """Each leaf with a leading batch axis (of B, when given) repeated n
    times along it, element by element."""
    return {k: v.repeat_interleave(n, dim=0)
            if torch.is_tensor(v) and v.ndim >= 1
            and (B is None or v.shape[0] == B) else v
            for k, v in p.items()}


class VideoSequential(AugmentationSequential):
    """Temporally consistent augmentation of clips, (B, T, C, H, W)
    (``data_format="BTCHW"``) or (B, C, T, H, W); coordinate keys are
    (B, T, N, ...). With ``same_on_frame`` one parameter set is drawn per
    clip and repeated across its frames; without, each frame draws its
    own."""

    def __init__(self, *augs: AugmentationBase2D,
                 data_format: str = "BTCHW", same_on_frame: bool = True,
                 data_keys: Sequence[str] = ("input",)):
        super().__init__(*augs, data_keys=data_keys)
        if data_format not in ("BTCHW", "BCTHW"):
            raise ValueError(f"unknown data_format {data_format!r}")
        self.data_format = data_format
        self.same_on_frame = same_on_frame

    # -- clip folding --------------------------------------------------------
    def _fold(self, x: torch.Tensor, k: str) -> torch.Tensor:
        if k in ("input", "mask"):
            if self.data_format == "BCTHW":
                x = x.transpose(1, 2)
            B, T, C, H, W = x.shape
            return x.reshape(B * T, C, H, W)
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def _clip_T(self, x: torch.Tensor, k: str) -> int:
        """Frames a clip, from the input's own shape (an inverse of clips
        of another length must not reuse the forward's)."""
        if k in ("input", "mask") and self.data_format == "BCTHW":
            return x.shape[2]
        return x.shape[1]

    def _unfold(self, x: torch.Tensor, k: str, T: int) -> torch.Tensor:
        x = x.reshape((-1, T) + tuple(x.shape[1:]))
        if k in ("input", "mask") and self.data_format == "BCTHW":
            x = x.transpose(1, 2)
        return x

    def _clip_params(self, generator: torch.Generator, B: int, T: int,
                     frame_shape) -> List[Dict]:
        C, H, W = frame_shape
        if self.same_on_frame:
            params = self.generate_parameters(generator, (B, C, H, W))
            return [_repeat_batch(p, T, B) for p in params]
        return self.generate_parameters(generator, (B * T, C, H, W))

    def _folded(self, inputs, keys_):
        return [self._fold(as_float(x) if k in ("input", "mask")
                           else torch.as_tensor(x), k)
                for x, k in zip(inputs, keys_)]

    def _unfolded(self, out, keys_, T):
        outs = out if isinstance(out, tuple) else (out,)
        outs = tuple(self._unfold(o, k, T) for o, k in zip(outs, keys_))
        return outs[0] if len(outs) == 1 else outs

    def __call__(self, *inputs, data_keys: Optional[Sequence[str]] = None,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[List[Dict]] = None):
        keys_ = list(data_keys) if data_keys is not None else self.data_keys
        img = inputs[keys_.index("input")]
        if self.data_format == "BCTHW":
            B, C, T, H, W = img.shape
        else:
            B, T, C, H, W = img.shape
        if params is None:
            if generator is None:
                generator = default_generator(img.device)
            params = self._clip_params(generator, B, T, (C, H, W))
        out = super().__call__(*self._folded(inputs, keys_), data_keys=keys_,
                               params=params)
        return self._unfolded(out, keys_, T)

    def inverse(self, *inputs, data_keys: Optional[Sequence[str]] = None,
                params: Optional[List[Dict]] = None,
                in_hw: Optional[Tuple[int, int]] = None):
        keys_ = list(data_keys) if data_keys is not None else self.data_keys
        T = self._clip_T(inputs[0], keys_[0])
        out = super().inverse(*self._folded(inputs, keys_), data_keys=keys_,
                              params=params, in_hw=in_hw)
        return self._unfolded(out, keys_, T)


@dataclasses.dataclass(frozen=True)
class PatchParamItem:
    """One replayable patch record: the flat patch indices it applies to,
    the op (by position), and the op's generated parameters."""

    indices: Tuple[int, ...]
    op_index: int
    data: Dict


class PatchSequential(ImageSequential):
    """Per-patch augmentation with replayable records.

    The image is tiled into ``grid_size`` patches (same or valid padding).
    Sampling modes:

      * ``patchwise_apply=True``: op i applies to patch location i (the
        ops must tile the grid);
      * ``random_apply=n``: each patch draws its own random n-op
        subsequence (order shuffled);
      * default: every op applies to every patch, each patch with its own
        parameters; ``same_on_batch=True`` shares one record per patch
        location across the batch.

    ``forward_parameters`` returns ``PatchParamItem`` records; calling with
    ``params=records`` replays them exactly. ``inverse`` is the identity
    for intensity-only pipelines and raises otherwise."""

    def __init__(self, *augs: AugmentationBase2D,
                 grid_size: Union[int, Tuple[int, int]] = 4,
                 padding: str = "same", same_on_batch: bool = False,
                 patchwise_apply: bool = False,
                 random_apply: Union[bool, int] = False):
        super().__init__(*augs)
        self.grid_size = ((grid_size, grid_size)
                          if isinstance(grid_size, int) else tuple(grid_size))
        if padding not in ("same", "valid"):
            raise ValueError(f"`padding` must be 'same' or 'valid', "
                             f"got {padding!r}")
        self.padding = padding
        self.same_on_batch = same_on_batch
        if patchwise_apply:
            if isinstance(random_apply, int) and not isinstance(
                    random_apply, bool):
                raise ValueError(
                    "Only boolean `random_apply` allowed when "
                    f"`patchwise_apply` is set to True. Got {random_apply}.")
            gh, gw = self.grid_size
            if random_apply is False and len(self.augs) != gh * gw:
                raise ValueError(
                    "The number of processing modules must be equal with "
                    f"grid size. Got {len(self.augs)} and {gh * gw}. Please "
                    "set random_apply = True or patchwise_apply = False.")
        self.patchwise_apply = patchwise_apply
        self.random_apply = random_apply
        self._params: Optional[List[PatchParamItem]] = None

    # -- geometry ------------------------------------------------------------
    def compute_padding(self, hw: Tuple[int, int]
                        ) -> Tuple[int, int, int, int]:
        """(left, right, top, bottom), negative = crop."""
        H, W = hw
        gh, gw = self.grid_size
        if self.padding == "valid":
            ph, pw = H // gh, W // gw
            return (-pw // 2, pw // 2 - pw, -ph // 2, ph // 2 - ph)
        ph = H - H // gh * gh
        pw = W - W // gw * gw
        return (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)

    def _pad(self, x: torch.Tensor, pad) -> torch.Tensor:
        l, r, t, b = pad
        H, W = x.shape[-2:]
        x = x[..., max(-t, 0):H - max(-b, 0), max(-l, 0):W - max(-r, 0)]
        return TF.pad(x, (max(l, 0), max(r, 0), max(t, 0), max(b, 0)))

    def extract_patches(self, x: torch.Tensor,
                        pad: Optional[Tuple[int, int, int, int]] = None
                        ) -> torch.Tensor:
        """(B, C, H, W) → (B, P, C, ph, pw), row-major patch order; any
        remainder rows and columns are dropped."""
        if pad is not None:
            x = self._pad(x, pad)
        B, C, H, W = x.shape
        gh, gw = self.grid_size
        ph, pw = H // gh, W // gw
        x = x[..., :gh * ph, :gw * pw].reshape(B, C, gh, ph, gw, pw)
        return x.permute(0, 2, 4, 1, 3, 5).reshape(B, gh * gw, C, ph, pw)

    def restore_from_patches(self, patches: torch.Tensor,
                             pad: Optional[Tuple[int, int, int, int]] = None
                             ) -> torch.Tensor:
        gh, gw = self.grid_size
        B, P, C, ph, pw = patches.shape
        x = patches.reshape(B, gh, gw, C, ph, pw)
        x = x.permute(0, 3, 1, 4, 2, 5).reshape(B, C, gh * ph, gw * pw)
        if pad is not None:
            x = self._pad(x, tuple(-p for p in pad))
        return x

    def is_intensity_only(self) -> bool:
        return all(isinstance(a, IntensityAugmentationBase2D)
                   for a in self.augs)

    # -- parameter sampling --------------------------------------------------
    def forward_parameters(self, generator: torch.Generator, batch_shape
                           ) -> List[PatchParamItem]:
        """Records for `batch_shape` (B, C, H, W) of the original image,
        across the four sampling modes."""
        B, C, H, W = batch_shape
        pad = self.compute_padding((H, W))
        gh, gw = self.grid_size
        P = gh * gw
        ph, pw = (H + pad[2] + pad[3]) // gh, (W + pad[0] + pad[1]) // gw
        n_ops = len(self.augs)
        # the op choice is host data: one read of the generator seeds it
        rng = np.random.default_rng(int(torch.randint(
            0, 2**31 - 1, (), generator=generator,
            device=generator.device)))

        def gen(op_i, nb):
            return self.augs[op_i].generate_parameters(generator,
                                                       (nb, C, ph, pw))

        def one(op_i, nb_shared):
            """A record's params: shared by B (repeated) or per sample."""
            if self.same_on_batch:
                return _repeat_batch(gen(op_i, 1), B)
            return gen(op_i, nb_shared)

        records: List[PatchParamItem] = []
        if self.patchwise_apply:
            for loc in range(P):
                if self.random_apply is True:
                    n_take = int(rng.integers(1, min(4, n_ops) + 1))
                    ops = [int(o) for o in rng.permutation(n_ops)[:n_take]]
                else:
                    ops = [loc % n_ops]
                for op_i in ops:
                    idx = tuple(b * P + loc for b in range(B))
                    records.append(PatchParamItem(idx, op_i, one(op_i, B)))
            return records
        if self.random_apply:
            n_take = (n_ops if self.random_apply is True
                      else min(int(self.random_apply), n_ops))
        units = P if self.same_on_batch else B * P
        for u in range(units):
            ops = ([int(o) for o in rng.permutation(n_ops)[:n_take]]
                   if self.random_apply else range(n_ops))
            for op_i in ops:
                idx = (tuple(b * P + u for b in range(B))
                       if self.same_on_batch else (u,))
                records.append(PatchParamItem(idx, op_i, one(op_i, 1)))
        return records

    # -- replay ---------------------------------------------------------------
    @staticmethod
    def _merge_group(recs: List[PatchParamItem]):
        """A same-op group's indices and params concatenated along the
        batch axis; None if a leaf is not batch-leading (the caller then
        replays record by record)."""
        keys = list(recs[0].data)
        if any(list(r.data) != keys for r in recs[1:]):
            return None
        merged = {}
        for k in keys:
            pieces = [r.data[k] for r in recs]
            if not all(torch.is_tensor(v) and v.ndim >= 1
                       and v.shape[0] == len(r.indices)
                       for v, r in zip(pieces, recs)):
                return None
            merged[k] = torch.cat(pieces, dim=0)
        idx = np.concatenate([np.asarray(r.indices, np.int64) for r in recs])
        return idx, merged

    def forward_by_params(self, patches_flat: torch.Tensor,
                          params: List[PatchParamItem]) -> torch.Tensor:
        """(B·P, C, ph, pw) and records → augmented patches. Records are
        split into rounds that keep each patch's op order (a record's
        round counts the earlier records on any of its patches); within a
        round, the records of one op touch disjoint patches and merge into
        one call."""
        next_round: Dict[int, int] = {}
        groups: Dict[Tuple[int, int], List[PatchParamItem]] = {}
        for rec in params:
            r = max((next_round.get(i, 0) for i in rec.indices), default=0)
            for i in rec.indices:
                next_round[i] = r + 1
            groups.setdefault((r, rec.op_index), []).append(rec)
        dev = patches_flat.device
        for r, op_i in sorted(groups, key=lambda k: k[0]):
            recs = groups[(r, op_i)]
            merged = self._merge_group(recs)
            batches = ([(np.asarray(rec.indices, np.int64), rec.data)
                        for rec in recs] if merged is None else [merged])
            for idx, data in batches:
                idx = torch.from_numpy(idx).to(dev)
                out = self.augs[op_i](patches_flat[idx], params=data)
                patches_flat = patches_flat.index_copy(0, idx, out)
        return patches_flat

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 params: Optional[List[PatchParamItem]] = None
                 ) -> torch.Tensor:
        x = as_float(x)
        B, C, H, W = x.shape
        pad = self.compute_padding((H, W))
        if params is None:
            if generator is None:
                generator = default_generator(x.device)
            params = self.forward_parameters(generator, (B, C, H, W))
        self._params = params
        patches = self.extract_patches(x, pad)
        P = patches.shape[1]
        flat = self.forward_by_params(
            patches.reshape(B * P, *patches.shape[2:]), params)
        return self.restore_from_patches(flat.reshape(B, P, *flat.shape[1:]),
                                         pad)

    def inverse(self, x: torch.Tensor,
                params: Optional[List[PatchParamItem]] = None
                ) -> torch.Tensor:
        """The identity for intensity-only pipelines."""
        if self.is_intensity_only():
            return as_float(x)
        raise NotImplementedError(
            "PatchSequential inverse cannot be used with geometric "
            "transformations.")
