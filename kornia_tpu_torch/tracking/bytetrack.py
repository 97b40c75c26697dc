"""Multi-object tracker: ByteTrack's two-round association over a
fixed-capacity track table (counterpart of
``kornia_tpu/tracking/bytetrack.py``).

A frame's update (the batched Kalman predict and update, the IoU cost, two
greedy association rounds and the births and deaths) is a fixed sequence
of tensor ops on the tracker's device with no host read: each greedy step
picks the flat argmax and writes through 1-element index tensors, and the
births pair the k-th free slot with the k-th candidate by ranks. So a
frame on the card is enqueued without waiting for it.

Detections arrive padded, (N, 6) rows (class, score, x, y, w, h) with
score 0 for the padding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from ..core.dtype import float32_on

__all__ = ["TrackState", "ByteTracker", "BoxTracker"]

Device = Union[str, torch.device]

# the Kalman state is [cx, cy, a, h, vcx, vcy, va, vh]
_STD_POS = 1.0 / 20.0
_STD_VEL = 1.0 / 160.0


@dataclasses.dataclass
class TrackState:
    """Fixed-capacity track table."""

    mean: torch.Tensor      # (T, 8)
    cov: torch.Tensor       # (T, 8, 8)
    score: torch.Tensor     # (T,)
    cls: torch.Tensor       # (T,)
    track_id: torch.Tensor  # (T,) int32; 0 = unassigned
    alive: torch.Tensor     # (T,) bool: the slot holds a track, active or lost
    misses: torch.Tensor    # (T,) int32 frames since the last match
    next_id: torch.Tensor   # () int32

    @classmethod
    def empty(cls, capacity: int = 128, device: Device = "cuda"
              ) -> "TrackState":
        kw = dict(device=device)
        return cls(
            mean=torch.zeros((capacity, 8), **kw),
            cov=torch.eye(8, **kw).expand(capacity, 8, 8).clone(),
            score=torch.zeros((capacity,), **kw),
            cls=torch.zeros((capacity,), **kw),
            track_id=torch.zeros((capacity,), dtype=torch.int32, **kw),
            alive=torch.zeros((capacity,), dtype=torch.bool, **kw),
            misses=torch.zeros((capacity,), dtype=torch.int32, **kw),
            next_id=torch.ones((), dtype=torch.int32, **kw))

    def boxes_xyxy(self) -> torch.Tensor:
        """The tracks' current boxes (T, 4) xyxy."""
        cx, cy, a, h = self.mean[:, :4].unbind(-1)
        w = a * h
        return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                           -1)


def _xyxy_to_meas(b: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy → (..., 4) [cx, cy, aspect, h]."""
    w = b[..., 2] - b[..., 0]
    h = b[..., 3] - b[..., 1]
    return torch.stack([b[..., 0] + w / 2, b[..., 1] + h / 2,
                        w / h.clamp(min=1e-6), h], -1)


def _diag_cov(std: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(std * std)


def _kf_predict(mean: torch.Tensor, cov: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    F = torch.eye(8, dtype=mean.dtype, device=mean.device)
    F[:4, 4:] = torch.eye(4, dtype=mean.dtype, device=mean.device)
    h = mean[:, 3]
    std = torch.stack([_STD_POS * h, _STD_POS * h, torch.full_like(h, 1e-2),
                       _STD_POS * h, _STD_VEL * h, _STD_VEL * h,
                       torch.full_like(h, 1e-5), _STD_VEL * h], -1)
    mean = mean @ F.T
    cov = F @ cov @ F.T + _diag_cov(std)
    return mean, cov


def _kf_update(mean: torch.Tensor, cov: torch.Tensor, meas: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = mean[:, 3]
    std = torch.stack([_STD_POS * h, _STD_POS * h, torch.full_like(h, 1e-1),
                       _STD_POS * h], -1)
    # H = [I4 0]: H P Hᵀ and P Hᵀ are slices
    S = cov[:, :4, :4] + _diag_cov(std)                       # (T, 4, 4)
    PHt = cov[:, :, :4]                                       # (T, 8, 4)
    # solve_ex skips the error check's host read; a singular S gives a
    # non-finite gain, as the reference's solve does
    K = torch.linalg.solve_ex(S, PHt.transpose(1, 2))[0].transpose(1, 2)
    innov = meas - mean[:, :4]
    mean = mean + (K @ innov[..., None])[..., 0]
    cov = cov - K @ S @ K.transpose(1, 2)
    return mean, cov


def _iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (T, 4), b (D, 4) xyxy → IoU (T, D)."""
    lt = torch.maximum(a[:, None, :2], b[None, :, :2])
    rb = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]).clamp(min=0) * (a[:, 3] - a[:, 1]).clamp(min=0)
    area_b = (b[:, 2] - b[:, 0]).clamp(min=0) * (b[:, 3] - b[:, 1]).clamp(min=0)
    return inter / (area_a[:, None] + area_b[None] - inter).clamp(min=1e-9)


def _greedy_match(iou: torch.Tensor, row_ok: torch.Tensor,
                  col_ok: torch.Tensor, thresh: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy max-IoU assignment in min(T, D) steps: each takes the first
    largest entry and, where it exceeds `thresh`, matches its row and
    column and removes both. Returns (row_to_col (T,) int32, -1 where
    unmatched; col_matched (D,) bool).

    Each step removes its row and column whether or not it matched: once a
    step fails, every entry left is at most `thresh` (or, with `thresh`
    below -1, no step fails), so the later steps fail as they would on the
    untouched matrix (for finite IoUs: a NaN entry would be the maximum
    of a failed step). The steps' maxima are recorded, and the matches
    written after the loop: five launches a step, no host read."""
    T, D = iou.shape
    S = min(T, D)
    m = torch.where(row_ok[:, None] & col_ok[None, :], iou,
                    torch.full_like(iou, -1.0))
    flat_m = m.view(-1)
    best = torch.empty((S,), dtype=iou.dtype, device=iou.device)
    at = torch.empty((S,), dtype=torch.int64, device=iou.device)
    for k in range(S):
        torch.max(flat_m, 0, out=(best[k], at[k]))  # the first maximum
        m.index_fill_(0, torch.div(at[k:k + 1], D, rounding_mode="floor"),
                      -1.0)
        m.index_fill_(1, torch.remainder(at[k:k + 1], D), -1.0)
    ok = best > thresh
    rows = torch.div(at, D, rounding_mode="floor")
    cols = torch.remainder(at, D)
    # the failed steps write to one slot past the end
    r2c = torch.full((T + 1,), -1, dtype=torch.int64, device=iou.device)
    r2c.scatter_(0, torch.where(ok, rows, T), cols)
    cmatch = torch.zeros((D + 1,), dtype=torch.bool, device=iou.device)
    cmatch.index_fill_(0, torch.where(ok, cols, D), True)
    return r2c[:T].to(torch.int32), cmatch[:D]


class ByteTracker:
    """Two-round IoU tracker over a fixed-capacity track table on `device`.

    ``update(state, detections)`` with detections (N, 6) rows (class,
    score, x, y, w, h), padded rows scored 0, returns the new state; read
    results with ``current_tracks``.
    """

    def __init__(self, capacity: int = 128,
                 track_high_thresh: float = 0.5,
                 track_low_thresh: float = 0.1,
                 new_track_thresh: float = 0.6,
                 match_thresh: float = 0.3,
                 second_match_thresh: float = 0.5,
                 track_buffer: int = 30,
                 device: Device = "cuda"):
        self.capacity = capacity
        self.high = track_high_thresh
        self.low = track_low_thresh
        self.new = new_track_thresh
        self.match_thresh = match_thresh
        self.second_match_thresh = second_match_thresh
        self.buffer = track_buffer
        self.device = torch.device(device)

    def init_state(self) -> TrackState:
        return TrackState.empty(self.capacity, self.device)

    def update(self, state: TrackState, detections: torch.Tensor
               ) -> TrackState:
        return self._update(state, float32_on(detections, self.device))

    def _update(self, s: TrackState, det: torch.Tensor) -> TrackState:
        boxes = torch.stack([det[:, 2], det[:, 3], det[:, 2] + det[:, 4],
                             det[:, 3] + det[:, 5]], -1)
        scores = det[:, 1]
        cls = det[:, 0]
        d_high = scores > self.high
        d_low = (scores > self.low) & ~d_high

        mean, cov = _kf_predict(s.mean, s.cov)
        s = dataclasses.replace(s, mean=mean, cov=cov)
        iou = _iou_matrix(s.boxes_xyxy(), boxes)

        # round 1: every alive track against the high-score detections
        r2c1, cm1 = _greedy_match(iou, s.alive, d_high, self.match_thresh)
        m1 = r2c1 >= 0
        # round 2: the still unmatched active tracks against the low ones
        active = s.alive & (s.misses == 0)
        r2c2, _ = _greedy_match(iou, active & ~m1, d_low,
                                self.second_match_thresh)
        m2 = r2c2 >= 0
        matched = m1 | m2
        det_idx = torch.where(m1, r2c1, r2c2.clamp(min=0)).long()

        # the matched slots' Kalman update with their detections
        meas = _xyxy_to_meas(boxes)[det_idx]
        new_mean, new_cov = _kf_update(s.mean, s.cov, meas)
        mean = torch.where(matched[:, None], new_mean, s.mean)
        cov = torch.where(matched[:, None, None], new_cov, s.cov)
        score = torch.where(matched, scores[det_idx], s.score)
        tcls = torch.where(matched, cls[det_idx], s.cls)
        misses = torch.where(matched, 0, s.misses + 1)
        alive = s.alive & (misses <= self.buffer)

        # births: the unmatched high-score detections above new_track_thresh
        # take the free slots, the k-th candidate the k-th free slot
        birth_det = d_high & ~cm1 & (scores > self.new)
        free = ~alive
        free_rank = torch.cumsum(free, 0) - 1                 # (T,)
        cand_rank = torch.cumsum(birth_det, 0) - 1            # (D,)
        n_birth = torch.minimum(free.sum(), birth_det.sum())
        cand_order = torch.argsort(
            torch.where(birth_det, cand_rank, 1 << 30), stable=True)
        is_birth = free & (free_rank < n_birth)
        src = cand_order[torch.where(is_birth, free_rank, 0)]  # (T,)

        bmeas = _xyxy_to_meas(boxes)[src]
        bmean = torch.cat([bmeas, torch.zeros_like(bmeas)], -1)
        h0 = bmeas[:, 3]
        bstd = torch.stack([2 * _STD_POS * h0, 2 * _STD_POS * h0,
                            torch.full_like(h0, 1e-2), 2 * _STD_POS * h0,
                            10 * _STD_VEL * h0, 10 * _STD_VEL * h0,
                            torch.full_like(h0, 1e-5), 10 * _STD_VEL * h0],
                           -1)
        mean = torch.where(is_birth[:, None], bmean, mean)
        cov = torch.where(is_birth[:, None, None], _diag_cov(bstd), cov)
        score = torch.where(is_birth, scores[src], score)
        tcls = torch.where(is_birth, cls[src], tcls)
        misses = torch.where(is_birth, 0, misses)
        new_ids = s.next_id + free_rank.to(torch.int32)
        track_id = torch.where(is_birth, new_ids, s.track_id)
        next_id = s.next_id + n_birth.to(torch.int32)
        alive = alive | is_birth
        return TrackState(mean, cov, score, tcls, track_id, alive, misses,
                          next_id)

    def current_tracks(self, s: TrackState
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                  torch.Tensor, torch.Tensor]:
        """(boxes (T, 4) xyxy, ids (T,), scores, cls, valid): valid is
        alive and matched this frame."""
        valid = s.alive & (s.misses == 0)
        return s.boxes_xyxy(), s.track_id, s.score, s.cls, valid


class BoxTracker:
    """A detector and a ByteTracker: ``update(image (1, 3, H, W))`` runs the
    detector and advances the tracker; returns (boxes (T, 4) xyxy, ids
    (T,), scores (T,), cls (T,), valid (T,)).

    `detector` maps the image to padded detections (1, N, 6). The
    reference's default detector (an RT-DETR) is not ported yet.
    """

    def __init__(self, detector: Optional[Callable] = None,
                 tracker: Optional[ByteTracker] = None):
        if detector is None:
            raise NotImplementedError(
                "BoxTracker's default detector (contrib.detection's "
                "ObjectDetector, an RT-DETR) waits for ROADMAP Queue 1 "
                "item 6; pass a detector")
        self.detector = detector
        self.tracker = tracker or ByteTracker()
        self.state = self.tracker.init_state()
        self.frame_count = 0

    def reset(self):
        self.state = self.tracker.init_state()
        self.frame_count = 0

    def update(self, image: torch.Tensor):
        dets = self.detector(image)[0]  # (N, 6) class, score, x, y, w, h
        self.state = self.tracker.update(self.state, dets)
        self.frame_count += 1
        return self.tracker.current_tracks(self.state)

    def visualize(self, image: torch.Tensor) -> torch.Tensor:
        """The current tracks' boxes drawn in red onto (1, 3, H, W) image
        (reads the number of valid tracks on the host)."""
        from ..image.draw import draw_rectangle
        boxes, _ids, _sc, _cls, valid = self.tracker.current_tracks(
            self.state)
        if int(valid.sum()) == 0:
            return image
        rect = boxes[valid.nonzero()[:, 0]][None]  # (1, n, 4) xyxy
        return draw_rectangle(image, rect,
                              color=torch.tensor([1.0, 0.0, 0.0],
                                                 device=image.device))
