"""Contrib (counterpart of ``kornia_tpu/contrib/__init__.py``): the
operators of ``ops``, the stitcher, the reference's patch and
distance-transform classes and ``BoxMotTracker``. The detectors and the
model-backed ``SuperResolution`` (``detection``, ``models/``) are not
ported yet."""

from .ops import *  # noqa: F401,F403
from .image_stitching import ImageStitcher  # noqa: F401
from ..core.module import fn_module as _fn_module
from . import ops as _ops

ExtractTensorPatches = _fn_module(_ops.extract_tensor_patches,
                                  "ExtractTensorPatches")
CombineTensorPatches = _fn_module(_ops.combine_tensor_patches,
                                  "CombineTensorPatches")
DistanceTransform = _fn_module(_ops.distance_transform, "DistanceTransform")


class BoxMotTracker:
    """A detector and ByteTrack in one loop (the tracker's own keyword
    arguments, and its `device`, pass through)."""

    def __init__(self, detector=None, tracker_model_name: str = "ByteTrack",
                 **tracker_kwargs):
        from ..tracking.bytetrack import BoxTracker, ByteTracker
        allowed = ("capacity", "track_high_thresh", "track_low_thresh",
                   "new_track_thresh", "match_thresh", "second_match_thresh",
                   "track_buffer", "device")
        bt = ByteTracker(**{k: v for k, v in tracker_kwargs.items()
                            if k in allowed})
        self.detector = detector
        self._tracker = BoxTracker(detector=detector, tracker=bt)
        self.tracker_model_name = tracker_model_name

    def update(self, image):
        return self._tracker.update(image)

    __call__ = update
