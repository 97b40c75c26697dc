"""Contrib (counterpart of ``kornia_tpu/contrib/__init__.py``): the
operators of ``ops``, the detectors of ``detection``, the stitcher, the
reference's patch and distance-transform classes, ``SuperResolution`` and
``BoxMotTracker``. ``visual_prompter`` waits for the SAM family."""

from .ops import *  # noqa: F401,F403
from .detection import (  # noqa: F401
    BoxFiltering,
    EdgeDetector,
    FaceDetector,
    FaceDetectorResult,
    FaceKeypoint,
    ObjectDetector,
)
from .image_stitching import ImageStitcher  # noqa: F401
from ..core.module import fn_module as _fn_module
from . import ops as _ops

ExtractTensorPatches = _fn_module(_ops.extract_tensor_patches,
                                  "ExtractTensorPatches")
CombineTensorPatches = _fn_module(_ops.combine_tensor_patches,
                                  "CombineTensorPatches")
DistanceTransform = _fn_module(_ops.distance_transform, "DistanceTransform")


class SuperResolution:
    """A super-resolution model with a pre- and a post-processor; without
    a model, ``models.SmallSR()`` (x2, seeded weights) built at the first
    call on the input's device. A list or tuple of (C, H, W) images is
    upscaled one by one."""

    name = "super_resolution"

    def __init__(self, model=None, pre_processor=None, post_processor=None):
        self.model = model
        self.pre_processor = pre_processor or (lambda x: x)
        self.post_processor = post_processor or (lambda x: x)

    def __call__(self, images):
        x = self.pre_processor(images)
        first = x[0] if isinstance(x, (list, tuple)) else x
        if self.model is None:
            from ..models.small_sr import SmallSR
            self.model = SmallSR(device=first.device)
        if isinstance(x, (list, tuple)):
            out = [self.model(im[None])[0] for im in x]
        else:
            out = self.model(x)
        return self.post_processor(out)

    forward = __call__


class BoxMotTracker:
    """A detector and ByteTrack in one loop (the tracker's own keyword
    arguments, and its `device`, pass through); without a detector,
    BoxTracker's default, ``detection.ObjectDetector()`` on that device."""

    def __init__(self, detector=None, tracker_model_name: str = "ByteTrack",
                 **tracker_kwargs):
        from ..tracking.bytetrack import BoxTracker, ByteTracker
        allowed = ("capacity", "track_high_thresh", "track_low_thresh",
                   "new_track_thresh", "match_thresh", "second_match_thresh",
                   "track_buffer", "device")
        bt = ByteTracker(**{k: v for k, v in tracker_kwargs.items()
                            if k in allowed})
        self.detector = detector
        self._tracker = BoxTracker(detector=detector, tracker=bt,
                                   device=bt.device)
        self.tracker_model_name = tracker_model_name

    def update(self, image):
        return self._tracker.update(image)

    __call__ = update
