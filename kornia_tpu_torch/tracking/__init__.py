"""Tracking: the planar homography tracker and ByteTrack."""
from .planar_tracker import HomographyTracker
from .bytetrack import BoxTracker, ByteTracker, TrackState
