"""Tracking: the planar homography tracker and ByteTrack."""
