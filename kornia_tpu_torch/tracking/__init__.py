"""Tracking: the planar homography tracker."""
