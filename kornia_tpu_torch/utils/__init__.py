"""Utilities: the ray-traced scene renderer and camera trajectories."""
