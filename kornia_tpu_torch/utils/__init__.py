"""Utilities: the ray-traced scene renderer and camera trajectories,
checkpoints and restartable jobs."""
