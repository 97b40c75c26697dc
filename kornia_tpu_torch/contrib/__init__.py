"""Contributed operators: the plasma fractal of the scene renderer."""
