"""Restartable long-running jobs (counterpart of
``kornia_tpu/utils/elastic.py``).

`run_restartable` drives a step function with periodic checkpoints
(``checkpoint.py``); on (re)start it resumes from the newest checkpoint,
so a preempted or crashed job continues where it left off. State is any
tree of tensors and dataclasses (model params, optimizer state, BA map
blocks, LM damping). Checkpoints are ``<ckpt_dir>/step_<n>``.
"""

from __future__ import annotations

import os
import re
from typing import Any, Callable, Optional, Tuple

from .checkpoint import load_checkpoint, save_checkpoint

__all__ = ["run_restartable", "latest_checkpoint"]

_STEP_RE = re.compile(r"^step_(\d+)$")


def latest_checkpoint(ckpt_dir: str) -> Optional[Tuple[int, str]]:
    """Newest (step, path) under `ckpt_dir`, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = _STEP_RE.match(name)
        if m:
            step = int(m.group(1))
            if best is None or step > best[0]:
                best = (step, os.path.join(ckpt_dir, name))
    return best


def run_restartable(step_fn: Callable[[Any], Any], init_state: Any,
                    num_steps: int, ckpt_dir: str,
                    checkpoint_every: int = 100) -> Any:
    """Run `state = step_fn(state)` for `num_steps`, checkpointing every
    `checkpoint_every` steps and after the last; resumes from the newest
    checkpoint in `ckpt_dir` if one exists, restored onto `init_state`'s
    devices and dtypes."""
    start = 0
    state = init_state
    newest = latest_checkpoint(ckpt_dir)
    if newest is not None:
        start, path = newest
        state = load_checkpoint(path, init_state)
    os.makedirs(ckpt_dir, exist_ok=True)
    for step in range(start, num_steps):
        state = step_fn(state)
        done = step + 1
        if done % checkpoint_every == 0 or done == num_steps:
            save_checkpoint(os.path.join(ckpt_dir, f"step_{done}"), state)
    return state
