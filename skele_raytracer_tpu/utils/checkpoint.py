"""Checkpoint / resume for optimization state: one .npz per step.

The reference has no checkpointing at all — a frame only exists once fully
written (reference src/main.cpp:88-101; SURVEY.md §5). Long-running jobs
here (inverse-rendering fits) persist the full TrainState pytree (scene
params + optimizer moments + step) as `step_<N>.npz` in a directory, one
array per leaf keyed by its pytree path, and resume from the newest.
Restoring checks the file against the caller's template tree: the same
leaf paths, shapes and dtypes, or an error.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import jax
import numpy as np

_NAME = re.compile(r"step_(\d+)\.npz")


def _ckpt_path(directory: str, step: int) -> str:
    return os.path.join(os.path.abspath(directory), f"step_{step:08d}.npz")


def _leaves(tree):
    """[(path string, leaf)] in the tree's flatten order."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), leaf) for p, leaf in flat]


def save(directory: str, state: Any) -> str:
    """Save `state` (any pytree with an int `step` leaf) under directory.
    Written to a temporary name and renamed, so a crash mid-write never
    leaves a truncated newest checkpoint."""
    step = int(jax.device_get(state.step))
    path = _ckpt_path(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    arrays = {k: np.asarray(v) for k, v in _leaves(jax.device_get(state))}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for name in os.listdir(directory)
             if (m := _NAME.fullmatch(name))]
    return max(steps) if steps else None


def restore_latest(directory: str, template: Any) -> Optional[Any]:
    """Restore the newest checkpoint as the same pytree structure as
    `template`, or None if the directory holds none. Raises ValueError
    when the file's leaves do not match the template's."""
    step = latest_step(directory)
    if step is None:
        return None
    path = _ckpt_path(directory, step)
    expected = _leaves(template)
    with np.load(path, allow_pickle=False) as data:
        if set(data.files) != {k for k, _ in expected}:
            raise ValueError(
                f"{path}: leaves {sorted(data.files)} do not match the "
                f"template's {sorted(k for k, _ in expected)}")
        leaves = []
        for k, ref in expected:
            a = data[k]
            if a.shape != np.shape(ref) or a.dtype != np.asarray(ref).dtype:
                raise ValueError(
                    f"{path}: leaf {k} is {a.dtype}{list(a.shape)}, the "
                    f"template's is {np.asarray(ref).dtype}"
                    f"{list(np.shape(ref))}")
            leaves.append(a)
    treedef = jax.tree_util.tree_structure(template)
    return jax.tree_util.tree_unflatten(treedef, leaves)
