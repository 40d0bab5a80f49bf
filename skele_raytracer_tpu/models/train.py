"""Inverse-rendering optimization: the framework's "training" loop.

The reference is forward-only (SURVEY.md §5: no checkpointing, no training
of any kind). The differentiable design adds the capability the north
star asks for: gradient descent on scene parameters (sphere centers/radii,
triangle vertices, materials, lights) against a target image, with the
image-space loss and its backward pass sharded over a device mesh and the
parameter gradients all-reduced (`psum`) across it.

A `TrainState` is a plain pytree (scene params + optax optimizer state) so
it checkpoints as one .npz (utils/checkpoint.py) and shards trivially
(params replicated; rays sharded by parallel/api.py).
"""

from __future__ import annotations

from functools import partial
from typing import Any, NamedTuple, Optional

import jax
import jax.numpy as jnp
import optax

from skele_raytracer_tpu.config import RenderConfig
from skele_raytracer_tpu.models.renderer import render_ids_chunked
from skele_raytracer_tpu.parallel.api import loss_and_grad_sharded


class TrainState(NamedTuple):
    scene: Any  # Scene pytree — every leaf is a trainable parameter
    opt_state: Any
    step: jnp.ndarray  # [] int32


def make_optimizer(learning_rate: float = 1e-2) -> optax.GradientTransformation:
    return optax.adam(learning_rate)


def init_state(scene, tx: optax.GradientTransformation) -> TrainState:
    return TrainState(
        scene=scene, opt_state=tx.init(scene), step=jnp.zeros((), jnp.int32)
    )


def full_loss(scene, cfg: RenderConfig, key, target):
    """Per-sample mean squared error vs `target` [H,W,3] — each supersample
    is compared to its pixel's target value (NOT the sample-averaged pixel:
    keeping the reduction per-ray is what lets the sharded implementation
    in parallel/api.py compute the identical objective with one psum).
    Single-device reference implementation of that sharded loss."""
    H, W, spp = cfg.height, cfg.width, cfg.samples_per_pixel
    ids = jnp.arange(H * W * spp, dtype=jnp.uint32)
    radiance = render_ids_chunked(scene, cfg, key, ids)
    # ids is the full arange by construction, so each pixel's target
    # repeats spp times in id order — a broadcast, not a row gather.
    t = jnp.broadcast_to(
        jnp.reshape(target, (H * W, 1, 3)), (H * W, spp, 3)
    ).reshape(H * W * spp, 3)
    err = radiance - t
    return jnp.mean(err * err)


def make_trainable_mask(scene, paths):
    """0/1 pytree selecting which scene leaves train; `paths` are dotted
    leaf-path prefixes (e.g. "spheres.diffuse", "point_lights").

    Restricting the trainable set is standard differentiable-rendering
    practice: silhouette gradients are biased (hit selection is
    stop-gradient'ed), so letting geometry/camera drift while fitting
    materials destabilizes the loss.
    """

    def mask_leaf(path, leaf):
        name = jax.tree_util.keystr(path)[1:].replace("'", "").replace("]", "").replace("[", ".")
        keep = any(name.startswith(p) for p in paths)
        return jnp.full_like(leaf, 1.0 if keep else 0.0)

    return jax.tree_util.tree_map_with_path(mask_leaf, scene)


def train_step(
    state: TrainState,
    cfg: RenderConfig,
    tx: optax.GradientTransformation,
    key,
    target,
    mesh=None,
    trainable=None,
):
    """One optimization step. With a mesh: rays sharded, grads psum'd
    (parallel/api.py); without: single-device value_and_grad. `trainable`
    (make_trainable_mask) zeroes gradients outside the chosen leaves.

    Jit this with cfg/tx/mesh static: the whole step — forward render,
    backward, all-reduce, adam update — is one XLA program.
    """
    # Per-step stream: the uint32 render seed advances with the step so
    # every optimization step sees fresh MC samples.
    key = jnp.asarray(key, jnp.uint32) + state.step.astype(jnp.uint32)
    if mesh is not None:
        loss, grads = loss_and_grad_sharded(state.scene, cfg, key, target, mesh)
    else:
        loss, grads = jax.value_and_grad(full_loss)(state.scene, cfg, key, target)
    if trainable is not None:
        grads = jax.tree_util.tree_map(lambda g, m: g * m, grads, trainable)
    updates, opt_state = tx.update(grads, state.opt_state, state.scene)
    scene = optax.apply_updates(state.scene, updates)
    # Structural flags are not pytree leaves; optax passes them through.
    return TrainState(scene=scene, opt_state=opt_state, step=state.step + 1), loss


def fit(
    scene,
    cfg: RenderConfig,
    target,
    *,
    steps: int = 100,
    learning_rate: float = 1e-2,
    seed: int = 0,
    mesh=None,
    trainable_paths=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 50,
    log_every: int = 10,
):
    """Optimize scene parameters to match `target`; returns (scene, losses).

    trainable_paths: dotted leaf-path prefixes restricting which leaves
    move (make_trainable_mask); None trains everything.
    Resumes from `checkpoint_dir` if it holds a previous run's state
    (SURVEY.md §5 checkpoint/resume: the reference has none; long
    optimizations here restart from the last saved step).
    """
    cfg = cfg.resolved()
    tx = make_optimizer(learning_rate)
    state = init_state(scene, tx)
    trainable = (
        make_trainable_mask(scene, tuple(trainable_paths))
        if trainable_paths
        else None
    )
    start = 0
    if checkpoint_dir is not None:
        from skele_raytracer_tpu.utils import checkpoint as ckpt

        restored = ckpt.restore_latest(checkpoint_dir, state)
        if restored is not None:
            state = restored
            start = int(state.step)

    step_fn = jax.jit(partial(train_step, cfg=cfg, tx=tx, mesh=mesh))
    key = jnp.uint32(seed)
    losses = []
    for i in range(start, steps):
        state, loss = step_fn(state, key=key, target=target, trainable=trainable)
        losses.append(float(loss))
        if log_every and (i % log_every == 0 or i == steps - 1):
            print(f"step {i}: loss {losses[-1]:.6e}")
        if checkpoint_dir is not None and (i + 1) % checkpoint_every == 0:
            ckpt.save(checkpoint_dir, state)
    if checkpoint_dir is not None and start < steps:
        ckpt.save(checkpoint_dir, state)
    return state.scene, losses
