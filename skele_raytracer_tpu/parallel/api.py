"""Device-mesh parallelism: sharded rendering and gradient all-reduce.

The reference's entire parallelism story is one OpenMP pragma over image
rows (reference src/main.cpp:33) plus a CUDA pixel grid
(cudasrc/main.cu:86-103); there is no multi-device or multi-host anything
(SURVEY.md §2.3). This design scales the same embarrassingly
parallel structure onto a `jax.sharding.Mesh`:

* mesh axes ("tiles", "samples"): the flat ray-id space (pixel x spp x
  path) is partitioned over both axes. "tiles" plays the role of the
  reference's row-parallelism (data parallel over pixels); "samples" shards
  the supersample/gillum-path axis when the image axis alone is too small
  to fill the mesh (SURVEY.md §5 long-axis discussion).
* the scene pytree is replicated (it is small — even dragon.scn's 10k
  triangles are ~KBs); rays are sharded. No communication happens in the
  forward pass at all.
* gradients of scene parameters are partial sums over rays, so the backward
  pass ends in ONE `psum` over both mesh axes — the all-reduce the north
  star asks to overlap with the backward sweep. XLA schedules that overlap
  when the psum is emitted inside the same jit as the backward ops.

Because rays are generated from flat ids and all RNG is counter-based
(ops/sampling.py), ANY partition of the id space renders the identical
frame — sharding invariance is tested, not hoped for.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from skele_raytracer_tpu.config import RenderConfig
from skele_raytracer_tpu.models.renderer import render_ids_chunked

shard_map = jax.shard_map


def factor_mesh(n: int) -> Tuple[int, int]:
    """Split n devices into (tiles, samples) axis sizes, tiles-major.

    Prefers the most-square split with tiles >= samples so small meshes
    spend devices on the image axis first (the bigger axis in practice)."""
    best = (n, 1)
    for s in range(1, int(np.sqrt(n)) + 1):
        if n % s == 0:
            best = (n // s, s)
    return best


def make_mesh(
    devices: Optional[Sequence] = None,
    axis_sizes: Optional[Tuple[int, int]] = None,
) -> Mesh:
    """A 2-D ("tiles", "samples") mesh over `devices` (default: all)."""
    devices = list(devices if devices is not None else jax.devices())
    t, s = axis_sizes if axis_sizes is not None else factor_mesh(len(devices))
    if t * s != len(devices):
        raise ValueError(f"axis sizes {t}x{s} != device count {len(devices)}")
    return Mesh(np.asarray(devices).reshape(t, s), ("tiles", "samples"))


def _pad_ids(n_total: int, n_shards: int):
    """Flat ray ids padded to a multiple of n_shards by continuing the
    sequence past the frame (out-of-frame ids produce harmless rays; the
    renderer drops the rows, the loss masks them by `id < n_total`)."""
    per = -(-n_total // n_shards)
    ids = np.arange(n_shards * per, dtype=np.uint32)
    return jnp.asarray(ids), per


def render_radiance_sharded(scene, cfg: RenderConfig, key, mesh: Mesh):
    """Full-frame radiance [H, W, 3] with rays sharded over the mesh.

    Jittable (mesh/cfg static). The per-device body is exactly the
    single-device chunked renderer — sharding composes around it, never
    changes it.
    """
    H, W, spp = cfg.height, cfg.width, cfg.samples_per_pixel
    n_total = H * W * spp
    n_shards = mesh.devices.size
    ids, _ = _pad_ids(n_total, n_shards)

    # Scene and key ride through shard_map as explicit replicated operands:
    # closing over them would capture whatever sharding their buffers carry
    # from earlier steps, which is invalid inside the Manual mesh context.
    # check_vma=False: pallas_call outputs carry no varying-mesh-axis
    # metadata, so the default VMA check rejects the Pallas backend inside
    # shard_map (same setting as loss_and_grad_sharded below).
    fn = shard_map(
        lambda s, k, i: render_ids_chunked(s, cfg, k, i),
        mesh=mesh,
        in_specs=(P(), P(), P(("tiles", "samples"))),
        out_specs=P(("tiles", "samples")),
        check_vma=False,
    )
    radiance = fn(scene, key, ids)[:n_total]
    return radiance.reshape(H, W, spp, 3).mean(axis=2)


@partial(jax.jit, static_argnums=(1,), static_argnames=("mesh",))
def _render_sharded_jit(scene, cfg, key, *, mesh):
    return render_radiance_sharded(scene, cfg, key, mesh)


def render_sharded(scene, cfg: RenderConfig, seed: int = 0, mesh: Optional[Mesh] = None):
    """Eager sharded render over all local devices (or a given mesh)."""
    mesh = mesh if mesh is not None else make_mesh()
    return _render_sharded_jit(scene, cfg, jnp.uint32(seed), mesh=mesh)


# ---------------------------------------------------------------------------
# Differentiable rendering: sharded loss + gradient all-reduce
# ---------------------------------------------------------------------------


def _local_loss(scene, cfg, key, ids, target_flat, n_total):
    """Sum of squared error of this shard's rays vs the target, normalized
    by the GLOBAL element count so the psum of local losses is the global
    per-sample mean loss (models/train.py full_loss — identical objective).
    Padded out-of-frame rays are masked out."""
    radiance = render_ids_chunked(scene, cfg, key, ids)
    err = (radiance - target_flat) * (ids < n_total).astype(radiance.dtype)[:, None]
    return jnp.sum(err * err) / (n_total * 3.0)


def loss_and_grad_sharded(scene, cfg: RenderConfig, key, target, mesh: Mesh):
    """(loss, d loss / d scene) with rays sharded and ONE psum for grads.

    `target` is the [H, W, 3] target radiance (e.g. a photograph for inverse
    rendering). Supersamples are compared per-sample against their pixel's
    target value (equivalent in expectation to comparing the averaged
    pixel; keeps the reduction local).
    Returns (scalar loss, scene-pytree gradient), both replicated.
    """
    H, W, spp = cfg.height, cfg.width, cfg.samples_per_pixel
    n_total = H * W * spp
    n_shards = mesh.devices.size
    ids, _ = _pad_ids(n_total, n_shards)
    # Target value for each ray id: ids are the padded arange, so each
    # pixel's target repeats spp times in order — a broadcast, not a row
    # gather (see train.full_loss).
    # Padding rows repeat the last pixel (the old clipped-gather value);
    # they are masked out of the loss anyway.
    t2 = jnp.reshape(target, (H * W, 3))
    tflat = jnp.broadcast_to(t2[:, None, :], (H * W, spp, 3)).reshape(
        n_total, 3
    )
    pad = ids.shape[0] - n_total
    if pad:
        tflat = jnp.concatenate(
            [tflat, jnp.broadcast_to(t2[-1][None, :], (pad, 3))], axis=0
        )

    def body(scene_r, key_r, ids_shard, t_shard):
        loss, g = jax.value_and_grad(_local_loss)(
            scene_r, cfg, key_r, ids_shard, t_shard, n_total
        )
        # The one collective: all-reduce partial sums over both mesh axes.
        # XLA overlaps this with the backward computation feeding it.
        loss = jax.lax.psum(loss, ("tiles", "samples"))
        g = jax.tree_util.tree_map(
            lambda x: jax.lax.psum(x, ("tiles", "samples")), g
        )
        return loss, g

    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(("tiles", "samples")), P(("tiles", "samples"))),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(scene, key, ids, tflat)


def replicate_scene(scene, mesh: Mesh):
    """device_put the scene pytree fully replicated over the mesh — the
    analog of the CUDA build's one-time scene upload
    (cudasrc/scene.h:147-176), done once per mesh, not per frame."""
    spec = NamedSharding(mesh, P())
    return jax.device_put(scene, spec)
