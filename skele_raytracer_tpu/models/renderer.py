"""Top-level render orchestration.

The batched replacement for the reference's render loops
(`generate_rays_parallel`, src/main.cpp:19-104, and the serial SDL variant
src/main.cpp:108-227): one jit-compiled program that

  1. streams the frame's pixel samples in fixed-size chunks (`lax.map`) to
     bound device-memory residency — a 1080p jsample-5 frame is 52M primary rays and
     is never materialized at once;
  2. generates rays from flat sample ids (ops/camera.py) so the chunking —
     and the device sharding built on top of it (parallel/) — never changes
     the per-pixel RNG and therefore never changes the image;
  3. averages supersamples per pixel (image[y][x] /= grid^2,
     src/main.cpp:68) and reshapes to [H, W, 3].

`render()` is the user-facing eager entry; `render_radiance` is the pure
jittable core used by jit/grad/shard_map wrappers.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from skele_raytracer_tpu.config import RenderConfig
from skele_raytracer_tpu.models.integrator import integrate
from skele_raytracer_tpu.ops.camera import rays_for_ids


def _chunk_samples(cfg: RenderConfig) -> int:
    """Samples per chunk such that the expanded in-flight ray set stays
    near cfg.rays_per_chunk.

    Monte-Carlo expands each sample into num_paths linear continuations;
    the clean-mode Whitted frontier DOUBLES per depth level (reflection +
    refraction children, models/integrator.py integrate_whitted), so deep
    non-MC traces must shrink the chunk or the frontier blows HBM.
    """
    if cfg.monte_carlo:
        fan = max(cfg.paths_per_sample, 1)
    elif cfg.quirks.disable_reflections:
        fan = 1
    else:
        fan = 2 ** min(max(cfg.max_depth - 1, 0), 12)
    per = max(1, cfg.rays_per_chunk // fan)
    return max(128, min(per, cfg.height * cfg.width * cfg.samples_per_pixel))


def render_ids(scene, cfg: RenderConfig, key, sample_ids):
    """Radiance [N, 3] for the given flat sample ids (pixel * spp + sample).

    The unit of work for chunking AND device sharding: any partition of the
    id space renders the identical frame.
    """
    o, d = rays_for_ids(scene.camera, cfg, key, sample_ids)
    return integrate(scene, cfg, key, o, d, sample_ids)


def render_ids_chunked(scene, cfg: RenderConfig, key, sample_ids):
    """Radiance [N, 3] for arbitrary sample ids — the unit every consumer
    (full frame, device shards, progressive bands, training loss) builds
    on.

    Small scenes under backend="pallas" route through the whole-frame
    path-trace kernel (ops/pallas/pathtrace.py): ONE pallas_call covers
    ray-gen + RNG + intersect + shade + the MC bounce loop, instead of a
    chain of small fusions per chunk. Its custom_vjp replays the
    forward's hit records in XLA for gradients. Everything else streams
    through the chunked jnp wavefront below.
    """
    from skele_raytracer_tpu.ops.pallas import pathtrace

    cfg = cfg.resolved()  # backend="auto" -> pallas on a GPU, jnp elsewhere
    if pathtrace.use_pathtrace(scene, cfg):
        return pathtrace.pathtrace_ids(scene, cfg, key, sample_ids)
    return render_ids_chunked_jnp(scene, cfg, key, sample_ids)


def render_ids_chunked_jnp(scene, cfg: RenderConfig, key, sample_ids):
    """The chunked wavefront path: radiance [N, 3] streamed chunk by chunk
    (`lax.map`), differentiable end to end.

    The chunk body is rematerialized (`jax.checkpoint`): without it,
    reverse-mode AD would save every chunk's intermediates across the
    whole lax.map — tens of GB/frame at 1080p — instead of recomputing
    one chunk at a time during the backward sweep.
    """
    n = sample_ids.shape[0]
    chunk = _chunk_samples(cfg)
    n_chunks = -(-n // chunk)
    padded = n_chunks * chunk
    ids = jnp.concatenate(
        [sample_ids, jnp.zeros((padded - n,), jnp.uint32)]
    ).reshape(n_chunks, chunk)
    body = jax.checkpoint(partial(render_ids, scene, cfg, key))
    radiance = jax.lax.map(body, ids)
    return radiance.reshape(padded, 3)[:n]


def render_radiance(scene, cfg: RenderConfig, key):
    """Full-frame radiance [H, W, 3] (pre-quantization), jittable."""
    H, W, spp = cfg.height, cfg.width, cfg.samples_per_pixel
    sample_ids = jnp.arange(H * W * spp, dtype=jnp.uint32)
    radiance = render_ids_chunked(scene, cfg, key, sample_ids)
    # Average the supersamples (src/main.cpp:68: image /= grid^2).
    return radiance.reshape(H, W, spp, 3).mean(axis=2)


@partial(jax.jit, static_argnums=(1,))
def _render_jit(scene, cfg, key):
    return render_radiance(scene, cfg, key)


def render(scene, cfg: RenderConfig, seed: int = 0):
    """Render a frame: [H, W, 3] float32 radiance (clamp/quantize with
    utils.image.to_ppm — the reference clamps to [0,1] and scales by 255
    only at write time, src/main.cpp:88-101)."""
    return _render_jit(scene, cfg, jnp.uint32(seed))


@partial(jax.jit, static_argnums=(1,))
def _render_frames_jit(scene, cfg, seeds):
    return jax.lax.map(lambda k: render_radiance(scene, cfg, k), seeds)


def render_frames(scene, cfg: RenderConfig, seeds):
    """Render a BATCH of frames (distinct RNG seeds) in ONE device
    program: [K, H, W, 3] float32 radiance.

    The serving-throughput entry point: frames share one program, so the
    fixed per-dispatch host<->device latency is paid once per batch, not
    once per frame. Each frame is an independent sample stream, so this
    also serves progressive accumulation: mean the K frames for a
    K-times-denoised image.

    seeds: [K] uint32 (e.g. jnp.arange(K, dtype=jnp.uint32)). Memory is
    bounded by cfg.rays_per_chunk exactly as in render(); the K output
    frames (K*H*W*3 floats) are the only K-scaled residency.
    """
    return _render_frames_jit(scene, cfg, jnp.asarray(seeds, jnp.uint32))
