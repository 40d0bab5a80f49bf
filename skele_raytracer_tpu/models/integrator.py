"""Wavefront integrators — the batched re-design of `shade()`.

The reference integrator (src/raytrace.h:139-227) is a per-pixel recursive
function: nearest-hit scan, direct Blinn-Phong, and (for --gillum) a
Monte-Carlo recursion in which EVERY level spawns `num_path_traces` child
rays (src/raytrace.h:117-131) — exponential in depth, unvectorizable, and
undifferentiable as written. Here the recursion is restructured into an
iterative wavefront over flat ray batches:

* bounce 0: one intersect + direct-illumination pass per pixel sample;
* bounces 1..D-1 (Monte-Carlo only): each sample carries `num_paths`
  LINEAR continuation paths with a running throughput, advanced by
  `lax.scan` — fixed depth, static shapes, XLA-differentiable end to end.

Estimator equivalence: the reference combines
    total = (direct/pi + 2 * indirect) * diffuse        (src/raytrace.h:213)
    indirect = mean_paths(r1 * shade_child) / (1/pi)    (src/raytrace.h:130-133)
which telescopes into per-path radiance
    L += T * (direct/pi) * diffuse;   T *= 2*pi*r1*diffuse
with `num_paths` paths averaged at the top. For depth <= 2 (every
benchmarked reference config: the timed path hardcodes depth 1,
src/main.cpp:23; spheres2's max_depth is 2) the linear and exponential
forms are IDENTICAL per-sample; for deeper traces they agree in
expectation (the reference's exponential fan-out is a variance choice, not
a different integral — SURVEY.md §2.9.9).

Miss rays return the scene background at any depth (src/raytrace.h:190-193);
depth exhaustion returns black (src/raytrace.h:142-145); parity-mode
triangle hits return black and terminate (src/raytrace.h:221-224).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from skele_raytracer_tpu.config import INDIRECT_ORIGIN_EPS, RenderConfig
from skele_raytracer_tpu.ops import sampling
from skele_raytracer_tpu.ops.geometry import intersect, normalize, offset_origin
from skele_raytracer_tpu.ops.shading import (
    direct_illumination,
    fresnel,
    gather_material,
    refraction,
)

_PI = jnp.pi


def _fog_uniforms(scene, cfg, key, ids, bounce):
    # fog_zeroed: the fog term is identically zero (types.Scene.fog_zeroed)
    # and shading skips the rerouted block, so no draws are needed.
    if not scene.has_fog or scene.fog_zeroed:
        return None
    L = scene.point_lights.mask.shape[0]
    F = scene.fog.mask.shape[0]
    return sampling.uniform(key, ids, bounce, sampling.PURPOSE_FOG, (L, F, 4, 2))


def _shade_hit(scene, cfg: RenderConfig, key, o, d, ids, bounce):
    """Nearest hit + direct illumination for a ray batch.

    Returns (hits, mat, direct [R,3], shade_mask [R] 1.0 where the ray hit
    something that shades — sphere always; triangle only in clean mode,
    miss_mask [R]).
    """
    quirks = cfg.quirks
    hits = intersect(o, d, scene, quirks=quirks)
    # Hit topology is discrete: selection is held fixed for gradients
    # (differentiate shading wrt params given the forward's hit structure).
    kind = jax.lax.stop_gradient(hits.kind)
    index = jax.lax.stop_gradient(hits.index)
    hits = hits._replace(kind=kind, index=index)

    mat = gather_material(scene, kind, index, quirks=quirks)
    # prim_center only feeds the fog distance term — skip the gather
    # entirely when fog shading is inactive.
    if scene.has_fog and not scene.fog_zeroed:
        from skele_raytracer_tpu.ops.geometry import gather_rows, one_hot_rows

        oh = one_hot_rows(index, scene.spheres.mask.shape[0])
        prim_center = gather_rows(oh, scene.spheres.center)
        if not quirks.triangles_shade_black:
            prim_center = jnp.where((kind == 2)[:, None], hits.point, prim_center)
    else:
        prim_center = hits.point  # unused downstream

    fog_u = _fog_uniforms(scene, cfg, key, ids, bounce)
    direct = direct_illumination(
        hits.point, hits.normal, scene, mat, prim_center, cfg, fog_u
    )

    shades = kind == 1
    if not quirks.triangles_shade_black:
        shades = shades | (kind == 2)
    miss = kind == 0
    return hits, mat, direct, shades, miss


def _mc_continue(scene, cfg: RenderConfig, key, hits, mat, ids, bounce):
    """Sample the Monte-Carlo continuation ray at each hit
    (montecarlo_global_illumination's per-path body, src/raytrace.h:117-131).

    Returns (o', d', factor [R,3]) with factor = 2*pi*r1*diffuse — the
    per-bounce throughput multiplier derived in the module docstring.
    """
    point, normal, diffuse = hits.point, hits.normal, mat.diffuse
    quirks = cfg.quirks
    r = sampling.uniform(key, ids, bounce, sampling.PURPOSE_PATH, (2,))
    r1, r2 = r[:, 0], r[:, 1]
    smp = sampling.uniform_sample_hemi(r1, r2)
    d_new = sampling.to_world(smp, normal, quirks=quirks)
    if not quirks.unnormalized_ray_dirs:
        d_new = normalize(d_new)
    if quirks.scalar_epsilon_offset:
        o_new = point + INDIRECT_ORIGIN_EPS  # scalar add (src/raytrace.h:128)
    else:
        o_new = offset_origin(point, normal)
    factor = 2.0 * _PI * r1[:, None] * diffuse
    return o_new, d_new, factor


def integrate_linear(scene, cfg: RenderConfig, key, o, d, sample_ids):
    """Radiance for primary rays [C] — parity semantics (and clean
    Monte-Carlo path tracing when quirks are off and monte_carlo is on).

    sample_ids: [C] uint32 global sample ids (RNG identity). Returns [C,3].
    """
    P = cfg.paths_per_sample
    hits, mat, direct, shades, miss = _shade_hit(scene, cfg, key, o, d, sample_ids, 0)
    background = jnp.broadcast_to(scene.background[None, :], direct.shape)

    if not cfg.monte_carlo:
        # Plain Blinn-Phong: direct for sphere hits (src/raytrace.h:205-218),
        # black triangles, background misses. No reachable recursion.
        return jnp.where(
            miss[:, None], background, jnp.where(shades[:, None], direct, 0.0)
        )

    # Bounce-0 direct term of the MC combine (shared by all paths).
    l0 = jnp.where(
        miss[:, None],
        background,
        jnp.where(shades[:, None], direct / _PI * mat.diffuse, 0.0),
    )
    if cfg.max_depth <= 1:
        # Continuations would call shade(depth=0) == black (src/raytrace.h:142).
        return l0

    # Expand each live sample into P linear continuation paths.
    C = o.shape[0]
    path_ids = (sample_ids[:, None] * P + jnp.arange(P, dtype=jnp.uint32)[None, :]).reshape(-1)
    rep = lambda a: jnp.repeat(a, P, axis=0)
    hits_p = jax.tree_util.tree_map(rep, hits)
    mat_p = jax.tree_util.tree_map(rep, mat)
    o1, d1, f1 = _mc_continue(scene, cfg, key, hits_p, mat_p, path_ids, 0)
    t1 = f1 * rep(shades)[:, None]  # only shaded hits continue

    def _bounce_shade(o_b, d_b, t_b, bounce):
        h, m, dir_b, sh, ms = _shade_hit(
            scene, cfg, key, o_b, d_b, path_ids, bounce
        )
        bg = jnp.broadcast_to(scene.background[None, :], dir_b.shape)
        l_add = t_b * jnp.where(
            ms[:, None], bg, jnp.where(sh[:, None], dir_b / _PI * m.diffuse, 0.0)
        )
        return h, m, sh, l_add

    def body(carry, bounce):
        o_b, d_b, t_b = carry
        h, m, sh, l_add = _bounce_shade(o_b, d_b, t_b, bounce)
        o_n, d_n, f = _mc_continue(scene, cfg, key, h, m, path_ids, bounce)
        t_n = t_b * f * sh[:, None]
        return (o_n, d_n, t_n), l_add

    # The FINAL bounce is peeled out of the scan: its continuation ray is
    # never traced (shade(depth=0) == black, src/raytrace.h:142), so
    # sampling it — RNG draws, hemisphere transform, normalize, origin
    # offset for every path ray — would be pure waste. At the benchmarked
    # depth 2 this skips one full sampling pass over ALL path rays.
    bounces = jnp.arange(1, cfg.max_depth - 1, dtype=jnp.int32)
    (o_f, d_f, t_f), l_adds = jax.lax.scan(body, (o1, d1, t1), bounces)
    _, _, _, l_last = _bounce_shade(o_f, d_f, t_f, cfg.max_depth - 1)
    path_l = jnp.sum(l_adds, axis=0) + l_last  # [C*P, 3]
    indirect = jnp.mean(path_l.reshape(C, P, 3), axis=1)
    return l0 + indirect


def integrate_whitted(scene, cfg: RenderConfig, key, o, d, sample_ids):
    """Clean-mode Whitted tracing: realizes the reference's DEAD
    reflection/refraction code path (src/raytrace.h:46-103, unreachable
    behind the early return at :44) as a breadth-first frontier expansion.

    Per hit with nonzero specular and remaining depth (the dead code's gate,
    src/raytrace.h:52):
      * reflection child: direction = reflect(d_hat, n), weight
        (1 - fresnel) * material.specular (src/raytrace.h:77-80 weights);
      * refraction child: direction = bp::refraction(d_hat, n, ior), weight
        fresnel, spawned when fresnel < 1 (src/raytrace.h:60-70).
    Differences from the dead code are deliberate sanity fixes and are
    documented here: the reference reflects the LIGHT direction once PER
    LIGHT and overwrites (not accumulates) the refraction colour inside the
    light loop; the clean tracer reflects the VIEW ray once, which is what
    Whitted tracing means. Parity tests never exercise this path.
    """
    quirks = cfg.quirks
    frontier_o, frontier_d = o, d
    weight = jnp.ones_like(o)
    total = jnp.zeros_like(o)
    ids = sample_ids

    for depth in range(cfg.max_depth):
        hits, mat, direct, shades, miss = _shade_hit(
            scene, cfg, key, frontier_o, frontier_d, ids, depth
        )
        bg = jnp.broadcast_to(scene.background[None, :], direct.shape)
        l_local = jnp.where(
            miss[:, None], bg, jnp.where(shades[:, None], direct, 0.0)
        )
        # Fold the frontier's weighted contributions back onto their
        # original samples (the frontier doubles by concatenation, so rows
        # i, i+n, i+2n, ... belong to sample i).
        total = total + _fold(weight * l_local, o.shape[0])

        if depth == cfg.max_depth - 1:
            break

        d_hat = normalize(frontier_d)
        fr = fresnel(d_hat, hits.normal, mat.ior)
        has_spec = jnp.any(mat.specular != 0.0, axis=-1) & shades

        o_child = offset_origin(hits.point, hits.normal)
        refl_d = d_hat - 2.0 * jnp.sum(d_hat * hits.normal, -1, keepdims=True) * hits.normal
        refl_w = weight * mat.specular * (1.0 - fr)[:, None] * has_spec[:, None]
        refr_d = refraction(d_hat, hits.normal, mat.ior)
        refr_valid = has_spec & (fr < 1.0) & (jnp.sum(refr_d * refr_d, -1) > 0)
        refr_w = weight * fr[:, None] * refr_valid[:, None]
        # refraction continues on the far side of the surface
        o_refr = offset_origin(hits.point, hits.normal, sign=-1.0)

        frontier_o = jnp.concatenate([o_child, o_refr], axis=0)
        frontier_d = jnp.concatenate([refl_d, refr_d], axis=0)
        weight = jnp.concatenate([refl_w, refr_w], axis=0)
        # Distinct RNG stream per frontier branch: reflection children get
        # id*2, refraction children id*2+1 (injective per depth since ids
        # are dense), so siblings never share fog/sampling draws — the
        # reference's per-call rand() would not correlate them either.
        ids = jnp.concatenate([ids * 2, ids * 2 + 1], axis=0)

    return total


def _fold(contrib, n):
    """Sum a [k*n, 3] frontier contribution back to its n original samples
    (the frontier doubles by concatenation, so rows i, i+n, i+2n, ... all
    belong to sample i)."""
    k = contrib.shape[0] // n
    return contrib.reshape(k, n, 3).sum(axis=0)


def integrate(scene, cfg: RenderConfig, key, o, d, sample_ids):
    """Dispatch: Monte-Carlo / parity -> linear wavefront; clean non-MC with
    reflections enabled -> Whitted frontier."""
    if cfg.monte_carlo or cfg.quirks.disable_reflections:
        return integrate_linear(scene, cfg, key, o, d, sample_ids)
    return integrate_whitted(scene, cfg, key, o, d, sample_ids)
