"""Intersection geometry, batched over rays × primitives.

The reference's per-ray scalar loops (sphere scan src/raytrace.h:152-166,
triangle scan src/raytrace.h:170-187) become rank-2 [rays, primitives]
vector computations that XLA fuses; the whole-frame path-trace kernel
(ops/pallas/pathtrace.py) runs the same math per ray in registers for
small scenes.

All functions are pure and differentiable. Discrete hit *selection*
(argmin indices, hit masks) is wrapped in stop_gradient by callers; the
continuous quantities (t, hit point, normal) carry gradients.

Conventions: rays are (origin [R,3], direction [R,3]); directions may be
unnormalized (the reference never normalizes: SURVEY.md §2.9.3) — the
quadratic handles non-unit d via a = dot(d, d) exactly as src/utils.h:113-121.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from skele_raytracer_tpu.config import CLEAN_T_EPS, TRIANGLE_DET_EPS, Quirks

INF = jnp.inf


def dot(a, b, axis=-1):
    return jnp.sum(a * b, axis=axis)


def _pos_sqrt(x):
    """sqrt(max(x, 0)) whose gradient is 0 (not inf/NaN) at x <= 0.

    The naive sqrt(maximum(x, 0)) has an infinite partial at x == 0, and a
    masked consumer's zero cotangent times that infinity is NaN — exactly
    what happens for grazing-ray discriminants, padded primitives, and
    zero-length vectors. The double-where makes every partial finite.
    """
    pos = x > 0
    return jnp.sqrt(jnp.where(pos, x, 1.0)) * pos


def norm(v, axis=-1, keepdims=False):
    """|v| with zero (not NaN) gradient at v = 0."""
    return _pos_sqrt(jnp.sum(v * v, axis=axis, keepdims=keepdims))


def normalize(v, axis=-1):
    """Normalize; zero vectors map to zero with zero gradient (glm would
    give nan/inf — the reference never normalizes a zero vector on
    reachable paths)."""
    n = norm(v, axis=axis, keepdims=True)
    return v * jnp.where(n > 0, 1.0 / jnp.where(n > 0, n, 1.0), 0.0)


_safe_sqrt = _pos_sqrt


def one_hot_rows(index, n, valid=None):
    """[R, n] float32 one-hot of `index` (optionally gated by `valid`).

    Row gathers from small tables go through `one_hot @ table` instead of
    `table[index]`: identical values, but the gradient wrt the table is
    the matrix product `one_hot.T @ g` instead of a scatter-add.
    """
    cols = jnp.arange(n, dtype=index.dtype)[None, :]
    oh = (index[:, None] == cols).astype(jnp.float32)
    if valid is not None:
        oh = oh * valid.astype(jnp.float32)[:, None]
    return oh


def gather_rows(oh, table):
    """`oh @ table` at HIGHEST matmul precision.

    A one-hot gather must reproduce the table values EXACTLY, but DEFAULT
    f32 precision may run the product in reduced precision (TF32 on GPU
    tensor cores keeps 10 mantissa bits), quantizing the gathered values
    — a sphere centre at -50.0 would snap to coarse steps, flattening
    small geometry perturbations. HIGHEST keeps full f32, exact for
    0/1-weight rows. Every one_hot_rows product goes through here."""
    return jnp.matmul(oh, table, precision=jax.lax.Precision.HIGHEST)


def offset_origin(point, normal, sign=1.0):
    """Secondary-ray origin offset along the normal, scaled with distance
    from the world origin: float32 hit points carry ~|p| * 2^-23 error, so
    a FIXED epsilon self-intersects far geometry (visible as shadow-acne
    rings on large ground planes). Clean-mode paths only; parity keeps the
    reference's scalar epsilon adds (src/utils.h:46,64; raytrace.h:128)."""
    scale = CLEAN_T_EPS * (1.0 + norm(point, keepdims=True))
    return point + sign * scale * normal


class SphereHits(NamedTuple):
    t: jnp.ndarray  # [R] ray-parameter of nearest valid sphere hit (inf = none)
    index: jnp.ndarray  # [R] int32 index of that sphere
    hit: jnp.ndarray  # [R] bool


def ray_sphere_all(o, d, center, radius, mask, *, t_clip: float):
    """t of each ray against each sphere: [R, S].

    Implements the reference quadratic + root selection exactly
    (collision_distance src/utils.h:113-121, smallest_root src/utils.h:87-110).
    For a = dot(d,d) > 0 the root t1 = (-b+sq)/2a always >= t2, so the
    reference's `t1 < t2` branch is dead and smallest_root reduces to
    `t2 if t2 >= 0 else INF` — implemented directly.

    `t_clip`: hits with t <= t_clip are rejected (the reference's
    intersection_occurs near clip of 1.0 in ray-parameter units,
    src/utils.h:169-179; clean mode passes CLEAN_T_EPS).
    """
    ec = o[:, None, :] - center[None, :, :]  # [R, S, 3]
    a = dot(d, d)[:, None]  # [R, 1]
    b = 2.0 * dot(d[:, None, :], ec)  # [R, S]
    c = dot(ec, ec) - radius[None, :] ** 2  # [R, S]
    disc = b * b - 4.0 * a * c
    sq = _safe_sqrt(disc)
    t2 = (-b - sq) / (2.0 * a)
    valid = (disc >= 0) & (t2 >= 0) & (t2 > t_clip) & (mask[None, :] > 0)
    return jnp.where(valid, t2, INF)


def nearest_sphere(o, d, center, radius, mask, *, quirks: Quirks) -> SphereHits:
    """Nearest sphere hit per ray (the reference's sphere scan,
    src/raytrace.h:152-166: min over t with first-wins ties)."""
    t_clip = 1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS
    t_all = ray_sphere_all(o, d, center, radius, mask, t_clip=t_clip)
    idx = jnp.argmin(t_all, axis=1).astype(jnp.int32)  # first min wins, like the loop
    t = jnp.min(t_all, axis=1)
    return SphereHits(t=t, index=idx, hit=jnp.isfinite(t))


class TriangleHits(NamedTuple):
    t: jnp.ndarray  # [R]
    index: jnp.ndarray  # [R] int32
    hit: jnp.ndarray  # [R] bool
    u: jnp.ndarray  # [R] barycentric
    v: jnp.ndarray  # [R]


def ray_triangle_all(o, d, v0, v1, v2, mask, *, quirks: Quirks):
    """(t, valid) of each ray against each triangle: [R, T].

    Parity mode replicates the reference's variant of Möller-Trumbore
    (triangle_intersection_occurs, src/utils.h:181-213) exactly, including
    its two deviations from the standard algorithm:
      * u is computed as dot(-(o - v0), p) / det — sign-flipped vs standard
        MT, so the accepted barycentric region is mirrored (src/utils.h:196);
      * there is no t > 0 check, so negative-t (behind-the-origin) hits are
        accepted (src/utils.h:211) and can win the nearest-hit comparison
        (src/raytrace.h:176-186).
    Clean mode uses standard MT with a t > CLEAN_T_EPS bound.
    """
    e1 = v1 - v0  # [T, 3]
    e2 = v2 - v0
    p = jnp.cross(d[:, None, :], e2[None, :, :])  # [R, T, 3]
    det = dot(e1[None, :, :], p)  # [R, T]
    ok = jnp.abs(det) >= TRIANGLE_DET_EPS
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    tvec = o[:, None, :] - v0[None, :, :]  # [R, T, 3]
    if quirks.reference_triangle_test:
        u = dot(-tvec, p) * inv
    else:
        u = dot(tvec, p) * inv
    q = jnp.cross(tvec, e1[None, :, :])  # [R, T, 3]
    v = dot(d[:, None, :], q) * inv
    t = dot(e2[None, :, :], q) * inv
    # Reference rejects u<0, u>1, v<0, u+v>1 strictly (src/utils.h:197-207).
    ok = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (mask[None, :] > 0)
    if not quirks.reference_triangle_test:
        ok = ok & (t > CLEAN_T_EPS)
    return jnp.where(ok, t, INF), ok, u, v


def nearest_triangle(o, d, v0, v1, v2, mask, *, quirks: Quirks) -> TriangleHits:
    """Nearest triangle per ray.

    Parity caveat: because negative t is allowed, "nearest" means smallest
    signed t among valid hits (matching the reference's strict `t <
    min_distance` loop, src/raytrace.h:176-186, where min_distance starts at
    the sphere minimum, so any negative-t triangle wins).
    """
    t_all, ok, u_all, v_all = ray_triangle_all(o, d, v0, v1, v2, mask, quirks=quirks)
    # Valid entries may be negative in parity mode; invalid ones are +inf,
    # so argmin still selects the reference's winner (first-wins on ties,
    # matching the strict < in the loop).
    idx = jnp.argmin(t_all, axis=1).astype(jnp.int32)
    t = jnp.min(t_all, axis=1)
    hit = jnp.take_along_axis(ok, idx[:, None], axis=1)[:, 0] & jnp.isfinite(t)
    u = jnp.take_along_axis(u_all, idx[:, None], axis=1)[:, 0]
    v = jnp.take_along_axis(v_all, idx[:, None], axis=1)[:, 0]
    return TriangleHits(t=t, index=idx, hit=hit, u=u, v=v)


def replay_triangle_t(o, d, tris, index):
    """Differentiable t of each ray against its SELECTED triangle — [R]
    work, not [R, T].

    The path-trace kernel decides the hit structure forward-only (which
    triangle wins); this re-derives the winning t from (o, d,
    triangle[index]) so gradients flow to rays and vertices WITHOUT
    re-running (or differentiating) the full scan: the backward pass
    reuses the forward's intersection structure and recomputes only the
    continuous quantity. Same Möller-Trumbore t as ray_triangle_all
    (src/utils.h:181-213) restricted to one triangle per ray.
    """
    idx = jnp.minimum(index, tris.v0.shape[0] - 1)
    v0, v1, v2 = tris.v0[idx], tris.v1[idx], tris.v2[idx]
    e1 = v1 - v0
    e2 = v2 - v0
    p = jnp.cross(d, e2)
    det = dot(e1, p)
    ok = jnp.abs(det) >= TRIANGLE_DET_EPS
    inv = jnp.where(ok, 1.0 / jnp.where(ok, det, 1.0), 0.0)
    q = jnp.cross(o - v0, e1)
    return dot(e2, q) * inv


class Hits(NamedTuple):
    """Combined nearest-hit record for a ray batch.

    kind: 0 = miss, 1 = sphere, 2 = triangle (the reference's
    hit_a_sphere/hit_a_triangle booleans, src/raytrace.h:146-187).
    """

    kind: jnp.ndarray  # [R] int32
    index: jnp.ndarray  # [R] int32 (into spheres or triangles by kind)
    t: jnp.ndarray  # [R]
    point: jnp.ndarray  # [R, 3]
    normal: jnp.ndarray  # [R, 3] (sphere normal; triangle geometric normal in clean mode)


def intersect(o, d, scene, *, quirks: Quirks) -> Hits:
    """Nearest hit over all scene primitives (the body of `shade`'s search,
    src/raytrace.h:146-187): spheres scanned first, then triangles, where a
    triangle wins only with strictly smaller t. Each scan is the
    brute-force [rays, primitives] broadcast, which XLA fuses into one
    reduction per primitive kind.
    """
    # Each scan is skipped statically when the scene has none of its
    # primitives (the padded phantom slots can never hit, but the [R, N]
    # work and its gradient cost are real).
    if scene.has_spheres:
        sph = nearest_sphere(
            o, d, scene.spheres.center, scene.spheres.radius, scene.spheres.mask,
            quirks=quirks,
        )
    else:
        R = o.shape[0]
        sph = SphereHits(
            t=jnp.full((R,), INF),
            index=jnp.zeros((R,), jnp.int32),
            hit=jnp.zeros((R,), bool),
        )
    if scene.has_triangles:
        tri = nearest_triangle(
            o, d, scene.triangles.v0, scene.triangles.v1, scene.triangles.v2,
            scene.triangles.mask, quirks=quirks,
        )
        tri_wins = tri.hit & (tri.t < jnp.where(sph.hit, sph.t, INF))
        kind = jnp.where(tri_wins, 2, jnp.where(sph.hit, 1, 0)).astype(jnp.int32)
        index = jnp.where(tri_wins, tri.index, sph.index)
        t = jnp.where(tri_wins, tri.t, sph.t)
    else:
        tri_wins = None
        kind = jnp.where(sph.hit, 1, 0).astype(jnp.int32)
        index = sph.index
        t = sph.t

    t_safe = jnp.where(jnp.isfinite(t), t, 0.0)
    point = o + d * t_safe[:, None]

    # Sphere normal: normalize(point - center) (src/raytrace.h:199-201).
    # One-hot matmul instead of a gather: the gather's backward is a
    # serial scatter-add (see one_hot_rows).
    if scene.has_spheres:
        oh = one_hot_rows(sph.index, scene.spheres.mask.shape[0])
        c = gather_rows(oh, scene.spheres.center)
        normal = normalize(point - c)
    else:
        normal = jnp.zeros_like(point)
    if scene.has_triangles:
        # Triangle geometric normal (clean mode; parity shades triangles
        # black so the normal is unused there): normalize(cross(e1, e2)),
        # flipped to face the incoming ray. Computed as a [T, 3] TABLE
        # first, then ONE row gather — normalize/cross commute with the
        # gather (same ops on the same rows, bitwise identical), the
        # per-triangle work is loop-invariant across render chunks, and
        # the per-ray cost drops from two [R] gathers + cross + rsqrt to
        # a single [R] gather.
        e1_t = scene.triangles.v1 - scene.triangles.v0
        e2_t = scene.triangles.v2 - scene.triangles.v0
        n_table = normalize(jnp.cross(e1_t, e2_t))
        n_tri = n_table[tri.index]
        n_tri = n_tri * jnp.where(dot(n_tri, d)[:, None] > 0, -1.0, 1.0)
        normal = jnp.where((kind == 2)[:, None], n_tri, normal)
    return Hits(kind=kind, index=index, t=t, point=point, normal=normal)


def shadow_occluded(point, to_light_dir, scene, *, quirks: Quirks):
    """Is the path from `point` toward `to_light_dir` blocked?

    Replicates `shadow()` (src/utils.h:42-76): the shadow ray starts at
    point + 1e-6 added to EVERY component (not along the normal), direction
    is normalized, and occlusion uses the same t > 1.0 predicate as primary
    rays — with no max-t bound, so occluders beyond a point light still
    occlude (one cause of the README's "shadows aren't 100% working").
    Parity mode tests spheres only (triangles never occlude,
    src/utils.h:49-55); clean mode also tests triangles and offsets along
    the normal... the normal offset is handled by callers via origin.
    """
    from skele_raytracer_tpu.config import SHADOW_ORIGIN_EPS

    if quirks.scalar_epsilon_offset:
        origin = point + SHADOW_ORIGIN_EPS
    else:
        origin = point  # caller pre-offset along the normal in clean mode
    direction = normalize(to_light_dir)
    t_clip = 1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS
    t_sph = ray_sphere_all(
        origin, direction, scene.spheres.center, scene.spheres.radius,
        scene.spheres.mask, t_clip=t_clip,
    )
    occluded = jnp.any(jnp.isfinite(t_sph), axis=1)
    if not quirks.sphere_only_shadows:
        t_tri, ok, _, _ = ray_triangle_all(
            origin, direction, scene.triangles.v0, scene.triangles.v1,
            scene.triangles.v2, scene.triangles.mask, quirks=quirks,
        )
        occluded = occluded | jnp.any(ok, axis=1)
    return occluded


def hit_geometry(o, d, scene, kind, index, t):
    """Differentiable (point, normal) replay from the discrete hit
    structure (kind 0 miss / 1 sphere / 2 triangle, primitive index, t):
    sphere normal from the selected centre, triangle geometric normal
    flipped toward the ray — intersect's normals without its scans."""
    t_safe = jnp.where(jnp.isfinite(t), t, 0.0)
    point = o + d * t_safe[:, None]
    S = scene.spheres.mask.shape[0]
    oh = one_hot_rows(jnp.where(kind == 1, index, 0), S)
    n_sph = normalize(point - gather_rows(oh, scene.spheres.center))
    idx_t = jnp.minimum(
        jnp.where(kind == 2, index, 0), scene.triangles.v0.shape[0] - 1
    )
    e1 = scene.triangles.v1[idx_t] - scene.triangles.v0[idx_t]
    e2 = scene.triangles.v2[idx_t] - scene.triangles.v0[idx_t]
    n_tri = normalize(jnp.cross(e1, e2))
    n_tri = n_tri * jnp.where(dot(n_tri, d)[:, None] > 0, -1.0, 1.0)
    normal = jnp.where((kind == 2)[:, None], n_tri, n_sph)
    return point, normal
