"""Blinn-Phong shading, spherical fog, reflection/refraction/Fresnel.

Vectorized re-design of the reference `bp::` namespace
(src/blinn_phong.h:10-185): every term is computed for a whole ray batch
against all (padded) lights at once, with masks standing in for the
reference's per-light loops and early-outs. All functions are pure and
differentiable with respect to materials, lights, and geometry.

Faithfulness notes (each cites the reference):
* Point lights fall off as 1/d^2 (src/blinn_phong.h:69-70).
* Directional light `direction` points TOWARD the light — used directly in
  dot(n, l) with no negation (src/blinn_phong.h:84-85) — and has no falloff.
* The specular view vector comes from the CAMERA position, not the ray
  origin (src/blinn_phong.h:93) — visible for secondary rays.
* The half vector divides by its length explicitly (src/blinn_phong.h:101).
* When any fog volume exists, BOTH the diffuse and the specular per-light
  terms are replaced by the fog term (src/blinn_phong.h:56-66,104-110 route
  through spherical_fog_shading) — each with independent random draws.
* Shadow gating is `!use_shadows || !shadow(...)` evaluated identically for
  diffuse and specular (src/blinn_phong.h:53,98).
* `fresnel`'s Rp uses the reference's denominator (ior*cosi + et*cost) for
  both Rs and Rp (src/blinn_phong.h:180-181) — physically Rp's should be
  (et*cosi + ior*cost); replicated bug-for-bug since it is capability
  surface (exercised by clean mode's reflection weights).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from skele_raytracer_tpu.config import (
    CLEAN_T_EPS,
    SHADOW_ORIGIN_EPS,
    Quirks,
    RenderConfig,
)
from skele_raytracer_tpu.ops.geometry import (
    _pos_sqrt,
    dot,
    norm,
    normalize,
    gather_rows,
    one_hot_rows,
    ray_sphere_all,
    ray_triangle_all,
)


class GatheredMaterial(NamedTuple):
    """Per-ray material properties gathered at hit points."""

    ambient: jnp.ndarray  # [R, 3]
    diffuse: jnp.ndarray  # [R, 3]
    specular: jnp.ndarray  # [R, 3]
    transmissive: jnp.ndarray  # [R, 3]
    power: jnp.ndarray  # [R]
    ior: jnp.ndarray  # [R]


def _pack_material(table):
    """[N, 14] column-packed material table:
    ambient(3) diffuse(3) specular(3) transmissive(3) power(1) ior(1)."""
    return jnp.concatenate(
        [
            table.ambient, table.diffuse, table.specular, table.transmissive,
            table.power[:, None], table.ior[:, None],
        ],
        axis=1,
    )


def _unpack_material(vals) -> GatheredMaterial:
    return GatheredMaterial(
        ambient=vals[:, 0:3],
        diffuse=vals[:, 3:6],
        specular=vals[:, 6:9],
        transmissive=vals[:, 9:12],
        power=vals[:, 12],
        ior=vals[:, 13],
    )


# Above this row count, a one-hot [R, N] matrix costs more than the
# scatter it avoids (dragon's 10k-triangle table would be GBs per chunk);
# fall back to a plain gather there.
_ONE_HOT_MAX_ROWS = 512


def _select_rows(table, index, valid=None):
    """table[index] via one-hot matmul for small tables, plain gather for
    large ones (see one_hot_rows for why)."""
    n = table.shape[0]
    if n <= _ONE_HOT_MAX_ROWS:
        out = gather_rows(one_hot_rows(index, n, valid=valid), table)
    else:
        out = table[jnp.minimum(index, n - 1)]
        if valid is not None:
            out = out * valid.astype(out.dtype)[:, None]
    return out


def gather_material(scene, kind, index, *, quirks: Quirks) -> GatheredMaterial:
    """Material at each hit, as ONE row-select per primitive table
    (one-hot matmul for small tables, gather for mesh-scale ones).
    Parity mode only ever shades spheres (triangles return black before
    touching materials, src/raytrace.h:221-224), so it reads the sphere
    table unconditionally; clean mode adds the triangle table gated by
    kind==2."""
    sph, tri = scene.spheres, scene.triangles
    if quirks.triangles_shade_black:
        return _unpack_material(_select_rows(_pack_material(sph), index))
    vals = _select_rows(_pack_material(sph), index, valid=kind != 2) + _select_rows(
        _pack_material(tri), index, valid=kind == 2
    )
    return _unpack_material(vals)


def _shadow_mask(x, normal, scene, cfg: RenderConfig, l_vec, light_dist=None):
    """not-shadowed mask [R, L] for shadow rays from x toward each light.

    Replicates `shadow()` (src/utils.h:42-76): origin offset is the scalar
    1e-6 added to every component, direction normalized, occlusion = any
    sphere with t > 1.0 (no max-t bound — occluders beyond the light still
    occlude). Clean mode offsets along the normal, bounds point-light
    occluders by the light distance, and lets triangles occlude too.

    The (tiny, static) light axis is iterated in Python rather than
    flattened to [R*L, 3], so each light's scan is its own [R, N]
    reduction.
    """
    quirks = cfg.quirks
    R, L = l_vec.shape[0], l_vec.shape[1]
    if quirks.scalar_epsilon_offset:
        origin = x + SHADOW_ORIGIN_EPS
    else:
        from skele_raytracer_tpu.ops.geometry import offset_origin

        origin = offset_origin(x, normal)
    t_clip = 1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS
    bound = light_dist is not None and not quirks.near_clip_t_le_1

    cols = []
    for l in range(L):
        direction = normalize(l_vec[:, l, :])
        if scene.has_spheres:
            t_sph = ray_sphere_all(
                origin, direction, scene.spheres.center, scene.spheres.radius,
                scene.spheres.mask, t_clip=t_clip,
            )  # [R, S]
            if bound:
                occ = jnp.any(t_sph < light_dist[:, l, None], axis=1)
            else:
                occ = jnp.any(jnp.isfinite(t_sph), axis=1)
        else:
            occ = jnp.zeros((R,), bool)
        if not quirks.sphere_only_shadows and scene.has_triangles:
            t_tri, ok, _, _ = ray_triangle_all(
                origin, direction, scene.triangles.v0, scene.triangles.v1,
                scene.triangles.v2, scene.triangles.mask, quirks=quirks,
            )
            if bound:
                occ = occ | jnp.any(ok & (t_tri < light_dist[:, l, None]), axis=1)
            else:
                occ = occ | jnp.any(ok, axis=1)
        cols.append(~occ)
    return jnp.stack(cols, axis=1)  # [R, L]


def _fog_term(scene, mat, prim_center, l, x, n, light_pos, light_col, fog_u):
    """spherical_fog_shading summed over fog volumes (src/blinn_phong.h:19-44).

    fog_u: [R, L, F, 4] uniforms — [.,.,.,0] is the interaction draw, the
    rest feed scattering_phase_function (src/utils.h:216-224: three U[-1,1]
    offsets scaled by fog.scattering, added to the light direction).
    Returns [R, L, 3].
    """
    fog = scene.fog
    # distance = |sphere_center - light_pos|, clamped to 2 * fog radius
    # (src/blinn_phong.h:22-27).
    dist_cl = norm(prim_center[:, None, :] - light_pos[None, :, :])  # [R, L]
    dist_cl = jnp.minimum(dist_cl[:, :, None], 2.0 * fog.radius[None, None, :])  # [R,L,F]
    p_no_interaction = jnp.exp(
        -dist_cl * (fog.absorption + fog.scattering)[None, None, :]
    )
    interacts = fog_u[..., 0] > p_no_interaction  # [R, L, F]

    # Interaction branch: plain 1/d^2 diffuse term (src/blinn_phong.h:31-38).
    d_lx = norm(light_pos[None, :, :] - x[:, None, :])  # [R, L]
    intensity = 1.0 / jnp.maximum(d_lx * d_lx, 1e-30)
    ndotl = jnp.maximum(0.0, dot(n[:, None, :], l))  # [R, L]
    diffuse_like = (
        mat.diffuse[:, None, :] * light_col[None, :, :] * (intensity * ndotl)[:, :, None]
    )  # [R, L, 3]

    # No-interaction branch: perturbed-direction albedo term
    # (src/blinn_phong.h:41-43, src/utils.h:216-224).
    offsets = fog_u[..., 1:4] * 2.0 - 1.0  # [R, L, F, 3] in U[-1, 1]
    new_l = l[:, :, None, :] + fog.scattering[None, None, :, None] * offsets
    ndotl2 = jnp.maximum(0.0, dot(n[:, None, None, :], new_l))  # [R, L, F]
    albedo_like = (
        fog.albedo[None, None, :, :] * light_col[None, :, None, :] * ndotl2[..., None]
    )  # [R, L, F, 3]

    per_fog = jnp.where(
        interacts[..., None], diffuse_like[:, :, None, :], albedo_like
    )
    return jnp.sum(per_fog * fog.mask[None, None, :, None], axis=2)  # [R, L, 3]


def direct_illumination(x, n, scene, mat, prim_center, cfg: RenderConfig,
                        fog_u=None):
    """ambient + diffuse + specular at the hit points — the REACHABLE body
    of the reference's direct_illumination (src/raytrace.h:36-44; the
    reflection/refraction block below its early return is dead code and is
    realized instead by models/integrator.integrate_whitted).

    x, n: [R, 3] hit points / normals. mat: gathered material. prim_center:
    [R, 3] center of the hit sphere (fog distance term). fog_u: fog uniforms
    [R, L, F, 4, 2] when the scene has fog. Returns [R, 3].
    """
    quirks = cfg.quirks
    total = scene.ambient[None, :] * mat.ambient  # bp::ambient_shading (:13-17)

    # ---- point lights --------------------------------------------------
    # With parity's zeroed fog, BOTH per-point-light terms are rerouted
    # through a fog term that is identically zero (types.Scene.fog_zeroed),
    # so the whole block — including its shadow rays — folds away.
    # Directional lights are unaffected (no fog reroute in the reference's
    # directional loops) but are dropped in parity mode anyway.
    # Skipped entirely (static) when none parsed (scene.point_active):
    # phantom padded slots contribute zero but would still launch a full
    # per-light shadow sweep per chunk.
    if scene.has_point_lights and not (scene.has_fog and scene.fog_zeroed):
        plights = scene.point_lights
        l_vec = plights.position[None, :, :] - x[:, None, :]  # [R, L, 3]
        d_l = norm(l_vec)  # [R, L]
        l = l_vec / jnp.maximum(d_l, 1e-30)[:, :, None]
        lmask = plights.mask[None, :]  # [1, L]
        if cfg.use_shadows:
            unshadowed = _shadow_mask(x, n, scene, cfg, l_vec, light_dist=d_l)
        else:
            unshadowed = jnp.ones_like(d_l, bool)
        gate = lmask * unshadowed  # [R, L]

        intensity = 1.0 / jnp.maximum(d_l * d_l, 1e-30)  # 1/d^2 (:69-70)
        ndotl = jnp.maximum(0.0, dot(n[:, None, :], l))

        if scene.has_fog:
            fog_d = _fog_term(scene, mat, prim_center, l, x, n,
                              plights.position, plights.colour, fog_u[..., 0])
            fog_s = _fog_term(scene, mat, prim_center, l, x, n,
                              plights.position, plights.colour, fog_u[..., 1])
            diffuse_pt = fog_d
            specular_pt = fog_s
        else:
            diffuse_pt = (
                mat.diffuse[:, None, :] * plights.colour[None, :, :]
                * (intensity * ndotl)[:, :, None]
            )
            view = normalize(scene.camera.position[None, :] - x)  # camera, not ray origin (:93)
            h_raw = view[:, None, :] + l
            h = h_raw / jnp.maximum(norm(h_raw, keepdims=True), 1e-30)
            ndoth = jnp.maximum(0.0, dot(n[:, None, :], h))
            spec_pow = jnp.power(jnp.maximum(ndoth, 1e-30), mat.power[:, None]) * (ndoth > 0)
            specular_pt = (
                mat.specular[:, None, :] * plights.colour[None, :, :]
                * (intensity * spec_pow)[:, :, None]
            )
        total = total + jnp.sum((diffuse_pt + specular_pt) * gate[:, :, None], axis=1)

    # ---- directional lights (src/blinn_phong.h:81-88,121-133) ----------
    # Skipped entirely (static) when none parsed — the reference's loops are
    # dead in parity mode anyway because parseScene drops these lights
    # (src/scene.cpp:139-163, SURVEY.md §2.9.5).
    dlights = scene.directional_lights
    if scene.has_directional:
        ld = normalize(dlights.direction)[None, :, :]  # [1, L, 3] toward light, unnegated
        ld = jnp.broadcast_to(ld, (x.shape[0],) + ld.shape[1:])
        dmask = dlights.mask[None, :]
        if cfg.use_shadows:
            unshadowed_d = _shadow_mask(x, n, scene, cfg, ld, light_dist=None)
        else:
            unshadowed_d = jnp.ones((x.shape[0], dlights.mask.shape[0]), bool)
        gate_d = dmask * unshadowed_d
        ndotl_d = jnp.maximum(0.0, dot(n[:, None, :], ld))
        diffuse_dir = (
            mat.diffuse[:, None, :] * dlights.colour[None, :, :] * ndotl_d[:, :, None]
        )
        view = normalize(scene.camera.position[None, :] - x)
        h_raw = view[:, None, :] + ld
        h = h_raw / jnp.maximum(norm(h_raw, keepdims=True), 1e-30)
        ndoth_d = jnp.maximum(0.0, dot(n[:, None, :], h))
        spec_pow_d = jnp.power(jnp.maximum(ndoth_d, 1e-30), mat.power[:, None]) * (ndoth_d > 0)
        specular_dir = (
            mat.specular[:, None, :] * dlights.colour[None, :, :] * spec_pow_d[:, :, None]
        )
        total = total + jnp.sum(
            (diffuse_dir + specular_dir) * gate_d[:, :, None], axis=1
        )

    return total


def reflect_direction(l, n):
    """bp::reflect_direction (src/blinn_phong.h:137-140):
    normalize(l - 2 dot(l, n) n)."""
    return normalize(l - 2.0 * dot(l, n)[..., None] * n)


def refraction(d, n, ior):
    """bp::refraction (src/blinn_phong.h:143-153). No inside/outside eta
    handling, exactly as the reference: k = 1 - ior^2 (1 - dot(d,n)^2);
    k < 0 -> zero vector (total internal reflection sentinel)."""
    dn = dot(d, n)[..., None]
    k = 1.0 - ior[..., None] ** 2 * (1.0 - dn * dn)
    refr = ior[..., None] * d - (ior[..., None] * dn + _pos_sqrt(k)) * n
    return jnp.where(k < 0.0, 0.0, refr)


def fresnel(d, n, ior):
    """bp::fresnel (src/blinn_phong.h:156-184): full Fresnel Rs/Rp (the
    "Schlick" comment there is wrong) with eta swap on cos>0 and the
    reference's Rp denominator (see module docstring). Returns [R]."""
    cosi = jnp.clip(dot(d, n), -1.0, 1.0)
    et = jnp.where(cosi > 0, ior, 1.0)
    io = jnp.where(cosi > 0, 1.0, ior)
    sint = et / jnp.where(io != 0, io, 1.0) * _pos_sqrt(1.0 - cosi * cosi)
    cost = _pos_sqrt(1.0 - sint * sint)
    cosi = jnp.abs(cosi)
    denom = io * cosi + et * cost
    denom = jnp.where(jnp.abs(denom) > 1e-30, denom, 1e-30)
    rs = (io * cosi - et * cost) / denom
    rp = (et * cosi - io * cost) / denom
    fr = (rs * rs + rp * rp) / 2.0
    return jnp.where(sint >= 1.0, 1.0, fr)
