"""Whole-frame path-trace kernel (Pallas through Triton) for small scenes.

The headline benchmark (spheres2 1080p gillum16, the reference's timed
config — reference src/main.cpp:19-104 + src/raytrace.h:139-227) runs on
scenes whose primitive tables are tiny (~16 spheres, at most a few
decorative triangles), so the hot loop is pure per-ray arithmetic:
camera ray, nearest-primitive scans, Blinn-Phong shading, and
`num_paths` Monte-Carlo continuation rays per sample. Traced through XLA
(models/integrator.py) that frame decomposes into a chain of small
fusions per `lax.map` chunk, each a launch plus an HBM round trip for a
few microseconds of arithmetic.

This kernel renders the whole frame in ONE `pallas_call`. Its shape is
the reference CUDA build's (one thread per pixel sample, the primitive
loops kept in registers, reference cudasrc/main.cu:16-57): each Triton
program takes a 1-D block of BLOCK flat sample ids, about one per
thread, and runs ray generation, the counter-based threefry RNG, the
sphere/triangle scans, shading (with shadow scans) and the whole
Monte-Carlo bounce loop in registers. The scene tables are a few KB;
they are read with scalar loads that every thread of a block issues at
the same address, a broadcast served by L1. Nothing intermediate touches
device memory.

Semantics are the wavefront integrator's (models/integrator.py
`integrate_linear`, itself the re-design of reference src/raytrace.h:
139-227): same threefry2x32 streams bit-for-bit (ops/sampling.py), same
quadratic/root selection (src/utils.h:87-121), same triangle test incl.
parity's mirrored-u negative-t variant (src/utils.h:181-213) and
black-triangle shading (src/raytrace.h:221-224), same parity quirks
(unnormalized dirs, t<=1 clip, diagonal jitter, buggy tangent frame,
scalar epsilon offsets) or clean-mode replacements, same light loops
(src/blinn_phong.h). The numeric deviations are mul-by-reciprocal vs
divide rounding (1 ulp) in t, transcendental lowering differences and
the FMA contraction of the GPU compiler — tests/test_pathtrace.py pins
the kernel to the jnp path within a stated tolerance.

Differentiation: `pathtrace_ids` is a custom_vjp. Under differentiation
the kernel also writes one packed int32 hit record per (sample, bounce)
— primitive index, hit bit, triangle bit, per-light unshadowed bits —
and the backward is plain XLA: `_replay_chunked` re-computes the
radiance from those records (nearest-hit scans collapse to the selected
primitive's O(1) t, occlusion scans to record-bit gates) under jax.vjp.
The backward thus reuses the forward's intersection structure; it is
O(rays) elementwise work with no scans, which XLA fuses.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from skele_raytracer_tpu.config import (
    CLEAN_T_EPS,
    INDIRECT_ORIGIN_EPS,
    SHADOW_ORIGIN_EPS,
    TRIANGLE_DET_EPS,
    RenderConfig,
)
from skele_raytracer_tpu.ops.sampling import (
    _GOLDEN,
    PURPOSE_FOG,
    PURPOSE_JITTER,
    PURPOSE_PATH,
    threefry2x32,
)

# Samples per Triton program (a power of two, as Triton requires) and the
# warps that run them: one sample per thread. Chosen by timing on the H100
# against 64/2, 128/4 and 256/4 (PERF.md, Findings).
BLOCK = 256
NUM_WARPS = 8

# "No hit" sentinel for the running minimum of the scans.
_BIG = np.float32(3.0e38)

_TWO_PI = np.float32(2.0 * np.pi)
_PI = np.float32(np.pi)

# Sphere tables up to this size are scanned by unrolled code; larger ones
# by fori_loops over dynamic scalar table reads (same math, constant code
# size). MAX_TRIS keeps mesh-scale scenes on the XLA triangle scan.
_UNROLL_SPHERES = 64
MAX_SPHERES = 256  # hit records hold the primitive index in 8 bits
MAX_TRIS = 32

MAX_FOG = 2  # fog volumes the kernel shades in-register (per volume:
# 8 threefry draws + the two rerouted per-light fog terms, per ray
# bounce — spheres2's single volume is the benchmarked case)


def use_pathtrace(scene, cfg: RenderConfig) -> bool:
    """True when this kernel serves the config: pallas backend, a small
    scene (spheres + at most MAX_TRIS decorative triangles — mesh scenes
    take the XLA wavefront), linear (MC/parity) integrator; value-bearing
    fog is shaded in-kernel up to MAX_FOG volumes (src/blinn_phong.h:56-66
    rerouting)."""
    return (
        cfg.backend == "pallas"
        and (scene.has_spheres or scene.has_triangles)
        and not (scene.has_triangles
                 and scene.triangles.mask.shape[0] > MAX_TRIS)
        and (not (scene.has_fog and not scene.fog_zeroed)
             or scene.fog.mask.shape[0] <= MAX_FOG)
        and (cfg.monte_carlo or cfg.quirks.disable_reflections)
        and scene.spheres.mask.shape[0] <= MAX_SPHERES
        and cfg.max_depth >= 1
    )


def _draw2(seed, bounce: int, purpose: int, ids, pair_idx):
    """TWO U[0,1) values from ONE threefry2x32 call: draws (2*pair_idx,
    2*pair_idx + 1) of the (seed, bounce, purpose) stream — bit-identical
    to ops/sampling.uniform's word mapping (draw i = word i%2 of counter
    i//2). Consuming both output words halves the generator's cost, which
    dominates the fog reroute (8 draws per (light, fog) per bounce)."""
    k1 = np.uint32((int(bounce) * int(_GOLDEN) + int(purpose)) & 0xFFFFFFFF)
    y0, y1 = threefry2x32(seed, k1, ids, jnp.uint32(pair_idx))

    # sampling.bits_to_unit; the top-24-bit value is exact in f32
    def conv(y):
        return (y >> np.uint32(8)).astype(jnp.float32) * np.float32(2**-24)

    return conv(y0), conv(y1)


def _draw(seed, bounce: int, purpose: int, ids, draw_idx: int):
    """One U[0,1) value (word draw_idx % 2 of pair draw_idx // 2); prefer
    _draw2 when both words of a pair are consumed."""
    return _draw2(seed, bounce, purpose, ids, draw_idx // 2)[draw_idx % 2]


def _normalize3(vx, vy, vz):
    """geometry.normalize on components (zero maps to zero)."""
    n2 = vx * vx + vy * vy + vz * vz
    pos = n2 > 0
    nn = jnp.sqrt(jnp.where(pos, n2, 1.0)) * pos
    inv = jnp.where(nn > 0, 1.0 / jnp.where(nn > 0, nn, 1.0), 0.0)
    return vx * inv, vy * inv, vz * inv, nn


def _sphere_num(o, d, a4, sphere):
    """The reference quadratic (src/utils.h:113-121) for one sphere in
    numerator space: returns (disc, -b - sqrt(disc)); the shared
    denominator 2a > 0 preserves order, so scans compare numerators."""
    ox, oy, oz = o
    dx, dy, dz = d
    cx, cy, cz, r2 = sphere
    ex, ey, ez = ox - cx, oy - cy, oz - cz
    b = 2.0 * (dx * ex + dy * ey + dz * ez)
    c = ex * ex + ey * ey + ez * ez - r2
    disc = b * b - a4 * c
    pos = disc > 0
    sq = jnp.sqrt(jnp.where(pos, disc, 1.0)) * pos
    return disc, -b - sq


def _scan_spheres(o, d, sph, t_clip: float, rows=None):
    """Nearest-sphere scan (geometry.ray_sphere_all + first-wins argmin,
    src/utils.h:87-121, src/raytrace.h:152-166).

    o: 3-tuple of per-sample values OR scalars (primary rays share one
    origin). d: 3-tuple. sph[s] -> (cx, cy, cz, r2, mask) scalars.
    t materializes once as num * (0.5/a). Returns (hit, t, idx) — plus
    the gathered `rows` when given.

    rows: optional per-sphere material scalars (rows[s] -> tuple of
    columns). The winner's row is gathered INSIDE the argmin update — one
    select per column per sphere — instead of a separate `_gather` pass
    over the same table. Misses keep row 0 exactly like _gather's
    bidx-init-0 convention.
    """
    dx, dy, dz = d
    a = dx * dx + dy * dy + dz * dz
    a4 = 4.0 * a
    clipnum = (2.0 * t_clip) * a
    best = jnp.full(dx.shape, _BIG, jnp.float32)
    bidx = jnp.zeros(dx.shape, jnp.int32)
    mats = None
    if rows is not None:
        zero = jnp.zeros(dx.shape, jnp.float32)
        mats = [zero + v for v in rows[0]]
    for s in range(len(sph)):
        cx, cy, cz, r2, msk = sph[s]
        disc, num = _sphere_num(o, d, a4, (cx, cy, cz, r2))
        valid = (disc >= 0) & (num > clipnum) & (msk > 0)
        upd = valid & (num < best)
        best = jnp.where(upd, num, best)
        bidx = jnp.where(upd, s, bidx)
        if rows is not None and s > 0:
            mats = [jnp.where(upd, v, m) for v, m in zip(rows[s], mats)]
    hit = best < _BIG
    t = best * (0.5 / a)
    if rows is not None:
        return hit, t, bidx, mats
    return hit, t, bidx


def _gather(bidx, rows, valid=None):
    """Select per-primitive scalars by the scan's winning index: for each
    column, sum_s (bidx == s) * value[s]. rows: list over primitives of
    per-column scalars. Misses gather row 0 (bidx init 0), matching the
    jnp argmin-of-all-inf convention; `valid` optionally gates whole rays
    (the jnp one_hot_rows valid mask)."""
    if not rows:
        return []
    n_cols = len(rows[0])
    outs = [None] * n_cols
    for s, vals in enumerate(rows):
        m = bidx == s
        if valid is not None:
            m = m & valid
        m = m.astype(jnp.float32)
        for c in range(n_cols):
            term = m * vals[c]
            outs[c] = term if outs[c] is None else outs[c] + term
    return outs


def _scan_spheres_loop(o, d, sph_ref, S: int, t_clip: float):
    """_scan_spheres as a fori_loop over dynamic scalar table reads (the
    S > _UNROLL_SPHERES regime). Same numerator-space math and first-wins
    tie behavior; no fused material rows (use _gather_loop on the
    winner)."""
    dx, dy, dz = d
    a = dx * dx + dy * dy + dz * dz
    a4 = 4.0 * a
    clipnum = (2.0 * t_clip) * a

    def body(sid, carry):
        best, bidx = carry
        disc, num = _sphere_num(
            o, d, a4, tuple(sph_ref[sid, c] for c in range(4)))
        valid = (disc >= 0) & (num > clipnum) & (sph_ref[sid, 4] > 0)
        upd = valid & (num < best)
        return (jnp.where(upd, num, best), jnp.where(upd, sid, bidx))

    best, bidx = jax.lax.fori_loop(
        0, S, body,
        (jnp.full(dx.shape, _BIG, jnp.float32),
         jnp.zeros(dx.shape, jnp.int32)),
    )
    return best < _BIG, best * (0.5 / a), bidx


def _gather_loop(bidx, ref, cols, S: int, valid=None):
    """_gather as a fori_loop: per column, sum_s (bidx == s) * ref[s, c]
    with dynamic scalar reads. cols are static column indices."""
    z = jnp.zeros(bidx.shape, jnp.float32)

    def body(sid, outs):
        m = bidx == sid
        if valid is not None:
            m = m & valid
        mf = m.astype(jnp.float32)
        return tuple(o + mf * ref[sid, c] for o, c in zip(outs, cols))

    return list(jax.lax.fori_loop(0, S, body, tuple(z for _ in cols)))


def _occluded_loop(origin, direction, sph_ref, S: int, t_clip: float, bound):
    """_occluded's sphere part as a fori_loop (loop-mode shadows)."""
    dx, dy, dz = direction
    a = dx * dx + dy * dy + dz * dz
    a = jnp.where(a > 0, a, 1.0)
    a4 = 4.0 * a
    clipnum = (2.0 * t_clip) * a
    inv2a = 0.5 / a

    def body(sid, occ):
        disc, num = _sphere_num(
            origin, direction, a4, tuple(sph_ref[sid, c] for c in range(4)))
        valid = (disc >= 0) & (num > clipnum) & (sph_ref[sid, 4] > 0)
        if bound is not None:
            valid = valid & (num * inv2a < bound)
        return occ | valid

    return jax.lax.fori_loop(0, S, body, jnp.zeros(dx.shape, bool))


def _tri_test(o, d, tri, ref_test: bool):
    """Möller-Trumbore against ONE triangle's scalars
    (geometry.ray_triangle_all semantics: parity keeps the sign-flipped u
    and accepts negative t, src/utils.h:181-213; clean is standard MT
    with t > CLEAN_T_EPS). Returns (valid, t)."""
    ox, oy, oz = o
    dx, dy, dz = d
    (v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, msk) = tri
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    ok = jnp.abs(det) >= TRIANGLE_DET_EPS
    inv = jnp.where(ok, 1.0, 0.0) / jnp.where(ok, det, 1.0)
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u_dot = tvx * px + tvy * py + tvz * pz
    u = (-u_dot if ref_test else u_dot) * inv
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    valid = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (msk > 0)
    if not ref_test:
        valid = valid & (t > CLEAN_T_EPS)
    return valid, t


def _scan_tris(o, d, tris, ref_test: bool):
    """Nearest-triangle scan (first-wins argmin over t with invalid ->
    +BIG; parity's negative-t hits sort first exactly as the reference's
    strict-< scan, src/raytrace.h:176-186)."""
    best = jnp.full(d[0].shape, _BIG, jnp.float32)
    bidx = jnp.zeros(d[0].shape, jnp.int32)
    for s, tri in enumerate(tris):
        valid, t = _tri_test(o, d, tri, ref_test)
        upd = valid & (t < best)
        best = jnp.where(upd, t, best)
        bidx = jnp.where(upd, s, bidx)
    return best < _BIG, best, bidx


def _occluded(origin, direction, sph, t_clip: float, bound,
              tris=(), ref_test: bool = False):
    """Any-sphere (+ any-triangle in clean mode) occlusion scan
    (reference shadow(), src/utils.h:42-76): parity is unbounded
    (occluders beyond the light still occlude) and sphere-only; clean
    bounds by the light distance and lets triangles occlude."""
    dx, dy, dz = direction
    a = dx * dx + dy * dy + dz * dz
    a = jnp.where(a > 0, a, 1.0)  # zero-length dirs (dead rays) never hit
    a4 = 4.0 * a
    clipnum = (2.0 * t_clip) * a
    inv2a = 0.5 / a
    occ = jnp.zeros(dx.shape, bool)
    for s in range(len(sph)):
        cx, cy, cz, r2, msk = sph[s]
        disc, num = _sphere_num(origin, direction, a4, (cx, cy, cz, r2))
        valid = (disc >= 0) & (num > clipnum) & (msk > 0)
        if bound is not None:
            valid = valid & (num * inv2a < bound)
        occ = occ | valid
    for tri in tris:
        valid, t = _tri_test(origin, direction, tri, ref_test)
        if bound is not None:
            valid = valid & (t < bound)
        occ = occ | valid
    return occ


def _tangent_frame(nx, ny, nz):
    """sampling.tangent_frame on components (src/utils.h:148-165)."""
    use_x = jnp.abs(nx) > jnp.abs(ny)
    inv_a = 1.0 / jnp.sqrt(jnp.maximum(nx * nx + nz * nz, 1e-30))
    inv_b = 1.0 / jnp.sqrt(jnp.maximum(ny * ny + nz * nz, 1e-30))
    zero = jnp.zeros_like(nx)
    pnx = jnp.where(use_x, nz * inv_a, zero)
    pny = jnp.where(use_x, zero, -nz * inv_b)
    pnz = jnp.where(use_x, -nx * inv_a, ny * inv_b)
    # perp_to_both = cross(normal, perp_to_normal)
    pbx = ny * pnz - nz * pny
    pby = nz * pnx - nx * pnz
    pbz = nx * pny - ny * pnx
    return (pnx, pny, pnz), (pbx, pby, pbz)


class _Rows:
    """Row access to one scene table ref: `rows[s]` reads row s's columns
    `cols` as scalar loads at the point of use (a broadcast L1 hit), so
    the unrolled scans keep no table values live across the kernel."""

    def __init__(self, ref, n: int, cols):
        self.ref, self.n, self.cols = ref, n, tuple(cols)

    def __len__(self):
        return self.n

    def __getitem__(self, s):
        return tuple(self.ref[s, c] for c in self.cols)

    def __iter__(self):
        return (self[s] for s in range(self.n))


def _build_frame_math(
    *,
    S: int,
    T: int,
    L: int,
    LD: int,
    sph_on: bool,
    tri_on: bool,
    point_on: bool,
    dir_on: bool,
    use_shadows: bool,
    mc: bool,
    P: int,
    D: int,
    grid: int,
    width: int,
    height: int,
    angle: float,
    quirks,
    F: int = 0,
):
    """Close the static render configuration over the per-block frame math
    and return `frame_math(tabs, ids, seed, emit) -> (r, g, b)`.

    `tabs` are the five table refs (indexed [row, col]); `ids` the
    block's flat sample ids. `emit(slot, rec)`, when not None, receives
    one packed int32 hit record per (sample, bounce) — bits 0:8 primitive
    index, bit 8 hit flag, bit 9 triangle-won flag, bits 10+ per-light
    unshadowed flags (point lights first, then directional, both at
    padded table positions) — the structure `_replay_radiance` replays.
    """
    aspect = width / float(height)
    inv_w, inv_h = 1.0 / width, 1.0 / height
    spp = grid * grid if grid > 0 else 1
    t_clip = 1.0 if quirks.near_clip_t_le_1 else CLEAN_T_EPS
    clean_offsets = not quirks.scalar_epsilon_offset
    shadow_bound = not quirks.near_clip_t_le_1  # clean bounds point lights
    ref_test = quirks.reference_triangle_test
    tri_black = quirks.triangles_shade_black
    shadow_tris = tri_on and not quirks.sphere_only_shadows
    loop_spheres = sph_on and S > _UNROLL_SPHERES
    lights_on = point_on or dir_on
    # material columns: ambient(5:8) diffuse(8:11) specular(11:14)
    # power(14). Specular/power are gathered only when a light loop will
    # consume them, and the hit center (-> normal) only when the bounce
    # needs geometry — the final bounce of a lights-off MC frame (the
    # headline config) gathers just 6 columns.
    shade_cols = list(range(5, 11)) + (list(range(11, 15)) if lights_on
                                       else [])
    n_sc = len(shade_cols)
    # Triangle table layout: v0 0:3, e1 3:6, e2 6:9, mask 9, unit normal
    # 10:13, ambient 13:16, diffuse 16:19, specular 19:22, power 22.
    tri_shade_cols = list(range(13, 19)) + (list(range(19, 23)) if lights_on
                                            else [])

    def frame_math(tabs, ids, seed, emit=None):
        sph_ref, tri_ref, misc_ref, pl_ref, dl_ref = tabs

        def read3(ref, row, col0):
            return ref[row, col0], ref[row, col0 + 1], ref[row, col0 + 2]

        cam = read3(misc_ref, 0, 0)
        right = read3(misc_ref, 0, 3)
        up = read3(misc_ref, 0, 6)
        cdir = read3(misc_ref, 0, 9)
        amb_s = read3(misc_ref, 0, 12)
        bg = read3(misc_ref, 0, 15)

        sph = (_Rows(sph_ref, S, range(5)) if sph_on and not loop_spheres
               else [])
        full_rows = _Rows(sph_ref, S, shade_cols + [0, 1, 2])
        shade_rows = _Rows(sph_ref, S, shade_cols)
        tris_geo = _Rows(tri_ref, T, range(10)) if tri_on else []
        tri_norm_rows = ([read3(tri_ref, t, 10) for t in range(T)]
                         if tri_on else [])
        tri_mat_rows = _Rows(tri_ref, T, tri_shade_cols)

        def unpack(m):
            amb, dif = m[0:3], m[3:6]
            if lights_on:
                return amb, dif, m[6:9], m[9]
            return amb, dif, None, None

        plights = _Rows(pl_ref, L, range(7)) if point_on else []
        dlights = _Rows(dl_ref, LD, range(7)) if dir_on else []
        # fog volumes (misc rows 1..F): radius, absorption, scattering,
        # albedo rgb, mask — _pack_tables layout
        fogs = _Rows(misc_ref, 1 + F, range(7))

        def offset(x, n, eps):
            """Secondary-ray origin: clean mode's geometry.offset_origin
            (along the normal, scaled with |x|); parity's scalar `eps`
            added to every component."""
            if clean_offsets:
                xn = jnp.sqrt(jnp.maximum(
                    x[0] * x[0] + x[1] * x[1] + x[2] * x[2], 0.0))
                sc = CLEAN_T_EPS * (1.0 + xn)
                return (x[0] + sc * n[0], x[1] + sc * n[1],
                        x[2] + sc * n[2])
            return (x[0] + eps, x[1] + eps, x[2] + eps)

        def occluded(sh_o, sdir, bound):
            if loop_spheres:
                occ = _occluded_loop(sh_o, sdir, sph_ref, S, t_clip, bound)
                if shadow_tris:
                    occ = occ | _occluded(sh_o, sdir, [], t_clip, bound,
                                          tris=tris_geo, ref_test=ref_test)
                return occ
            return _occluded(sh_o, sdir, sph, t_clip, bound,
                             tris=tris_geo if shadow_tris else (),
                             ref_test=ref_test)

        def shade(x, n, amb, dif, spec, powr, pc=None, idp=None, bounce=0):
            """direct_illumination (ops/shading.py): ambient + per-light
            Blinn-Phong with optional shadow scans. Also returns the
            packed per-light unshadowed bits (or None)."""
            dr = amb_s[0] * amb[0]
            dg = amb_s[1] * amb[1]
            db = amb_s[2] * amb[2]
            bits = None
            if not lights_on:
                return dr, dg, db, bits
            # view vector from the CAMERA position (src/blinn_phong.h:93)
            vx, vy, vz, _ = _normalize3(cam[0] - x[0], cam[1] - x[1],
                                        cam[2] - x[2])
            if use_shadows:
                sh_o = offset(x, n, SHADOW_ORIGIN_EPS)

            def gate_of(li_bit, lm, sdir, bound):
                nonlocal bits
                if not use_shadows:
                    return lm
                unsh = (~occluded(sh_o, sdir, bound)).astype(jnp.int32)
                if emit is not None:
                    b_l = unsh << li_bit
                    bits = b_l if bits is None else bits | b_l
                return lm * unsh.astype(jnp.float32)

            for li in range(len(plights)):
                lx, ly, lz, cr, cg, cb, lm = plights[li]
                lvx, lvy, lvz = lx - x[0], ly - x[1], lz - x[2]
                d2 = lvx * lvx + lvy * lvy + lvz * lvz
                pos = d2 > 0
                d_l = jnp.sqrt(jnp.where(pos, d2, 1.0)) * pos
                inv_dl = 1.0 / jnp.maximum(d_l, 1e-30)
                ldx, ldy, ldz = lvx * inv_dl, lvy * inv_dl, lvz * inv_dl
                sdir = _normalize3(lvx, lvy, lvz)[:3]
                gate = gate_of(10 + li, lm, sdir,
                               d_l if shadow_bound else None)
                intensity = 1.0 / jnp.maximum(d_l * d_l, 1e-30)
                ndotl = jnp.maximum(0.0, n[0] * ldx + n[1] * ldy + n[2] * ldz)
                if F > 0:
                    # Fog reroute (shading._fog_term): BOTH the diffuse and
                    # the specular per-light terms become fog terms with
                    # independent draws — the sampling.uniform (L, F, 4, 2)
                    # stream, C-order flat draw indices. Gate (mask *
                    # unshadowed) still applies; 1/d^2 and ndotl live
                    # INSIDE the interaction branch.
                    diff_base = intensity * ndotl
                    fr = fg_ = fb = 0.0
                    for fi in range(F):
                        rad, absn, scat, alr, alg, alb_, mf = fogs[1 + fi]
                        dcx = pc[0] - lx
                        dcy = pc[1] - ly
                        dcz = pc[2] - lz
                        dist = jnp.sqrt(jnp.maximum(
                            dcx * dcx + dcy * dcy + dcz * dcz, 0.0))
                        dist = jnp.minimum(dist, 2.0 * rad)
                        p_no = jnp.exp(-dist * (absn + scat))
                        # draw ((lf*4+k)*2 + term) = word `term` of pair
                        # (lf*4 + k): the diffuse/specular terms of each
                        # offset k share ONE threefry call (_draw2).
                        base_p = (li * F + fi) * 4
                        pairs = [
                            _draw2(seed, bounce, PURPOSE_FOG, idp, base_p + k)
                            for k in range(4)
                        ]
                        for term in (0, 1):
                            interacts = pairs[0][term] > p_no
                            nlx = ldx + scat * (pairs[1][term] * 2.0 - 1.0)
                            nly = ldy + scat * (pairs[2][term] * 2.0 - 1.0)
                            nlz = ldz + scat * (pairs[3][term] * 2.0 - 1.0)
                            ndotl2 = jnp.maximum(
                                0.0, n[0] * nlx + n[1] * nly + n[2] * nlz)
                            fr += jnp.where(interacts, dif[0] * diff_base,
                                            alr * ndotl2) * mf
                            fg_ += jnp.where(interacts, dif[1] * diff_base,
                                             alg * ndotl2) * mf
                            fb += jnp.where(interacts, dif[2] * diff_base,
                                            alb_ * ndotl2) * mf
                    dr += cr * fr * gate
                    dg += cg * fg_ * gate
                    db += cb * fb * gate
                    continue
                spow = _spec_pow(n, vx, vy, vz, ldx, ldy, ldz, powr)
                gi = gate * intensity
                dr += (dif[0] * cr * ndotl + spec[0] * cr * spow) * gi
                dg += (dif[1] * cg * ndotl + spec[1] * cg * spow) * gi
                db += (dif[2] * cb * ndotl + spec[2] * cb * spow) * gi
            for li in range(len(dlights)):
                ldx, ldy, ldz, cr, cg, cb, lm = dlights[li]
                # per-sample values from here on: a scan over a uniform
                # (scalar) direction would leave its results scalar
                ldx, ldy, ldz = (jnp.broadcast_to(c, x[0].shape)
                                 for c in (ldx, ldy, ldz))
                gate = gate_of(10 + L + li, lm, (ldx, ldy, ldz), None)
                ndotl = jnp.maximum(0.0, n[0] * ldx + n[1] * ldy + n[2] * ldz)
                spow = _spec_pow(n, vx, vy, vz, ldx, ldy, ldz, powr)
                dr += (dif[0] * cr * ndotl + spec[0] * cr * spow) * gate
                dg += (dif[1] * cg * ndotl + spec[1] * cg * spow) * gate
                db += (dif[2] * cb * ndotl + spec[2] * cb * spow) * gate
            return dr, dg, db, bits

        def record(slot, idx, hit, tri_wins, bits):
            if emit is None:
                return
            rec = idx | (hit.astype(jnp.int32) << 8)
            if tri_wins is not None:
                rec = rec | (tri_wins.astype(jnp.int32) << 9)
            if bits is not None:
                rec = rec | bits
            emit(slot, rec)

        def nearest(o3, d3, rows=None):
            """Combined nearest hit (geometry.intersect semantics: sphere
            scan, triangle scan, triangle wins on strictly smaller t).
            Returns (hit_any, tri_wins|None, t, idx, shadesf, missf,
            mats|None) — mats is the winner's material row when `rows`
            is given and the sphere-only fused-gather scan applies."""
            mats = None
            if loop_spheres:
                s_hit, s_t, s_idx = _scan_spheres_loop(
                    o3, d3, sph_ref, S, t_clip)
            elif sph:
                if rows is not None and not tri_on:
                    s_hit, s_t, s_idx, mats = _scan_spheres(
                        o3, d3, sph, t_clip, rows=rows)
                else:
                    s_hit, s_t, s_idx = _scan_spheres(o3, d3, sph, t_clip)
            else:
                s_hit = jnp.zeros(ids.shape, bool)
                s_t = jnp.full(ids.shape, _BIG, jnp.float32)
                s_idx = jnp.zeros(ids.shape, jnp.int32)
            if tri_on:
                t_hit, t_t, t_idx = _scan_tris(o3, d3, tris_geo, ref_test)
                tri_wins = t_hit & (t_t < jnp.where(s_hit, s_t, _BIG))
                hit_any = s_hit | tri_wins
                t_sel = jnp.where(tri_wins, t_t, s_t)
                idx = jnp.where(tri_wins, t_idx, s_idx)
                # parity shades only spheres (triangles black,
                # src/raytrace.h:221-224); clean shades both kinds
                shades = (s_hit & ~tri_wins) if tri_black else hit_any
            else:
                tri_wins = None
                hit_any, t_sel, idx, shades = s_hit, s_t, s_idx, s_hit
            return (hit_any, tri_wins, t_sel, idx,
                    shades.astype(jnp.float32),
                    1.0 - hit_any.astype(jnp.float32), mats)

        def gather_mat(idx, tri_wins, need_geo):
            """Material (+ sphere center when need_geo) at the winning
            primitive — mirrors shading.gather_material: parity reads the
            sphere table unconditionally at the combined index; clean
            sums kind-gated sphere and triangle selections."""
            cols = shade_cols + ([0, 1, 2] if need_geo else [])
            sph_valid = None if (not tri_on or tri_black) else ~tri_wins
            if loop_spheres:
                m = _gather_loop(idx, sph_ref, cols, S, valid=sph_valid)
            else:
                rows = full_rows if need_geo else shade_rows
                m = _gather(idx, [rows[s] for s in range(S)],
                            valid=sph_valid)
            if sph_valid is not None:
                mt = _gather(idx, [tri_mat_rows[t] for t in range(T)],
                             valid=tri_wins)
                m = [a + b for a, b in zip(m[:n_sc], mt)] + m[n_sc:]
            return m

        def hit_geom(o, d, t, hit_any, tri_wins, idx, centers):
            """(point, normal): sphere normal from the gathered center;
            triangle geometric normal (precomputed unit, flipped toward
            the ray) where the triangle won."""
            tsafe = jnp.where(hit_any, t, 0.0)
            px = o[0] + d[0] * tsafe
            py = o[1] + d[1] * tsafe
            pz = o[2] + d[2] * tsafe
            nx, ny, nz, _ = _normalize3(px - centers[0], py - centers[1],
                                        pz - centers[2])
            if tri_on:
                tn = _gather(idx, tri_norm_rows, valid=tri_wins)
                flip = jnp.where(
                    tn[0] * d[0] + tn[1] * d[1] + tn[2] * d[2] > 0, -1.0, 1.0)
                nx = jnp.where(tri_wins, tn[0] * flip, nx)
                ny = jnp.where(tri_wins, tn[1] * flip, ny)
                nz = jnp.where(tri_wins, tn[2] * flip, nz)
            return (px, py, pz), (nx, ny, nz)

        def fog_center(x, cen, tri_wins):
            # fog distance term: sphere center for sphere hits, the hit
            # point for clean triangle hits (shading._shade_hit routing)
            if F > 0 and tri_on and not tri_black:
                return tuple(jnp.where(tri_wins, x[c], cen[c])
                             for c in range(3))
            return cen

        # ---- camera rays (ops/camera.py::rays_for_ids) -----------------
        # pixel / sample split in exact integer arithmetic (the jnp path's
        # float forms give the same values for every in-frame id)
        pixel = ids // np.uint32(spp)
        xs = (pixel % np.uint32(width)).astype(jnp.float32)
        ys = (pixel // np.uint32(width)).astype(jnp.float32)
        if grid > 0:
            if quirks.diagonal_jitter:
                r = _draw(seed, 0, PURPOSE_JITTER, ids, 0)
                jx, jy = r, r
            else:
                smp = ids % np.uint32(spp)
                ci = (smp // np.uint32(grid)).astype(jnp.float32)
                cj = (smp % np.uint32(grid)).astype(jnp.float32)
                r0, r1j = _draw2(seed, 0, PURPOSE_JITTER, ids, 0)
                jx = (cj + r0) / grid
                jy = (ci + r1j) / grid
        else:
            jx = jy = np.float32(0.5)
        u = (2.0 * ((xs + jx) * inv_w) - 1.0) * angle * aspect
        v = (1.0 - 2.0 * ((ys + jy) * inv_h)) * angle
        dx = cdir[0] + u * right[0] + v * up[0]
        dy = cdir[1] + u * right[1] + v * up[1]
        dz = cdir[2] + u * right[2] + v * up[2]
        if not quirks.unnormalized_ray_dirs:
            dx, dy, dz, _ = _normalize3(dx, dy, dz)

        hit0, triw0, t0, idx0, shades0f, miss0f, fm0 = nearest(
            cam, (dx, dy, dz), rows=full_rows)
        m0 = fm0 if fm0 is not None else gather_mat(idx0, triw0, True)
        amb0, dif0, spec0, pow0 = unpack(m0)
        cen0 = m0[n_sc:n_sc + 3]
        x0, n0 = hit_geom(cam, (dx, dy, dz), t0, hit0, triw0, idx0, cen0)
        d0r, d0g, d0b, bits0 = shade(x0, n0, amb0, dif0, spec0, pow0,
                                     pc=fog_center(x0, cen0, triw0),
                                     idp=ids, bounce=0)
        record(0, idx0, hit0, triw0, bits0)

        if not mc:
            # Plain Blinn-Phong (src/raytrace.h:205-218): direct for
            # shaded hits, black for parity triangles, background for
            # misses.
            return (shades0f * d0r + miss0f * bg[0],
                    shades0f * d0g + miss0f * bg[1],
                    shades0f * d0b + miss0f * bg[2])

        # MC combine (src/raytrace.h:213): l0 = direct/pi * diffuse.
        l0r = shades0f * (d0r / _PI * dif0[0]) + miss0f * bg[0]
        l0g = shades0f * (d0g / _PI * dif0[1]) + miss0f * bg[1]
        l0b = shades0f * (d0b / _PI * dif0[2]) + miss0f * bg[2]

        if D <= 1:
            return l0r, l0g, l0b

        # ---- Monte-Carlo continuation paths ----------------------------
        # Hoisted per-sample state shared by all P paths: the primary
        # hit's tangent frame and throughput base 2*pi*diffuse*shades.
        pn0, pb0 = _tangent_frame(*n0)
        base = (_TWO_PI * dif0[0] * shades0f, _TWO_PI * dif0[1] * shades0f,
                _TWO_PI * dif0[2] * shades0f)

        def sample_dir(r1, r2, n, pn, pb):
            """uniform_sample_hemi + to_world (ops/sampling.py)."""
            pos = 1.0 - r1 * r1 > 0
            s_th = jnp.sqrt(jnp.where(pos, 1.0 - r1 * r1, 1.0)) * pos
            phi = _TWO_PI * r2
            sx = s_th * jnp.cos(phi)
            sy = r1
            sz = s_th * jnp.sin(phi)
            if quirks.buggy_tangent_frame:
                third = (pn[0], pb[1], pb[2])
            else:
                third = pn
            ddx = sx * pb[0] + sy * n[0] + sz * third[0]
            ddy = sx * pb[1] + sy * n[1] + sz * third[1]
            ddz = sx * pb[2] + sy * n[2] + sz * third[2]
            if not quirks.unnormalized_ray_dirs:
                ddx, ddy, ddz, _ = _normalize3(ddx, ddy, ddz)
            return ddx, ddy, ddz

        def path_body(p, acc):
            ar, ag, ab = acc
            idp = ids * jnp.uint32(P) + jnp.asarray(p, jnp.uint32)
            # state from the previous bounce's hit
            xb, nb, pnb, pbb = x0, n0, pn0, pb0
            Tb = None  # throughput; None until the first factor lands
            difb, shadesbf = dif0, shades0f
            for b in range(1, D):
                r1, r2 = _draw2(seed, b - 1, PURPOSE_PATH, idp, 0)
                db3 = sample_dir(r1, r2, nb, pnb, pbb)
                ob3 = offset(xb, nb, INDIRECT_ORIGIN_EPS)
                if Tb is None:
                    Tb = (base[0] * r1, base[1] * r1, base[2] * r1)
                else:
                    f = _TWO_PI * r1
                    Tb = (Tb[0] * (f * difb[0]) * shadesbf,
                          Tb[1] * (f * difb[1]) * shadesbf,
                          Tb[2] * (f * difb[2]) * shadesbf)
                last = b == D - 1
                need_geo = lights_on or not last
                hitb, triwb, tb, idxb, shadesbf, missbf, fmb = nearest(
                    ob3, db3, rows=full_rows if need_geo else shade_rows)
                mb = fmb if fmb is not None else gather_mat(
                    idxb, triwb, need_geo)
                ambb, difb, specb, powb = unpack(mb)
                if need_geo:
                    xb, nb = hit_geom(ob3, db3, tb, hitb, triwb, idxb,
                                      mb[n_sc:n_sc + 3])
                if lights_on:
                    dbr, dbg, dbb, bitsb = shade(
                        xb, nb, ambb, difb, specb, powb,
                        pc=fog_center(xb, mb[n_sc:n_sc + 3], triwb),
                        idp=idp, bounce=b)
                else:
                    dbr = amb_s[0] * ambb[0]
                    dbg = amb_s[1] * ambb[1]
                    dbb = amb_s[2] * ambb[2]
                    bitsb = None
                record(1 + p * (D - 1) + (b - 1), idxb, hitb, triwb, bitsb)
                ar += Tb[0] * (shadesbf * (dbr / _PI * difb[0])
                               + missbf * bg[0])
                ag += Tb[1] * (shadesbf * (dbg / _PI * difb[1])
                               + missbf * bg[1])
                ab += Tb[2] * (shadesbf * (dbb / _PI * difb[2])
                               + missbf * bg[2])
                if not last:
                    pnb, pbb = _tangent_frame(*nb)
            return ar, ag, ab

        # The paths run as a loop, not unrolled: on the H100 the loop was
        # both faster and compiled several times sooner than the unrolled
        # form (PERF.md, Findings).
        zero = jnp.zeros(ids.shape, jnp.float32)
        ar, ag, ab = jax.lax.fori_loop(0, P, path_body, (zero, zero, zero))
        inv_p = np.float32(1.0 / P)
        return l0r + ar * inv_p, l0g + ag * inv_p, l0b + ab * inv_p

    return frame_math


def _spec_pow(n, vx, vy, vz, ldx, ldy, ldz, powr):
    """Blinn-Phong specular factor max(n.h, 0)^power with the half vector
    divided by its length (src/blinn_phong.h:93-101)."""
    hx, hy, hz = vx + ldx, vy + ldy, vz + ldz
    h2 = hx * hx + hy * hy + hz * hz
    hpos = h2 > 0
    hn = jnp.maximum(jnp.sqrt(jnp.where(hpos, h2, 1.0)) * hpos, 1e-30)
    ihn = 1.0 / hn
    ndoth = jnp.maximum(
        0.0, n[0] * hx * ihn + n[1] * hy * ihn + n[2] * hz * ihn)
    return jnp.power(jnp.maximum(ndoth, 1e-30), powr) * (ndoth > 0)


def _build_kernel(*, with_records: bool = False, **static):
    """Whole-frame kernel: ref plumbing around `_build_frame_math`."""
    fm = _build_frame_math(**static)

    def kernel(sph_ref, tri_ref, misc_ref, pl_ref, dl_ref, seed_ref, ids_ref,
               r_ref, g_ref, b_ref, *maybe_rec):
        def emit(slot, rec):
            maybe_rec[0][slot, :] = rec

        r, g, b = fm(
            (sph_ref, tri_ref, misc_ref, pl_ref, dl_ref),
            ids_ref[...], seed_ref[0],
            emit if with_records else None,
        )
        r_ref[...] = r
        g_ref[...] = g
        b_ref[...] = b

    return kernel


def _n_records(cfg: RenderConfig) -> int:
    """Hit records per sample: primary + one per (path, bounce)."""
    if not cfg.monte_carlo or cfg.max_depth <= 1:
        return 1
    return 1 + cfg.paths_per_sample * (cfg.max_depth - 1)


def _pow2(n: int) -> int:
    """Smallest power of two >= n (Triton block shapes must be powers of
    two)."""
    return 1 << max(n - 1, 0).bit_length()


def _pad_pow2(tab):
    """Zero-pad a 2-D table to power-of-two rows and columns. The kernel
    reads only the real rows and columns, at static or loop-bounded
    indices."""
    r, c = tab.shape
    return jnp.pad(tab, ((0, _pow2(r) - r), (0, _pow2(c) - c)))


def _pack_tables(scene):
    """The five scalar tables the kernel reads (spheres, triangles,
    camera + fog, point lights, directional lights), each padded to
    power-of-two shapes."""
    from skele_raytracer_tpu.ops.geometry import normalize

    sph_t, cam_t = scene.spheres, scene.camera
    sph_tab = jnp.concatenate(
        [
            sph_t.center,                            # 0:3
            (sph_t.radius * sph_t.radius)[:, None],  # 3
            sph_t.mask[:, None],                     # 4
            sph_t.ambient,                           # 5:8
            sph_t.diffuse,                           # 8:11
            sph_t.specular,                          # 11:14
            sph_t.power[:, None],                    # 14
        ],
        axis=1,
    )
    # Triangle table (decorative triangles only — use_pathtrace caps at
    # MAX_TRIS). Edges and the unit geometric normal are precomputed; the
    # kernel flips the normal toward each ray.
    if scene.has_triangles:
        tr = scene.triangles
        e1 = tr.v1 - tr.v0
        e2 = tr.v2 - tr.v0
        ntri = normalize(jnp.cross(e1, e2))
        tri_tab = jnp.concatenate(
            [tr.v0, e1, e2, tr.mask[:, None], ntri, tr.ambient, tr.diffuse,
             tr.specular, tr.power[:, None]],
            axis=1,
        )  # [T, 23]
    else:
        tri_tab = jnp.zeros((1, 1), jnp.float32)

    right = jnp.cross(-cam_t.direction, cam_t.up)
    misc = jnp.concatenate(
        [cam_t.position, right, cam_t.up, cam_t.direction, scene.ambient,
         scene.background]
    )[None, :]  # [1, 18]
    if scene.has_fog and not scene.fog_zeroed:
        # fog rows appended below the camera row: radius(0) absorption(1)
        # scattering(2) albedo(3:6) mask(6) — shading._fog_term's inputs
        # (the volume CENTER is unused by the reference's fog math).
        fg = scene.fog
        fog_rows = jnp.concatenate(
            [fg.radius[:, None], fg.absorption[:, None],
             fg.scattering[:, None], fg.albedo, fg.mask[:, None]], axis=1)
        misc = jnp.concatenate(
            [misc, jnp.pad(fog_rows, ((0, 0), (0, misc.shape[1] - 7)))],
            axis=0)

    plt_ = scene.point_lights
    pl_tab = jnp.concatenate(
        [plt_.position, plt_.colour, plt_.mask[:, None]], axis=1)
    dlt = scene.directional_lights
    dl_tab = jnp.concatenate(
        [normalize(dlt.direction), dlt.colour, dlt.mask[:, None]], axis=1)
    return tuple(_pad_pow2(t) for t in (sph_tab, tri_tab, misc, pl_tab,
                                        dl_tab))


def _static_kernel_args(scene, cfg: RenderConfig) -> dict:
    """The static configuration closed over the kernel."""
    # Same static gate as ops/shading.direct_illumination: parity's zeroed
    # fog reroutes (and so kills) the whole point-light block.
    point_on = scene.has_point_lights and not (
        scene.has_fog and scene.fog_zeroed
    )
    # fov projection constant (ops/camera.py computes tan in f32 inside the
    # trace; the f64-then-round value here can differ by 1 ulp — covered by
    # the kernel-vs-jnp tolerance)
    angle = float(np.float32(np.tan(np.pi * 0.5 * cfg.fov / 180.0)))
    return dict(
        S=scene.spheres.mask.shape[0],
        T=scene.triangles.mask.shape[0] if scene.has_triangles else 1,
        L=scene.point_lights.mask.shape[0],
        LD=scene.directional_lights.mask.shape[0],
        sph_on=scene.has_spheres, tri_on=scene.has_triangles,
        point_on=point_on, dir_on=scene.has_directional,
        use_shadows=cfg.use_shadows, mc=cfg.monte_carlo,
        P=cfg.paths_per_sample, D=cfg.max_depth, grid=cfg.grid_size,
        width=cfg.width, height=cfg.height, angle=angle, quirks=cfg.quirks,
        F=(scene.fog.mask.shape[0]
           if scene.has_fog and not scene.fog_zeroed else 0),
    )


def _check_platform(cfg: RenderConfig) -> None:
    """The kernel compiles only through Triton for an NVIDIA GPU; anywhere
    else it runs only in the Pallas interpreter, which is asked for
    explicitly (RenderConfig.interpret) and never chosen silently."""
    if not cfg.interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "backend='pallas' runs the Triton path-trace kernel, which "
            f"compiles only for an NVIDIA GPU (this is {jax.default_backend()!r}"
            "); use backend='jnp', or interpret=True to run the kernel in "
            "the Pallas interpreter")


def _pathtrace_call(scene, cfg: RenderConfig, seed, sample_ids,
                    with_records: bool = False):
    """Pad, pack the scalar tables, and launch the whole-frame kernel.
    Returns radiance [N, 3] for the given flat sample ids (plus the
    packed [K, N] int32 hit records when with_records)."""
    _check_platform(cfg)
    N = sample_ids.shape[0]
    n_blocks = -(-N // BLOCK)
    Np = n_blocks * BLOCK
    # pad ids duplicate sample 0's work; their rows are dropped below
    ids = jnp.pad(sample_ids.astype(jnp.uint32), (0, Np - N))
    tabs = _pack_tables(scene)
    seed_arr = jnp.asarray(seed, jnp.uint32).reshape(1)

    kernel = _build_kernel(
        with_records=with_records, **_static_kernel_args(scene, cfg)
    )
    whole = lambda t: pl.BlockSpec(t.shape, lambda i: (0,) * t.ndim)
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    out_shape = jax.ShapeDtypeStruct((Np,), jnp.float32)
    out_specs = [ray_spec] * 3
    out_shapes = [out_shape] * 3
    if with_records:
        Kp = _pow2(_n_records(cfg))
        out_specs.append(pl.BlockSpec((Kp, BLOCK), lambda i: (0, i)))
        out_shapes.append(jax.ShapeDtypeStruct((Kp, Np), jnp.int32))
    out = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[whole(t) for t in tabs] + [whole(seed_arr), ray_spec],
        out_specs=tuple(out_specs),
        out_shape=tuple(out_shapes),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=cfg.interpret,
        name="pathtrace",
    )(*tabs, seed_arr, ids)
    radiance = jnp.stack(out[:3], axis=1)[:N]
    if with_records:
        # rows past K are never written
        return radiance, out[3][:_n_records(cfg), :N]
    return radiance


def _f0(x):
    """float0 cotangent for integer primals."""
    return np.zeros(np.shape(x), jax.dtypes.float0)


# ---------------------------------------------------------------------------
# Hit-structure replay: the differentiable backward of the kernel
# ---------------------------------------------------------------------------


def replay_frame_bits(scene, cfg: RenderConfig, seed, sample_ids, rec):
    """The tangent-frame branch bits [P*(D-1), N] the replay takes at
    THIS scene — the frozen-topology side data for the fixed-topology
    finite-difference gradient check (pass to _replay_radiance /
    _replay_chunked as frame_bits)."""
    bits: list = []
    _replay_radiance(scene, cfg, seed, sample_ids, rec,
                     collect_frame_bits=bits)
    N = sample_ids.shape[0]
    if not bits:
        return jnp.zeros((0, N), bool)
    # [D-1, N*P] (path-major rows) -> [P*(D-1), N] rows p*(D-1)+(b-1)
    P = cfg.paths_per_sample
    return jnp.stack(bits).reshape(len(bits), N, P).transpose(2, 0, 1).reshape(
        P * len(bits), N)


def _replay_radiance(scene, cfg: RenderConfig, seed, sample_ids, rec,
                     frame_bits=None, collect_frame_bits=None):
    """Differentiable jnp re-computation of the kernel's radiance FROM the
    saved hit structure: per-bounce sphere t replayed from the SELECTED
    sphere's quadratic (O(rays), src/utils.h:113-121), shading gated by
    the saved per-light unshadowed bits — no argmin, no [rays, spheres]
    scans, no shadow scans. rec: [K, N] int32 packed (index | hit<<8 |
    triangle<<9 | unshadowed bits<<10).

    `frame_bits` (optional, [P*(D-1), N] bool, rows p*(D-1)+(b-1)):
    FREEZES the tangent-frame branch per (path, bounce) — the remaining discrete selection beyond
    the hit records. The fixed-topology finite-difference check passes
    the base scene's bits (replay_frame_bits) so FD samples the same
    locally-smooth function autodiff differentiates."""
    from skele_raytracer_tpu.ops import sampling
    from skele_raytracer_tpu.ops.camera import rays_for_ids
    from skele_raytracer_tpu.ops.geometry import (
        _pos_sqrt,
        dot,
        gather_rows,
        hit_geometry,
        norm,
        normalize,
        offset_origin,
        one_hot_rows,
        replay_triangle_t,
    )
    from skele_raytracer_tpu.ops.shading import gather_material

    q = cfg.quirks
    S = scene.spheres.mask.shape[0]
    point_on = scene.has_point_lights and not (
        scene.has_fog and scene.fog_zeroed
    )
    dir_on = scene.has_directional
    Lp = scene.point_lights.mask.shape[0]

    def unpack_rec(r):
        idx = r & 0xFF
        hit = ((r >> 8) & 1).astype(bool)
        tri = ((r >> 9) & 1).astype(bool)
        kind = jnp.where(tri, 2, jnp.where(hit, 1, 0)).astype(jnp.int32)
        return idx, kind

    def replay_hit(o, d, idx, kind):
        """(point, normal, material) from the saved discrete structure:
        selected-sphere quadratic / selected-triangle MT t (O(rays)),
        then the shared hit_geometry / gather_material replays."""
        oh = one_hot_rows(jnp.where(kind == 1, idx, 0), S)
        cen = gather_rows(oh, scene.spheres.center)
        rad = gather_rows(oh, scene.spheres.radius[:, None])[:, 0]
        ec = o - cen
        a = dot(d, d)
        b = 2.0 * dot(d, ec)
        c = dot(ec, ec) - rad ** 2
        t_sph = (-b - _pos_sqrt(b * b - 4.0 * a * c)) / (2.0 * a)
        if scene.has_triangles:
            t_tri = replay_triangle_t(
                o, d, scene.triangles, jnp.where(kind == 2, idx, 0))
            t = jnp.where(kind == 2, t_tri,
                          jnp.where(kind == 1, t_sph, 0.0))
        else:
            t = jnp.where(kind == 1, t_sph, 0.0)
        x, n = hit_geometry(o, d, scene, kind, idx, t)
        return x, n, gather_material(scene, kind, idx, quirks=q)

    def gates_from_bits(r, base_bit, count):
        if not cfg.use_shadows:
            return jnp.ones((r.shape[0], count), jnp.float32)
        cols = jnp.arange(count, dtype=jnp.int32)[None, :]
        return ((r[:, None] >> (base_bit + cols)) & 1).astype(jnp.float32)

    def shade_replay(x, n, mat, r, fog_draws):
        total = scene.ambient[None, :] * mat.ambient
        if not (point_on or dir_on):
            return total
        view = normalize(scene.camera.position[None, :] - x)
        if point_on:
            pl_ = scene.point_lights
            gate = gates_from_bits(r, 10, Lp) * pl_.mask[None, :]
            l_vec = pl_.position[None, :, :] - x[:, None, :]
            d_l = norm(l_vec)
            l = l_vec / jnp.maximum(d_l, 1e-30)[:, :, None]
            intensity = 1.0 / jnp.maximum(d_l * d_l, 1e-30)
            ndotl = jnp.maximum(0.0, dot(n[:, None, :], l))
            if fog_draws is not None:
                from skele_raytracer_tpu.ops.shading import _fog_term

                prim_center, fog_u = fog_draws
                args = (scene, mat, prim_center, l, x, n, pl_.position,
                        pl_.colour)
                diffuse_pt = _fog_term(*args, fog_u[..., 0])
                specular_pt = _fog_term(*args, fog_u[..., 1])
            else:
                diffuse_pt = (mat.diffuse[:, None, :] * pl_.colour[None, :, :]
                              * (intensity * ndotl)[:, :, None])
                h_raw = view[:, None, :] + l
                h = h_raw / jnp.maximum(norm(h_raw, keepdims=True), 1e-30)
                ndoth = jnp.maximum(0.0, dot(n[:, None, :], h))
                spow = jnp.power(jnp.maximum(ndoth, 1e-30),
                                 mat.power[:, None]) * (ndoth > 0)
                specular_pt = (mat.specular[:, None, :]
                               * pl_.colour[None, :, :]
                               * (intensity * spow)[:, :, None])
            total = total + jnp.sum(
                (diffuse_pt + specular_pt) * gate[:, :, None], axis=1)
        if dir_on:
            dl_ = scene.directional_lights
            Ld = dl_.mask.shape[0]
            gate = gates_from_bits(r, 10 + Lp, Ld) * dl_.mask[None, :]
            ld = normalize(dl_.direction)[None, :, :]
            ld = jnp.broadcast_to(ld, (x.shape[0],) + ld.shape[1:])
            ndotl = jnp.maximum(0.0, dot(n[:, None, :], ld))
            diffuse_d = (mat.diffuse[:, None, :] * dl_.colour[None, :, :]
                         * ndotl[:, :, None])
            h_raw = view[:, None, :] + ld
            h = h_raw / jnp.maximum(norm(h_raw, keepdims=True), 1e-30)
            ndoth = jnp.maximum(0.0, dot(n[:, None, :], h))
            spow = jnp.power(jnp.maximum(ndoth, 1e-30),
                             mat.power[:, None]) * (ndoth > 0)
            specular_d = (mat.specular[:, None, :] * dl_.colour[None, :, :]
                          * spow[:, :, None])
            total = total + jnp.sum(
                (diffuse_d + specular_d) * gate[:, :, None], axis=1)
        return total

    live_fog = scene.has_fog and not scene.fog_zeroed

    def fog_draws(x, kind, idx, ids, bounce):
        """(prim_center, fog uniforms) for the fog reroute — the same
        inputs integrator._shade_hit hands shading._fog_term."""
        if not (live_fog and point_on):
            return None
        oh = one_hot_rows(idx, S)
        prim_center = gather_rows(oh, scene.spheres.center)
        if not q.triangles_shade_black:
            prim_center = jnp.where((kind == 2)[:, None], x, prim_center)
        fog_u = sampling.uniform(
            seed, ids, bounce, sampling.PURPOSE_FOG,
            (Lp, scene.fog.mask.shape[0], 4, 2))
        return prim_center, fog_u

    def shades_miss(kind):
        """(shades, miss) column masks — parity triangles shade black
        (src/raytrace.h:221-224), clean shades both kinds."""
        sh = (kind == 1) if q.triangles_shade_black else (kind > 0)
        return sh[:, None], (kind == 0)[:, None]

    o, d = rays_for_ids(scene.camera, cfg, seed, sample_ids)
    idx0, kind0 = unpack_rec(rec[0])
    x0, n0, mat0 = replay_hit(o, d, idx0, kind0)
    direct0 = shade_replay(x0, n0, mat0, rec[0],
                           fog_draws(x0, kind0, idx0, sample_ids, 0))
    bg = jnp.broadcast_to(scene.background[None, :], direct0.shape)
    sh0, miss0 = shades_miss(kind0)
    if not cfg.monte_carlo:
        return jnp.where(miss0, bg, jnp.where(sh0, direct0, 0.0))
    l0 = jnp.where(miss0, bg,
                   jnp.where(sh0, direct0 / jnp.pi * mat0.diffuse, 0.0))
    D, P = cfg.max_depth, cfg.paths_per_sample
    if D <= 1:
        return l0

    # All P paths advance together as one [N*P] batch (path p of sample
    # i is row i*P + p, the integrator's layout), so the op count per
    # chunk does not grow with P.
    N = sample_ids.shape[0]
    pid = (sample_ids.astype(jnp.uint32)[:, None] * jnp.uint32(P)
           + jnp.arange(P, dtype=jnp.uint32)[None, :]).reshape(-1)

    def per_path(rows):
        """[P*(D-1), N] rows laid out p*(D-1)+(b-1) -> [D-1, N*P]."""
        return rows.reshape(P, D - 1, N).transpose(1, 2, 0).reshape(
            D - 1, N * P)

    rec_b = per_path(rec[1:])
    fb_b = None if frame_bits is None else per_path(frame_bits)
    rep = lambda a: jnp.repeat(a, P, axis=0)
    xb, nb, difb = rep(x0), rep(n0), rep(mat0.diffuse)
    shb = rep(sh0.astype(jnp.float32))
    bgp = rep(bg)
    T = None
    acc = 0.0
    for b in range(1, D):
        rdraw = sampling.uniform(seed, pid, b - 1, sampling.PURPOSE_PATH,
                                 (2,))
        r1, r2 = rdraw[:, 0], rdraw[:, 1]
        smp = sampling.uniform_sample_hemi(r1, r2)
        if collect_frame_bits is not None:
            collect_frame_bits.append(
                jnp.abs(nb[..., 0]) > jnp.abs(nb[..., 1]))
        d_new = sampling.to_world(
            smp, nb, quirks=q, use_x=None if fb_b is None else fb_b[b - 1])
        if not q.unnormalized_ray_dirs:
            d_new = normalize(d_new)
        if q.scalar_epsilon_offset:
            o_new = xb + INDIRECT_ORIGIN_EPS
        else:
            o_new = offset_origin(xb, nb)
        f = 2.0 * jnp.pi * r1[:, None] * difb
        T = f * shb if T is None else T * f * shb
        rk = rec_b[b - 1]
        idxb, kindb = unpack_rec(rk)
        xb, nb, matb = replay_hit(o_new, d_new, idxb, kindb)
        directb = shade_replay(xb, nb, matb, rk,
                               fog_draws(xb, kindb, idxb, pid, b))
        shb_c, missb = shades_miss(kindb)
        acc = acc + T * jnp.where(
            missb, bgp,
            jnp.where(shb_c, directb / jnp.pi * matb.diffuse, 0.0))
        difb, shb = matb.diffuse, shb_c.astype(jnp.float32)
    return l0 + acc.reshape(N, P, 3).sum(axis=1) / P


def _replay_chunked(scene, cfg: RenderConfig, seed, sample_ids, rec,
                    frame_bits=None):
    """Chunk + rematerialize the replay (same rationale as
    renderer.render_ids_chunked_jnp: the per-bounce AD residuals of a
    whole 1080p frame would be GBs). frame_bits: see _replay_radiance."""
    n = sample_ids.shape[0]
    fan = max(cfg.paths_per_sample, 1)
    chunk = max(128, min(max(1, cfg.rays_per_chunk // fan), n))
    n_chunks = -(-n // chunk)
    padded = n_chunks * chunk
    K = rec.shape[0]
    ids = jnp.pad(sample_ids, (0, padded - n)).reshape(n_chunks, chunk)
    rec_p = jnp.pad(rec, ((0, 0), (0, padded - n))).reshape(
        K, n_chunks, chunk).transpose(1, 0, 2)
    args = (ids, rec_p)
    if frame_bits is not None:
        B = frame_bits.shape[0]
        fb_p = jnp.pad(frame_bits, ((0, 0), (0, padded - n))).reshape(
            B, n_chunks, chunk).transpose(1, 0, 2)
        args = args + (fb_p,)
    body = jax.checkpoint(
        lambda a: _replay_radiance(scene, cfg, seed, a[0], a[1],
                                   frame_bits=a[2] if len(a) > 2 else None)
    )
    radiance = jax.lax.map(body, args)
    return radiance.reshape(padded, 3)[:n]


def _can_replay(scene, cfg: RenderConfig) -> bool:
    """Records fit: with shadows, every padded light's unshadowed bit
    must land inside an int32. Otherwise gradients re-derive through the
    jnp wavefront (the same estimator)."""
    L = scene.point_lights.mask.shape[0]
    LD = scene.directional_lights.mask.shape[0]
    return not cfg.use_shadows or 10 + L + LD <= 32


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def pathtrace_ids(scene, cfg: RenderConfig, seed, sample_ids):
    """Whole-frame kernel radiance [N, 3], differentiable.

    Forward: the Triton kernel (module docstring). Backward: jax.vjp of
    the XLA replay `_replay_chunked` driven by the forward's saved
    per-bounce hit records — the backward pass reuses the forward's
    intersection structure instead of re-intersecting. Configs whose
    records don't fit (`_can_replay`) re-derive the gradient through the
    jnp wavefront path, whose estimator is identical."""
    sg = jax.lax.stop_gradient
    return _pathtrace_call(sg(scene), cfg, seed, sample_ids)


def _pt_fwd(scene, cfg, seed, sample_ids):
    sg = jax.lax.stop_gradient
    if _can_replay(scene, cfg):
        radiance, rec = _pathtrace_call(
            sg(scene), cfg, seed, sample_ids, with_records=True
        )
        return radiance, (scene, seed, sample_ids, rec)
    radiance = _pathtrace_call(sg(scene), cfg, seed, sample_ids)
    return radiance, (scene, seed, sample_ids, None)


def _pt_bwd(cfg, res, g):
    scene, seed, sample_ids, rec = res
    if rec is None:
        from skele_raytracer_tpu.models.renderer import render_ids_chunked_jnp

        fn = lambda s: render_ids_chunked_jnp(s, cfg, seed, sample_ids)
    else:
        fn = lambda s: _replay_chunked(s, cfg, seed, sample_ids, rec)
    _, vjp = jax.vjp(fn, scene)
    return vjp(g)[0], _f0(seed), _f0(sample_ids)


pathtrace_ids.defvjp(_pt_fwd, _pt_bwd)
