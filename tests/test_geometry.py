"""Closed-form unit tests for intersection geometry (ops/geometry.py)."""

import jax.numpy as jnp
import numpy as np

from skele_raytracer_tpu import CLEAN, PARITY
from skele_raytracer_tpu.ops.geometry import (
    nearest_sphere,
    nearest_triangle,
    ray_sphere_all,
    ray_triangle_all,
)


def _rays(*pairs):
    o = jnp.asarray([p[0] for p in pairs], jnp.float32)
    d = jnp.asarray([p[1] for p in pairs], jnp.float32)
    return o, d


def test_sphere_closed_form():
    # Unit sphere at origin, ray from z=-5 toward +z: hits at t=4.
    o, d = _rays(([0, 0, -5], [0, 0, 1]))
    c = jnp.asarray([[0.0, 0.0, 0.0]])
    r = jnp.asarray([1.0])
    m = jnp.asarray([1.0])
    t = ray_sphere_all(o, d, c, r, m, t_clip=1.0)
    assert np.allclose(t, 4.0)


def test_sphere_unnormalized_direction_scales_t():
    # Same geometry, direction scaled 2x -> t halves (a = dot(d,d) handling,
    # reference src/utils.h:116).
    o, d = _rays(([0, 0, -5], [0, 0, 2]))
    t = ray_sphere_all(o, d, jnp.asarray([[0.0, 0.0, 0.0]]), jnp.asarray([1.0]),
                       jnp.asarray([1.0]), t_clip=1.0)
    assert np.allclose(t, 2.0)


def test_sphere_near_clip_t_le_1():
    # Hit at t=0.5 rejected by the parity clip (src/utils.h:173) but
    # accepted in clean mode.
    o, d = _rays(([0, 0, -1.5], [0, 0, 1]))
    c, r, m = jnp.asarray([[0.0, 0.0, 0.0]]), jnp.asarray([1.0]), jnp.asarray([1.0])
    t_par = ray_sphere_all(o, d, c, r, m, t_clip=1.0)
    t_cln = ray_sphere_all(o, d, c, r, m, t_clip=1e-4)
    assert np.isinf(np.asarray(t_par)).all()
    assert np.allclose(t_cln, 0.5)


def test_sphere_inside_returns_inf():
    # Camera inside the sphere: t2 < 0 < t1, reference smallest_root's dead
    # t1<t2 branch means it returns INF (no hit) — SURVEY quirk.
    o, d = _rays(([0, 0, 0], [0, 0, 1]))
    t = ray_sphere_all(o, d, jnp.asarray([[0.0, 0.0, 0.0]]), jnp.asarray([2.0]),
                       jnp.asarray([1.0]), t_clip=1e-4)
    assert np.isinf(np.asarray(t)).all()


def test_sphere_mask_blocks_padding():
    o, d = _rays(([0, 0, -5], [0, 0, 1]))
    t = ray_sphere_all(o, d, jnp.asarray([[0.0, 0.0, 0.0]]), jnp.asarray([1.0]),
                       jnp.asarray([0.0]), t_clip=1.0)
    assert np.isinf(np.asarray(t)).all()


def test_nearest_sphere_first_wins_ties():
    o, d = _rays(([0, 0, -5], [0, 0, 1]))
    c = jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]])
    r = jnp.asarray([1.0, 1.0])
    m = jnp.asarray([1.0, 1.0])
    hits = nearest_sphere(o, d, c, r, m, quirks=PARITY)
    assert int(hits.index[0]) == 0


def test_triangle_clean_standard_mt():
    # Triangle in z=0 plane, ray straight through its interior.
    v0 = jnp.asarray([[-1.0, -1.0, 0.0]])
    v1 = jnp.asarray([[1.0, -1.0, 0.0]])
    v2 = jnp.asarray([[0.0, 1.0, 0.0]])
    o, d = _rays(([0, -0.2, -3], [0, 0, 1]))
    t, ok, u, v = ray_triangle_all(o, d, v0, v1, v2, jnp.asarray([1.0]), quirks=CLEAN)
    assert bool(ok[0, 0]) and np.allclose(t[0, 0], 3.0)


def test_triangle_parity_mirrored_u():
    """The reference's u = dot(-(o-v0), p)/det sign flip (src/utils.h:196):
    a hit that standard MT accepts with u > 0 is REJECTED in parity mode,
    and vice versa for the mirrored region."""
    v0 = jnp.asarray([[-1.0, -1.0, 0.0]])
    v1 = jnp.asarray([[1.0, -1.0, 0.0]])
    v2 = jnp.asarray([[0.0, 1.0, 0.0]])
    m = jnp.asarray([1.0])
    # Interior point biased toward v1 -> standard u strictly positive.
    o, d = _rays(([0.4, -0.5, -3], [0, 0, 1]))
    _, ok_c, u_c, _ = ray_triangle_all(o, d, v0, v1, v2, m, quirks=CLEAN)
    _, ok_p, u_p, _ = ray_triangle_all(o, d, v0, v1, v2, m, quirks=PARITY)
    assert bool(ok_c[0, 0]) and float(u_c[0, 0]) > 0
    assert not bool(ok_p[0, 0])  # mirrored test rejects it
    assert np.allclose(u_p, -u_c)
    # u == 0 (a point on the v0-v2 edge) accepted by both.
    o2, d2 = _rays(([-0.5, 0.0, -3], [0, 0, 1]))
    _, ok_c2, u_c2, _ = ray_triangle_all(o2, d2, v0, v1, v2, m, quirks=CLEAN)
    _, ok_p2, _, _ = ray_triangle_all(o2, d2, v0, v1, v2, m, quirks=PARITY)
    assert bool(ok_c2[0, 0]) and abs(float(u_c2[0, 0])) < 1e-6
    assert bool(ok_p2[0, 0])


def test_triangle_parity_negative_t_accepted():
    # No t>0 check in parity (src/utils.h:211): triangle BEHIND the ray
    # origin still "hits" with negative t.
    v0 = jnp.asarray([[-1.0, -1.0, 5.0]])
    v1 = jnp.asarray([[1.0, -1.0, 5.0]])
    v2 = jnp.asarray([[0.0, 1.0, 5.0]])
    m = jnp.asarray([1.0])
    # (-1, 0) lies in the parity-accepted MIRRORED region (standard
    # u = -0.25, so the sign-flipped u = +0.25 passes the [0,1] test).
    o, d = _rays(([-1, 0, 10], [0, 0, 1]))  # triangle is behind
    hits_p = nearest_triangle(o, d, v0, v1, v2, m, quirks=PARITY)
    hits_c = nearest_triangle(o, d, v0, v1, v2, m, quirks=CLEAN)
    assert bool(hits_p.hit[0]) and float(hits_p.t[0]) == -5.0
    assert not bool(hits_c.hit[0])


# ---------------------------------------------------------------------------
# The brute-force mesh path (the XLA [rays, triangles] scan every mesh
# scene takes): the semantics a mesh traversal must keep.
# ---------------------------------------------------------------------------


def _mesh(n=300, seed=4):
    rng = np.random.default_rng(seed)
    v0 = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    v1 = v0 + rng.normal(size=(n, 3)).astype(np.float32) * 1.5
    v2 = v0 + rng.normal(size=(n, 3)).astype(np.float32) * 1.5
    m = np.ones((n,), np.float32)
    m[-4:] = 0.0  # padding slots
    return v0, v1, v2, m


def _mesh_rays(n=512, seed=5):
    rng = np.random.default_rng(seed)
    o = np.zeros((n, 3), np.float32)
    o[:, 2] = -14.0
    d = np.concatenate([rng.uniform(-0.5, 0.5, (n, 2)), np.ones((n, 1))],
                       axis=1).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def test_mesh_first_minimum_tie_break_only_on_hits():
    """Identical triangles tie exactly: the FIRST index wins (the
    reference's strict-< scan, src/raytrace.h:176-186). Rays that hit
    nothing report no hit and index 0 — a tie among the +inf 'no hit'
    entries never produces a winner."""
    tri = np.array([[-5, -1, 4], [5, -1, 4], [0, 5, 4]], np.float32)
    far = tri + np.array([0, 0, 3], np.float32)
    # table: [far, tri, far, tri, masked tri]
    v = np.stack([far, tri, far, tri, tri])
    m = jnp.asarray([1.0, 1.0, 1.0, 1.0, 0.0])
    o, d = _rays(([0, 0, 0], [0, 0, 1]), ([0, 0, 0], [0, 0, -1]),
                 ([40, 40, 0], [0, 0, 1]))
    h = nearest_triangle(o, d, *(jnp.asarray(v[:, k]) for k in range(3)),
                         m, quirks=CLEAN)
    hit, idx = np.asarray(h.hit), np.asarray(h.index)
    assert hit[0] and idx[0] == 1 and np.isclose(h.t[0], 4.0)
    assert not hit[1] and idx[1] == 0  # both copies lie behind this ray
    assert not hit[2] and idx[2] == 0 and not np.isfinite(h.t[2])


def test_mesh_scan_permutation_invariant():
    """Reordering the triangle table permutes the winning index and
    leaves t and the hit mask unchanged."""
    v0, v1, v2, m = _mesh()
    o, d = _mesh_rays()
    perm = np.random.default_rng(9).permutation(v0.shape[0])
    a = nearest_triangle(o, d, v0, v1, v2, m, quirks=CLEAN)
    b = nearest_triangle(o, d, v0[perm], v1[perm], v2[perm], m[perm],
                         quirks=CLEAN)
    hit = np.asarray(a.hit)
    assert 0.1 < hit.mean() < 1.0
    np.testing.assert_array_equal(hit, np.asarray(b.hit))
    np.testing.assert_array_equal(np.asarray(a.t), np.asarray(b.t))
    np.testing.assert_array_equal(np.asarray(a.index)[hit],
                                  perm[np.asarray(b.index)[hit]])


def test_mesh_occlusion_bounded_by_light_distance():
    """Clean shadows count a triangle only strictly before the light
    (t < t_max); parity's shadow() is unbounded and triangle-free."""
    from skele_raytracer_tpu.config import RenderConfig
    from skele_raytracer_tpu.ops.shading import _shadow_mask
    from skele_raytracer_tpu.scene.types import make_scene

    mat = dict(ambient=(0, 0, 0), diffuse=(1, 1, 1), specular=(0, 0, 0),
               transmissive=(0, 0, 0), power=1.0, ior=1.0)
    scene = make_scene(
        triangles=[dict(v0=(-5, -5, 5), v1=(5, -5, 5), v2=(0, 5, 5), **mat)],
        point_lights=[dict(position=(0, 0, 9), colour=(1, 1, 1))],
        camera_direction=(0, 0, 1), camera_up=(0, 1, 0))
    x = jnp.zeros((2, 3), jnp.float32)
    n = jnp.asarray([[0, 0, 1], [0, 0, 1]], jnp.float32)
    # light at z=9 behind the triangle (z=5), light at z=3 in front of it
    l_vec = jnp.asarray([[[0, 0, 9]], [[0, 0, 3]]], jnp.float32)
    dist = jnp.asarray([[9.0], [3.0]])
    cfg = RenderConfig(quirks=CLEAN)
    unsh = np.asarray(_shadow_mask(x, n, scene, cfg, l_vec, light_dist=dist))
    assert unsh[:, 0].tolist() == [False, True]
    unsh_p = np.asarray(_shadow_mask(x, n, scene, RenderConfig(), l_vec,
                                     light_dist=dist))
    assert unsh_p.all()


def test_mesh_dead_rays_never_hit_and_leave_live_rays_alone():
    """Zero-length directions (rays whose path died) hit nothing and
    produce no NaN; mixing them into a batch leaves the live rays'
    results bit-identical."""
    v0, v1, v2, m = _mesh()
    o, d = _mesh_rays(64)
    live = nearest_triangle(o, d, v0, v1, v2, m, quirks=CLEAN)
    d_mixed = d.at[::2].set(0.0)
    mixed = nearest_triangle(o, d_mixed, v0, v1, v2, m, quirks=CLEAN)
    hit = np.asarray(mixed.hit)
    assert not hit[::2].any()
    assert not np.isnan(np.asarray(mixed.t)).any()
    for f in ("t", "index", "hit"):
        np.testing.assert_array_equal(np.asarray(getattr(mixed, f))[1::2],
                                      np.asarray(getattr(live, f))[1::2])
