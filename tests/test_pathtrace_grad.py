"""The path-trace kernel's differentiation and wrapper: packed hit records,
the XLA record replay that is its backward, custom_vjp gradients vs
jax.grad through the jnp wavefront, and the power-of-two padding of the
tables and records the Triton kernel needs. The kernel runs in the Pallas
interpreter here."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from skele_raytracer_tpu.config import CLEAN, RenderConfig
from skele_raytracer_tpu.models.renderer import render_ids_chunked
from skele_raytracer_tpu.ops import geometry
from skele_raytracer_tpu.ops.camera import rays_for_ids
from skele_raytracer_tpu.ops.pallas import pathtrace
from skele_raytracer_tpu.scene.parser import parse_scene_text

from conftest import TEST_SCN, TEST_SCN_FOG

KCFG = RenderConfig(width=12, height=8, monte_carlo=True, num_paths=2,
                    max_depth=2, use_shadows=True, backend="pallas",
                    interpret=True, quirks=CLEAN)


def test_records_decode_to_jnp_hits():
    """Record slot 0 decodes to geometry.intersect's hit structure for the
    primary rays: kind from the hit/triangle bits, primitive index from
    bits 0:8 (spheres and triangles, clean mode)."""
    scene = parse_scene_text(TEST_SCN).to_scene(CLEAN)
    ids = jnp.arange(KCFG.width * KCFG.height, dtype=jnp.uint32)
    _, rec = pathtrace._pathtrace_call(scene, KCFG, jnp.uint32(3), ids,
                                       with_records=True)
    r0 = np.asarray(rec[0])
    kind = np.where((r0 >> 9) & 1, 2, np.where((r0 >> 8) & 1, 1, 0))
    o, d = rays_for_ids(scene.camera, KCFG, jnp.uint32(3), ids)
    with jax.default_matmul_precision("highest"):
        hits = geometry.intersect(o, d, scene, quirks=KCFG.quirks)
    jk, ji = np.asarray(hits.kind), np.asarray(hits.index)
    assert (kind > 0).any() and (kind == 0).any()
    np.testing.assert_array_equal(kind, jk)
    np.testing.assert_array_equal((r0 & 0xFF)[jk > 0], ji[jk > 0])


@pytest.mark.parametrize("paths,depth", [(1, 1), (3, 2), (3, 3)])
def test_record_rows_padded_and_trimmed(paths, depth):
    """The kernel writes K = 1 + P*(D-1) record rows into a power-of-two
    [Kp, Np] block layout; the wrapper returns exactly [K, N] for a
    sample count that does not fill a block."""
    scene = parse_scene_text(TEST_SCN).to_scene(CLEAN)
    cfg = KCFG.replace(width=10, height=7, num_paths=paths, max_depth=depth)
    n = 70
    ids = jnp.arange(n, dtype=jnp.uint32)
    rad, rec = pathtrace._pathtrace_call(scene, cfg, jnp.uint32(1), ids,
                                         with_records=True)
    K = 1 + paths * (depth - 1)
    assert rad.shape == (n, 3) and rec.shape == (K, n)
    assert pathtrace._pow2(K) >= K
    # every written row carries hit bits consistent with its primitive
    r = np.asarray(rec)
    assert ((r >> 8) & 1).any()
    assert np.all((r & 0xFF)[((r >> 8) & 1) == 0] == 0)


def test_table_padding_pow2():
    """_pack_tables pads every table to power-of-two rows and columns
    (Triton's block-shape rule) and keeps the real entries in place."""
    rng = np.random.default_rng(0)
    text = TEST_SCN_FOG + "".join(
        f"sphere {x:.2f} 2 {z:.2f} .3\n"
        for x, z in rng.uniform(-5, 5, (17, 2)))
    text += "point_light 1 9 1 2 2 2\n"
    scene = parse_scene_text(text).to_scene(CLEAN)
    assert scene.spheres.mask.shape[0] == 24  # 21 spheres, padded to 8s
    tabs = pathtrace._pack_tables(scene)
    for t in tabs:
        for n in t.shape:
            assert n & (n - 1) == 0, t.shape
    sph, tri, misc, pl, dl = (np.asarray(t) for t in tabs)
    S = scene.spheres.mask.shape[0]
    np.testing.assert_array_equal(sph[:S, 0:3], scene.spheres.center)
    np.testing.assert_array_equal(sph[:S, 4], scene.spheres.mask)
    assert not sph[S:].any() and not sph[:, 15:].any()
    T = scene.triangles.mask.shape[0]
    np.testing.assert_array_equal(tri[:T, 0:3], scene.triangles.v0)
    assert tri.shape[1] == 32 and not tri[:, 23:].any()
    np.testing.assert_array_equal(misc[0, 0:3], scene.camera.position)
    np.testing.assert_array_equal(misc[1, 0], scene.fog.radius[0])
    L = scene.point_lights.mask.shape[0]
    assert pl.shape[0] == pathtrace._pow2(L) and L == 3
    np.testing.assert_array_equal(pl[:L, 3:6], scene.point_lights.colour)


def test_replay_value_matches_kernel():
    """The saved hit records replayed through the differentiable XLA chain
    reproduce the kernel's own radiance (same structure, same math —
    only float-tolerance apart), fog reroute included."""
    scene = parse_scene_text(TEST_SCN_FOG).to_scene(CLEAN)
    cfg = KCFG.replace(num_paths=3, max_depth=3)
    ids = jnp.arange(cfg.width * cfg.height, dtype=jnp.uint32)
    assert pathtrace._can_replay(scene, cfg)
    radiance, rec = pathtrace._pathtrace_call(
        scene, cfg, jnp.uint32(9), ids, with_records=True)
    with jax.default_matmul_precision("highest"):
        replayed = pathtrace._replay_chunked(
            scene, cfg, jnp.uint32(9), ids, rec)
    np.testing.assert_allclose(np.asarray(replayed), np.asarray(radiance),
                               rtol=1e-4, atol=1e-5)


# Gradient scenes: TEST_SCN_FOG in clean mode shades its fog volume and its
# triangles (and lets them occlude shadow rays), so fog and triangle leaves
# carry gradient; parity mode zeroes the fog and shades triangles black.
GRAD_SCENES = {
    "clean_fog": (TEST_SCN_FOG, CLEAN),
    "parity": (TEST_SCN, RenderConfig().quirks),
}


@pytest.fixture(scope="module")
def grads():
    """Per scene: (kernel records + XLA replay, jax.grad through the jnp
    wavefront) gradients of one loss, each computed once for the leaf
    checks below."""
    cache = {}

    def get(name):
        if name not in cache:
            text, quirks = GRAD_SCENES[name]
            cfg = KCFG.replace(quirks=quirks)
            scene = parse_scene_text(text).to_scene(quirks)
            assert pathtrace.use_pathtrace(scene, cfg)
            assert pathtrace._can_replay(scene, cfg)
            ids = jnp.arange(cfg.width * cfg.height, dtype=jnp.uint32)
            w = jnp.linspace(0.5, 1.5, ids.shape[0] * 3).reshape(-1, 3)

            def loss(s, c):
                return jnp.sum(
                    render_ids_chunked(s, c, jnp.uint32(3), ids) * w)

            with jax.default_matmul_precision("highest"):
                gk = jax.grad(loss)(scene, cfg)
                gj = jax.grad(loss)(scene, cfg.replace(backend="jnp"))
            cache[name] = gk, gj
        return cache[name]

    return get


@pytest.mark.parametrize("leaf", [
    "spheres.center", "spheres.radius", "spheres.diffuse",
    "point_lights.position", "point_lights.colour",
    "camera.position", "camera.direction",
    "triangles.v0", "triangles.v1", "triangles.v2", "triangles.diffuse",
    "fog.albedo", "fog.scattering",
])
def test_grad_matches_jnp(grads, leaf):
    """custom_vjp gradients (kernel records + XLA replay) equal jax.grad
    through the jnp path for sphere, light, camera, triangle and fog
    leaves (clean mode, live fog): the same estimator differentiated at
    the same hit structure, so only float tolerance apart (rtol 1e-3,
    atol 1e-5). fog.absorption is not listed: it enters only the discrete
    interaction draw (ops/shading.py), so its gradient is zero on both
    paths; test_every_leaf_matches_jnp checks that they agree."""
    gk, gj = grads("clean_fog")
    a, b = gk, gj
    for part in leaf.split("."):
        a, b = getattr(a, part), getattr(b, part)
    a, b = np.asarray(a), np.asarray(b)
    assert np.isfinite(a).all()
    assert np.abs(b).max() > 0, f"{leaf}: oracle gradient is zero"
    np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("scene_name", list(GRAD_SCENES))
def test_every_leaf_matches_jnp(grads, scene_name):
    """Every leaf of the scene's gradient, in parity and in clean mode:
    finite, nonzero somewhere, and equal to the jnp path's (rtol 1e-3,
    atol 1e-5)."""
    gk, gj = grads(scene_name)
    pk, _ = jax.tree_util.tree_flatten_with_path(gk)
    lj = jax.tree_util.tree_leaves(gj)
    assert len(pk) == len(lj)
    assert any(np.abs(np.asarray(a)).sum() > 0 for _, a in pk)
    for (path, a), b in zip(pk, lj):
        a, b = np.asarray(a), np.asarray(b)
        name = jax.tree_util.keystr(path)
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.slow
def test_fixed_topology_fd_matches_analytic():
    """The falsifiable geometry-gradient check (BASELINE.md 'pixel-grad
    parity ... allclose'): freeze the forward's hit records and central-FD
    the differentiable replay wrt sphere centres. At fixed hit topology
    the pixel function is smooth — no silhouette caveat applies — so
    autodiff of the replay (the exact function the production backward
    differentiates) must match FD to first order."""
    cfg = KCFG.replace(quirks=RenderConfig().quirks)
    scene = parse_scene_text(TEST_SCN).to_scene(cfg.quirks)
    ids = jnp.arange(cfg.width * cfg.height, dtype=jnp.uint32)
    _, rec = pathtrace._pathtrace_call(
        scene, cfg, jnp.uint32(9), ids, with_records=True)
    rec = jax.lax.stop_gradient(rec)
    # Freeze the remaining discrete selection too: the tangent-frame
    # branch bits at the base scene (a flip under perturbation is a jump
    # discontinuity FD would integrate as constant-in-eps bias).
    bits = pathtrace.replay_frame_bits(scene, cfg, jnp.uint32(9), ids, rec)

    def loss(s):
        r = pathtrace._replay_chunked(s, cfg, jnp.uint32(9), ids, rec,
                                      frame_bits=bits)
        w = jnp.linspace(0.5, 1.5, r.size).reshape(r.shape)
        return jnp.sum(r * w)

    loss_j = jax.jit(loss)
    ga = np.asarray(jax.grad(loss)(scene).spheres.center, np.float64)
    base = np.asarray(scene.spheres.center, np.float64)
    mask = np.asarray(scene.spheres.mask) > 0
    eps = 1e-2
    fd = np.zeros_like(base)
    for i in range(base.shape[0]):
        if not mask[i]:
            continue
        for j in range(base.shape[1]):
            d = np.zeros_like(base)
            d[i, j] = eps
            sp = scene.replace(spheres=scene.spheres.replace(
                center=jnp.asarray(base + d, jnp.float32)))
            sm = scene.replace(spheres=scene.spheres.replace(
                center=jnp.asarray(base - d, jnp.float32)))
            fd[i, j] = (float(loss_j(sp)) - float(loss_j(sm))) / (2 * eps)
    num = np.linalg.norm((ga - fd)[mask])
    den = max(np.linalg.norm(fd[mask]), 1e-9)
    assert num / den < 1e-2, (num / den, ga, fd)
