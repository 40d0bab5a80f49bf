"""Whole-frame path-trace kernel (ops/pallas/pathtrace.py) vs the
differentiable jnp wavefront path: value equivalence across quirk modes
and scene features, and partition invariance.

The kernel reimplements the reference's sphere-scene hot loop
(src/raytrace.h:139-227, src/utils.h:87-121, src/blinn_phong.h) in one
pallas_call; these tests pin it to models/integrator.integrate_linear,
which is itself oracle-verified (tests/test_render_parity.py). Each case
runs twice: in the Pallas interpreter (here, on the CPU) and compiled
through Triton (`gpu`-marked: on the card, via `python chip_smoke.py`).
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from skele_raytracer_tpu.config import CLEAN, RenderConfig
from skele_raytracer_tpu.models.renderer import (
    render_ids_chunked,
    render_ids_chunked_jnp,
)
from skele_raytracer_tpu.ops.pallas import pathtrace
from skele_raytracer_tpu.scene.parser import parse_scene, parse_scene_text
from skele_raytracer_tpu.scene.types import make_scene

from conftest import SCENES, TEST_SCN, TEST_SCN_FOG

SPHERES_SCN = """
camera -6 2 -4 .77 0 .64 0 1 0 35
background .05 .1 .15
material .6 .55 .5 .7 .6 .5 .3 .25 .2 32 .2 .2 .2 1.5
sphere 0 -50 0 50
material .2 .8 .9 .25 .9 1 .3 .3 .3 16 .2 .2 .2 1.3
sphere -3 1 0 .75
material 0 .7 0 0 .7 0 .1 .2 .1 8 .9 .9 .9 1.1
sphere 0 1.25 0 1
material .1 .1 .9 .2 .2 1 .4 .4 .4 24 0 0 0 1.0
sphere 3 1.5 0 1.25
point_light 10 10 10 0 5 0
point_light 0 3 7 3 1 40
directional_light .8 .1 .1 -1 -1 1
ambient_light .25 .25 .25
max_depth 5
"""

# TEST_SCN's spheres lit by a directional light only (clean mode keeps
# directional lights; parity drops them at parse, src/scene.cpp:139-163).
DIRECTIONAL_SCN = "\n".join(
    line for line in TEST_SCN.splitlines()
    if not line.startswith(("point_light", "vertex", "triangle")))


@pytest.fixture(params=["interpret", pytest.param("gpu", marks=pytest.mark.gpu)])
def mode(request):
    """How the kernel runs: in the Pallas interpreter, or compiled for
    the card (skips without one; see conftest.gpu)."""
    if request.param == "gpu":
        request.getfixturevalue("gpu")
    return request.param


def _compare(scene, cfg, mode, seed=7, frac_tol=0.005, atol=1e-4):
    """Kernel vs jnp radiance. Transcendental lowering and the GPU
    compiler's FMA contraction can flip a grazing hit by 1 ulp, so up to
    0.5% of values may differ discretely; everything else must match to
    1e-4, and the frame means to 5e-4 (the flips must stay rare enough
    not to move them). The jnp side runs at HIGHEST matmul precision so
    no TF32 enters the reference's one-hot gathers."""
    cfg = cfg.replace(backend="pallas", interpret=mode == "interpret")
    assert pathtrace.use_pathtrace(scene, cfg), "kernel must serve this config"
    n = cfg.width * cfg.height * cfg.samples_per_pixel
    ids = jnp.arange(n, dtype=jnp.uint32)
    a = np.asarray(render_ids_chunked(scene, cfg, jnp.uint32(seed), ids))
    with jax.default_matmul_precision("highest"):
        b = np.asarray(render_ids_chunked_jnp(scene, cfg, jnp.uint32(seed),
                                              ids))
    assert a.shape == b.shape == (n, 3)
    assert np.isfinite(a).all()
    err = np.abs(a - b)
    frac_bad = (err > atol).mean()
    assert frac_bad <= frac_tol, (
        f"{frac_bad:.2%} of values differ (max {err.max():.3e})"
    )
    assert np.allclose(a.mean(0), b.mean(0), atol=5e-4)


def _many_sphere_scene(n=128, seed=3, triangles=(), directional=()):
    rng = np.random.default_rng(seed)
    spheres = []
    for _ in range(n):
        c = rng.uniform(-8, 8, 3)
        c[1] = abs(c[1])
        spheres.append(dict(
            center=tuple(c), radius=float(rng.uniform(0.3, 1.0)),
            ambient=tuple(rng.uniform(0, .3, 3)),
            diffuse=tuple(rng.uniform(0, 1, 3)),
            specular=tuple(rng.uniform(0, .5, 3)), transmissive=(0, 0, 0),
            power=float(rng.uniform(2, 40)), ior=1.2))
    return make_scene(
        spheres=spheres, triangles=list(triangles),
        directional_lights=list(directional),
        point_lights=[dict(position=(0, 30, -20), colour=(500, 500, 500)),
                      dict(position=(-10, 10, 0), colour=(100, 80, 60))],
        ambient=(0.2, 0.2, 0.2), camera_position=(0, 3, -24),
        camera_direction=(0, 0, 1), camera_up=(0, 1, 0),
        background=(.05, .1, .15))


_MC = dict(monte_carlo=True, num_paths=2, max_depth=2)
_TRI_MAT = dict(ambient=(0.2, 0.1, 0.1), diffuse=(0.7, 0.3, 0.2),
                specular=(0.2, 0.2, 0.2), transmissive=(0, 0, 0),
                power=8.0, ior=1.0)

# (scene source, quirks, config overrides). Scene sources: scene text, or
# a callable building the Scene.
CASES = {
    "parity_blinn_phong": (SPHERES_SCN, None, dict()),
    "parity_shadows": (SPHERES_SCN, None, dict(use_shadows=True)),
    "parity_jsample2": (SPHERES_SCN, None,
                        dict(grid_size=2, use_shadows=True)),
    "parity_mc_depth2": (SPHERES_SCN, None, dict(use_shadows=True, **_MC)),
    "parity_mc_depth3": (SPHERES_SCN, None, dict(
        use_shadows=True, monte_carlo=True, num_paths=2, max_depth=3)),
    "clean_mc_stratified_depth3": (SPHERES_SCN, CLEAN, dict(
        grid_size=2, use_shadows=True, monte_carlo=True, num_paths=2,
        max_depth=3)),
    "clean_fog": (TEST_SCN_FOG, CLEAN, dict(use_shadows=True, **_MC)),
    "parity_zeroed_fog": (TEST_SCN_FOG, None, dict(use_shadows=True, **_MC)),
    "triangles_parity": (TEST_SCN, None, dict(use_shadows=True, **_MC)),
    "triangles_clean": (TEST_SCN, CLEAN, dict(use_shadows=True, **_MC)),
    "directional_lights_clean": (DIRECTIONAL_SCN, CLEAN, dict(
        use_shadows=True, monte_carlo=True, num_paths=2, max_depth=1)),
    "loop_mode_spheres": (
        lambda: _many_sphere_scene(80, triangles=[
            dict(v0=(-8, 0, 4), v1=(8, 0, 4), v2=(0, 10, 4), **_TRI_MAT)],
            directional=[dict(direction=(-1, 2, -1), colour=(.4, .4, .3))]),
        CLEAN, dict(width=8, height=6, use_shadows=True, **_MC)),
    "partial_block": (SPHERES_SCN, None, dict(
        width=15, height=11, use_shadows=True, **_MC)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_jnp(case, mode):
    src, quirks, over = CASES[case]
    cfg = RenderConfig(**{"width": 16, "height": 8, **over})
    if quirks is not None:
        cfg = cfg.replace(quirks=quirks)
    scene = (src() if callable(src)
             else parse_scene_text(src).to_scene(cfg.quirks))
    if case == "parity_zeroed_fog":
        assert scene.fog_zeroed
    if case == "loop_mode_spheres":
        assert scene.spheres.mask.shape[0] > pathtrace._UNROLL_SPHERES
    if case == "partial_block":
        assert (cfg.width * cfg.height) % pathtrace.BLOCK != 0
    _compare(scene, cfg, mode)


class TestSmoke:
    def test_small_parity_blinn_phong(self):
        scene = parse_scene_text(SPHERES_SCN).to_scene()
        _compare(scene, RenderConfig(width=16, height=8, use_shadows=True),
                 "interpret")


@pytest.mark.slow
def test_spheres2_parity_fog_zeroed():
    # The headline scene: parity zeroes the fog (quirk
    # fog_sscanf_mismatch), which statically folds away the whole
    # point-light block (ops/shading.py) — the kernel must take the
    # same ambient-only shading path.
    parsed = parse_scene(os.path.join(SCENES, "spheres2.scn"))
    cfg = RenderConfig(width=32, height=18, monte_carlo=True, num_paths=16,
                       max_depth=2, use_shadows=True)
    scene = parsed.to_scene(cfg.quirks)
    assert scene.fog_zeroed and not scene.has_triangles
    _compare(scene, cfg, "interpret")


class TestSharded:
    pytestmark = [pytest.mark.slow]

    def test_sharded_render_matches_single_device(self):
        """The kernel path composes with shard_map: an 8-device mesh
        renders the same frame (per-ray values are partition-independent;
        the final stack/mean ops may reassociate by an ulp)."""
        from skele_raytracer_tpu.models.renderer import render_radiance
        from skele_raytracer_tpu.parallel.api import (
            make_mesh,
            render_radiance_sharded,
        )

        cfg = RenderConfig(width=16, height=12, monte_carlo=True, num_paths=2,
                           max_depth=2, use_shadows=True, backend="pallas",
                           interpret=True)
        scene = parse_scene_text(SPHERES_SCN).to_scene(cfg.quirks)
        single = np.asarray(jax.jit(
            lambda s, k: render_radiance(s, cfg, k))(scene, jnp.uint32(0)))
        mesh = make_mesh()
        sharded = np.asarray(jax.jit(
            lambda s, k: render_radiance_sharded(s, cfg, k, mesh)
        )(scene, jnp.uint32(0)))
        np.testing.assert_allclose(single, sharded, atol=1e-6, rtol=0)


class TestPartitionInvariance:
    pytestmark = [pytest.mark.slow]

    def test_split_ids_bitwise(self):
        """Radiance is per-ray; any partition of the id space must
        reproduce the identical values (the property device sharding and
        progressive bands are built on)."""
        cfg = RenderConfig(width=16, height=12, monte_carlo=True, num_paths=3,
                           max_depth=2, use_shadows=True, backend="pallas",
                           interpret=True)
        scene = parse_scene_text(SPHERES_SCN).to_scene(cfg.quirks)
        n = 16 * 12
        ids = jnp.arange(n, dtype=jnp.uint32)
        whole = np.asarray(
            pathtrace.pathtrace_ids(scene, cfg, jnp.uint32(5), ids))
        parts = [
            np.asarray(pathtrace.pathtrace_ids(
                scene, cfg, jnp.uint32(5), ids[i:i + 64]))
            for i in range(0, n, 64)
        ]
        np.testing.assert_array_equal(whole, np.concatenate(parts))


class TestDispatch:
    def test_sphere_count_envelope_gates(self):
        """Dispatch gates across the sphere-count envelope: unrolled
        kernel to _UNROLL_SPHERES, fori_loop kernel to MAX_SPHERES, jnp
        wavefront beyond (the reference's brute force,
        src/raytrace.h:152-166, silently scales; so must we). Records
        serve every kernel config whose light bits fit; the
        >MAX_SPHERES fallback additionally renders (cheap jnp path)."""
        cfg = RenderConfig(width=8, height=6, monte_carlo=True, num_paths=2,
                           max_depth=2, use_shadows=True, backend="pallas",
                           rays_per_chunk=1 << 10)
        for n, served in ((48, True), (96, True), (300, False)):
            scene = _many_sphere_scene(n)
            assert pathtrace.use_pathtrace(scene, cfg) == served, n
            assert pathtrace._can_replay(scene, cfg), n
        ids = jnp.arange(8 * 6, dtype=jnp.uint32)
        r = np.asarray(render_ids_chunked(
            _many_sphere_scene(300), cfg, jnp.uint32(2), ids))
        assert np.isfinite(r).all() and r.std() > 0

    def test_gates(self, parsed_test_scene):
        from conftest import make_mesh_scene

        cfg = RenderConfig(monte_carlo=True, num_paths=2, max_depth=2,
                           backend="pallas")
        sph = parse_scene_text(SPHERES_SCN).to_scene(cfg.quirks)
        assert pathtrace.use_pathtrace(sph, cfg)
        # jnp backend opts out
        assert not pathtrace.use_pathtrace(sph, cfg.replace(backend="jnp"))
        # a few decorative triangles are served in-kernel...
        tri = parsed_test_scene.to_scene(cfg.quirks)
        assert pathtrace.use_pathtrace(tri, cfg)
        # ...but mesh-scale scenes take the XLA triangle scan
        mesh = make_mesh_scene(t=700)
        assert not pathtrace.use_pathtrace(mesh, cfg)
        # the clean Whitted frontier (non-MC, reflections on) is not served
        clean_whitted = RenderConfig(backend="pallas", quirks=CLEAN)
        sph_c = parse_scene_text(SPHERES_SCN).to_scene(CLEAN)
        assert not pathtrace.use_pathtrace(sph_c, clean_whitted)

    @pytest.mark.parametrize("n_fog,served", [(1, True), (2, True),
                                              (3, False)])
    def test_fog_volume_gate(self, n_fog, served):
        """Value-bearing fog is shaded in-kernel up to MAX_FOG volumes;
        more take the jnp wavefront."""
        fog = "".join(f"spherical_fog 0 0 0 {60 + i} .9 .8 .7 .02 .01\n"
                      for i in range(n_fog))
        scene = parse_scene_text(SPHERES_SCN + fog).to_scene(CLEAN)
        cfg = RenderConfig(monte_carlo=True, num_paths=2, max_depth=2,
                           backend="pallas", quirks=CLEAN)
        assert scene.has_fog and not scene.fog_zeroed
        assert pathtrace.use_pathtrace(scene, cfg) == served

    @pytest.mark.parametrize("platform,backend", [("gpu", "pallas"),
                                                  ("cpu", "jnp")])
    def test_auto_backend_follows_platform(self, monkeypatch, platform,
                                           backend):
        """backend="auto" takes the kernel exactly on a GPU."""
        monkeypatch.setattr(jax, "default_backend", lambda: platform)
        assert RenderConfig().resolved().backend == backend
        assert RenderConfig(backend="jnp").resolved().backend == "jnp"

    def test_forced_kernel_off_gpu_raises(self):
        """backend="pallas" on a platform without the GPU compiler fails
        loudly unless the interpreter is asked for explicitly."""
        assert jax.default_backend() != "gpu"
        scene = parse_scene_text(SPHERES_SCN).to_scene()
        cfg = RenderConfig(width=8, height=4, backend="pallas")
        ids = jnp.arange(32, dtype=jnp.uint32)
        with pytest.raises(ValueError, match="interpret=True"):
            render_ids_chunked(scene, cfg, jnp.uint32(0), ids)
