"""Test harness config: run on a virtual 8-device CPU mesh by default.

Set BEFORE jax initializes: the default suite must not depend on (or
occupy) an accelerator, and the sharding tests need multiple devices
(xla_force_host_platform_device_count=8 simulates them on CPU, the
standard JAX practice for testing multi-device code). A run that sets
JAX_PLATFORMS itself keeps it: `chip_smoke.py` runs the `gpu`-marked tests
with JAX_PLATFORMS=cuda.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()

sys.path.insert(0, os.path.dirname(__file__))  # make `oracle` importable

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from skele_raytracer_tpu.scene.parser import parse_scene_text  # noqa: E402

SCENES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "scenes")

# A small self-contained scene exercising every feature: multiple spheres
# and materials, triangles, two point lights, a directional light (dropped
# in parity mode), accumulated ambient, background, supersampling-friendly.
TEST_SCN = """
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
vertex -15 -15 10
vertex -14 -15 10
vertex -13 -15 10
vertex -3 4 2
vertex 0 5 2
vertex -1.5 6.5 2
triangle 0 1 2
triangle 3 4 5
point_light 10 10 10 0 5 0
point_light 0 3 7 3 1 40
directional_light .8 .1 .1 -1 -1 1
ambient_light .15 .15 .15
ambient_light .1 .1 .1
max_depth 5
"""


# TEST_SCN plus a spherical fog volume with parameters chosen so BOTH fog
# branches fire (p_no_interaction = exp(-dist * (absorption + scattering))
# lands mid-range at this scene's light distances): value-level fog
# verification needs real, nonzero parameters (VERDICT missing #3).
TEST_SCN_FOG = TEST_SCN + "\nspherical_fog 0 0 0 60 .9 .8 .7 .02 .01\n"


@pytest.fixture(scope="session")
def parsed_test_scene():
    return parse_scene_text(TEST_SCN)


@pytest.fixture(scope="session")
def parsed_fog_scene():
    return parse_scene_text(TEST_SCN_FOG)


@pytest.fixture(scope="session")
def parsed_spheres1():
    return parse_scene_text(open(os.path.join(SCENES, "spheres1.scn")).read())


def assert_images_close(a, b, atol=2e-5, rtol=2e-5, what=""):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    err = np.abs(a - b)
    denom = np.maximum(np.abs(b), 1.0)
    rel = err / denom
    ok = (err <= atol) | (rel <= rtol)
    frac_bad = 1.0 - ok.mean()
    assert frac_bad == 0.0, (
        f"{what}: {frac_bad:.2%} of values differ "
        f"(max abs {err.max():.3e}, max rel {rel.max():.3e})"
    )


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is an NVIDIA GPU: the test runs a
    kernel compiled through Triton, which has no CPU lowering. Decided
    here, at run time, so every worker collects the same tests."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (Triton-compiled kernel); run "
                    "on the card with `python chip_smoke.py`")


def make_mesh_scene(t=700, seed=12):
    """A scene with a mesh-scale triangle count (past the path-trace
    kernel's MAX_TRIS) plus one sphere and one light."""
    from skele_raytracer_tpu.scene.types import make_scene

    rng = np.random.default_rng(seed)
    mat = dict(
        ambient=(0.1, 0.1, 0.1), diffuse=(0.6, 0.5, 0.4),
        specular=(0.2, 0.2, 0.2), transmissive=(0, 0, 0), power=8.0, ior=1.0,
    )
    tris = []
    for i in range(t):
        v0 = rng.uniform(-6, 6, 3)
        tris.append(dict(
            v0=tuple(v0), v1=tuple(v0 + rng.normal(size=3)),
            v2=tuple(v0 + rng.normal(size=3)), **mat,
        ))
    return make_scene(
        triangles=tris,
        spheres=[dict(center=(0, -60, 0), radius=50.0, **mat)],
        point_lights=[dict(position=(0, 20, -10), colour=(200, 200, 200))],
        ambient=(0.2, 0.2, 0.2),
        camera_position=(0, 0, -14), camera_direction=(0, 0, 1),
        camera_up=(0, 1, 0), background=(0.05, 0.1, 0.15),
    )
