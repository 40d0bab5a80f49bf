"""Every shipped .scn scene parses and renders in both semantic modes.

bear.scn (31 spheres), test.scn (2,763 triangles + spot_light unknown
command), dragon.scn (10,002 triangles), spheres1/2 — tiny smoke renders
catching shape/padding/dispatch regressions across scene structures the
feature tests don't cover.
"""

import glob
import os

import numpy as np
import pytest

import jax.numpy as jnp

from skele_raytracer_tpu.config import CLEAN, PARITY, RenderConfig
from skele_raytracer_tpu.models.renderer import render_radiance
from skele_raytracer_tpu.scene.parser import parse_scene

SCENES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "scenes", "*.scn")))


@pytest.mark.parametrize("path", SCENES, ids=[os.path.basename(s) for s in SCENES])
@pytest.mark.parametrize("quirks", [PARITY, CLEAN], ids=["parity", "clean"])
def test_scene_renders(path, quirks):
    parsed = parse_scene(path)
    scene = parsed.to_scene(quirks)
    cfg = RenderConfig(
        width=24, height=16, max_depth=2, use_shadows=True,
        quirks=quirks, rays_per_chunk=1 << 9,
    )
    img = np.asarray(render_radiance(scene, cfg, jnp.uint32(1)))
    assert img.shape == (16, 24, 3)
    assert np.isfinite(img).all()
    assert (img >= 0).all()
    # the frame must not be uniformly one value (something got traced)
    assert img.std() > 0
