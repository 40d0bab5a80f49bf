"""Parser semantics tests (grammar + quirks, scene/parser.py)."""

import os

import numpy as np

from skele_raytracer_tpu import CLEAN, PARITY
from skele_raytracer_tpu.scene.parser import parse_scene_text


def test_material_state_machine():
    p = parse_scene_text(
        """
material 1 0 0 .5 0 0 .1 .1 .1 8 .2 .2 .2 1.5
sphere 0 0 0 1
sphere 1 1 1 2
material 0 1 0 0 .5 0 0 0 0 16 0 0 0 1
sphere 2 2 2 3
"""
    )
    assert len(p.spheres) == 3
    assert p.spheres[0]["ambient"] == (1.0, 0.0, 0.0)
    assert p.spheres[1]["ambient"] == (1.0, 0.0, 0.0)  # same material carries over
    assert p.spheres[2]["ambient"] == (0.0, 1.0, 0.0)
    assert p.spheres[0]["power"] == 8 and p.spheres[2]["power"] == 16
    assert p.spheres[0]["ior"] == 1.5


def test_default_material_applies_before_any_material_line():
    # Reference: `Material mat;` defaults (src/material.h) apply to shapes
    # declared before the first material command.
    p = parse_scene_text("sphere 0 0 0 1")
    assert p.spheres[0]["ambient"] == (0.0, 0.0, 0.0)
    assert p.spheres[0]["power"] == 1.0 and p.spheres[0]["ior"] == 1.0


def test_triangle_indices_and_resolution():
    p = parse_scene_text(
        """
vertex 0 0 0
vertex 1 0 0
vertex 0 1 0
triangle 0 1 2
"""
    )
    assert len(p.triangles) == 1
    assert p.triangles[0]["v0"] == (0.0, 0.0, 0.0)
    assert p.triangles[0]["v2"] == (0.0, 1.0, 0.0)


def test_ambient_accumulates():
    # src/scene.cpp:187-189 uses += across ambient_light lines.
    p = parse_scene_text("ambient_light .1 .2 .3\nambient_light .1 .1 .1")
    assert np.allclose(p.ambient, (0.2, 0.3, 0.4))


def test_directional_light_clamp_and_parity_drop():
    p = parse_scene_text("directional_light 2 .5 3 0 -1 0")
    # per-channel clamp at 1 (src/scene.cpp:143-154)
    assert p.directional_lights[0]["colour"] == (1.0, 0.5, 1.0)
    # parity build drops them (src/scene.cpp never push_backs)
    assert p.to_scene(PARITY).directional_lights.mask.sum() == 0
    assert p.to_scene(CLEAN).directional_lights.mask.sum() == 1


def test_fog_parity_zeroed_clean_parsed():
    p = parse_scene_text("spherical_fog 0 -50 0 100 1 1 1 .5 .25")
    assert p.fog[0]["radius"] == 100.0
    assert p.fog[0]["scattering"] == 0.5 and p.fog[0]["absorption"] == 0.25
    sc_par = p.to_scene(PARITY)
    sc_cln = p.to_scene(CLEAN)
    assert sc_par.has_fog and sc_cln.has_fog  # structurally present in both
    assert float(sc_par.fog.radius[0]) == 0.0  # sscanf-mismatch stand-in
    assert float(sc_cln.fog.radius[0]) == 100.0


def test_comments_blank_unknown_and_output_image():
    p = parse_scene_text(
        """
# a comment
   # indented comment

max_vertices 10009
spot_light 1 1 1 0 0 0
output_image foo.bmp
film_resolution 640 480
max_depth 5
background .1 .2 .3
"""
    )
    assert p.output_image == "foo.bmp"
    assert (p.width, p.height) == (640, 480)
    assert p.max_depth == 5
    assert p.background == (0.1, 0.2, 0.3)
    assert not p.spheres and not p.point_lights


def test_camera_parse_keeps_unnormalized_vectors():
    p = parse_scene_text("camera -6 2 -4 .77 0 .64 0 1 0 35")
    assert p.camera_direction == (0.77, 0.0, 0.64)  # NOT normalized
    assert p.half_height_angle == 35.0


def test_real_scenes_parse(parsed_spheres1):
    assert len(parsed_spheres1.spheres) == 4
    assert len(parsed_spheres1.triangles) == 2
    assert len(parsed_spheres1.point_lights) == 2
    from conftest import SCENES

    dragon = open(os.path.join(SCENES, "dragon.scn")).read()
    p = parse_scene_text(dragon)
    assert len(p.triangles) == 10002  # SURVEY.md: dragon = 10,002 tris
    assert len(p.directional_lights) == 1
    assert (p.width, p.height) == (640, 480)


def test_padding_and_masks(parsed_spheres1):
    sc = parsed_spheres1.to_scene(PARITY, pad_multiple=8)
    assert sc.spheres.center.shape == (8, 3)
    assert sc.spheres.mask.sum() == 4
    assert sc.triangles.v0.shape[0] == 8
    assert sc.point_lights.mask.sum() == 2
