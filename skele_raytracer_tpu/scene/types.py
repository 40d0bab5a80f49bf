"""Scene data model: struct-of-arrays pytrees.

The reference stores the scene as C++ vectors of structs (`Scene`,
reference src/scene.h:13-28; POD shapes src/shapes.h, lights src/lights.h,
materials src/material.h, fog src/Fog.h). This design flattens
everything to padded struct-of-arrays pytrees of `jnp` arrays so that

* the whole scene is one `device_put` (the analog of the CUDA build's
  `allocate_device_cudascene_struct` upload, reference cudasrc/scene.h:147-176,
  done once instead of per-array cudaMalloc/cudaMemcpy),
* every geometric/material/light leaf is differentiable,
* array counts are padded to a static multiple so jit traces are reusable
  across scenes of similar size; `mask` marks real entries (1.0) vs padding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _pytree_dataclass(cls):
    """A frozen dataclass registered as a JAX pytree. Fields declared with
    `_static()` are metadata (trace-time constants, part of the jit cache
    key); all others are leaves. `replace(**changes)` returns a copy."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return jax.tree_util.register_dataclass(cls)


def _static(default):
    return dataclasses.field(default=default, metadata=dict(static=True))


def _pad_rows(a: np.ndarray, n: int) -> np.ndarray:
    """Zero-pad the leading axis of `a` to length n."""
    pad = [(0, n - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return np.pad(a, pad)


def padded_size(count: int, multiple: int = 8) -> int:
    """Smallest multiple of `multiple` that is >= max(count, 1)."""
    count = max(count, 1)
    return ((count + multiple - 1) // multiple) * multiple


@_pytree_dataclass
class Spheres:
    """Spheres + their materials (reference src/shapes.h:12-23,
    src/SphereCollider.h:8-12, src/material.h:9-26), SoA and padded."""

    center: jnp.ndarray  # [S, 3]
    radius: jnp.ndarray  # [S]
    ambient: jnp.ndarray  # [S, 3]
    diffuse: jnp.ndarray  # [S, 3]
    specular: jnp.ndarray  # [S, 3]
    transmissive: jnp.ndarray  # [S, 3]
    power: jnp.ndarray  # [S]
    ior: jnp.ndarray  # [S]
    mask: jnp.ndarray  # [S] 1.0 = real entry, 0.0 = padding

    @property
    def count(self) -> int:
        return self.center.shape[0]


@_pytree_dataclass
class Triangles:
    """Triangles + their materials (reference src/shapes.h:26-33), SoA.

    Vertices are stored resolved (the reference resolves indices at parse
    time too, src/scene.cpp:67-82 — vertex edits after parse don't propagate).
    """

    v0: jnp.ndarray  # [T, 3]
    v1: jnp.ndarray  # [T, 3]
    v2: jnp.ndarray  # [T, 3]
    ambient: jnp.ndarray  # [T, 3]
    diffuse: jnp.ndarray  # [T, 3]
    specular: jnp.ndarray  # [T, 3]
    transmissive: jnp.ndarray  # [T, 3]
    power: jnp.ndarray  # [T]
    ior: jnp.ndarray  # [T]
    mask: jnp.ndarray  # [T]

    @property
    def count(self) -> int:
        return self.v0.shape[0]


@_pytree_dataclass
class PointLights:
    """Point lights (reference src/lights.h:20-23)."""

    position: jnp.ndarray  # [L, 3]
    colour: jnp.ndarray  # [L, 3]
    mask: jnp.ndarray  # [L]


@_pytree_dataclass
class DirectionalLights:
    """Directional lights (reference src/lights.h:14-18). NOTE the reference
    treats `direction` as pointing TOWARD the light when shading
    (normalize(light.direction) used directly in dot(n, l),
    src/blinn_phong.h:84-85) — we keep those semantics."""

    direction: jnp.ndarray  # [L, 3]
    colour: jnp.ndarray  # [L, 3]
    mask: jnp.ndarray  # [L]


@_pytree_dataclass
class Fog:
    """Spherical fog volumes (reference src/Fog.h:10-32)."""

    center: jnp.ndarray  # [F, 3]
    radius: jnp.ndarray  # [F]
    albedo: jnp.ndarray  # [F, 3]
    scattering: jnp.ndarray  # [F]
    absorption: jnp.ndarray  # [F]
    mask: jnp.ndarray  # [F]


@_pytree_dataclass
class Camera:
    """Camera (reference src/camera.h:8-32). `right` is derived at ray-gen
    time as cross(-direction, up) exactly as the reference constructor does
    (src/camera.h:21,30); direction/up are NOT normalized because the
    reference discards the glm::normalize results (src/scene.cpp:92-93)."""

    position: jnp.ndarray  # [3]
    direction: jnp.ndarray  # [3]
    up: jnp.ndarray  # [3]
    half_height_angle: jnp.ndarray  # [] — parsed, never used for projection
    # (the reference projects with Options.fov instead, src/main.cpp:43)


@_pytree_dataclass
class Scene:
    """Full differentiable scene pytree (reference src/scene.h:13-28).

    Static render info (width/height/max_depth from the .scn file) lives in
    `ParsedScene`/`RenderConfig`, not here. The three `*_active` fields are
    static (non-pytree) structural flags — whether the scene has ANY fog /
    triangles / directional lights changes the reference's control flow
    (e.g. fog presence reroutes all diffuse/specular shading through
    spherical_fog_shading, src/blinn_phong.h:56-66), so they must be
    trace-time constants, not traced mask values.
    """

    spheres: Spheres
    triangles: Triangles
    point_lights: PointLights
    directional_lights: DirectionalLights
    ambient: jnp.ndarray  # [3] — accumulates over ambient_light lines
    # (reference src/scene.cpp:187-189 uses +=)
    fog: Fog
    camera: Camera
    background: jnp.ndarray  # [3]
    fog_active: bool = _static(False)
    triangles_active: bool = _static(False)
    directional_active: bool = _static(False)
    # Whether ANY real point light / sphere exists. The padded tables
    # always hold >= 1 (>= 8) slots, so without these flags a scene lit
    # only by a directional light still pays a full per-light shadow
    # sweep for a masked phantom slot.
    point_active: bool = _static(False)
    spheres_active: bool = _static(False)
    # Parity's stand-in for the reference's uninitialized fog (SURVEY §2.9.6)
    # is all-zero parameters, which makes the fog-rerouted diffuse+specular
    # terms IDENTICALLY zero (exp(0)=1 -> never "interacts"; albedo=0 kills
    # the other branch). This static flag lets shading fold that to zero
    # instead of drawing fog randoms and computing a provably-zero term.
    fog_zeroed: bool = _static(False)

    @property
    def has_fog(self) -> bool:
        return self.fog_active

    @property
    def has_triangles(self) -> bool:
        return self.triangles_active

    @property
    def has_directional(self) -> bool:
        return self.directional_active

    @property
    def has_point_lights(self) -> bool:
        return self.point_active

    @property
    def has_spheres(self) -> bool:
        return self.spheres_active


def make_scene(
    *,
    spheres: Optional[list] = None,
    triangles: Optional[list] = None,
    point_lights: Optional[list] = None,
    directional_lights: Optional[list] = None,
    ambient=(0.0, 0.0, 0.0),
    fog: Optional[list] = None,
    camera_position=(0.0, 0.0, 0.0),
    camera_direction=(0.0, 0.0, 0.0),
    camera_up=(0.0, 0.0, 0.0),
    half_height_angle=0.0,
    background=(0.0, 0.0, 0.0),
    pad_multiple: int = 8,
    dtype=jnp.float32,
    fog_zeroed: bool = False,
) -> Scene:
    """Build a padded Scene pytree from Python-level records.

    `spheres`: list of dicts with keys center, radius, ambient, diffuse,
    specular, transmissive, power, ior. `triangles`: same material keys plus
    v0, v1, v2. Lights/fog: dicts mirroring the reference structs.
    """
    spheres = spheres or []
    triangles = triangles or []
    point_lights = point_lights or []
    directional_lights = directional_lights or []
    fog = fog or []

    def build(records, fields, n):
        out = {}
        for name, width in fields.items():
            if records:
                a = np.asarray([r[name] for r in records], dtype=np.float32)
            else:
                a = np.zeros((0, width) if width > 1 else (0,), np.float32)
            if width > 1:
                a = a.reshape(len(records), width)
            out[name] = jnp.asarray(_pad_rows(a, n), dtype)
        mask = np.zeros((n,), np.float32)
        mask[: len(records)] = 1.0
        out["mask"] = jnp.asarray(mask, dtype)
        return out

    # Primitive axes pad to a multiple (they are the per-ray scan axes and
    # benefit from aligned shapes reused across similar scenes); light/fog
    # axes pad only to >= 1 — they multiply into [rays, lights, fog, ...]
    # shading/RNG intermediates, where 8x padding would mean 8-64x wasted
    # bandwidth on the hot path.
    ns = padded_size(len(spheres), pad_multiple)
    nt = padded_size(len(triangles), pad_multiple)
    nl = padded_size(len(point_lights), 1)
    nd = padded_size(len(directional_lights), 1)
    nf = padded_size(len(fog), 1)

    mat_fields = dict(ambient=3, diffuse=3, specular=3, transmissive=3, power=1, ior=1)
    sph = build(spheres, dict(center=3, radius=1, **mat_fields), ns)
    tri = build(triangles, dict(v0=3, v1=3, v2=3, **mat_fields), nt)

    pl = build(point_lights, dict(position=3, colour=3), nl)
    dl = build(directional_lights, dict(direction=3, colour=3), nd)
    fg = build(fog, dict(center=3, radius=1, albedo=3, scattering=1, absorption=1), nf)

    return Scene(
        spheres=Spheres(**sph),
        triangles=Triangles(**tri),
        point_lights=PointLights(**pl),
        directional_lights=DirectionalLights(**dl),
        ambient=jnp.asarray(ambient, dtype),
        fog=Fog(**fg),
        camera=Camera(
            position=jnp.asarray(camera_position, dtype),
            direction=jnp.asarray(camera_direction, dtype),
            up=jnp.asarray(camera_up, dtype),
            half_height_angle=jnp.asarray(half_height_angle, dtype),
        ),
        background=jnp.asarray(background, dtype),
        fog_active=len(fog) > 0,
        triangles_active=len(triangles) > 0,
        directional_active=len(directional_lights) > 0,
        point_active=len(point_lights) > 0,
        spheres_active=len(spheres) > 0,
        fog_zeroed=fog_zeroed,
    )
