"""Frozen, hashable render configuration.

The reference splits configuration between CLI flags (`main()`,
reference src/main.cpp:246-379) and the `Options` struct (src/utils.h:26-39),
with two documented precedence quirks: the CLI always clobbers the scene
file's `film_resolution` (src/main.cpp:394-395) and the scene `max_depth`
command is parsed but ignored (src/scene.cpp:192-198 vs Options.max_depth).

Here configuration is a single frozen dataclass so it can be passed as a
static argument to `jax.jit`. Precedence is explicit: CLI > scene file >
defaults, with a parity flag replicating the reference's effective behavior.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class Quirks:
    """Catalogued reference behaviors (SURVEY.md §2.9) toggled individually.

    ``PARITY`` turns every quirk on (bug-for-bug reachable semantics of the
    reference CPU build); ``CLEAN`` turns every quirk off (the behavior the
    reference *intended*). Each field cites the reference location it models.
    """

    # glm::normalize(ray_dir) return value discarded — rays stay unnormalized
    # (src/main.cpp:57,77; camera vectors likewise src/scene.cpp:92-93).
    unnormalized_ray_dirs: bool = True
    # intersection_occurs rejects hits with t <= 1.0 in ray-parameter units
    # (src/utils.h:173). Clean mode uses t > SHADOW_EPS with normalized dirs.
    near_clip_t_le_1: bool = True
    # Supersampling draws ONE uniform r and reuses it for both u and v, and
    # ignores the n×n cell indices (src/main.cpp:48-69) — samples jitter along
    # the pixel diagonal. Clean mode uses stratified 2-D jitter.
    diagonal_jitter: bool = True
    # Möller-Trumbore with a sign flip: u = dot(-(o - v0), p) / det
    # (src/utils.h:196) — accepts a mirrored barycentric region — and no
    # t > 0 check (src/utils.h:211), so negative-t hits are accepted by the
    # caller (src/raytrace.h:176-186). Clean mode is standard MT with t > eps.
    reference_triangle_test: bool = True
    # Monte-Carlo tangent-to-world transform uses perp_to_both for the y/z
    # rows of the third basis column (src/raytrace.h:123-125) — a skewed frame.
    buggy_tangent_frame: bool = True
    # parseScene never push_backs directional lights (src/scene.cpp:139-163),
    # so every directional-light loop is dead in practice.
    drop_directional_lights: bool = True
    # Triangle hits shade black and spawn no secondary work
    # (src/raytrace.h:221-224).
    triangles_shade_black: bool = True
    # shadow() iterates spheres only — triangles never occlude
    # (src/utils.h:42-76).
    sphere_only_shadows: bool = True
    # Shadow/secondary ray origins offset by a scalar added to every
    # component (src/utils.h:46,64 use 1e-6; src/raytrace.h:128 uses 1e-5)
    # instead of offsetting along the normal.
    scalar_epsilon_offset: bool = True
    # The `spherical_fog` command's sscanf format string starts with "fog"
    # (src/scene.cpp:210) so zero fields convert and the fog is constructed
    # from uninitialized stack floats. Deterministic stand-in here: all-zero
    # fog parameters (the UB cannot be reproduced faithfully).
    fog_sscanf_mismatch: bool = True
    # Reflection/refraction/fresnel are dead code behind an early return
    # (src/raytrace.h:44). Parity mode keeps them off; clean mode traces them.
    disable_reflections: bool = True

    def replace(self, **kw) -> "Quirks":
        return dataclasses.replace(self, **kw)


PARITY = Quirks()
CLEAN = Quirks(
    **{f.name: False for f in dataclasses.fields(Quirks)}
)


@dataclass(frozen=True)
class RenderConfig:
    """One render invocation's static parameters.

    Mirrors `Options` (reference src/utils.h:26-39) plus width/height (CLI
    flags, src/main.cpp:283-313). Defaults match the reference's defaults:
    fov=60, num_paths=1, grid_size=0, max_depth=3 (the README's claimed
    default of 1 contradicts the code — SURVEY.md §2.9 item on Options).
    """

    width: int = 1920
    height: int = 1080
    fov: float = 60.0
    max_depth: int = 3
    # jsample n: n×n samples per pixel; 0 = one center ray (src/main.cpp:71-83)
    grid_size: int = 0
    monte_carlo: bool = False
    num_paths: int = 1  # --gillum
    use_shadows: bool = False
    quirks: Quirks = PARITY
    # The XLA wavefront processes rays in fixed-size chunks (lax.map) to
    # bound device-memory residency: each chunk's [rays, primitives]
    # intermediates scale with it.
    rays_per_chunk: int = 1 << 16
    # Hot-path backend: "jnp" (pure JAX, XLA-fused wavefront) or "pallas"
    # (the whole-frame Triton path-trace kernel, ops/pallas/pathtrace.py).
    # "auto" resolves to pallas on a GPU and jnp elsewhere at dispatch time
    # (resolved()); per-scene gates inside the renderer still take the jnp
    # path where the kernel does not apply.
    backend: str = "auto"
    # Run the Pallas kernel in the Pallas interpreter instead of compiling
    # it for the GPU. Tests set it on machines without a GPU; a pallas
    # backend without it raises there rather than interpreting silently.
    interpret: bool = False

    @property
    def samples_per_pixel(self) -> int:
        g = self.grid_size
        return g * g if g > 0 else 1

    @property
    def paths_per_sample(self) -> int:
        return self.num_paths if self.monte_carlo else 1

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def resolved(self) -> "RenderConfig":
        """Resolve backend="auto" to the platform's path: the Triton kernel
        on a GPU, the XLA-fused jnp wavefront elsewhere. Deterministic per
        process; called once at the render dispatch entry
        (models/renderer.render_ids_chunked)."""
        if self.backend != "auto":
            return self
        import jax

        pallas = jax.default_backend() == "gpu"
        return self.replace(backend="pallas" if pallas else "jnp")


# Distance below which a secondary/shadow intersection is ignored in clean
# mode (the reference's analog is the t <= 1.0 clip, src/utils.h:173).
CLEAN_T_EPS = 1e-4
# Origin offsets used by the reference: shadow rays (src/utils.h:46,64) and
# Monte-Carlo indirect rays (src/raytrace.h:128).
SHADOW_ORIGIN_EPS = 1e-6
INDIRECT_ORIGIN_EPS = 1e-5
# Triangle parallel-ray epsilon (src/utils.h:190).
TRIANGLE_DET_EPS = 1e-5
