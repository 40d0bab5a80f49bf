"""Fixed-topology finite-difference geometry-gradient check (CPU, f64).

The falsifiable version of the north-star pixel-gradient parity check
(BASELINE.md: "pixel-grad parity ... allclose"): freeze EVERY discrete
selection the forward made — the per-bounce hit records AND the
tangent-frame branch bits — and central-difference the differentiable
replay (ops/pallas/pathtrace._replay_chunked) wrt sphere centres. At
fixed topology the pixel function is smooth, so the production backward
(jax.vjp of this replay at these records) must match FD allclose.

Runs as a SUBPROCESS of bench.py on the CPU backend with x64 enabled:
f32 finite differences on a frame-sum loss carry ~0.5% rounding noise at
safe step sizes, which would swamp the 1e-3 target; f64 removes it
without touching the production f32 code paths.

Usage: JAX_PLATFORMS=cpu JAX_ENABLE_X64=1 python tools/fixed_topology_fd.py \
           <npz with rec [K,N] int32 and ga [S,3] f64> '<json config>'
Prints one JSON line: {"geometry_fixed_topology_fd_rel": ..., ...}.
"""

from __future__ import annotations

import json
import sys

import numpy as np

import jax
import jax.numpy as jnp


def main() -> None:
    from skele_raytracer_tpu.config import CLEAN, RenderConfig
    from skele_raytracer_tpu.ops.pallas import pathtrace
    from skele_raytracer_tpu.scene.parser import parse_scene

    data = np.load(sys.argv[1])
    p = json.loads(sys.argv[2])
    cfg = RenderConfig(
        width=p["width"], height=p["height"], monte_carlo=True,
        num_paths=p["paths"], max_depth=p["depth"], use_shadows=True,
        rays_per_chunk=p["chunk"], quirks=CLEAN,
    )
    scene = parse_scene(p["scene"]).to_scene(CLEAN)
    ids = jnp.arange(cfg.height * cfg.width, dtype=jnp.uint32)
    rec = jnp.asarray(data["rec"])
    ga = np.asarray(data["ga"], np.float64)  # production backward grad
    seed = jnp.uint32(p["seed"])

    # Frame-branch bits at the BASE scene, computed in f32 to match the
    # branch decisions the production backward held fixed.
    bits = pathtrace.replay_frame_bits(scene, cfg, seed, ids, rec)

    def to64(s):
        return jax.tree_util.tree_map(
            lambda x: x.astype(jnp.float64)
            if jnp.issubdtype(x.dtype, jnp.floating) else x,
            s,
        )

    scene64 = to64(scene)

    def loss(s):
        r = pathtrace._replay_chunked(s, cfg, seed, ids, rec,
                                      frame_bits=bits)
        img = r.reshape(cfg.height, cfg.width, 3)
        w = jnp.linspace(0.5, 1.5, img.size).reshape(img.shape)
        return jnp.sum(img * w)

    loss_j = jax.jit(loss)
    base = np.asarray(scene64.spheres.center, np.float64)
    mask = np.asarray(scene.spheres.mask) > 0
    eps = float(p.get("eps", 2e-4))

    def at(centers):
        return float(loss_j(scene64.replace(
            spheres=scene64.spheres.replace(center=jnp.asarray(centers)))))

    fd = np.zeros_like(base)
    for i in range(base.shape[0]):
        if not mask[i]:
            continue
        for j in range(base.shape[1]):
            d = np.zeros_like(base)
            d[i, j] = eps
            fd[i, j] = (at(base + d) - at(base - d)) / (2 * eps)

    rel = float(np.linalg.norm((ga - fd)[mask])
                / max(np.linalg.norm(fd[mask]), 1e-9))
    print(json.dumps({
        "geometry_fixed_topology_fd_rel": round(rel, 6),
        "fd_eps": eps,
        "n_params": int(mask.sum()) * base.shape[1],
        "max_abs_err": round(float(np.abs(ga - fd)[mask].max()), 6),
    }))


if __name__ == "__main__":
    main()
