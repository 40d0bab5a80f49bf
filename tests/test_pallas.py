"""backend="pallas" through the user-facing entry points: the whole-frame
Triton path-trace kernel (run in the Pallas interpreter here) under
shard_map and under jax.grad, vs the jnp backend."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from skele_raytracer_tpu.config import CLEAN, RenderConfig
from skele_raytracer_tpu.models.renderer import render_radiance
from skele_raytracer_tpu.ops.pallas import pathtrace


def test_pallas_backend_under_shard_map(parsed_test_scene):
    """backend='pallas' inside render_sharded (shard_map needs
    check_vma=False for pallas_call outputs) must match the unsharded
    render."""
    from skele_raytracer_tpu.models.renderer import render
    from skele_raytracer_tpu.parallel.api import render_sharded

    scene = parsed_test_scene.to_scene(CLEAN)
    cfg = RenderConfig(
        width=24, height=16, use_shadows=True, monte_carlo=True,
        num_paths=2, max_depth=1, quirks=CLEAN, rays_per_chunk=1 << 9,
        backend="pallas", interpret=True,
    )
    assert pathtrace.use_pathtrace(scene, cfg)
    a = np.asarray(render(scene, cfg, seed=2))
    b = np.asarray(render_sharded(scene, cfg, seed=2))
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_pallas_backend_is_differentiable(parsed_test_scene):
    """backend='pallas' + jax.grad must work (the kernel is forward-only;
    the custom_vjp replays the saved hit records in XLA) and agree with
    the jnp backend's gradients."""
    scene = parsed_test_scene.to_scene(CLEAN)
    cfg = RenderConfig(
        width=24, height=16, use_shadows=True, monte_carlo=True,
        num_paths=1, max_depth=1, quirks=CLEAN, rays_per_chunk=1 << 9,
        interpret=True,
    )
    assert pathtrace.use_pathtrace(scene, cfg.replace(backend="pallas"))

    def loss(s, backend):
        img = render_radiance(s, cfg.replace(backend=backend), jnp.uint32(3))
        w = jnp.linspace(0.5, 1.5, img.size).reshape(img.shape)
        return jnp.sum(img * w)

    with jax.default_matmul_precision("highest"):
        g_jnp = jax.grad(lambda s: loss(s, "jnp"))(scene)
        g_pl = jax.grad(lambda s: loss(s, "pallas"))(scene)
    for a, b in zip(
        jax.tree_util.tree_leaves(g_jnp), jax.tree_util.tree_leaves(g_pl)
    ):
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-3, atol=1e-4
        )


@pytest.mark.slow
def test_pallas_backend_renders_same_image(parsed_test_scene):
    scene = parsed_test_scene.to_scene()
    base = RenderConfig(
        width=32, height=24, use_shadows=True, monte_carlo=True,
        num_paths=2, max_depth=2, rays_per_chunk=1 << 10,
    )
    img_jnp = np.asarray(render_radiance(scene, base, jnp.uint32(4)))
    img_pl = np.asarray(render_radiance(
        scene, base.replace(backend="pallas", interpret=True), jnp.uint32(4)))
    close = np.isclose(img_jnp, img_pl, rtol=1e-4, atol=1e-4)
    assert close.mean() > 0.995, f"{(~close).sum()} px differ"
