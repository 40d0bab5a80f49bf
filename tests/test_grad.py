"""Differentiability: finite-difference checks on scene parameters.

The north star requires pixel-gradient parity checked by finite differences
on scene params (BASELINE.json). Hit *selection* is discrete and held fixed
(stop_gradient in models/integrator.py), so gradients are exact for
parameters that do not move silhouettes — materials, light colours and
positions, background — and first-order for geometry (sphere centers/radii)
away from silhouette pixels. The tests check both regimes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from skele_raytracer_tpu.config import RenderConfig
from skele_raytracer_tpu.models.renderer import render_radiance
from skele_raytracer_tpu.models.train import full_loss

CFG = RenderConfig(
    width=32,
    height=24,
    monte_carlo=False,
    use_shadows=True,
    rays_per_chunk=1 << 10,
)
CFG_MC = CFG.replace(monte_carlo=True, num_paths=2, max_depth=2)


@pytest.fixture(scope="module")
def scene(parsed_test_scene):
    return parsed_test_scene.to_scene()


from functools import lru_cache


@lru_cache(maxsize=None)
def _loss_fn(cfg):
    def impl(scene):
        # Smooth scalar functional of the image (weights avoid symmetry nulls).
        img = render_radiance(scene, cfg, jnp.uint32(7))
        w = jnp.linspace(0.5, 1.5, img.size).reshape(img.shape)
        return jnp.sum(img * w)

    return jax.jit(impl)


def _loss(scene, cfg):
    return _loss_fn(cfg)(scene)


def _fd_check(scene, cfg, get, put, eps, rtol, what, atol=1e-4):
    """Central finite difference vs autodiff for the leaf selected by
    get/put (get(scene) -> leaf array; put(scene, leaf) -> scene)."""
    grad = jax.grad(lambda s: _loss(s, cfg))(scene)
    g = np.asarray(get(grad))
    base = np.asarray(get(scene), np.float64)
    fd = np.zeros_like(base)
    it = np.ndindex(base.shape)
    for idx in it:
        d = np.zeros_like(base)
        d[idx] = eps
        lp = float(_loss(put(scene, jnp.asarray(base + d, jnp.float32)), cfg))
        lm = float(_loss(put(scene, jnp.asarray(base - d, jnp.float32)), cfg))
        fd[idx] = (lp - lm) / (2 * eps)
    err = np.abs(g - fd)
    tol = atol + rtol * np.abs(fd)
    assert (err <= tol).all(), (
        f"{what}: max err {err.max():.3e} vs fd magnitude {np.abs(fd).max():.3e}\n"
        f"autodiff:\n{g}\nfd:\n{fd}"
    )


def _leaf(path):
    def get(s):
        obj = s
        for p in path:
            obj = getattr(obj, p)
        return obj

    def put(s, v):
        # rebuild nested scene dataclasses immutably
        def rec(obj, i):
            if i == len(path) - 1:
                return obj.replace(**{path[i]: v})
            return obj.replace(**{path[i]: rec(getattr(obj, path[i]), i + 1)})

        return rec(s, 0)

    return get, put


# eps is large (2e-2) because the loss is an f32 sum over the image: central
# differences at eps=1e-3 are dominated by float32 rounding (~loss * 1e-7 /
# eps). Every parameter here enters the image (near-)linearly, so the larger
# step adds no curvature bias.
@pytest.mark.parametrize(
    "path,eps,rtol",
    [
        (("spheres", "diffuse"), 2e-2, 2e-2),
        (("spheres", "specular"), 2e-2, 2e-2),
        (("spheres", "ambient"), 2e-2, 2e-2),
        (("point_lights", "colour"), 2e-2, 2e-2),
        (("background",), 2e-2, 2e-2),
        (("ambient",), 2e-2, 2e-2),
    ],
)
def test_fd_smooth_params(scene, path, eps, rtol):
    get, put = _leaf(path)
    _fd_check(scene, CFG, get, put, eps, rtol, "/".join(path), atol=5e-3)


def test_fd_light_position(scene):
    get, put = _leaf(("point_lights", "position"))
    # Positions move shadows (discrete) — compare without shadows where the
    # dependence is smooth (1/d^2 falloff + half-vector).
    _fd_check(scene, CFG.replace(use_shadows=False), get, put, 1e-2, 5e-2,
              "point_lights/position", atol=2e-2)


def test_fd_sphere_geometry_smooth_part(scene):
    # Geometry gradients: silhouette pixels carry a discrete jump FD sees
    # but stop_gradient'ed hit selection does not. With a coarse image most
    # pixels are interior; require agreement within 15% in aggregate norm.
    cfg = CFG.replace(use_shadows=False)
    grad = jax.grad(lambda s: _loss(s, cfg))(scene)
    g = np.asarray(grad.spheres.center, np.float64)
    get, put = _leaf(("spheres", "center"))
    base = np.asarray(get(scene), np.float64)
    eps = 2e-3
    fd = np.zeros_like(base)
    for idx in np.ndindex(base.shape):
        d = np.zeros_like(base)
        d[idx] = eps
        lp = float(_loss(put(scene, jnp.asarray(base + d, jnp.float32)), cfg))
        lm = float(_loss(put(scene, jnp.asarray(base - d, jnp.float32)), cfg))
        fd[idx] = (lp - lm) / (2 * eps)
    num = np.linalg.norm(g - fd)
    den = max(np.linalg.norm(fd), 1e-9)
    assert num / den < 0.15, (num / den, g, fd)


def test_grad_flows_through_mc_path(scene):
    g = jax.grad(lambda s: _loss(s, CFG_MC))(scene)
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves)
    # Indirect bounce must contribute: diffuse grads nonzero.
    assert np.abs(np.asarray(g.spheres.diffuse)).max() > 0


def test_grad_no_nans_with_shadows_and_mc(scene):
    target = jnp.zeros((CFG_MC.height, CFG_MC.width, 3))
    g = jax.grad(lambda s: full_loss(s, CFG_MC, jnp.uint32(1), target))(scene)
    for leaf in jax.tree_util.tree_leaves(g):
        assert np.isfinite(np.asarray(leaf)).all()
