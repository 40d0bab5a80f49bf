"""Inverse-rendering fit loop: convergence, checkpoint/resume, scaling."""

import numpy as np

import jax
import jax.numpy as jnp

from skele_raytracer_tpu.config import RenderConfig
from skele_raytracer_tpu.models import train
from skele_raytracer_tpu.models.renderer import render_radiance
from skele_raytracer_tpu.parallel.multihost import scaling_report

CFG = RenderConfig(width=24, height=16, use_shadows=False, rays_per_chunk=1 << 9)


def _two_scene(parsed_test_scene, diffuse_scale):
    scene = parsed_test_scene.to_scene()
    return scene.replace(
        spheres=scene.spheres.replace(diffuse=scene.spheres.diffuse * diffuse_scale)
    )


def test_fit_recovers_material(parsed_test_scene, tmp_path):
    target_scene = _two_scene(parsed_test_scene, 1.0)
    target = np.asarray(render_radiance(target_scene, CFG, jnp.uint32(0)))
    start = _two_scene(parsed_test_scene, 0.5)  # wrong diffuse

    fitted, losses = train.fit(
        start, CFG, jnp.asarray(target), steps=40, learning_rate=5e-3,
        log_every=0, checkpoint_dir=str(tmp_path / "ckpt"), checkpoint_every=10,
    )
    assert losses[-1] < losses[0] * 0.35, losses[::10]
    # The RENDER converges to the target (parameter recovery itself is
    # ill-posed: ambient/specular can compensate for diffuse).
    img0 = np.asarray(render_radiance(start, CFG, jnp.uint32(0)))
    img1 = np.asarray(render_radiance(fitted, CFG, jnp.uint32(0)))
    e0 = np.abs(img0 - target).mean()
    e1 = np.abs(img1 - target).mean()
    assert e1 < e0 * 0.7, (e0, e1)


def test_fit_resumes_from_checkpoint(parsed_test_scene, tmp_path):
    scene = _two_scene(parsed_test_scene, 0.6)
    target = np.asarray(render_radiance(parsed_test_scene.to_scene(), CFG, jnp.uint32(0)))
    ckpt = str(tmp_path / "ckpt")

    _, losses_a = train.fit(
        scene, CFG, jnp.asarray(target), steps=6, learning_rate=1e-2,
        log_every=0, checkpoint_dir=ckpt, checkpoint_every=3,
    )
    # Second call continues from step 6 (checkpointed) to 10: only 4 steps run.
    _, losses_b = train.fit(
        scene, CFG, jnp.asarray(target), steps=10, learning_rate=1e-2,
        log_every=0, checkpoint_dir=ckpt, checkpoint_every=100,
    )
    assert len(losses_a) == 6
    assert len(losses_b) == 4


def test_checkpoint_roundtrip(parsed_test_scene, tmp_path):
    from skele_raytracer_tpu.utils import checkpoint as ckpt

    scene = parsed_test_scene.to_scene()
    tx = train.make_optimizer(1e-2)
    state = train.init_state(scene, tx)._replace(step=jnp.int32(7))
    path = ckpt.save(str(tmp_path), state)
    assert "00000007" in path
    restored = ckpt.restore_latest(str(tmp_path), state)
    for a, b in zip(
        jax.tree_util.tree_leaves(state), jax.tree_util.tree_leaves(restored)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_is_npz_keyed_by_leaf_path(parsed_test_scene, tmp_path):
    """One .npz per step, one array per leaf keyed by its pytree path."""
    from skele_raytracer_tpu.utils import checkpoint as ckpt

    state = train.init_state(parsed_test_scene.to_scene(),
                             train.make_optimizer(1e-2))
    path = ckpt.save(str(tmp_path), state._replace(step=jnp.int32(3)))
    assert path.endswith("step_00000003.npz")
    with np.load(path) as data:
        np.testing.assert_array_equal(
            data[".scene.spheres.center"], np.asarray(state.scene.spheres.center))
        assert len(data.files) == len(jax.tree_util.tree_leaves(state))


def test_checkpoint_rejects_other_tree(parsed_test_scene, tmp_path):
    """Restoring against a template whose leaves differ (a scene with
    another sphere count) is an error, not a silent reshape."""
    import pytest

    from skele_raytracer_tpu.utils import checkpoint as ckpt

    tx = train.make_optimizer(1e-2)
    ckpt.save(str(tmp_path), train.init_state(parsed_test_scene.to_scene(), tx))
    other = parsed_test_scene.to_scene(pad_multiple=16)
    with pytest.raises(ValueError, match="leaf"):
        ckpt.restore_latest(str(tmp_path), train.init_state(other, tx))


def test_scaling_report_runs(parsed_test_scene):
    scene = parsed_test_scene.to_scene()
    rows = scaling_report(scene, CFG, device_counts=[1, 4, 8], iters=1)
    assert [r["devices"] for r in rows] == [1, 4, 8]
    assert all(r["rays_per_sec"] > 0 for r in rows)
    assert rows[0]["efficiency"] == 1.0


def test_trainable_mask_paths(parsed_test_scene):
    scene = parsed_test_scene.to_scene()
    m = train.make_trainable_mask(scene, ("spheres.diffuse", "background"))
    on = {
        jax.tree_util.keystr(p)
        for p, l in jax.tree_util.tree_leaves_with_path(m)
        if float(jnp.abs(l).max()) > 0
    }
    assert on == {".spheres.diffuse", ".background"}, on


def test_masked_step_freezes_other_leaves(parsed_test_scene):
    scene = parsed_test_scene.to_scene()
    tx = train.make_optimizer(1e-2)
    state = train.init_state(scene, tx)
    mask = train.make_trainable_mask(scene, ("spheres.diffuse",))
    target = jnp.zeros((CFG.height, CFG.width, 3))
    import functools

    step = jax.jit(functools.partial(train.train_step, cfg=CFG, tx=tx))
    new_state, _ = step(state, key=jnp.uint32(0), target=target, trainable=mask)
    moved = np.abs(
        np.asarray(new_state.scene.spheres.diffuse - scene.spheres.diffuse)
    ).max()
    frozen = np.abs(
        np.asarray(new_state.scene.spheres.center - scene.spheres.center)
    ).max()
    assert moved > 0 and frozen == 0, (moved, frozen)
