"""Multi-process (multi-"host") execution: the only parallel surface the
virtual single-process mesh cannot exercise.

Spawns a real 2-process jax.distributed cluster on CPU (4 virtual devices
per process, 8 global — the standard multi-host recipe at miniature scale,
parallel/multihost.py) and asserts the distributed render equals the
single-process 8-device render, with `gather_image` assembling the frame
on process 0 only.
"""

import os
import socket
import subprocess
import sys

import numpy as np

from conftest import TEST_SCN


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_env(n_local: int) -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_local}"
    # Keep the repo importable from the worker script's directory.
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo
    return env


def test_two_process_distributed_render(tmp_path):
    scn = tmp_path / "scene.scn"
    scn.write_text(TEST_SCN)
    out = tmp_path / "frame.npy"
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), str(port), str(scn), str(out)],
            env=_worker_env(4),
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se}"

    dist = np.load(out)

    # Single-process 8-device reference (this pytest process IS on an
    # 8-device CPU mesh via conftest).
    import jax
    import jax.numpy as jnp

    from skele_raytracer_tpu.config import RenderConfig
    from skele_raytracer_tpu.parallel.api import make_mesh, render_radiance_sharded
    from skele_raytracer_tpu.scene.parser import parse_scene_text

    scene = parse_scene_text(TEST_SCN).to_scene()
    cfg = RenderConfig(width=24, height=16, use_shadows=True, rays_per_chunk=1 << 9)
    mesh = make_mesh()
    ref = np.asarray(
        jax.jit(lambda s, k: render_radiance_sharded(s, cfg, k, mesh))(
            scene, jnp.uint32(0)
        )
    )
    # Same ray ids, same counter-based RNG, same chunking -> the frames
    # must agree to float tolerance (reduction tiling may differ).
    np.testing.assert_allclose(dist, ref, rtol=0, atol=1e-5)


def test_two_process_distributed_train_step(tmp_path):
    """The design's ONE collective — the gradient psum in
    parallel/api.loss_and_grad_sharded — exercised across a REAL process
    boundary: one train_step on a 2-process jax.distributed cluster must
    produce the same loss and updated parameters as the single-process
    8-device mesh (SURVEY §2.3 communication-backend row)."""
    scn = tmp_path / "scene.scn"
    scn.write_text(TEST_SCN)
    out = tmp_path / "trained.npz"
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")

    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), str(port), str(scn), str(out),
             "train"],
            env=_worker_env(4),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{so}\n{se}"
    dist = np.load(str(out))

    # Single-process 8-device reference of the identical step.
    from functools import partial

    import jax
    import jax.numpy as jnp

    from skele_raytracer_tpu.config import RenderConfig
    from skele_raytracer_tpu.models import train
    from skele_raytracer_tpu.parallel.api import make_mesh
    from skele_raytracer_tpu.scene.parser import parse_scene_text

    scene = parse_scene_text(TEST_SCN).to_scene()
    cfg = RenderConfig(width=24, height=16, use_shadows=True,
                       rays_per_chunk=1 << 9)
    tx = train.make_optimizer(1e-2)
    state = train.init_state(scene, tx)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    step_fn = jax.jit(
        partial(train.train_step, cfg=cfg, tx=tx, mesh=make_mesh()))
    state, loss = step_fn(state, key=jnp.uint32(3), target=target)

    assert np.isfinite(dist["loss"]) and dist["loss"] > 0
    np.testing.assert_allclose(dist["loss"], np.asarray(loss), rtol=1e-6)
    for k, ref_leaf in (
        ("diffuse", state.scene.spheres.diffuse),
        ("center", state.scene.spheres.center),
        ("light", state.scene.point_lights.colour),
    ):
        np.testing.assert_allclose(
            dist[k], np.asarray(ref_leaf), rtol=0, atol=1e-6)
    # the step actually moved parameters
    assert not np.array_equal(dist["diffuse"],
                              np.asarray(scene.spheres.diffuse))
