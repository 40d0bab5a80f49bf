"""Multi-host execution: runtime init + host-spanning render/train.

The reference has no multi-process capability at all (SURVEY §2.3); its
scaling ceiling is one machine's OpenMP threads. This framework scales
across hosts with the standard JAX multi-controller recipe:

* every host runs the SAME program and calls `initialize()` once;
* the global mesh spans all hosts' devices ("tiles" x "samples",
  parallel/api.py); ray ids are sharded over it, so each host renders the
  tiles its devices own — the analog of the reference's per-row OpenMP
  split, but across machines with zero communication in the forward pass;
* gradient all-reduce (`psum` in loss_and_grad_sharded) is one
  collective; XLA picks the transport (NVLink within a host, the network
  across hosts);
* `gather_image` brings the frame to host 0 for IO, the only host
  transfer in the pipeline.

Single-host multi-device (and the CPU-simulated mesh used in tests) needs
no initialize(); everything below degrades gracefully to one process.

Scaling methodology (no cluster is attached to CI): the sharding-invariance
tests prove the N-device program computes the identical frame, and
`scaling_report()` measures throughput on 1..N local devices; the
multi-host path is the same program with `jax.devices()` spanning hosts.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import jax
import numpy as np

from skele_raytracer_tpu.config import RenderConfig
from skele_raytracer_tpu.parallel.api import make_mesh, render_radiance_sharded


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Start the JAX distributed runtime (jax.distributed.initialize).

    Pass the coordinator address (`host:port`), process count and this
    process's id explicitly unless a cluster environment JAX detects
    provides them. No-op if already initialized.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError:
        pass  # already initialized


def is_primary() -> bool:
    return jax.process_index() == 0


def global_mesh(axis_sizes=None):
    """Mesh over every device of every host (jax.devices() is global)."""
    return make_mesh(jax.devices(), axis_sizes)


def gather_image(img) -> Optional[np.ndarray]:
    """Assemble the full frame on host 0 (None elsewhere). The only
    host-device transfer of the render pipeline."""
    from jax.experimental import multihost_utils

    if jax.process_count() > 1:
        img = multihost_utils.process_allgather(img, tiled=True)
    return np.asarray(img) if is_primary() else None


def scaling_report(
    scene,
    cfg: RenderConfig,
    seed: int = 0,
    device_counts: Optional[Sequence[int]] = None,
    iters: int = 3,
):
    """Throughput at 1..N devices + scaling efficiency vs 1 device.

    Returns a list of dicts: {devices, seconds, rays_per_sec, efficiency}.
    Run on a CPU-simulated mesh in tests; on real hardware it is the
    measurement harness for the >= 90% scaling-efficiency target.
    """
    import jax.numpy as jnp

    n_all = len(jax.devices())
    counts = list(device_counts or [c for c in (1, 2, 4, 8, 16, 32) if c <= n_all])
    rays = cfg.height * cfg.width * cfg.samples_per_pixel
    rows = []
    for n in counts:
        mesh = make_mesh(jax.devices()[:n])
        fn = jax.jit(
            lambda s, k, m=mesh: render_radiance_sharded(s, cfg, k, m)
        )
        jax.block_until_ready(fn(scene, jnp.uint32(seed)))  # compile
        t0 = time.perf_counter()
        for _ in range(iters):
            jax.block_until_ready(fn(scene, jnp.uint32(seed)))
        dt = (time.perf_counter() - t0) / iters
        rows.append(dict(devices=n, seconds=dt, rays_per_sec=rays / dt))
    # Normalize by PER-DEVICE throughput of the smallest run so efficiency
    # is meaningful even when device_counts doesn't start at 1 (e.g.
    # [2, 4, 8]): efficiency = per-device throughput relative to the
    # smallest count's per-device throughput.
    base_per_device = rows[0]["rays_per_sec"] / rows[0]["devices"]
    for r in rows:
        r["efficiency"] = r["rays_per_sec"] / (base_per_device * r["devices"])
    return rows
