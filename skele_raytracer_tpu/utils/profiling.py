"""Observability: structured render metrics and profiler traces.

The reference's only instrumentation is printf banners and external
`time`(1) runs captured in src/time_notes (SURVEY §5). Here every render
can report structured metrics — wall time per stage, rays/sec/chip,
effective ray counts — and wrap itself in a `jax.profiler` trace for
XLA-level analysis.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import jax


@dataclass
class RenderStats:
    """Accumulated metrics for one render/optimization run."""

    width: int = 0
    height: int = 0
    samples_per_pixel: int = 1
    paths_per_sample: int = 1
    max_depth: int = 1
    stages: Dict[str, float] = field(default_factory=dict)
    device: str = ""

    @property
    def primary_rays(self) -> int:
        return self.width * self.height * self.samples_per_pixel

    @property
    def effective_rays(self) -> int:
        """Shade evaluations per frame: one primary + paths * (depth-1)
        continuations per sample (models/integrator.py wavefront)."""
        bounces = max(self.max_depth - 1, 0)
        return self.primary_rays * (1 + self.paths_per_sample * bounces)

    def rays_per_sec(self, stage: str = "render") -> float:
        dt = self.stages.get(stage, 0.0)
        return self.effective_rays / dt if dt > 0 else 0.0

    def to_json(self) -> str:
        return json.dumps(
            {
                "resolution": [self.width, self.height],
                "spp": self.samples_per_pixel,
                "paths": self.paths_per_sample,
                "max_depth": self.max_depth,
                "effective_rays": self.effective_rays,
                "stages_s": {k: round(v, 5) for k, v in self.stages.items()},
                "rays_per_sec": round(self.rays_per_sec()),
                "device": self.device,
            }
        )


@contextlib.contextmanager
def stage(stats: RenderStats, name: str):
    """Time a stage; accumulates into stats.stages[name]."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats.stages[name] = stats.stages.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """jax.profiler trace if log_dir is given, else a no-op."""
    if log_dir:
        with jax.profiler.trace(log_dir):
            yield
    else:
        yield


def timed_render(render_fn, cfg, *args, trace_dir: Optional[str] = None):
    """Run `render_fn(*args)`, returning (image, RenderStats)."""
    stats = RenderStats(
        width=cfg.width,
        height=cfg.height,
        samples_per_pixel=cfg.samples_per_pixel,
        paths_per_sample=cfg.paths_per_sample,
        max_depth=cfg.max_depth,
        device=str(jax.devices()[0]),
    )
    with profiler_trace(trace_dir):
        with stage(stats, "render"):
            img = jax.block_until_ready(render_fn(*args))
    return img, stats
