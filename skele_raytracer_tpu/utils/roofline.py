"""Speed-of-light (roofline) accounting for renders on the attached GPU.

The reference ships raw `time`(1) logs only (src/time_notes:1-17); this
module supplies the analysis: how close each device program runs to the
hardware ceiling, and WHICH ceiling binds.

* `peaks(device_kind)` — the published peaks of the card JAX reports, from
  one table keyed by `device_kind`. A card that is not in the table is an
  error, never a default.
* `analyze_trace(dir)` — parse a `jax.profiler.trace` capture and, for
  every device op, derive achieved memory bandwidth from the HLO shapes in
  its `long_name`.
* `frame_model(...)` — an analytic per-ray cost model for a render config
  (FLOPs and minimal device-memory traffic), used by bench.py to report a
  speed-of-light block without needing a trace.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
from collections import defaultdict
from dataclasses import dataclass

import numpy as np

# Published peaks, dense (no sparsity), from NVIDIA's H100 Tensor Core GPU
# data sheet. fp32 is the rate outside the tensor cores (the path tracer's
# per-ray arithmetic); tf32/bf16 are the tensor-core rates; hbm is bytes/s.
# The rates assume the card's full power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # H100 SXM5
        "fp32": 67e12, "tf32": 495e12, "bf16": 989e12, "hbm": 3.35e12,
    },
    "NVIDIA H100 PCIe": {
        "fp32": 51e12, "tf32": 378e12, "bf16": 756e12, "hbm": 2.0e12,
    },
}


def peaks(device_kind: str) -> dict:
    """Peak rates of the card named by `jax.devices()[0].device_kind`."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device {device_kind!r}; known: "
            f"{sorted(PEAKS)}") from None


# f32[131072,16]{1,0}  /  pred[512]{0}  /  s32[80,2]
_SHAPE_RE = re.compile(
    r"(f32|f16|bf16|s32|u32|s16|u16|s8|u8|pred|f64|s64|u64)"
    r"\[([0-9,]*)\]"
)

_DTYPE_BYTES = {
    "f64": 8, "s64": 8, "u64": 8,
    "f32": 4, "s32": 4, "u32": 4,
    "f16": 2, "bf16": 2, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1,
}


def op_bytes(long_name: str) -> int:
    """Bytes named by an HLO op's full expression (result shape + operand
    shapes) as found in trace `args.long_name` — one read or write of
    each array."""
    total = 0
    for m in _SHAPE_RE.finditer(long_name):
        dims = [int(x) for x in m.group(2).split(",") if x]
        total += int(np.prod(dims, dtype=np.int64)) * _DTYPE_BYTES[m.group(1)]
    return total


@dataclass
class OpStat:
    name: str
    long_name: str
    total_s: float
    count: int
    bytes: int

    @property
    def gbps(self):
        return self.bytes * self.count / self.total_s / 1e9

    def hbm_pct(self, peak: dict):
        """% of the card's memory-bandwidth speed of light."""
        return 100.0 * self.gbps * 1e9 / peak["hbm"]


def _load_trace_events(trace_dir: str):
    paths = glob.glob(
        os.path.join(trace_dir, "**", "*.trace.json.gz"), recursive=True
    )
    if not paths:
        raise FileNotFoundError(f"no *.trace.json.gz under {trace_dir}")
    with gzip.open(sorted(paths)[-1], "rt") as f:
        return json.load(f)["traceEvents"]


def analyze_trace(trace_dir: str, min_total_s: float = 0.0):
    """Aggregate device-side ops of a jax.profiler capture into OpStats
    sorted by total time (descending). Device planes are the processes
    named `/device:GPU:<n>`."""
    events = _load_trace_events(trace_dir)
    dev_pids = {
        e["pid"]
        for e in events
        if e.get("ph") == "M"
        and e.get("name") == "process_name"
        and "/device:GPU" in str(e.get("args", {}).get("name", ""))
    }
    agg: dict[str, list] = defaultdict(lambda: [0.0, 0, ""])
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in dev_pids:
            continue
        name = e.get("name", "?")
        a = agg[name]
        a[0] += e.get("dur", 0) / 1e6
        a[1] += 1
        if not a[2]:
            a[2] = str(e.get("args", {}).get("long_name", ""))
    out = []
    for name, (tot, cnt, long_name) in agg.items():
        if tot >= min_total_s:
            out.append(OpStat(name, long_name, tot, cnt,
                              op_bytes(long_name) if long_name else 0))
    out.sort(key=lambda s: -s.total_s)
    return out


# ---------------------------------------------------------------------------
# Analytic frame model (no trace needed) — bench.py's `sol` block
# ---------------------------------------------------------------------------


def frame_model(
    *,
    width: int,
    height: int,
    paths: int,
    depth: int,
    s_pad: int,
    samples: int = 1,
):
    """Minimal-work model of one MC frame (sphere scene, parity quirks —
    the headline config).

    FLOPs per ray segment (models/integrator.py one bounce):
      sphere quadratic vs s_pad spheres  ~30 each   (ops/geometry.py)
      nearest-select + material gathers  ~8*s_pad
      threefry2x32 sampling              ~250       (ops/sampling.py)
      frame transform + state update     ~120
    Device-memory bytes, *minimum*: the whole-frame kernel keeps path
    state in registers, so only the sample ids in and the radiance out
    move (16 B per sample), plus the [H, W, 3] image.
    """
    samples_total = width * height * samples
    segments = samples_total * (1 + paths * max(depth - 1, 1))
    flops_per_seg = 30 * s_pad + 8 * s_pad + 250 + 120
    return {
        "segments": segments,
        "flops": segments * flops_per_seg,
        "hbm_bytes_min": samples_total * 16 + width * height * 12,
    }


def sol_summary(model: dict, seconds: float, peak: dict):
    """Achieved fraction of the card's fp32 and memory ceilings, and the
    binding one, for a modelled frame taking `seconds` of device time."""
    flops_s = model["flops"] / seconds
    bw = model["hbm_bytes_min"] / seconds
    fp32, hbm = flops_s / peak["fp32"], bw / peak["hbm"]
    return {
        "achieved_tflops": flops_s / 1e12,
        "fp32_sol_pct": 100 * fp32,
        "hbm_min_gbps": bw / 1e9,
        "hbm_min_pct": 100 * hbm,
        "bound": "fp32" if fp32 > hbm else "hbm",
    }
