"""Golden-image parity vs the reference binary's actual output.

Two golden sources:

1. `renders/testcpu.ppm` of a checkout of the reference — the only
   machine-readable render the reference SHIPS (SURVEY §4): dragon.scn
   at the `--parallel true` hardcodes (640x480, depth 1, no supersampling
   — reference src/main.cpp:21-24). The tests that read it run only when
   SKT_REFERENCE_DIR names a reference checkout, and skip otherwise.

2. `tests/goldens/*.ppm.gz` — renders produced by BUILDING AND RUNNING
   the reference binary here (tools/make_goldens.sh: SDL no-op stub for
   the unused visual path; two pieces of undefined behavior pinned to
   the code's evident intent and documented there — notably
   `bool use_shadows;` at src/main.cpp:244 is UNINITIALIZED, which on
   this build made `--shadow` a no-op and every render shadowed). These
   cover spheres1/spheres2/test/dragon across shadow on/off, the fog
   scene, and one serial-path render at a non-hardcoded resolution.

All configs are deterministic (no rand(): no jitter, no Monte-Carlo —
the reference seeds libc rand with time(0), src/main.cpp:400, so
stochastic configs cannot be compared pixelwise). Each test checks a
20k-pixel random sample so CI stays fast on the CPU brute-force path;
tolerance: >=99.5% byte-identical pixels (differences concentrate at
silhouette/grazing pixels where one float ulp flips the quantized byte).
"""

import gzip
import os
import tempfile

import numpy as np
import pytest

import jax.numpy as jnp

from skele_raytracer_tpu.config import RenderConfig
from skele_raytracer_tpu.models.renderer import render_ids_chunked
from skele_raytracer_tpu.scene.parser import parse_scene
from skele_raytracer_tpu.utils.image import quantize, read_ppm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
SCENES = os.path.join(REPO, "scenes")


def reference_render(name="testcpu.ppm"):
    """Path of a render shipped with the reference checkout named by
    SKT_REFERENCE_DIR; skips the calling test when the variable is unset
    or the render is absent."""
    root = os.environ.get("SKT_REFERENCE_DIR")
    if not root:
        pytest.skip("SKT_REFERENCE_DIR is unset (set it to a checkout of "
                    "the reference to compare with its shipped render)")
    path = os.path.join(root, "renders", name)
    if not os.path.exists(path):
        pytest.skip(f"reference render {path} not present")
    return path


def _read_ppm_gz(name):
    raw = gzip.decompress(open(os.path.join(GOLDEN_DIR, name), "rb").read())
    with tempfile.TemporaryDirectory() as td:
        tmp = os.path.join(td, name[:-3])
        with open(tmp, "wb") as f:
            f.write(raw)
        return read_ppm(tmp)


def _check_sampled(ref, scene_file, cfg, min_exact=0.995, seed=0,
                   n_sample=20000):
    h, w = ref.shape[:2]
    scene = parse_scene(scene_file).to_scene(cfg.quirks)
    rng = np.random.default_rng(seed)
    n = min(n_sample, h * w)
    pix = rng.choice(h * w, size=n, replace=False).astype(np.uint32)
    radiance = np.asarray(
        render_ids_chunked(scene, cfg, jnp.uint32(0), jnp.asarray(pix))
    )
    ours = quantize(radiance.reshape(-1, 1, 3)).reshape(-1, 3)
    theirs = ref.reshape(-1, 3)[pix]
    exact = (ours == theirs).all(axis=1).mean()
    assert exact > min_exact, (
        f"only {exact:.4%} of sampled pixels byte-identical"
    )


def test_dragon_matches_reference_golden():
    cfg = RenderConfig(
        width=640, height=480, max_depth=1, use_shadows=False,
        rays_per_chunk=1 << 12,
    )
    _check_sampled(read_ppm(reference_render()),
                   os.path.join(SCENES, "dragon.scn"), cfg)


# (golden file, scene, shadows, w, h, depth) — all parity-mode, fov 60.
REF_BINARY_CASES = [
    ("spheres1_bp.ppm.gz", "spheres1.scn", False, 640, 480, 1),
    ("spheres1_bp_shadows.ppm.gz", "spheres1.scn", True, 640, 480, 1),
    # spheres2 carries the spherical_fog line: verifies the parity
    # zero-fog reroute (config.Quirks.fog_sscanf_mismatch) against the
    # UB-pinned binary end to end.
    ("spheres2_bp.ppm.gz", "spheres2.scn", False, 640, 480, 1),
    ("spheres2_bp_shadows.ppm.gz", "spheres2.scn", True, 640, 480, 1),
    # test.scn: triangles-shade-black + unknown-command skips
    # (max_vertices/max_normals/spot_light).
    ("test_bp_shadows.ppm.gz", "test.scn", True, 640, 480, 1),
    ("dragon_bp_shadows.ppm.gz", "dragon.scn", True, 640, 480, 1),
    # Serial path: honors width/height/depth (no 640x480 hardcode).
    ("spheres1_serial_160.ppm.gz", "spheres1.scn", True, 160, 120, 3),
]


@pytest.mark.parametrize(
    "golden,scn,shadow,w,h,depth", REF_BINARY_CASES,
    ids=[c[0][:-7] for c in REF_BINARY_CASES],
)
def test_matches_rebuilt_reference_binary(golden, scn, shadow, w, h, depth):
    ref = _read_ppm_gz(golden)
    assert ref.shape == (h, w, 3)
    cfg = RenderConfig(
        width=w, height=h, max_depth=depth, use_shadows=shadow,
        rays_per_chunk=1 << 14, backend="jnp",
    )
    # Dragon is the CPU brute-force [rays, 10002-triangle] path — a
    # smaller sample keeps the default suite fast (the 20k-pixel dragon
    # audit is test_dragon_matches_reference_golden above).
    n = 6000 if scn == "dragon.scn" else 20000
    _check_sampled(ref, os.path.join(SCENES, scn), cfg, n_sample=n)


# ---------------------------------------------------------------------------
# STOCHASTIC configs — the configurations BASELINE.md actually times
# (jsample-5 / gillum-16, reference README.md:40-51, src/time_notes:3-8).
# Their pixels depend on libc rand(), so bytes cannot match; instead
# tools/make_stochastic_goldens.sh pins srand via a time() LD_PRELOAD
# shim, renders N=8 seeds through the reference's SERIAL path (single
# thread -> deterministic rand() stream per seed; the OpenMP path races
# rand() across threads and cannot be pinned), and stores the per-pixel
# mean/variance of the quantized frames. The framework implements the
# same estimator with its threefry RNG, so M framework seeds must agree
# with the reference IN MEAN within the measured Monte-Carlo standard
# error.
# ---------------------------------------------------------------------------

# (npz, scene, cfg overrides, sampled pixel count)
STOCHASTIC_CASES = [
    ("spheres1_jsample5_shadows_160.npz", "spheres1.scn",
     dict(width=160, height=120, grid_size=5, max_depth=1,
          use_shadows=True), 2000),
    ("spheres1_gillum16_shadows_160.npz", "spheres1.scn",
     dict(width=160, height=120, monte_carlo=True, num_paths=16,
          max_depth=2, use_shadows=True), 4000),
    ("spheres2_gillum16_shadows_128.npz", "spheres2.scn",
     dict(width=128, height=96, monte_carlo=True, num_paths=16,
          max_depth=2, use_shadows=True), 4000),
    ("spheres2_jsample5_shadows_128.npz", "spheres2.scn",
     dict(width=128, height=96, grid_size=5, max_depth=1,
          use_shadows=True), 2000),
]


@pytest.mark.parametrize(
    "golden,scn,params,n_pix", STOCHASTIC_CASES,
    ids=[c[0][:-4] for c in STOCHASTIC_CASES],
)
def test_stochastic_mean_matches_reference_binary(golden, scn, params, n_pix):
    data = np.load(os.path.join(GOLDEN_DIR, golden))
    mu_r = data["mean"].astype(np.float64)
    var_r = data["var"].astype(np.float64)
    n_ref = int(data["n"])
    cfg = RenderConfig(rays_per_chunk=1 << 14, backend="jnp", **params)
    assert mu_r.shape == (cfg.height, cfg.width, 3)
    scene = parse_scene(os.path.join(SCENES, scn)).to_scene(cfg.quirks)

    # Random pixel subset (all spp samples of each chosen pixel, so the
    # per-pixel supersample mean + quantization matches the PPM pipeline).
    spp = cfg.samples_per_pixel
    rng = np.random.default_rng(1)
    pix = np.sort(rng.choice(cfg.height * cfg.width, size=n_pix,
                             replace=False)).astype(np.uint32)
    ids = (pix[:, None] * spp + np.arange(spp, dtype=np.uint32)).ravel()
    ids = jnp.asarray(ids)

    M = 8
    frames = []
    for k in range(M):
        radiance = np.asarray(
            render_ids_chunked(scene, cfg, jnp.uint32(k), ids)
        ).reshape(n_pix, spp, 3).mean(axis=1)
        frames.append(
            quantize(radiance.reshape(-1, 1, 3)).reshape(-1, 3)
            .astype(np.float64)
        )
    mu_f = np.stack(frames).mean(0)

    mu_r_s = mu_r.reshape(-1, 3)[pix]
    var_s = var_r.reshape(-1, 3)[pix]
    # 3-sigma on the difference of two sample means (+1 LSB quantization
    # slack); the 8-run variance estimate is itself noisy, so allow a
    # small tail beyond the pointwise bound but require it to be tiny.
    se = np.sqrt(var_s * (1.0 / n_ref + 1.0 / M))
    bad = np.abs(mu_r_s - mu_f) > 3.0 * se + 1.0
    assert bad.mean() <= 0.01, (
        f"{bad.mean():.3%} of channel values outside 3 sigma "
        f"(max |diff| {np.abs(mu_r_s - mu_f).max():.2f})"
    )
    # Aggregate bias: the global mean must agree far inside one byte.
    assert abs(mu_r_s.mean() - mu_f.mean()) < 0.25, (
        mu_r_s.mean(), mu_f.mean()
    )
