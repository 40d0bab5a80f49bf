"""Smoke test of the renderer's main path on one NVIDIA GPU (or four).

Runs the reference's timed configuration — spheres2.scn at 1920x1080,
`--gillum 16 --depth 2 --shadow`, parity mode — through the entry points
a user calls (`render`, `render_frames`, the CLI, `train.full_loss`,
`train.fit`), with every kernel compiled for the card, and checks each
result against the plain jnp/XLA path or the reference binary's goldens.
Phases run in order and the script stops at the first failure:

  0. the card: nvidia-smi name and power limit; JAX's platform is "gpu"
  1. the `gpu`-marked tests, in a child pytest (before this process
     touches the card, so one process holds it at a time)
  2. compile-only check of the Triton kernel at the headline shape
  3. headline forward: kernel vs XLA, both timed; the CLI
  4. forward+backward: kernel records + XLA replay vs jax.grad through
     the jnp wavefront, both timed
  5. clean spheres2 (fog shaded in the kernel) vs XLA; render_frames K=16
  6. the reference-binary goldens at full frame
  7. dragon 640x480 (XLA triangle scan): time and peak memory
  8. train.fit: 5 steps at 512x512 with checkpoint and resume

`--four-cards` runs only the multi-device path (render_sharded and one
loss_and_grad_sharded step on a 4-card mesh) and what it is compared with.

Usage: python chip_smoke.py [--four-cards]
The last line of stdout is one JSON object naming the device.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(REPO, "scenes")
GOLDENS = os.path.join(REPO, "tests", "goldens")
CARD = ""


def log(msg: str) -> None:
    print(f"[{CARD}] {msg}", flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def phase0_card(n_cards: int) -> None:
    global CARD
    if not os.path.isdir(os.path.join(REPO, "skele_raytracer_tpu")):
        fail("run chip_smoke.py from a checkout of the repository")
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except FileNotFoundError:
        fail("nvidia-smi not found: no NVIDIA GPU on this machine")
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    lines = smi.stdout.strip().splitlines()
    CARD = lines[0].strip()
    print(CARD, flush=True)
    # JAX's view, from a child that releases the card when it exits
    probe = subprocess.run(
        [sys.executable, "-c",
         "import jax; d = jax.devices(); "
         "print(d[0].platform, len(d), d[0].device_kind)"],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "XLA_PYTHON_CLIENT_PREALLOCATE": "false"})
    check(probe.returncode == 0, f"JAX found no device: {probe.stderr[-500:]}")
    platform, count, kind = probe.stdout.strip().split(maxsplit=2)
    check(platform == "gpu", f"JAX platform is {platform!r}, not 'gpu'")
    check(int(count) >= n_cards, f"{count} GPU(s) visible, {n_cards} needed")
    log(f"phase 0: JAX sees {count} x {kind}")


def phase1_gpu_tests() -> None:
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", os.path.join(REPO, "tests"),
         "-m", "gpu", "-o", "addopts=", "-q", "-p", "no:cacheprovider"],
        cwd=REPO, env={**os.environ, "JAX_PLATFORMS": "cuda"},
        capture_output=True, text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-1:] or [""]
    check(r.returncode == 0,
          f"gpu-marked tests failed (rc {r.returncode}):\n"
          f"{r.stdout[-3000:]}\n{r.stderr[-2000:]}")
    log(f"phase 1: gpu tests: {tail[0]} ({time.perf_counter() - t0:.1f} s)")


# ---------------------------------------------------------------------------
# Phases 2-8 run in this process, after it imports JAX.
# ---------------------------------------------------------------------------


def timed(fn, *args, n=5):
    """(median seconds, all runs) of fn(*args), warm, each run ending in
    block_until_ready."""
    import jax
    import numpy as np

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def compare_frames(a, b, what):
    """The kernel-vs-XLA rule (tests/test_pathtrace.py): at most 0.5% of
    values beyond atol 1e-4 — transcendental lowering and FMA contraction
    flip grazing hits by 1 ulp — and frame means within 5e-4."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    check(a.shape == b.shape, f"{what}: shapes {a.shape} vs {b.shape}")
    check(np.isfinite(a).all(), f"{what}: non-finite values")
    err = np.abs(a - b)
    frac = float((err > 1e-4).mean())
    dmean = float(np.abs(a.reshape(-1, 3).mean(0)
                         - b.reshape(-1, 3).mean(0)).max())
    log(f"{what}: {frac:.5%} of values beyond 1e-4 (limit 0.5%), "
        f"max |diff| {err.max():.3e}, frame-mean diff {dmean:.2e} "
        "(limit 5e-4)")
    check(frac <= 0.005 and dmean <= 5e-4, f"{what}: outside tolerance")


def compare_grads(ga, gb, what):
    """Gradient rule: every leaf allclose at rtol 1e-3, atol 1e-5 (the same
    estimator differentiated at the same hit structure; only summation
    order and FMA contraction differ)."""
    import jax
    import numpy as np

    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(ga),
                            jax.tree_util.tree_leaves(gb)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        check(np.isfinite(a).all(), f"{what}: non-finite gradient")
        if not (np.abs(a - b) <= 1e-5 + 1e-3 * np.abs(b)).all():
            fail(f"{what}: leaf {jax.tree_util.keystr(path)} beyond rtol "
                 f"1e-3 / atol 1e-5 (max |diff| {np.abs(a - b).max():.3e})")
    log(f"{what}: all leaves within rtol 1e-3, atol 1e-5")


def single_card(results: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from skele_raytracer_tpu import cli
    from skele_raytracer_tpu.config import CLEAN, RenderConfig
    from skele_raytracer_tpu.models import train
    from skele_raytracer_tpu.models.renderer import (
        render,
        render_frames,
        render_radiance,
    )
    from skele_raytracer_tpu.scene.parser import parse_scene
    from skele_raytracer_tpu.utils.image import quantize, read_ppm

    dev = jax.devices()[0]
    spheres2 = parse_scene(os.path.join(SCENES, "spheres2.scn"))
    head = RenderConfig(width=1920, height=1080, monte_carlo=True,
                        num_paths=16, max_depth=2, use_shadows=True)
    check(head.resolved().backend == "pallas", "auto backend is not pallas")
    scene = spheres2.to_scene(head.quirks)
    big_chunk = 1 << 22  # 4M rays per XLA chunk, sized for 80 GB
    seed = jnp.uint32(0)

    # ---- phase 2: compile-only -------------------------------------------
    t0 = time.perf_counter()
    fwd = jax.jit(lambda s, k: render_radiance(s, head, k))
    compiled = fwd.trace(scene, seed).lower().compile()
    log(f"phase 2: Triton kernel compiled at 1920x1080 in "
        f"{time.perf_counter() - t0:.1f} s; memory analysis: "
        f"{compiled.memory_analysis()}")

    # ---- phase 3: headline forward ---------------------------------------
    img = render(scene, head, seed=0)
    xla = head.replace(backend="jnp")
    with jax.default_matmul_precision("highest"):
        ref = render(scene, xla, seed=0)
    compare_frames(img, ref, "phase 3: headline kernel vs XLA")
    t_k, runs = timed(lambda: render(scene, head, seed=0))
    log(f"phase 3: headline forward, Triton kernel: median {t_k:.6f} s "
        f"of {['%.6f' % t for t in runs]}")
    results["fwd_kernel_s"] = t_k
    for chunk in (head.rays_per_chunk, big_chunk):
        c = xla.replace(rays_per_chunk=chunk)
        t_x, runs = timed(lambda c=c: render(scene, c, seed=0))
        log(f"phase 3: headline forward, XLA wavefront rays_per_chunk="
            f"{chunk}: median {t_x:.6f} s of {['%.6f' % t for t in runs]}")
        results[f"fwd_xla_chunk{chunk}_s"] = t_x
    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "head.ppm")
        rc = cli.main(["--path", os.path.join(SCENES, "spheres2.scn"),
                       "--output", out, "--width", "1920", "--height", "1080",
                       "--gillum", "16", "--depth", "2", "--shadow"])
        check(rc == 0, f"CLI exited {rc}")
        same = float((read_ppm(out) == quantize(img)).all(-1).mean())
    log(f"phase 3: CLI wrote the headline PPM; {same:.4%} of pixels equal "
        "render()'s")
    check(same == 1.0, "CLI image differs from render()")

    # ---- phase 4: forward + backward -------------------------------------
    g_cfg = head.replace(width=320, height=180)
    g_tgt = jnp.zeros((180, 320, 3), jnp.float32)
    for name, sc in (("parity spheres2", scene),
                     ("clean spheres1",
                      parse_scene(os.path.join(SCENES, "spheres1.scn"))
                      .to_scene(CLEAN))):
        cfg = g_cfg if name.startswith("parity") else g_cfg.replace(
            quirks=CLEAN)
        with jax.default_matmul_precision("highest"):
            gk = jax.jit(jax.grad(
                lambda s: train.full_loss(s, cfg, seed, g_tgt)))(sc)
            gj = jax.jit(jax.grad(lambda s: train.full_loss(
                s, cfg.replace(backend="jnp"), seed, g_tgt)))(sc)
        compare_grads(gk, gj, f"phase 4: gradients 320x180 gillum16 {name}")
    tgt = jnp.zeros((1080, 1920, 3), jnp.float32)
    for tag, cfg in (("kernel + XLA replay", head), ("XLA autodiff", xla)):
        for chunk in (head.rays_per_chunk, big_chunk):
            c = cfg.replace(rays_per_chunk=chunk)
            step = jax.jit(jax.grad(
                lambda s, k, c=c: train.full_loss(s, c, k, tgt)))
            t, runs = timed(step, scene, seed)
            log(f"phase 4: headline forward+backward, {tag}, "
                f"rays_per_chunk={chunk}: median {t:.6f} s of "
                f"{['%.6f' % x for x in runs]}")
            results[f"fwdbwd_{'kernel' if c.backend == 'auto' else 'xla'}"
                    f"_chunk{chunk}_s"] = t

    # ---- phase 5: clean fog + render_frames ------------------------------
    clean = head.replace(quirks=CLEAN)
    sc_clean = spheres2.to_scene(CLEAN)
    check(sc_clean.has_fog and not sc_clean.fog_zeroed, "fog not live")
    img_c = render(sc_clean, clean, seed=0)
    with jax.default_matmul_precision("highest"):
        ref_c = render(sc_clean, clean.replace(backend="jnp",
                                               rays_per_chunk=big_chunk),
                       seed=0)
    compare_frames(img_c, ref_c, "phase 5: clean fog kernel vs XLA")
    t_c, _ = timed(lambda: render(sc_clean, clean, seed=0))
    t_cx, _ = timed(lambda: render(sc_clean, clean.replace(
        backend="jnp", rays_per_chunk=big_chunk), seed=0))
    log(f"phase 5: clean fog forward: kernel median {t_c:.6f} s, XLA "
        f"(rays_per_chunk={big_chunk}) median {t_cx:.6f} s")
    seeds = jnp.arange(16, dtype=jnp.uint32)
    frames = render_frames(scene, head, seeds)
    check(frames.shape == (16, 1080, 1920, 3), f"frames {frames.shape}")
    check(bool(jnp.isfinite(frames).all()), "render_frames non-finite")
    np.testing.assert_allclose(np.asarray(frames[3]),
                               np.asarray(render(scene, head, seed=3)),
                               rtol=0, atol=1e-6)
    t_f, _ = timed(lambda: render_frames(scene, head, seeds), n=3)
    log(f"phase 5: render_frames K=16: median {t_f:.6f} s "
        f"({t_f / 16:.6f} s/frame); frame 3 equals render(seed=3)")

    # ---- phase 6: goldens at full frame -----------------------------------
    def ppm_gz(name):
        with tempfile.TemporaryDirectory() as td:
            p = os.path.join(td, "g.ppm")
            with open(p, "wb") as f:
                f.write(gzip.decompress(
                    open(os.path.join(GOLDENS, name), "rb").read()))
            return read_ppm(p)

    for golden, scn, shadow, w, h, depth in (
        ("spheres1_bp.ppm.gz", "spheres1.scn", False, 640, 480, 1),
        ("spheres1_bp_shadows.ppm.gz", "spheres1.scn", True, 640, 480, 1),
        ("spheres2_bp.ppm.gz", "spheres2.scn", False, 640, 480, 1),
        ("spheres2_bp_shadows.ppm.gz", "spheres2.scn", True, 640, 480, 1),
        ("test_bp_shadows.ppm.gz", "test.scn", True, 640, 480, 1),
        ("dragon_bp_shadows.ppm.gz", "dragon.scn", True, 640, 480, 1),
        ("spheres1_serial_160.ppm.gz", "spheres1.scn", True, 160, 120, 3),
    ):
        cfg = RenderConfig(width=w, height=h, max_depth=depth,
                           use_shadows=shadow)
        sc = parse_scene(os.path.join(SCENES, scn)).to_scene(cfg.quirks)
        ours = quantize(render(sc, cfg, seed=0))
        exact = float((ours == ppm_gz(golden)).all(-1).mean())
        log(f"phase 6: {golden}: {exact:.4%} pixels byte-identical "
            "(limit 99.5%)")
        check(exact >= 0.995, f"{golden} below 99.5%")
    for golden, scn, over in (
        ("spheres1_jsample5_shadows_160.npz", "spheres1.scn",
         dict(width=160, height=120, grid_size=5, max_depth=1)),
        ("spheres1_gillum16_shadows_160.npz", "spheres1.scn",
         dict(width=160, height=120, monte_carlo=True, num_paths=16,
              max_depth=2)),
        ("spheres2_gillum16_shadows_128.npz", "spheres2.scn",
         dict(width=128, height=96, monte_carlo=True, num_paths=16,
              max_depth=2)),
        ("spheres2_jsample5_shadows_128.npz", "spheres2.scn",
         dict(width=128, height=96, grid_size=5, max_depth=1)),
    ):
        data = np.load(os.path.join(GOLDENS, golden))
        mu_r, var_r = data["mean"].astype(np.float64), data["var"]
        cfg = RenderConfig(use_shadows=True, **over)
        sc = parse_scene(os.path.join(SCENES, scn)).to_scene(cfg.quirks)
        M = 8
        mu_f = np.mean([quantize(render(sc, cfg, seed=k)).astype(np.float64)
                        for k in range(M)], axis=0)
        # tests/test_golden.py's rule: 3 sigma of the difference of two
        # sample means (+1 LSB of quantization) on all but 1% of values,
        # and global means within a quarter byte
        se = np.sqrt(var_r * (1.0 / int(data["n"]) + 1.0 / M))
        bad = float((np.abs(mu_r - mu_f) > 3.0 * se + 1.0).mean())
        dm = abs(mu_r.mean() - mu_f.mean())
        log(f"phase 6: {golden}: {bad:.3%} of values beyond 3 sigma "
            f"(limit 1%), global mean diff {dm:.3f} (limit 0.25)")
        check(bad <= 0.01 and dm < 0.25, f"{golden} outside MC error")

    # ---- phase 7: dragon -------------------------------------------------
    dragon = parse_scene(os.path.join(SCENES, "dragon.scn")).to_scene(CLEAN)
    for name, cfg in (
        ("clean shadows depth2", RenderConfig(
            width=640, height=480, max_depth=2, use_shadows=True,
            quirks=CLEAN)),
        ("clean gillum16 depth2", RenderConfig(
            width=640, height=480, max_depth=2, use_shadows=True,
            quirks=CLEAN, monte_carlo=True, num_paths=16)),
    ):
        comp = jax.jit(lambda s, k, c=cfg: render_radiance(s, c, k)).trace(
            dragon, seed).lower().compile()
        out = comp(dragon, seed)
        check(bool(jnp.isfinite(out).all()) and float(out.std()) > 0,
              f"dragon {name}: bad image")
        t, runs = timed(comp, dragon, seed, n=3)
        ma = comp.memory_analysis()
        log(f"phase 7: dragon 640x480 {name}: median {t:.6f} s; program "
            f"temp {ma.temp_size_in_bytes} B; process peak_bytes_in_use "
            f"{dev.memory_stats()['peak_bytes_in_use']}")
        results[f"dragon_{name.split()[1]}_s"] = t

    # ---- phase 8: train.fit with checkpoint + resume ---------------------
    fit_cfg = RenderConfig(width=512, height=512, monte_carlo=True,
                           num_paths=4, max_depth=2, use_shadows=True)
    target = render(scene, fit_cfg, seed=0)
    start = scene.replace(spheres=scene.spheres.replace(
        diffuse=scene.spheres.diffuse * 0.5))
    with tempfile.TemporaryDirectory() as td:
        kw = dict(learning_rate=5e-2, log_every=0, checkpoint_dir=td,
                  trainable_paths=("spheres.diffuse",))
        _, la = train.fit(start, fit_cfg, target, steps=3,
                          checkpoint_every=3, **kw)
        _, lb = train.fit(start, fit_cfg, target, steps=5, **kw)
    losses = la + lb
    log(f"phase 8: train.fit 512x512 losses {['%.6g' % x for x in losses]} "
        "(steps 0-2, checkpoint, resumed 3-4)")
    check(len(la) == 3 and len(lb) == 2, "resume did not continue at step 3")
    check(all(np.isfinite(losses)), "non-finite loss")
    check(losses[-1] < losses[0], "loss did not fall")


def four_cards(results: dict) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from skele_raytracer_tpu.config import RenderConfig
    from skele_raytracer_tpu.models import train
    from skele_raytracer_tpu.models.renderer import render
    from skele_raytracer_tpu.parallel.api import (
        factor_mesh,
        loss_and_grad_sharded,
        make_mesh,
        render_sharded,
    )
    from skele_raytracer_tpu.scene.parser import parse_scene

    devs = jax.devices()[:4]
    check(len(devs) == 4, f"{len(devs)} devices, 4 needed")
    mesh = make_mesh(devs)
    log(f"mesh {dict(mesh.shape)} (factor_mesh(4) = {factor_mesh(4)}) over "
        f"{[str(d) for d in mesh.devices.ravel()]}")
    head = RenderConfig(width=1920, height=1080, monte_carlo=True,
                        num_paths=16, max_depth=2, use_shadows=True)
    scene = parse_scene(os.path.join(SCENES, "spheres2.scn")).to_scene()

    img4 = render_sharded(scene, head, seed=0, mesh=mesh)
    img1 = jax.device_get(render(scene, head, seed=0))
    err = float(np.abs(np.asarray(img4) - img1).max())
    log(f"render_sharded 4 cards vs 1 card: max |diff| {err:.3e} "
        "(limit 1e-6)")
    check(err <= 1e-6, "sharded render differs from the 1-card render")
    for s in img4.addressable_shards:
        log(f"  output shard {s.index} on {s.device}")
    t4, _ = timed(lambda: render_sharded(scene, head, seed=0, mesh=mesh))
    t1, _ = timed(lambda: render(scene, head, seed=0))
    log(f"headline forward: 4 cards median {t4:.6f} s, 1 card {t1:.6f} s")
    for d in devs:
        log(f"  {d}: peak_bytes_in_use {d.memory_stats()['peak_bytes_in_use']}")

    target = jnp.zeros((1080, 1920, 3), jnp.float32)
    seed = jnp.uint32(3)
    with jax.default_matmul_precision("highest"):
        l4, g4 = jax.jit(lambda s: loss_and_grad_sharded(
            s, head, seed, target, mesh))(scene)
        l1, g1 = jax.jit(jax.value_and_grad(
            lambda s: train.full_loss(s, head, seed, target)))(scene)
    dl = abs(float(l4) - float(l1)) / abs(float(l1))
    log(f"loss_and_grad_sharded: loss {float(l4):.8g} vs 1 card "
        f"{float(l1):.8g} (rel diff {dl:.2e}, limit 1e-5)")
    check(dl <= 1e-5, "sharded loss differs")
    compare_grads(g4, g1, "sharded gradient vs 1 card")
    results["four_card_fwd_s"] = t4


def main(argv) -> int:
    n_cards = 4 if "--four-cards" in argv else 1
    phase0_card(n_cards)
    if n_cards == 1:
        phase1_gpu_tests()

    import jax

    from skele_raytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    devs = jax.devices()
    check(devs[0].platform == "gpu", f"platform {devs[0].platform}")
    results: dict = {}
    (four_cards if n_cards == 4 else single_card)(results)
    log(f"results (seconds): {json.dumps(results)}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
