"""Command-line interface — the reference CLI's surface, JAX behind it.

The reference parses 10 flags with a manual strcmp loop (reference
src/main.cpp:230-413): --path --output --width --height --fov --gillum
--jsample --depth --parallel --shadow. This driver accepts the same flags
with the same semantics (e.g. `--gillum N` both enables Monte-Carlo GI and
sets the path count; `--shadow` is a bare flag; CLI width/height clobber
the scene file's film_resolution exactly as the reference does,
src/main.cpp:394-395) plus additions:

  --mode parity|clean   bug-for-bug reachable reference semantics vs the
                        intended behavior (reflections, lit triangles,
                        working directional lights — config.py Quirks)
  --seed N              deterministic threefry seed (the reference seeds
                        libc rand with time(0), src/main.cpp:400)
  --mesh / --no-mesh    shard rays over all visible devices
  --profile DIR         write a jax.profiler trace of the render

`--parallel true|false` is accepted for reference compatibility; both paths
render identically here (there is no serial SDL loop to fall back to, and
none of the reference's `--parallel true` hardcodes are replicated — pass
--width/--height/--depth explicitly for the historical 640x480/depth-1
behavior).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from skele_raytracer_tpu.config import CLEAN, PARITY, RenderConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="skele-raytracer-tpu",
        description="Differentiable JAX ray tracer "
        "(capabilities of lilinitsy/skele-raytracer)",
    )
    p.add_argument("--path", required=True, help="scene .scn file")
    p.add_argument("--output", required=True, help="output image (.ppm/.png)")
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--fov", type=float, default=60.0)
    p.add_argument("--gillum", type=int, default=None, metavar="N",
                   help="enable Monte-Carlo GI with N paths per sample")
    p.add_argument("--jsample", type=int, default=0, metavar="N",
                   help="N x N jittered supersampling grid")
    p.add_argument("--depth", type=int, default=3, help="max trace depth")
    p.add_argument("--parallel", default="true", choices=("true", "false"),
                   help="accepted for reference compatibility (no-op)")
    p.add_argument("--shadow", action="store_true", help="enable shadow rays")
    p.add_argument("--mode", default="parity", choices=("parity", "clean"))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", dest="mesh", action="store_true", default=True,
                   help="shard rays over all devices (default)")
    p.add_argument("--no-mesh", dest="mesh", action="store_false")
    p.add_argument("--chunk", type=int, default=1 << 16,
                   help="ray-batch chunk size (device-memory residency bound)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a jax.profiler trace to DIR")
    p.add_argument("--backend", default="auto", choices=("auto", "jnp", "pallas"),
                   help="hot-path backend: the whole-frame Pallas Triton "
                   "kernel (GPU only) or the pure-jnp XLA wavefront "
                   "(auto = pallas on a GPU, jnp elsewhere)")
    # Progressive/restartable rendering — the analog of the
    # reference's DEFAULT mode, the live SDL display that draws the frame
    # as it renders (reference src/main.cpp:108-227), plus the crash
    # recovery the reference lacks (a crash there loses the whole frame,
    # src/main.cpp:88-101).
    # Multi-frame serving (models/renderer.render_frames): K frames share
    # ONE device program, amortizing the fixed per-dispatch host<->device
    # latency. The reference renders one frame per process
    # (src/main.cpp:230-413).
    p.add_argument("--frames", type=int, default=None, metavar="K",
                   help="render K frames (seeds seed..seed+K-1) in one "
                   "device program; --output out.ppm writes out_000.ppm..")
    p.add_argument("--spp-accumulate", type=int, default=None, metavar="K",
                   help="average K independently-seeded frames into one "
                   "K-times-denoised image, rendered in one device program")
    p.add_argument("--progressive", action="store_true",
                   help="render in restartable row bands "
                   "(models/progressive.py); implied by --resume/--preview-dir")
    p.add_argument("--band-rows", type=int, default=64, metavar="N",
                   help="rows per progressive band (default 64)")
    p.add_argument("--resume", default=None, metavar="STATE",
                   help=".npz crash-resume state file: completed bands "
                   "persist there and a rerun continues from the last one")
    p.add_argument("--preview-dir", default=None, metavar="DIR",
                   help="overwrite DIR/preview.ppm with the partial frame "
                   "after each band (the live-display analog)")
    return p


def config_from_args(args, scene_width: int, scene_height: int) -> RenderConfig:
    """CLI > scene file > defaults — the reference's effective precedence
    (CLI defaults always clobber film_resolution, SURVEY.md §2.9.11; here
    the scene file wins unless the flag was actually passed)."""
    return RenderConfig(
        width=args.width if args.width is not None else scene_width,
        height=args.height if args.height is not None else scene_height,
        fov=args.fov,
        max_depth=args.depth,
        grid_size=args.jsample,
        monte_carlo=args.gillum is not None,
        num_paths=args.gillum if args.gillum is not None else 1,
        use_shadows=args.shadow,
        quirks=PARITY if args.mode == "parity" else CLEAN,
        rays_per_chunk=args.chunk,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import jax

    from skele_raytracer_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from skele_raytracer_tpu.models.renderer import render
    from skele_raytracer_tpu.parallel.api import make_mesh, render_sharded
    from skele_raytracer_tpu.scene.parser import parse_scene
    from skele_raytracer_tpu.utils.image import write_png, write_ppm

    try:
        parsed = parse_scene(args.path)
    except FileNotFoundError:
        # The reference exits with a message on a missing scene file
        # (reference src/scene.cpp:22-26); exit nonzero here.
        print(f"scene file could not be opened: {args.path}", file=sys.stderr)
        return 1
    cfg = config_from_args(args, parsed.width, parsed.height)
    cfg = cfg.replace(backend=args.backend).resolved()
    scene = parsed.to_scene(cfg.quirks)

    n_dev = len(jax.devices())
    print(f"{cfg!r}\ndevices: {n_dev} x {jax.devices()[0].platform}", file=sys.stderr)

    progressive = args.progressive or args.resume or args.preview_dir
    if (args.frames or args.spp_accumulate) and progressive:
        print("--frames/--spp-accumulate cannot combine with progressive "
              "rendering", file=sys.stderr)
        return 2

    def run():
        if args.frames or args.spp_accumulate:
            import jax.numpy as jnp

            from skele_raytracer_tpu.models.renderer import render_frames

            k = args.frames or args.spp_accumulate
            seeds = jnp.uint32(args.seed) + jnp.arange(k, dtype=jnp.uint32)
            frames = render_frames(scene, cfg, seeds)
            if args.spp_accumulate:
                return frames.mean(axis=0)
            return frames
        if progressive:
            from skele_raytracer_tpu.models.progressive import render_progressive
            from skele_raytracer_tpu.utils.image import write_ppm as _wppm

            preview_cb = None
            if args.preview_dir:
                os.makedirs(args.preview_dir, exist_ok=True)
                path = os.path.join(args.preview_dir, "preview.ppm")

                def preview_cb(frame, rows_done):
                    tmp = path + ".tmp"
                    _wppm(tmp, frame)
                    os.replace(tmp, path)

            return render_progressive(
                scene, cfg, seed=args.seed, band_rows=args.band_rows,
                state_path=args.resume, preview_cb=preview_cb,
            )
        if args.mesh and n_dev > 1:
            return render_sharded(scene, cfg, seed=args.seed, mesh=make_mesh())
        return render(scene, cfg, seed=args.seed)

    t0 = time.perf_counter()
    if args.profile:
        with jax.profiler.trace(args.profile):
            img = jax.block_until_ready(run())
    else:
        img = jax.block_until_ready(run())
    dt = time.perf_counter() - t0

    n_frames = args.frames or args.spp_accumulate or 1
    rays = cfg.width * cfg.height * cfg.samples_per_pixel * n_frames
    print(
        f"rendered {n_frames} x {cfg.width}x{cfg.height} ({rays} primary "
        f"rays) in {dt:.3f}s [{rays / dt:,.0f} rays/s incl. compile]",
        file=sys.stderr,
    )

    def write_one(path, frame):
        if path.endswith(".png"):
            write_png(path, frame)
        else:
            write_ppm(path, frame)

    if args.frames:
        root, ext = os.path.splitext(args.output)
        for k in range(args.frames):
            write_one(f"{root}_{k:03d}{ext}", img[k])
        print(f"WROTE TO {root}_000{ext} .. {root}_{args.frames - 1:03d}{ext}",
              file=sys.stderr)
    else:
        write_one(args.output, img)
        print(f"WROTE TO {args.output}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
