"""End-to-end CLI tests: the reference's user surface, run as a user would.

Each test invokes `python -m skele_raytracer_tpu` in a subprocess on the
CPU backend and checks the artifact it writes.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from skele_raytracer_tpu.utils.image import read_ppm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*args, timeout=420):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p]
    )
    return subprocess.run(
        [sys.executable, "-m", "skele_raytracer_tpu", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout,
    )


@pytest.mark.parametrize("mode", ["parity", "clean"])
def test_cli_renders_ppm(tmp_path, mode):
    out = str(tmp_path / f"{mode}.ppm")
    r = _run(
        "--path", "scenes/spheres1.scn", "--output", out,
        "--width", "48", "--height", "36", "--shadow", "--mode", mode,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "WROTE TO" in r.stderr
    img = read_ppm(out)
    assert img.shape == (36, 48, 3)
    assert img.std() > 0


def test_cli_reference_flag_set(tmp_path):
    """The reference's exact flag vocabulary works (main.cpp:246-379)."""
    out = str(tmp_path / "ref.ppm")
    r = _run(
        "--path", "scenes/spheres1.scn", "--output", out,
        "--width", "32", "--height", "24", "--fov", "60",
        "--gillum", "2", "--jsample", "2", "--depth", "2",
        "--parallel", "true", "--shadow",
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)


def test_cli_progressive_kill_and_resume(tmp_path):
    """Failure recovery end-to-end (SURVEY §5; the reference loses the
    whole frame on a crash, src/main.cpp:88-101): a render killed
    mid-frame by fault injection leaves a resume state; rerunning with
    --resume completes the frame and matches a clean one-shot render."""
    from skele_raytracer_tpu.models.progressive import FAULT_AFTER_BANDS_ENV

    state = str(tmp_path / "state.npz")
    out = str(tmp_path / "resumed.ppm")
    preview = str(tmp_path / "previews")
    common = (
        "--path", "scenes/spheres1.scn", "--output", out,
        "--width", "48", "--height", "36", "--shadow",
        "--band-rows", "8", "--resume", state, "--preview-dir", preview,
    )
    # First run: crash after 2 of the 5 bands have been persisted.
    os.environ[FAULT_AFTER_BANDS_ENV] = "2"
    try:
        r1 = _run(*common)
    finally:
        del os.environ[FAULT_AFTER_BANDS_ENV]
    assert r1.returncode != 0
    assert os.path.exists(state), "crash must leave a resume state"
    assert os.path.exists(os.path.join(preview, "preview.ppm"))
    # Second run resumes from band 2 and completes.
    r2 = _run(*common)
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert not os.path.exists(state), "completed render removes the state"
    resumed = read_ppm(out)
    # One-shot render of the same config must be pixel-identical
    # (band/chunk partition invariance).
    one_shot = str(tmp_path / "oneshot.ppm")
    r3 = _run(
        "--path", "scenes/spheres1.scn", "--output", one_shot,
        "--width", "48", "--height", "36", "--shadow", "--no-mesh",
    )
    assert r3.returncode == 0, r3.stderr[-2000:]
    np.testing.assert_array_equal(resumed, read_ppm(one_shot))


def test_cli_frames_and_accumulate(tmp_path):
    """--frames K renders K independently-seeded frames in ONE device
    program (renderer.render_frames, the serving-throughput path) and
    writes numbered files; --spp-accumulate K writes their mean. The
    mean of the K frames must equal the accumulated image."""
    out = str(tmp_path / "f.ppm")
    common = ("--path", "scenes/spheres1.scn", "--width", "32",
              "--height", "24", "--gillum", "2", "--depth", "2", "--shadow")
    r = _run(*common, "--output", out, "--frames", "3", "--seed", "5")
    assert r.returncode == 0, r.stderr[-2000:]
    frames = [read_ppm(str(tmp_path / f"f_{k:03d}.ppm")) for k in range(3)]
    # distinct seeds -> distinct MC noise
    assert not np.array_equal(frames[0], frames[1])
    acc = str(tmp_path / "acc.ppm")
    r2 = _run(*common, "--output", acc, "--spp-accumulate", "3", "--seed", "5")
    assert r2.returncode == 0, r2.stderr[-2000:]
    mean = np.stack([f.astype(np.float64) for f in frames]).mean(0)
    # Per-frame quantization costs <= 0.5 LSB each; saturated pixels
    # (clamped per frame vs clamped after averaging) can differ more.
    unsat = np.stack(frames).max(0) < 255
    err = np.abs(mean - read_ppm(acc).astype(np.float64))
    assert err[unsat].max() <= 1.0, err[unsat].max()
    # frames + progressive is rejected
    r3 = _run(*common, "--output", out, "--frames", "2", "--progressive")
    assert r3.returncode == 2


def test_cli_missing_scene_fails_cleanly(tmp_path):
    r = _run("--path", "/nope/missing.scn", "--output", str(tmp_path / "x.ppm"))
    assert r.returncode == 1
    assert "could not be opened" in r.stderr
    assert "Traceback" not in r.stderr


def test_cli_missing_required_args():
    r = _run("--output", "/tmp/x.ppm")
    assert r.returncode == 2
    assert "--path" in r.stderr
