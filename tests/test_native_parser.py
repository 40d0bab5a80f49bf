"""Cross-check the native C++ parser against the Python parser.

The Python parser (scene/parser.py) is the semantic source of truth; the
native library (native/parser.cpp) must produce an identical ParsedScene
on every scene file, including the quirky ones (dragon.scn's unknown
commands, spheres1.scn's windows output_image path, test.scn's spot_light).
"""

import glob
import os

import numpy as np
import pytest

from skele_raytracer_tpu.scene import native
from skele_raytracer_tpu.scene.parser import parse_scene_text

SCENES = sorted(glob.glob(os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "scenes", "*.scn")))


pytestmark = pytest.mark.skipif(
    not native.available(), reason="native parser library not built"
)


def _canon(parsed):
    return dict(
        width=parsed.width,
        height=parsed.height,
        max_depth=parsed.max_depth,
        output_image=parsed.output_image,
        ambient=np.round(np.asarray(parsed.ambient, np.float64), 10).tolist(),
        background=list(parsed.background),
        camera=(
            list(parsed.camera_position),
            list(parsed.camera_direction),
            list(parsed.camera_up),
            parsed.half_height_angle,
        ),
        vertices=[list(v) for v in parsed.vertices],
        spheres=parsed.spheres,
        triangles=parsed.triangles,
        point_lights=parsed.point_lights,
        directional_lights=parsed.directional_lights,
        fog=parsed.fog,
    )


@pytest.mark.parametrize("path", SCENES, ids=[os.path.basename(s) for s in SCENES])
def test_native_matches_python(path):
    py = parse_scene_text(open(path).read())
    nat = native.parse_scene_native(path)
    assert nat is not None
    a, b = _canon(py), _canon(nat)
    for key in a:
        if key in ("spheres", "triangles", "point_lights", "directional_lights", "fog"):
            assert len(a[key]) == len(b[key]), key
            for ra, rb in zip(a[key], b[key]):
                for f in ra:
                    np.testing.assert_allclose(
                        np.asarray(ra[f], np.float64),
                        np.asarray(rb[f], np.float64),
                        rtol=0, atol=1e-6, err_msg=f"{path} {key}.{f}",
                    )
        elif key in ("ambient", "vertices", "camera", "background"):
            np.testing.assert_allclose(
                np.asarray(a[key], dtype=object).astype(np.float64).ravel()
                if key != "camera"
                else np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in a[key]]),
                np.asarray(b[key], dtype=object).astype(np.float64).ravel()
                if key != "camera"
                else np.concatenate([np.ravel(np.asarray(x, np.float64)) for x in b[key]]),
                rtol=0, atol=1e-6, err_msg=f"{path} {key}",
            )
        else:
            assert a[key] == b[key], (path, key, a[key], b[key])


def test_native_missing_file():
    with pytest.raises(FileNotFoundError):
        native.parse_scene_native("/nonexistent/nope.scn")


def test_native_ppm_writer_matches_python(tmp_path):
    import numpy as np

    from skele_raytracer_tpu.utils import image

    rng = np.random.default_rng(0)
    img = rng.uniform(-0.1, 1.4, (13, 17, 3)).astype(np.float32)
    py_path, nat_path = str(tmp_path / "py.ppm"), str(tmp_path / "nat.ppm")
    # Python reference path
    q = image.quantize(img)
    with open(py_path, "wb") as f:
        f.write(f"P6\n17 13\n255\n".encode())
        f.write(q.tobytes())
    assert native.write_ppm_native(nat_path, img)
    assert open(py_path, "rb").read() == open(nat_path, "rb").read()
    back = image.read_ppm(nat_path)
    np.testing.assert_array_equal(back, q)
