"""PPM/PNG writers, PPM reader + reference quantization semantics."""

import struct
import zlib

import numpy as np

from skele_raytracer_tpu.utils.image import (
    quantize,
    read_ppm,
    write_png,
    write_ppm,
)

from test_golden import reference_render


def test_quantize_reference_semantics():
    img = np.asarray([[[0.0, 0.5, 1.0], [1.5, 0.999, 0.001]]])
    q = quantize(img)
    # min(1, v) * 255 truncated to uchar (src/main.cpp:96)
    assert q.tolist() == [[[0, 127, 255], [255, 254, 0]]]


def test_ppm_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.random((7, 5, 3)).astype(np.float32)
    path = str(tmp_path / "x.ppm")
    write_ppm(path, img)
    back = read_ppm(path)
    np.testing.assert_array_equal(back, quantize(img))


def test_read_reference_golden_header():
    # The one surviving machine-readable reference render: 640x480 P6
    # (SURVEY.md §4; renders/testcpu.ppm of a reference checkout).
    img = read_ppm(reference_render())
    assert img.shape == (480, 640, 3)


def test_png_roundtrip(tmp_path):
    """write_png emits a valid 8-bit RGB PNG (checked chunk by chunk,
    CRCs included) whose pixels are the reference quantization."""
    rng = np.random.default_rng(1)
    img = rng.random((6, 9, 3)).astype(np.float32)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        chunks[tag] = body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (w, h, depth, ctype) == (9, 6, 8, 2) and b"IEND" in chunks
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + w * 3)
    assert not rows[:, 0].any()  # filter type 0 on every scanline
    np.testing.assert_array_equal(rows[:, 1:].reshape(h, w, 3),
                                  quantize(img))
