"""Image output.

Reproduces the reference's quantization exactly (src/main.cpp:88-101): per
channel `min(1, v) * 255` cast to unsigned char — note there is NO lower
clamp and NO gamma in the reference; negative radiance (impossible on
reachable paths) would wrap in C, here it is clamped to 0 defensively, with
`quantize(..., parity=True)` available for bit-exact byte comparison.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def quantize(img, parity: bool = False) -> np.ndarray:
    """[H, W, 3] float radiance -> uint8, reference quantization."""
    a = np.asarray(img, dtype=np.float32)
    a = np.minimum(1.0, a)
    if not parity:
        a = np.maximum(0.0, a)
    return (a * 255.0).astype(np.uint8)


def write_ppm(path: str, img, parity: bool = False) -> None:
    """Binary P6 PPM, identical header/body layout to the reference writer
    (src/main.cpp:88-101). Uses the native C++ writer when available
    (scene/native.py; the reference's writer is native too), falling back
    to the pure-Python path (which alone supports parity's no-lower-clamp
    byte semantics)."""
    if not parity:
        try:
            from skele_raytracer_tpu.scene import native

            if native.write_ppm_native(path, img):
                return
        except Exception:
            pass
    q = quantize(img, parity=parity)
    h, w, _ = q.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(q.tobytes())


def write_png(path: str, img) -> None:
    """8-bit RGB PNG of the reference-quantized image: signature, IHDR,
    one zlib-compressed IDAT of unfiltered scanlines, IEND."""
    q = quantize(img)
    h, w, _ = q.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    # filter byte 0 (None) before every scanline
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), q.reshape(h, w * 3)], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw)))
        f.write(chunk(b"IEND", b""))


def read_ppm(path: str) -> np.ndarray:
    """Read binary P6 (for golden-image tests against renders/testcpu.ppm
    and reference-built goldens). Returns uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    # Header: magic, whitespace-separated w h maxval, single whitespace, raster.
    fields = []
    i = 0
    while len(fields) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        fields.append(data[i:j])
        i = j
    i += 1  # single whitespace after maxval
    magic, w, h, maxval = fields[0], int(fields[1]), int(fields[2]), int(fields[3])
    assert magic == b"P6" and maxval == 255, (magic, maxval)
    raster = np.frombuffer(data, dtype=np.uint8, count=w * h * 3, offset=i)
    return raster.reshape(h, w, 3)
