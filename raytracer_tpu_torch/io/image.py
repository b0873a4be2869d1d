"""Minimal dependency-free PNG output (port of
``raytracer_tpu/io/image.py``; numpy and zlib, byte for byte the same
files).

The reference displays frames via a fullscreen textured quad
(src/main.cpp:365-366, renderQuad:476-501); headless rendering writes
PNGs instead. Colors are raw linear values clamped to [0,1] — the
reference blits the RGBA32F texture with no gamma/tonemap
(shader.frag:1-12), so a plain 8-bit quantization matches what the
window showed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from raytracer_tpu_torch.core.scene import to_numpy


def to_uint8(img) -> np.ndarray:
    """Clamp floats to [0,1] and quantize to u8 (H, W, 3). ``img`` is an
    array or a tensor on any device."""
    img = to_numpy(img)
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img) -> None:
    """Write an (H, W, 3) float or uint8 array (or tensor) as a PNG."""
    arr = to_numpy(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    if arr.ndim == 2:
        arr = np.repeat(arr[:, :, None], 3, axis=2)
    h, w, _ = arr.shape

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", ihdr))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB PNG written by write_png back to (H, W, 3) u8.

    Minimal inverse of the writer (filter-0 rows, color type 2, bit
    depth 8) plus the common per-row filters 1/2 so externally-produced
    test fixtures load too.
    """
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos = 8
    w = h = None
    idat = b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, hh, depth, ctype = struct.unpack(">IIBB", payload[:10])
            h = hh
            assert depth == 8 and ctype == 2, "only 8-bit RGB supported"
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    raw = zlib.decompress(idat)
    stride = 3 * w
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        filt = raw[y * (stride + 1)]
        row = np.frombuffer(
            raw[y * (stride + 1) + 1:(y + 1) * (stride + 1)],
            np.uint8).astype(np.int32)
        if filt == 0:
            cur = row
        elif filt == 2:                      # Up
            cur = (row + prev) & 0xFF
        elif filt == 1:                      # Sub
            cur = row.copy()
            for x in range(3, stride):
                cur[x] = (cur[x] + cur[x - 3]) & 0xFF
        else:
            raise ValueError(f"unsupported PNG filter {filt}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out.reshape(h, w, 3)
