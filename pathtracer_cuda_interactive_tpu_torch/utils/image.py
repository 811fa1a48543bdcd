"""Tonemapping and image output.

The display transform matches the reference's CPU loop in
``UpdateTexture`` (opengl_display.cpp:99-117): divide the accumulation
buffer by the sample count, gamma-2 (sqrt), clamp, bytes.  The PNG writer
replaces the vendored-but-unused stb_image_write (main.cu:19-23) with a
dependency-free encoder on Python's zlib.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def tonemap(accum: np.ndarray, sample_count: int) -> np.ndarray:
    """[H,W,3] float accumulation + count -> [H,W,3] uint8
    (opengl_display.cpp:104-111: sqrt gamma, 255.99 scale)."""
    avg = np.asarray(accum, np.float32) / max(int(sample_count), 1)
    out = np.sqrt(np.clip(avg, 0.0, 1.0))
    return np.clip(out * 255.99, 0, 255).astype(np.uint8)


def encode_png(rgb: np.ndarray, level: int = 6) -> bytes:
    """Minimal RGB8 PNG encoder (in-memory; used by the web viewer's frame
    stream and the file writer below)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim == 2:
        rgb = np.repeat(rgb[..., None], 3, axis=-1)
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, level)) + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal RGB8 PNG writer."""
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for our own RGB8 output (round-trip/testing)."""
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos = 8
    idat = b""
    w = h = None
    while pos < len(data):
        (ln,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, bit, ctype = struct.unpack_from(">IIBB", payload)[:4]
            assert bit == 8 and ctype == 2, "only RGB8 supported"
        elif tag == b"IDAT":
            idat += payload
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * 3 + 1
    img = np.zeros((h, w, 3), np.uint8)
    prev = np.zeros(w * 3, np.int32)
    for y in range(h):
        row = raw[y * stride:(y + 1) * stride]
        filt, line = row[0], np.frombuffer(row[1:], np.uint8).astype(np.int32)
        if filt == 0:
            out = line
        elif filt == 1:
            out = line.copy()
            for x in range(3, len(out)):
                out[x] = (out[x] + out[x - 3]) & 0xFF
        elif filt == 2:
            out = (line + prev) & 0xFF
        else:
            raise NotImplementedError(f"PNG filter {filt}")
        prev = out
        img[y] = out.reshape(w, 3).astype(np.uint8)
    return img


def read_png_any(path: str) -> np.ndarray:
    """Read an arbitrary 8-bit image file to RGB uint8 [H,W,3].  Prefers
    Pillow (handles every PNG filter/interlace mode — needed for the
    reference's sample_images in the golden tests); falls back to our
    minimal reader for plain RGB8 PNGs."""
    try:
        from PIL import Image
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)
    except ImportError:
        return read_png(path)


def save_exr_like_npz(path: str, accum: np.ndarray, sample_count: int,
                      **extra) -> None:
    """HDR dump: accumulation + count (+ any extra state), the
    checkpoint/resume capability SURVEY.md §5 calls for."""
    np.savez_compressed(path, accum=np.asarray(accum, np.float32),
                        sample_count=np.int64(sample_count), **extra)
