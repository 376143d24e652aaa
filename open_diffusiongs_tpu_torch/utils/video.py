"""Pure-Python video writing: MJPEG-in-AVI (no ffmpeg/imageio in image).

The reference writes mp4s through imageio-ffmpeg (utils/saving.py videos).
This image has neither, so we emit Motion-JPEG AVI — playable everywhere —
from a list of HxWx3 uint8 frames, plus a PNG-sequence fallback.

The port's own copy of open_diffusiongs_tpu/utils/video.py.
"""

from __future__ import annotations

import io
import os
import struct
from typing import List, Sequence

import numpy as np
from PIL import Image


def _jpeg_bytes(frame: np.ndarray, quality: int = 92) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_mjpeg_avi(path: str, frames: Sequence[np.ndarray], fps: int = 30,
                    quality: int = 92) -> None:
    """frames: list of [h, w, 3] uint8 arrays (all the same size)."""
    assert len(frames) > 0
    h, w = frames[0].shape[:2]
    jpegs = [_jpeg_bytes(f, quality) for f in frames]
    jpegs = [j + (b"\x00" if len(j) % 2 else b"") for j in jpegs]
    n = len(jpegs)

    def chunk(fourcc: bytes, data: bytes) -> bytes:
        return fourcc + struct.pack("<I", len(data)) + data \
            + (b"\x00" if len(data) % 2 else b"")

    def lst(fourcc: bytes, data: bytes) -> bytes:
        return chunk(b"LIST", fourcc + data)

    avih = struct.pack("<14I", int(1e6 / fps), 0, 0, 0x10, n, 0, 1, 0,
                       w, h, 0, 0, 0, 0)
    # AVISTREAMHEADER: flags, priority, language, initialFrames, scale,
    # rate, start, length, suggestedBufferSize, quality, sampleSize, rcFrame
    strh = b"vids" + b"MJPG" + struct.pack(
        "<I2H8I4h", 0, 0, 0, 0, 1, fps, 0, n, 0, 0xFFFFFFFF & 0, 0,
        0, 0, w, h)
    strf = struct.pack("<I2i2H2I2i2I", 40, w, h, 1, 24, 0x47504A4D,
                       w * h * 3, 0, 0, 0, 0)
    hdrl = lst(b"hdrl", chunk(b"avih", avih)
               + lst(b"strl", chunk(b"strh", strh) + chunk(b"strf", strf)))

    movi_payload = b"".join(chunk(b"00dc", j) for j in jpegs)
    movi = lst(b"movi", movi_payload)

    # idx1
    idx = b""
    offset = 4
    for j in jpegs:
        size = len(j)
        idx += b"00dc" + struct.pack("<3I", 0x10, offset, size)
        offset += 8 + size + (size % 2)
    idx1 = chunk(b"idx1", idx)

    riff_payload = b"AVI " + hdrl + movi + idx1
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", len(riff_payload)) + riff_payload)


def write_png_sequence(dirname: str, frames: Sequence[np.ndarray]) -> None:
    os.makedirs(dirname, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(dirname, f"{i:05d}.png"))


def to_uint8(img: np.ndarray) -> np.ndarray:
    """float [0, 1] (any layout ending in h, w or h, w, c) -> uint8."""
    return (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)
