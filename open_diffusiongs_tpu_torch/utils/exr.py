"""Minimal OpenEXR 2.0 scanline reader/writer (pure Python + zlib).

The reference reads GObjaverse `*_nd.exr` normal+depth maps through
cv2.IMREAD_UNCHANGED (data/base.py:20-31).  This image has no OpenEXR/cv2
binding, so we implement the subset the dataset needs:

  * single-part scanline files, compression NONE / ZIPS (1 line) / ZIP
    (16-line blocks) with the standard delta-predictor + two-half byte
    interleave transform,
  * HALF and FLOAT channels, any channel names (sorted alphabetically per
    the EXR spec), returned as an [H, W, C] float32 array.

The writer emits HALF/FLOAT files, uncompressed or zip-compressed (used
by tests and synthetic dataset trees).

The port's own copy of open_diffusiongs_tpu/utils/exr.py.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Tuple

import numpy as np

_MAGIC = 20000630
_PIXELTYPE = {0: ("uint32", 4), 1: ("float16", 2), 2: ("float32", 4)}
_PT_CODE = {"float16": 1, "float32": 2}


def _read_null_str(buf: bytes, off: int) -> Tuple[str, int]:
    end = buf.index(b"\x00", off)
    return buf[off:end].decode("latin-1"), end + 1


def _predictor_undo(data: bytes) -> bytes:
    # OpenEXR "reconstruct": delta decode.  The sequential recurrence
    # y[i] = (x[i] + y[i-1] - 128) mod 256 telescopes to a cumsum —
    # y[i] = (sum(x[:i+1]) - 128*i) mod 256 — so it vectorizes exactly
    # (a per-byte Python loop here was ~200x slower, the decode hot spot).
    x = np.frombuffer(data, np.uint8).astype(np.int64)
    y = (np.cumsum(x) - 128 * np.arange(len(x), dtype=np.int64)) & 0xFF
    return y.astype(np.uint8).tobytes()


def _predictor_apply(data: bytes) -> bytes:
    x = np.frombuffer(data, np.uint8).astype(np.int16)
    out = np.empty(len(x), np.uint8)
    if len(x):
        out[0] = x[0]
        out[1:] = ((x[1:] - x[:-1] + 128) & 0xFF).astype(np.uint8)
    return out.tobytes()


def _deinterleave(data: bytes) -> bytes:
    # OpenEXR "interleave" undo: first half = even bytes, second = odd
    n = len(data)
    out = bytearray(n)
    half = (n + 1) // 2
    out[0::2] = data[:half]
    out[1::2] = data[half:]
    return bytes(out)


def _interleave(data: bytes) -> bytes:
    out = bytearray(len(data))
    half = (len(data) + 1) // 2
    out[:half] = data[0::2]
    out[half:] = data[1::2]
    return bytes(out)


def read_exr(path: str) -> Tuple[np.ndarray, List[str]]:
    """Read a scanline EXR -> ([H, W, C] float32, channel names in file
    order, i.e. alphabetical)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic, version = struct.unpack_from("<ii", buf, 0)
    assert magic == _MAGIC, "not an EXR file"
    assert (version & 0x200) == 0, "tiled EXR not supported"
    off = 8

    channels: List[Tuple[str, int]] = []
    compression = 0
    dw = None
    while True:
        name, off = _read_null_str(buf, off)
        if name == "":
            break
        atype, off = _read_null_str(buf, off)
        size = struct.unpack_from("<i", buf, off)[0]
        off += 4
        val = buf[off:off + size]
        off += size
        if name == "channels":
            coff = 0
            while val[coff] != 0:
                cname, coff = _read_null_str(val, coff)
                ptype = struct.unpack_from("<i", val, coff)[0]
                coff += 16  # pixel type + pLinear/reserved + sampling
                channels.append((cname, ptype))
        elif name == "compression":
            compression = val[0]
        elif name == "dataWindow":
            dw = struct.unpack("<4i", val)
    assert dw is not None
    xmin, ymin, xmax, ymax = dw
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    assert compression in (0, 2, 3), f"unsupported compression {compression}"
    lines_per_block = {0: 1, 2: 1, 3: 16}[compression]
    n_blocks = -(-height // lines_per_block)

    offsets = struct.unpack_from(f"<{n_blocks}q", buf, off)

    bytes_per_px = [(_PIXELTYPE[pt][1]) for _, pt in channels]
    line_bytes = width * sum(bytes_per_px)

    out = {cname: np.zeros((height, width), np.float32)
           for cname, _ in channels}
    # homogeneous channel dtype (the GObjaverse case) unpacks whole blocks
    # with one reshape/transpose instead of a per-line per-channel loop
    homo_dt = (_PIXELTYPE[channels[0][1]][0]
               if len({pt for _, pt in channels}) == 1 else None)
    for bi, boff in enumerate(offsets):
        y0 = struct.unpack_from("<i", buf, boff)[0] - ymin
        dsize = struct.unpack_from("<i", buf, boff + 4)[0]
        data = buf[boff + 8: boff + 8 + dsize]
        n_lines = min(lines_per_block, height - y0)
        raw_size = line_bytes * n_lines
        if compression in (2, 3):
            if dsize < raw_size:
                raw = _deinterleave(_predictor_undo(zlib.decompress(data)))
            else:
                raw = data  # stored uncompressed (incompressible block)
        else:
            raw = data
        if homo_dt is not None:
            blk = np.frombuffer(raw, dtype=homo_dt,
                                count=n_lines * len(channels) * width)
            blk = blk.reshape(n_lines, len(channels), width)
            for ci, (cname, _) in enumerate(channels):
                out[cname][y0:y0 + n_lines] = blk[:, ci].astype(np.float32)
            continue
        pos = 0
        for li in range(n_lines):
            for (cname, pt) in channels:
                dt, bpp = _PIXELTYPE[pt]
                row = np.frombuffer(raw, dtype=dt, count=width,
                                    offset=pos).astype(np.float32)
                out[cname][y0 + li] = row
                pos += width * bpp
    names = [c for c, _ in channels]
    img = np.stack([out[c] for c in names], axis=-1)
    return img, names


def read_depth_from_nd_exr(path: str) -> np.ndarray:
    """GObjaverse `_nd.exr` layout: RGBA where A is depth.  cv2 returns BGRA
    in file-channel order; the reference takes channel 3 (data/base.py:27).
    EXR stores channels alphabetically (A, B, G, R) — cv2 maps them so its
    index 3 is the 'A' (depth) channel; we select by name instead."""
    img, names = read_exr(path)
    if "A" in names:
        return img[..., names.index("A"):names.index("A") + 1]
    return img[..., -1:]


def write_exr(path: str, img: np.ndarray,
              channel_names: List[str] = None, half: bool = True,
              compression: str = "none") -> None:
    """Write a scanline EXR. img: [H, W, C] float32.  compression:
    "none", "zips" (per-line zlib) or "zip" (16-line blocks) — the zip
    modes produce what real GObjaverse assets use, exercising the
    deinterleave + delta-predictor decode path."""
    comp_code = {"none": 0, "zips": 2, "zip": 3}[compression]
    lines_per_block = {0: 1, 2: 1, 3: 16}[comp_code]
    h, w, c = img.shape
    if channel_names is None:
        channel_names = (["A", "B", "G", "R"] if c == 4 else
                         ["B", "G", "R"] if c == 3 else
                         [f"C{i}" for i in range(c)])
    assert len(channel_names) == c
    order = np.argsort(channel_names)   # EXR requires alphabetical order
    names_sorted = [channel_names[i] for i in order]
    dt = "float16" if half else "float32"
    bpp = 2 if half else 4

    header = bytearray()

    def attr(name: str, atype: str, val: bytes):
        header.extend(name.encode() + b"\x00" + atype.encode() + b"\x00")
        header.extend(struct.pack("<i", len(val)))
        header.extend(val)

    chan = bytearray()
    for nm in names_sorted:
        chan.extend(nm.encode() + b"\x00")
        chan.extend(struct.pack("<i", _PT_CODE[dt]))
        chan.extend(struct.pack("<i", 0))      # pLinear + reserved
        chan.extend(struct.pack("<2i", 1, 1))  # x/y sampling
    chan.extend(b"\x00")
    attr("channels", "chlist", bytes(chan))
    attr("compression", "compression", bytes([comp_code]))
    dw = struct.pack("<4i", 0, 0, w - 1, h - 1)
    attr("dataWindow", "box2i", dw)
    attr("displayWindow", "box2i", dw)
    attr("lineOrder", "lineOrder", b"\x00")
    attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
    attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header.extend(b"\x00")

    n_blocks = -(-h // lines_per_block)
    blocks = []
    for bi in range(n_blocks):
        y0 = bi * lines_per_block
        n_lines = min(lines_per_block, h - y0)
        # per line: channels in (alphabetical) order, channel-major
        raw = np.ascontiguousarray(
            img[y0:y0 + n_lines][:, :, order].transpose(0, 2, 1)
        ).astype(dt).tobytes()
        if comp_code:
            enc = zlib.compress(_predictor_apply(_interleave(raw)))
            if len(enc) >= len(raw):
                enc = raw       # incompressible block stays raw (EXR spec)
        else:
            enc = raw
        blocks.append((y0, enc))

    base = 8 + len(header) + 8 * n_blocks
    offsets, pos = [], base
    for _, enc in blocks:
        offsets.append(pos)
        pos += 8 + len(enc)

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _MAGIC, 2))
        f.write(header)
        f.write(struct.pack(f"<{n_blocks}q", *offsets))
        for y0, enc in blocks:
            f.write(struct.pack("<ii", y0, len(enc)))
            f.write(enc)
