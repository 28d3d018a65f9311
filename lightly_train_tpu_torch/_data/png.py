"""PNG decoding: chunks and inflate with ``zlib``, the scanline unfilter in
the port's host library (``csrc/image_decode.c``).

Every chunk's CRC is checked. Bit depths 1, 2, 4, 8 and 16, colour types 0,
2, 3, 4 and 6, and Adam7 interlacing decode; the result is what PIL's
``convert("RGB")`` gives, which the JAX package decodes with:

- gray stays one channel (the caller copies it to three); depths 1, 2 and 4
  scale to 0-255 (PIL's ``1``, ``L;2`` and ``L;4``); 16-bit gray opens as
  PIL's ``I;16`` and converts as its ``I;16`` -> ``L``, values above 255
  saturating;
- 16-bit RGB, RGBA and gray+alpha keep the high byte;
- alpha is dropped without compositing, and tRNS is ignored;
- a palette goes through PLTE; an index past its end reads black, as in
  PIL.
"""

from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np

from lightly_train_tpu_torch import _native
from lightly_train_tpu_torch._data.jpeg import check, check_size
from lightly_train_tpu_torch.errors import DatasetError

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type -> (samples a pixel, allowed bit depths)
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}

# Adam7 passes: (x0, y0, dx, dy).
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunks(data: bytes, path: str) -> List[Tuple[bytes, bytes]]:
    if not data.startswith(SIGNATURE):
        raise DatasetError(f"{path}: not a PNG file")
    out, pos = [], len(SIGNATURE)
    while True:
        if pos + 12 > len(data):
            raise DatasetError(f"{path}: truncated PNG (no IEND)")
        length = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise DatasetError(f"{path}: truncated PNG chunk {kind!r}")
        body = data[pos + 8:end]
        if zlib.crc32(kind + body) != int.from_bytes(data[end:end + 4], "big"):
            raise DatasetError(f"{path}: bad CRC in PNG chunk {kind!r}")
        out.append((kind, body))
        if kind == b"IEND":
            return out
        pos = end + 4


def _samples(rows: np.ndarray, width: int, channels: int,
             depth: int) -> np.ndarray:
    """Unfiltered scanlines (h, rowbytes) -> samples (h, width, channels),
    uint8 below 16 bits, uint16 at 16."""
    h = rows.shape[0]
    n = width * channels
    if depth == 16:
        values = rows.view(">u2")[:, :n].astype(np.uint16)
    elif depth == 8:
        values = rows[:, :n]
    else:
        bits = np.unpackbits(rows, axis=1).reshape(h, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        values = (bits * weights).sum(axis=2, dtype=np.uint8)[:, :n]
    return values.reshape(h, width, channels)


def _unfilter(raw: bytes, offset: int, width: int, height: int,
              channels: int, depth: int, path: str) -> Tuple[np.ndarray, int]:
    rowbytes = (width * channels * depth + 7) // 8
    size = height * (rowbytes + 1)
    if offset + size > len(raw):
        raise DatasetError(f"{path}: truncated PNG image data")
    src = np.frombuffer(raw, dtype=np.uint8, count=size, offset=offset)
    rows = np.empty((height, rowbytes), dtype=np.uint8)
    check(_native.host_function("image_decode", "lt_png_unfilter")(
        src.ctypes.data, rows.ctypes.data, height, rowbytes,
        max(1, channels * depth // 8)), path)
    return _samples(rows, width, channels, depth), offset + size


def decode_png(data: bytes, path: str) -> np.ndarray:
    """Decode to uint8 (H, W) for gray and gray+alpha, (H, W, 3) for the
    rest."""
    chunks = _chunks(data, path)
    if chunks[0][0] != b"IHDR" or len(chunks[0][1]) != 13:
        raise DatasetError(f"{path}: PNG without IHDR")
    ihdr = chunks[0][1]
    width = int.from_bytes(ihdr[0:4], "big")
    height = int.from_bytes(ihdr[4:8], "big")
    depth, ctype, method, filt, interlace = ihdr[8:13]
    if ctype not in _COLOR_TYPES or depth not in _COLOR_TYPES[ctype][1] \
            or method != 0 or filt != 0 or interlace > 1 \
            or width == 0 or height == 0:
        raise DatasetError(
            f"{path}: bad PNG header (colour type {ctype}, depth {depth})")
    check_size(width, height, path)
    channels = _COLOR_TYPES[ctype][0]
    palette = b"".join(body for kind, body in chunks if kind == b"PLTE")
    try:
        raw = zlib.decompress(b"".join(
            body for kind, body in chunks if kind == b"IDAT"))
    except zlib.error as e:
        raise DatasetError(f"{path}: bad PNG image data ({e})") from None
    dtype = np.uint16 if depth == 16 else np.uint8
    if interlace:
        image = np.zeros((height, width, channels), dtype=dtype)
        offset = 0
        for x0, y0, dx, dy in ADAM7:
            pw, ph = -(-(width - x0) // dx), -(-(height - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            image[y0::dy, x0::dx], offset = _unfilter(
                raw, offset, pw, ph, channels, depth, path)
    else:
        image, _ = _unfilter(raw, 0, width, height, channels, depth, path)
    if ctype == 3:
        table = np.zeros((256, 3), dtype=np.uint8)
        entries = np.frombuffer(palette, dtype=np.uint8)
        entries = entries[:len(entries) // 3 * 3].reshape(-1, 3)[:256]
        table[:len(entries)] = entries
        return table[image[..., 0]]
    if ctype in (0, 4):
        gray = image[..., 0]
        if depth == 16 and ctype == 0:
            return np.minimum(gray, 255).astype(np.uint8)
        if depth == 16:
            return (gray >> 8).astype(np.uint8)
        return (gray * (255 // ((1 << depth) - 1))).astype(np.uint8)
    rgb = image[..., :3]
    return (rgb >> 8).astype(np.uint8) if depth == 16 else rgb
