"""8-bit PNG files from the standard library and numpy alone.

The port's scene writer and image reader must work where neither PIL nor
libpng is installed. ``write_png`` stores RGB(A) or gray rows unfiltered in
one zlib stream; ``read_png`` decodes 8-bit gray, gray+alpha, RGB and RGBA
files without interlacing, with all five row filters, and raises on
anything else. ``imread`` takes PIL when it is importable (JPEG and every
other format), else ``read_png``.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """Write a uint8 [H, W], [H, W, 1|2|3|4] array as an 8-bit PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * C)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color_type, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth_row(cur: np.ndarray, prev: np.ndarray, bpp: int) -> None:
    """Undo the Paeth filter of one row in place (a per-byte recurrence)."""
    for i in range(len(cur)):
        a = int(cur[i - bpp]) if i >= bpp else 0
        b = int(prev[i])
        c = int(prev[i - bpp]) if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (int(cur[i]) + pred) & 0xFF


def _avg_row(cur: np.ndarray, prev: np.ndarray, bpp: int) -> None:
    for i in range(len(cur)):
        a = int(cur[i - bpp]) if i >= bpp else 0
        cur[i] = (int(cur[i]) + ((a + int(prev[i])) >> 1)) & 0xFF


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG → uint8 [H, W, C]."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, color_type, _, _, interlace = header
    if depth != 8 or color_type not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only 8-bit, non-interlaced gray/RGB(A) PNG is "
                         f"read without PIL (depth {depth}, colour type "
                         f"{color_type}, interlace {interlace})")
    C = _CHANNELS[color_type]
    stride = W * C
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        kind, cur = raw[y, 0], raw[y, 1:].copy()
        if kind == 1:  # Sub: running sum along the row, per channel
            cur = np.cumsum(cur.reshape(W, C), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = cur + prev
        elif kind == 3:  # Average
            _avg_row(cur, prev, C)
        elif kind == 4:  # Paeth
            _paeth_row(cur, prev, C)
        elif kind != 0:
            raise ValueError(f"{path}: bad PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out.reshape(H, W, C)


def imread(path: str) -> np.ndarray:
    """uint8 RGB [H, W, 3]: PIL where it is installed, else ``read_png``."""
    try:
        from PIL import Image
    except ImportError:
        img = read_png(path)
        if img.shape[-1] in (1, 2):
            img = np.repeat(img[..., :1], 3, axis=-1)
        return img[..., :3]
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
