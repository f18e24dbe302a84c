"""A PNG codec on the standard library (``zlib``, ``struct``) and numpy.

``imread_rgb`` reads a PNG as the JAX package's data loaders do (their
cv2 branch of ``_imread_rgb``): HWC RGB float32 in [0, 1]. ``save_png``
writes a float image as the JAX ``infer --save-dir`` does: clipped to
[0, 1], scaled by 255, plus 0.5, cast to uint8; one channel as gray.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel: gray, RGB, gray + alpha, RGBA
_SAMPLES = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length or zlib.crc32(kind + body) != struct.unpack(
                ">I", data[pos + 8 + length:pos + 12 + length])[0]:
            raise ValueError(f"{path}: corrupt PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, rows: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """The image bytes (rows, stride) of the scanlines, each reconstructed
    by its filter type: None, Sub, Up, Average or Paeth."""
    if len(raw) < rows * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    lines = np.frombuffer(raw, np.uint8, rows * (stride + 1)).reshape(rows, stride + 1)
    out = np.zeros((rows, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(rows):
        kind, line = int(lines[y, 0]), lines[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:
            cur = (np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.int64) % 256
                   ).astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur_l, up, src = [0] * stride, prev.tolist(), line.tolist()
            for i in range(stride):
                left = cur_l[i - bpp] if i >= bpp else 0
                if kind == 3:
                    pred = (left + up[i]) >> 1
                else:
                    pred = _paeth(left, up[i], up[i - bpp] if i >= bpp else 0)
                cur_l[i] = (src[i] + pred) & 0xFF
            cur = np.array(cur_l, np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {kind} in row {y}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """The samples of a PNG as stored: (H, W, C) uint8 or uint16, C the
    colour type's samples (gray 1, gray + alpha 2, RGB 3, RGBA 4). Takes
    8- and 16-bit non-interlaced files; raises ValueError naming the file
    for a palette, an interlaced or a sub-byte image."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if colour == 3:
        raise ValueError(f"{path}: palette PNGs are not supported")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    if colour not in _SAMPLES or depth not in (8, 16):
        raise ValueError(f"{path}: PNG colour type {colour} at bit depth {depth} "
                         f"is not supported (8- or 16-bit gray, gray + alpha, "
                         f"RGB, RGBA)")
    samples, nbytes = _SAMPLES[colour], depth // 8
    bpp = samples * nbytes
    img = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp, path)
    if depth == 16:
        img = img.view(">u2").astype(np.uint16)
    return img.reshape(height, width, samples)


def imread_rgb(path: str, bit_depth: Optional[int] = None) -> np.ndarray:
    """A PNG as HWC RGB float32 in [0, 1]: gray repeated to three channels,
    alpha dropped. With ``bit_depth`` the values are divided by
    2^bit_depth - 1 whatever they hold; otherwise by 4095 if any exceeds
    255, else by 255."""
    img = read_png(path)
    img = img[:, :, :1].repeat(3, axis=2) if img.shape[2] <= 2 else img[:, :, :3]
    img = img.astype(np.float32)
    if bit_depth is not None:
        return img / float(2 ** bit_depth - 1)
    return img / (4095.0 if img.max() > 255 else 255.0)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def save_png(y_hwc: np.ndarray, path: str) -> None:
    """Write an HWC (or HW1) float image in [0, 1] as an 8-bit PNG: gray
    for one channel, RGB for three."""
    img = np.clip(y_hwc, 0.0, 1.0)
    if img.shape[-1] == 1:
        img = img[:, :, 0]
    q = (img * 255.0 + 0.5).astype(np.uint8)
    if q.ndim == 2:
        colour = 0
    elif q.ndim == 3 and q.shape[2] == 3:
        colour = 2
    else:
        raise ValueError(f"save_png writes gray or RGB images, got shape {y_hwc.shape}")
    h, w = q.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), q.reshape(h, -1)], axis=1)
    with open(path, "wb") as f:
        f.write(SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))
