"""Vectorized two's-complement hex formatting of whole integer arrays.

The RTL vector files hold one fixed-width hex field per value,
``max(ceil(bits / 4), 2)`` lowercase digits: ``ops/fixedpoint.py``
``int_to_hex`` is the scalar spec, and every field written here equals it.
The digits of a whole array are made at once: the value as an unsigned
field (a negative value plus 2^bits), split into nibbles, each looked up in
a ``b"0123456789abcdef"`` table, into a ``uint8`` buffer that the caller
assembles into rows and writes as bytes.

A value whose scalar string would have another length (below -2^bits, or
at 16^digits and above) or that is not an integer raises ValueError: the
file would lose its fixed layout, and no stage of the datapath holds such
a value, since every stage is clamped to its width.
"""

from __future__ import annotations

import math

import numpy as np

DIGITS = np.frombuffer(b"0123456789abcdef", np.uint8)
# the two digits of each byte value, as one uint16 (its bytes in memory order)
PAIRS = np.stack([DIGITS[np.arange(256) >> 4], DIGITS[np.arange(256) & 15]],
                 axis=1).view(np.uint16)[:, 0]
NEWLINE = ord("\n")


def digits_of(bits: int) -> int:
    """Hex digits of a ``bits``-wide field: ceil(bits / 4), at least 2."""
    return max(math.ceil(bits / 4), 2)


def _as_int64(values) -> np.ndarray:
    """``values`` (integers, or integer-valued floats) as int64; ValueError
    on a value that is not an integer."""
    a = np.asarray(values)
    if a.dtype.kind in "iub":
        return a.astype(np.int64)
    if a.dtype.kind != "f":
        raise ValueError(f"hex fields hold integers, got dtype {a.dtype}")
    with np.errstate(invalid="ignore"):
        v = a.astype(np.int64)
    if (v != a).any():
        raise ValueError("hex fields hold integers, got a value that is not one")
    return v


def hex_cells(values, bits: int) -> np.ndarray:
    """The hex field of every value: uint8, shape ``values.shape + (digits,)``."""
    v = _as_int64(values)
    d = digits_of(bits)
    if v.size and (v.min() < -(1 << bits) or v.max() >= 16 ** d):
        raise ValueError(f"a value outside [-2^{bits}, 16^{d}) has no {d}-digit "
                         f"{bits}-bit hex field")
    u = np.where(v < 0, v + (1 << bits), v).astype(np.uint32 if d <= 8 else np.uint64)
    out = np.empty(v.shape + (d,), np.uint8)
    k = d // 2                                  # whole bytes; an odd digit leads
    if d % 2:
        out[..., 0] = DIGITS[u >> (8 * k)]
    pairs = np.empty(v.shape + (k,), np.uint16)
    for j in range(k):
        pairs[..., j] = PAIRS[(u >> (8 * (k - 1 - j))) & 255]
    out[..., d % 2:] = pairs.view(np.uint8).reshape(v.shape + (2 * k,))
    return out


def hex_rows(values, bits: int) -> np.ndarray:
    """Each row of the last axis as one line: its fields then a newline.
    uint8, shape ``values.shape[:-1] + (n * digits + 1,)``."""
    cells = hex_cells(values, bits)
    lead, width = cells.shape[:-2], cells.shape[-2] * cells.shape[-1]
    out = np.empty(lead + (width + 1,), np.uint8)
    out[..., :-1] = cells.reshape(lead + (width,))
    out[..., -1] = NEWLINE
    return out


def header(value: int) -> bytes:
    """A count or index line of the streams, ``"{:02x}\\n"``: at least two
    digits, more where the value needs them."""
    return b"%02x\n" % value


def header_cells(values) -> np.ndarray:
    """``header`` of each of ``values`` (all below 256), uint8 (n, 3)."""
    return hex_rows(np.asarray(values, np.int64)[:, None], 8)
