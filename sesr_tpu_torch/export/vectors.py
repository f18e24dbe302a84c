"""RTL test-vector exporters: the ASIC's stimulus and expected-response
hex streams, byte for byte as the reference writes them (its output.py,
output_end2end.py and the weight export of quan_func.py), from a
``QuantParams`` and the dumps of the plain interpreter
(``quant/integer.py`` ``integer_forward(collect_dumps=True)``).

The same exporters as the JAX package's ``sesr_tpu/export/vectors.py``,
formatted a whole array at a time (``export/hexfmt.py``); each returns its
files' contents as ASCII bytes. Every quirk of the reference's formats is
kept on purpose:

- the ``input`` tile stream pads W to the NEXT multiple of 32 even when W
  already is one, and its buffer keeps the original height;
- its first tile row and column are shrunk by the cumulative k//2 halo of
  the convs before the domain, the last height block takes the rows left;
- the ``pe_out`` / ``pe_add`` 32x32 block walk stops a block early at the
  image's last row;
- the end-to-end stream does not scale its height-block index by the tile
  (block hb reads rows hb..hb+31), and breaks a line after every fourth
  value and at the end of each image row whose count is not a multiple of
  four, without restarting the count;
- a negative requantization exponent (sr_x2_qat's ``res_requant_n``) is
  written as its two's complement, ``-1`` at 5 bits -> ``1f``.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List

import numpy as np

from sesr_tpu_torch.export.hexfmt import (NEWLINE, header, header_cells, hex_cells,
                                          hex_rows)
from sesr_tpu_torch.quant.params import QuantParams

TILE = 32


def _chw(a) -> np.ndarray:
    """The first image of an NHWC dump, channel-major (C, H, W)."""
    return np.asarray(a)[0].transpose(2, 0, 1)


def export_weights(qp: QuantParams) -> Dict[str, bytes]:
    """conv.weight.{i}.txt: a count line, then per 4-oc x 4-ic block and
    (kh, kw) tap one line of 16 values, ic-major inside the line; oc and
    ic padded up to multiples of 4."""
    out = {}
    for i, w_hwio in enumerate(qp.w_int):
        kh, kw, ic_r, oc_r = np.shape(w_hwio)
        oc, ic = math.ceil(oc_r / 4) * 4, math.ceil(ic_r / 4) * 4
        buf = np.zeros((kh, kw, ic, oc), np.int64)
        buf[:, :, :ic_r, :oc_r] = w_hwio
        # (kh, kw, bic, c, boc, o) -> (boc, bic, kh, kw, c, o)
        blocks = buf.reshape(kh, kw, ic // 4, 4, oc // 4, 4).transpose(4, 2, 0, 1, 3, 5)
        out[f"conv.weight.{i}.txt"] = (
            header(oc * ic * kh * kw // 16)
            + hex_rows(blocks.reshape(-1, 16), qp.hw.quan_bits).tobytes())
    return out


def _blocks(headers: np.ndarray, channel_rows: np.ndarray) -> bytes:
    """Blocks of the tile streams: per block its header lines, then per
    channel its index line and its rows. headers (B, n) uint8;
    channel_rows (B, C, R, line) uint8."""
    b, c = channel_rows.shape[:2]
    chan = np.broadcast_to(header_cells(np.arange(c)), (b, c, 3))
    body = np.concatenate([chan, channel_rows.reshape(b, c, -1)], axis=2)
    return np.concatenate([headers, body.reshape(b, -1)], axis=1).tobytes()


def export_input_tiles(qp: QuantParams, dumps: Dict[str, np.ndarray],
                       kernel_sizes: List[int]) -> Dict[str, bytes]:
    """input.{d}.txt: the 32-wide tile stream of each domain's int8 values,
    with the per-layer halo shrink."""
    out = {}
    overlap = TILE
    ksched = [0] + list(kernel_sizes)
    for d in range(len(kernel_sizes) + 1):
        data = _chw(dumps[f"input.{d}"])
        c, h, w = data.shape
        exp_w = (w // TILE + 1) * TILE
        nwb, nhb = exp_w // TILE, h // TILE + 1
        overlap -= ksched[d] // 2
        buf = np.zeros((c, h, exp_w), data.dtype)
        buf[:, :, :w] = data
        # the first column block: ``overlap`` values, then zeros to the tile
        cols = np.zeros((c, h, nwb, TILE), data.dtype)
        cols[:, :, 0, :overlap] = buf[:, :, :overlap]
        cols[:, :, 1:] = buf[:, :, overlap:overlap + (nwb - 1) * TILE].reshape(
            c, h, nwb - 1, TILE)
        parts, bh = [], 0
        for hb in range(nhb):
            rows = h - bh if hb == nhb - 1 else overlap if hb == 0 else TILE
            tiles = cols[:, bh:bh + rows].transpose(2, 0, 1, 3)     # (nwb, c, rows, TILE)
            heads = np.frombuffer(header(rows) + header(c), np.uint8)
            parts.append(_blocks(np.broadcast_to(heads, (nwb, heads.size)),
                                 hex_rows(tiles, qp.hw.quan_bits)))
            bh += rows
        out[f"input.{d}.txt"] = b"".join(parts)
    return out


def export_param_buf(qp: QuantParams) -> bytes:
    """param_buf.txt: the conv count, then per conv its channel count and
    per output channel one {fused bias, requant mantissa, residual requant
    mantissa} line."""
    hw = qp.hw
    parts = [hex_rows([[qp.num_convs]], 8).tobytes()]
    res = hex_cells(qp.res_requant_m, hw.requant_bits)
    for i in range(qp.num_convs):
        fused = np.asarray(qp.fused_bias(i))
        n = fused.shape[0]
        parts.append(hex_rows([[n]], 8).tobytes())
        m = hex_cells(qp.requant_m[i], hw.requant_bits)
        lines = np.concatenate([
            hex_cells(fused, hw.bias_bits), np.broadcast_to(m, (n, m.size)),
            np.broadcast_to(res, (n, res.size)),
            np.full((n, 1), NEWLINE, np.uint8)], axis=1)
        parts.append(lines.tobytes())
    return b"".join(parts)


def _blocked_stream(data_chw: np.ndarray, bit_width: int) -> bytes:
    """The pe_out / pe_add 32x32 block walk: per block its row count (the
    rows left in the last height block) and channel count, then per channel
    its index line and rows of 32 values, W zero-padded to the tile."""
    c, h, w = data_chw.shape
    exp_w = -(-w // TILE) * TILE
    nwb, nhb = exp_w // TILE, -(-h // TILE)
    buf = np.zeros((c, h, exp_w), data_chw.dtype)
    buf[:, :, :w] = data_chw
    parts = []
    for hb in range(nhb):
        bh = hb * TILE
        rows = min(TILE, h - bh)
        tiles = buf[:, bh:bh + rows].reshape(c, rows, nwb, TILE).transpose(2, 0, 1, 3)
        heads = np.frombuffer(header(rows) + header(c), np.uint8)
        parts.append(_blocks(np.broadcast_to(heads, (nwb, heads.size)),
                             hex_rows(tiles, bit_width)))
    return b"".join(parts)


def export_pe_out(qp: QuantParams, dumps: Dict[str, np.ndarray]) -> Dict[str, bytes]:
    """pe_output{i}_{p}.txt: each PE's saturated partial sums of conv i."""
    out = {}
    for i in range(qp.num_convs):
        pe = np.asarray(dumps[f"pe_out.{i}"])            # (PE, N, H, W, OC)
        for p in range(qp.hw.pe):
            out[f"pe_output{i}_{p}.txt"] = _blocked_stream(_chw(pe[p]), qp.hw.pe_acc_bits)
    return out


def export_pe_add(qp: QuantParams, dumps: Dict[str, np.ndarray]) -> Dict[str, bytes]:
    """pe_add_output{i}.txt: the saturated adder-tree sums of conv i."""
    return {f"pe_add_output{i}.txt": _blocked_stream(_chw(dumps[f"pe_add.{i}"]),
                                                     qp.hw.pe_add_bits)
            for i in range(qp.num_convs)}


def export_requant_shifts(qp: QuantParams) -> bytes:
    """requan_shift_n.txt: each conv's requantization exponent, then the
    residual's, with no newline after the last."""
    width = int(math.log2(qp.hw.requant_n_max))
    cells = hex_cells(list(qp.requant_n) + [qp.res_requant_n], width)
    lines = np.concatenate([cells, np.full((len(cells), 1), NEWLINE, np.uint8)], axis=1)
    return lines.tobytes()[:-1]


def export_end2end(qp: QuantParams, dumps: Dict[str, np.ndarray],
                   domains=(0, None)) -> Dict[str, bytes]:
    """Layer 0's input and the final domain's output (``domains``: (0,
    None) for 0 and L, else the domain indices) in the full-chip
    end-to-end row-major format: per height block its index, then per
    channel its index and the block's 32 rows, four values a line."""
    L = qp.num_convs
    out = {}
    for d in ([0, L] if domains == (0, None) else list(domains)):
        data = _chw(dumps[f"input.{d}"])
        c, h, w = data.shape
        nhb = -(-h // TILE)
        buf = np.zeros((c, nhb * TILE, w), data.dtype)
        buf[:, :h] = data
        # the upstream indexing kept: block hb reads rows hb..hb+31
        rows = np.stack([buf[:, hb:hb + TILE] for hb in range(nhb)])   # (nhb, c, TILE, w)
        cells = hex_cells(rows.reshape(nhb, c, -1), qp.hw.quan_bits)
        n, digits = TILE * w, cells.shape[-1]
        k = np.arange(n)
        # a line ends after every fourth value, and at a row's end whose
        # running count is not a multiple of four (the count runs on)
        breaks = ((k + 1) % 4 == 0) | (k % w == w - 1)
        starts = k * digits + np.concatenate([[0], np.cumsum(breaks)[:-1]])
        body = np.empty((nhb, c, n * digits + int(breaks.sum())), np.uint8)
        for j in range(digits):
            body[:, :, starts + j] = cells[:, :, :, j]
        body[:, :, starts[breaks] + digits] = NEWLINE
        chan = np.broadcast_to(header_cells(np.arange(c)), (nhb, c, 3))
        blocks = np.concatenate([chan, body], axis=2).reshape(nhb, -1)
        out[f"input.{d}.txt"] = b"".join(header(hb) + blocks[hb].tobytes()
                                         for hb in range(nhb))
    return out


def export_tree(qp: QuantParams, dumps: Dict[str, np.ndarray],
                kernel_sizes: List[int]) -> Dict[str, Dict[str, bytes]]:
    """The whole output_txt/ tree: {subdirectory: {file name: contents}}."""
    return {
        "weight": export_weights(qp),
        "input": export_input_tiles(qp, dumps, kernel_sizes),
        "bias": {"param_buf.txt": export_param_buf(qp)},
        "pe_out": export_pe_out(qp, dumps),
        "pe_add": export_pe_add(qp, dumps),
        "requan_shift_n": {"requan_shift_n.txt": export_requant_shifts(qp)},
        "end2end": export_end2end(qp, dumps),
    }


def export_all(qp: QuantParams, dumps: Dict[str, np.ndarray],
               kernel_sizes: List[int], out_dir: str) -> List[str]:
    """Write the output_txt/ tree (the reference's export layout) under
    ``out_dir``; returns the paths written. ``dumps``: numpy arrays (a
    dump dict on a device is moved to the host first)."""
    written = []
    for sub, files in export_tree(qp, dumps, kernel_sizes).items():
        d = os.path.join(out_dir, sub)
        os.makedirs(d, exist_ok=True)
        for name, text in files.items():
            path = os.path.join(d, name)
            with open(path, "wb") as f:
                f.write(text)
            written.append(path)
    return written
