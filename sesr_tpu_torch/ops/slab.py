"""Overlapping windows on one device: a frame as H-slabs, and the windows
of the sharded deployment forwards (``parallel/tiling.py``).

Port of sesr_tpu/ops/slab.py. The fused kernels run the whole network in
one launch, so there is nowhere inside them for a per-layer halo exchange.
A block [a, b) of the frame is instead computed from a window that reaches
R = ``spec.halo_width()`` = sum(k_i // 2) input pixels past each cut,
clamped inside the image, and only the block is kept:

- an output pixel at distance >= R from a window's cut edge cannot be
  influenced by anything beyond it, since each conv propagates influence
  k_i // 2 pixels, so the zero padding at the cut never reaches the block;
- at a true image edge the monolithic network zero-pads every layer's
  input, while pixels past a fetched halo would hold computed values
  (relu(bias) leaks in). So a window never reaches past the image edge:
  there its edge is the image's, and the kernel's own SAME padding is the
  monolithic padding. The residual shortcut is spatially local, so the
  argument covers it.

An overlap of R - 1 is not exact. The frame is quantized once; each window
is one launch of the deployment forward's kernel on the int8 window (the
plain version on a CPU tensor), in the int8 output contract; the blocks
are stitched as int8 and dequantized once (an elementwise map, so the
values are those of a forward that dequantizes each window). The JAX
package packs its windows into cells; the port does not pack, so the
cell geometry has no counterpart.
"""

from __future__ import annotations

from typing import Optional

import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.deploy import select_forward
from sesr_tpu_torch.ops.halo import halo_exchange
from sesr_tpu_torch.ops.kernels import OUT_DTYPES
from sesr_tpu_torch.quant.integer import as_input, dequantize_output, quantize_input
from sesr_tpu_torch.quant.params import QuantParams

# the JAX package aligns a slab's height to its (2, 4) cells' two rows;
# the port keeps the same heights
SLAB_ALIGN = 2


def receptive_radius(spec: SESRSpec) -> int:
    """Total receptive-field radius of the conv stack in input pixels."""
    return spec.halo_width()


def pick_slab_h(spec: SESRSpec, H: int, target: int = 272) -> int:
    """A slab height near ``target`` (even) such that the slabs cover H;
    frames at or below 2 x target run in one piece."""
    if H <= 2 * target:
        return H
    n_slabs = -(-H // target)
    per_slab = -(-H // n_slabs)
    return -(-per_slab // SLAB_ALIGN) * SLAB_ALIGN


def window(a: int, b: int, extent: int, R: int):
    """The window [lo, hi) that computes block [a, b) of [0, extent) exactly:
    R past each cut, clamped at the image edges."""
    return max(a - R, 0), min(b + R, extent)


def blocks(extent: int, n: int) -> list:
    """[a, b) of each of n blocks of [0, extent), in order (sizes differ by
    at most one)."""
    return [(j * extent // n, (j + 1) * extent // n) for j in range(n)]


def crop_block(y: torch.Tensor, spec: SESRSpec, keep_h, keep_w) -> torch.Tensor:
    """A window's output image ``y`` cropped to the block. ``keep_h`` /
    ``keep_w`` = (offset, length) of the block inside the window in input
    pixels (the output's are r times those, r the pixel shuffle's factor)."""
    r = spec.scaling_factor
    (oh, lh), (ow, lw) = keep_h, keep_w
    return y[:, oh * r:(oh + lh) * r, ow * r:(ow + lw) * r]


def run_window(fwd, spec: SESRSpec, qp: QuantParams, x_q: torch.Tensor, keep_h,
               keep_w) -> torch.Tensor:
    """``fwd`` on the int8 window ``x_q`` (N, h, w, C): its int8 output
    image cropped to the block (``crop_block``)."""
    return crop_block(fwd(spec, qp, x_q, out_dtype="int8", quantized=True), spec, keep_h, keep_w)


def rank_window(spec: SESRSpec, qp: QuantParams, x, h_group=None, w_group=None) -> tuple:
    """This rank's window of a sharded frame: (the int8 window, keep_h,
    keep_w). x is the rank's block; it is quantized, R =
    ``spec.halo_width()`` rows along ``h_group`` and columns along
    ``w_group`` are exchanged (the int8 input, once; each rank's block at
    least R wide), and what an edge rank received from beyond the image is
    dropped (``window``). keep_h / keep_w = (offset, length) of the block
    inside the window."""
    R = spec.halo_width()
    x_q = quantize_input(as_input(x), qp).to(torch.int8)
    keep = []
    for dim, group in ((1, h_group), (2, w_group)):
        ext = x_q.shape[dim]
        if group is None or group.size() == 1:
            keep.append((0, ext))
            continue
        a = group.rank() * ext
        lo, hi = window(a, a + ext, group.size() * ext, R)
        x_q = halo_exchange(x_q, R, group, dim).narrow(dim, lo - (a - R), hi - lo)
        keep.append((a - lo, ext))
    return x_q, keep[0], keep[1]


def output_contract(y_q: torch.Tensor, qp: QuantParams, out_dtype: str) -> torch.Tensor:
    """The int8 output image ``y_q`` in the ``out_dtype`` contract: as it is
    ("int8") or dequantized ("f32")."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype!r}")
    return y_q if out_dtype == "int8" else dequantize_output(y_q, qp)


def windowed_forward(spec: SESRSpec, qp: QuantParams, x_q: torch.Tensor, h_blocks, w_blocks,
                     fwd, out_dtype: str = "f32") -> torch.Tensor:
    """The output of the int8 frame ``x_q`` from one window per (H block, W
    block), run in turn and stitched: one launch of ``fwd``'s kernel each."""
    R = spec.halo_width()
    H, W = x_q.shape[1:3]
    rows = []
    for ha, hb in h_blocks:
        h_lo, h_hi = window(ha, hb, H, R)
        cols = []
        for wa, wb in w_blocks:
            w_lo, w_hi = window(wa, wb, W, R)
            cols.append(run_window(fwd, spec, qp, x_q[:, h_lo:h_hi, w_lo:w_hi],
                                   (ha - h_lo, hb - ha), (wa - w_lo, wb - wa)))
        rows.append(torch.cat(cols, dim=2))
    return output_contract(torch.cat(rows, dim=1), qp, out_dtype)


def slab_forward(spec: SESRSpec, qp: QuantParams, x, slab_h: Optional[int] = None, fwd=None,
                 batch_serial: bool = False, out_dtype: str = "f32",
                 device=None) -> torch.Tensor:
    """The deployment forward over H-slabs of ``slab_h`` rows (None:
    ``pick_slab_h``; H or more: one piece), each extended by R rows inside
    the frame. x: NHWC float in [0, 1] (numpy or tensor) on ``device``
    (default: x's device, else ``cuda``). ``fwd``: a deployment forward
    (default: the one the certificate selects, ``deploy.select_forward``).
    ``batch_serial``: the frames of a batch one after another. Equal,
    value for value, to ``fwd`` on the whole frame."""
    if fwd is None:
        fwd = select_forward(qp)[1]
    x = as_input(x, device)
    n, H, W, _ = x.shape
    if batch_serial and n > 1:
        return torch.cat([slab_forward(spec, qp, x[i:i + 1], slab_h, fwd, out_dtype=out_dtype)
                          for i in range(n)])
    slab_h = slab_h or pick_slab_h(spec, H)
    x_q = quantize_input(x, qp).to(torch.int8)
    h_blocks = [(a, min(a + slab_h, H)) for a in range(0, H, slab_h)]
    return windowed_forward(spec, qp, x_q, h_blocks, [(0, W)], fwd, out_dtype)
