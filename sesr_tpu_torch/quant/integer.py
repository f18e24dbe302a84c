"""The plain integer interpreter of the ASIC datapath, in PyTorch.

Value for value the same as the JAX package's
``sesr_tpu/quant/integer.py::integer_forward`` with the sim residual
wiring, per conv i:

  1. domain-in: conv 0 quantizes from float; middle convs add their zero
     point with an int8 clamp; the last conv does the integer residual add.
     The value fed to the conv is q - max(zero, -128).
  2. 4-PE partial convs (input channel c belongs to PE c % 4).
  3. per-PE zero restoration z_eff * sum(W_p), saturated to 18 bits.
  4. the 4-way PE sum saturated to 20 bits.
  5. fused bias: clamp(bias_int - zero * sum(W), 16 bits), with the
     unfloored zero.
  6. requantization by a 16-bit mantissa x 2^-n, rounded to float32 after
     each multiply; ReLU; conv 0's output is the residual shortcut; the
     last conv re-quantizes into the output domain and dequantizes.

``residual_mode`` wires the residual as the reference's compositions do:
"sim" (the default, the integer residual add above), "graph_add" (the
MFLAG 1/2 composition, where the model's float AddOp stays in the graph
ahead of the last conv, so the shortcut is added twice: a quirk the nr and
dm goldens pin) and "graph_add_qat" (that AddOp swapped for the frozen
QuantAdd of the qatf="qat_" composition, ``quant/qat.py``).

``corrected=True`` is the deployment datapath: no restoration, the clipped
``bias_int`` as the bias, and the residual add of the rounded operands at
full width. ``compute="fast"`` (corrected only, certified artifacts only)
runs one full-channel conv per layer with no per-PE stage; ``fast_layers``
(corrected only) does so on the flagged layers alone, as the layer-hybrid
lowering of the JAX package does (``packed_hybrid_forward``).

This module is the plain version behind the three hand-written kernels
(``ops/pe_exact.py``, ``ops/fast.py``, ``ops/corrected.py``). Its convolutions run in float64 on
integer values, where every partial sum is exact, then round: no TF32 and
no fast convolution algorithm can change a value.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.ops.conv import conv2d_nhwc, pixel_shuffle_nhwc
from sesr_tpu_torch.ops.fixedpoint import apply_requant_f32, saturate
from sesr_tpu_torch.quant.params import QuantParams
from sesr_tpu_torch.quant.qat import quant_add_frozen

COMPUTE_MODES = ("exact", "fast")
RESIDUAL_MODES = ("sim", "graph_add", "graph_add_qat")


def pe_channel_mask(ic: int, pe: int, p: int) -> np.ndarray:
    """The one channel round-robin rule of the PE decomposition: input
    channel c belongs to PE p iff c % pe == p. Every site that splits
    channels by PE (this module, the kernels' weight packing in
    ``convert.py``) derives from this helper."""
    return (np.arange(ic) % pe == p)


def resolve_device(x, device=None) -> torch.device:
    """The device a call runs on: ``device`` when given, else the device of
    a tensor ``x``, else the card."""
    if device is not None:
        return torch.device(device)
    if isinstance(x, torch.Tensor):
        return x.device
    return torch.device("cuda")


def as_input(x, device=None) -> torch.Tensor:
    """NHWC float32 tensor of ``x`` (numpy or tensor) on the call's device."""
    return torch.as_tensor(x, dtype=torch.float32, device=resolve_device(x, device))


def quant_limits(qp: QuantParams):
    bits = qp.hw.quan_bits
    return float(-(1 << (bits - 1))), float((1 << (bits - 1)) - 1)


def quantize_input(x: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """clip(round(x / f32(s0) + f32(z0))): the division is by the float32
    cast of the scale, through a one-element tensor so that no backend
    turns it into a multiply by the reciprocal."""
    qmin, qmax = quant_limits(qp)
    s0 = torch.tensor([qp.a_scale[0]], dtype=torch.float32, device=x.device)
    return torch.clamp(torch.round(x / s0 + float(qp.a_zero[0])), qmin, qmax)


def dequantize_output(y_q: torch.Tensor, qp: QuantParams) -> torch.Tensor:
    """(q - f32(z_L)) * f32(s_L), in float32."""
    L = qp.num_convs
    s_l = float(np.float32(qp.a_scale[L]))
    return (y_q.to(torch.float32) - float(qp.a_zero[L])) * s_l


def _domain_in(h, i: int, L: int, qp: QuantParams, shortcut,
               corrected: bool) -> torch.Tensor:
    """The int8 value x_q that conv i reads (as float32)."""
    qmin, qmax = quant_limits(qp)
    zero = float(qp.a_zero[i])
    if i == 0:
        return quantize_input(h, qp)
    if i == L - 1:
        half = -qmin
        if corrected:
            t = torch.round(shortcut) + torch.round(h)
        else:
            res_c = torch.clamp(torch.round(shortcut - half), qmin, qmax)
            in_c = torch.clamp(torch.round(h - half), qmin, qmax)
            t = res_c + in_c + 2.0 * half
        t = apply_requant_f32(t, qp.res_requant_m, qp.res_requant_n)
        return torch.clamp(torch.round(t + zero), qmin, qmax)
    return torch.clamp(torch.round(h + zero), qmin, qmax)


def graph_residual(h: torch.Tensor, shortcut: torch.Tensor, qp: QuantParams,
                   residual_mode: str, qat_add_bounds) -> torch.Tensor:
    """The graph's own residual add ahead of the last conv in the
    "graph_add" modes: h + shortcut, or the frozen QuantAdd of the two; the
    last conv's domain-in then adds the shortcut again."""
    if residual_mode == "graph_add_qat":
        return quant_add_frozen(h, shortcut, *qat_add_bounds, qp.hw.quan_bits)
    return h + shortcut


def _conv_int(x64: torch.Tensor, w: np.ndarray) -> torch.Tensor:
    """Exact integer SAME conv of float64 integer values, as float64."""
    n, hh, ww, _ = x64.shape
    if w.shape[2] == 0:                    # a PE that owns no channel
        return x64.new_zeros((n, hh, ww, w.shape[3]))
    w_t = torch.as_tensor(np.asarray(w, np.float64), device=x64.device)
    return torch.round(conv2d_nhwc(x64, w_t))


def _integer_conv_pe(x_shift: torch.Tensor, i: int, qp: QuantParams,
                     corrected: bool, dense: bool):
    """Steps 2-5. Returns (pe_out (PE, N, H, W, OC), pe_add, y, ovf18,
    ovf20), all integer-valued int32 tensors (counts as int64)."""
    hw = qp.hw
    w = np.asarray(qp.w_int[i])
    x64 = x_shift.to(torch.float64)
    hi16 = (1 << (hw.bias_bits - 1)) - 1
    clipped_bias = np.clip(np.asarray(qp.bias_int[i]), -hi16 - 1, hi16)
    dev = x_shift.device
    zero_count = torch.zeros((), dtype=torch.int64, device=dev)

    if dense:
        pe_add = saturate(_conv_int(x64, w), hw.pe_add_bits)
        y = pe_add + torch.as_tensor(clipped_bias.astype(np.float64), device=dev)
        pe_add = pe_add.to(torch.int32)
        return pe_add[None], pe_add, y.to(torch.int32), zero_count, zero_count

    z_eff = qp.effective_zero(i)
    pe_outs = []
    ovf18 = zero_count
    for p in range(hw.pe):
        w_p = w[:, :, pe_channel_mask(w.shape[2], hw.pe, p), :]
        y_p = _conv_int(x64[..., pe_channel_mask(x64.shape[-1], hw.pe, p)], w_p)
        if not corrected:
            zsum = w_p.sum(axis=(0, 1, 2)).astype(np.int64) * z_eff
            y_p = y_p + torch.as_tensor(zsum.astype(np.float64), device=dev)
        y_sat = saturate(y_p, hw.pe_acc_bits)
        ovf18 = ovf18 + (y_p != y_sat).sum()
        pe_outs.append(y_sat)
    pe_out = torch.stack(pe_outs, dim=0)
    pe_sum = pe_out.sum(dim=0)
    pe_add = saturate(pe_sum, hw.pe_add_bits)
    ovf20 = (pe_sum != pe_add).sum()
    fused = clipped_bias if corrected else qp.fused_bias(i)
    y = pe_add + torch.as_tensor(np.asarray(fused, np.float64), device=dev)
    return (pe_out.to(torch.int32), pe_add.to(torch.int32), y.to(torch.int32),
            ovf18, ovf20)


def integer_forward(spec: SESRSpec, qp: QuantParams, x,
                    collect_dumps: bool = False, corrected: bool = False,
                    compute: str = "exact", device=None, fast_layers=None,
                    residual_mode: str = "sim", qat_add_bounds=None):
    """Bit-exact integer forward. x: NHWC float in [0, 1] (numpy or tensor).

    Returns (y, dumps): y is the dequantized float32 output, pixel-shuffled
    where the task has a shuffle, on the call's device (``device``, else
    x's device, else ``cuda``). With ``collect_dumps`` the dict holds every
    stage, NHWC: ``input.{i}`` (x_q), ``pe_out.{i}`` (PE, N, H, W, OC),
    ``pe_add.{i}``, ``requant.{i}``, ``shortcut``, ``input.{L}`` (the int8
    output before dequantization and shuffle), and the per-layer
    saturation counts ``overflow_counts``, ``overflow_18``, ``overflow_20``.

    ``compute``: "exact" (the PE split; the values of the JAX package's
    "bf16" and "int32" modes) or "fast" (one full-channel conv per layer;
    requires ``corrected=True`` and a certified artifact).
    ``fast_layers`` (corrected only): one flag per layer; a flagged layer
    runs as one full-channel conv, with no per-PE stage (a certificate
    stamp says where that is exact; the result is this whatever the input).
    ``residual_mode``: "sim", "graph_add" or "graph_add_qat" (see the
    module docstring); the last needs ``qat_add_bounds`` = (union_lo,
    union_hi), the checkpoint's QuantAdd observer bounds
    (``io/torch_import.py`` ``load_qat_add_bounds``), which the other two
    modes ignore.
    """
    if residual_mode not in RESIDUAL_MODES:
        raise ValueError(f"residual_mode must be one of {RESIDUAL_MODES}, "
                         f"got {residual_mode!r}")
    if residual_mode == "graph_add_qat" and qat_add_bounds is None:
        raise ValueError("residual_mode='graph_add_qat' needs qat_add_bounds")
    if compute not in COMPUTE_MODES:
        raise ValueError(f"compute must be one of {COMPUTE_MODES}, got {compute!r}")
    if compute == "fast" and not qp.fast_cert_ok:
        raise ValueError(
            "compute='fast' requires a certified QuantParams: the fast "
            "datapath skips the per-PE 18-bit saturation stage and is only "
            "exact where certification has proven saturation-freedom. Use "
            "compute='exact' (PE-exact) for this artifact.")
    if compute == "fast" and not corrected:
        raise ValueError("compute='fast' is a mode of the corrected datapath")
    L = spec.num_convs
    if fast_layers is not None and (not corrected or len(fast_layers) != L):
        raise ValueError(f"fast_layers takes one flag per layer ({L}) of the "
                         f"corrected datapath, got {fast_layers!r}")
    dense = [compute == "fast" or bool(fast_layers and fast_layers[i]) for i in range(L)]
    qmin, qmax = quant_limits(qp)
    h = as_input(x, device)
    shortcut = None
    dumps: Dict[str, torch.Tensor] = {}
    overflows = []
    for i in range(L):
        if i == L - 1 and residual_mode != "sim":
            h = graph_residual(h, shortcut, qp, residual_mode, qat_add_bounds)
        x_q = _domain_in(h, i, L, qp, shortcut, corrected)
        x_shift = x_q - float(qp.effective_zero(i))
        pe_out, pe_add, y, ovf18, ovf20 = _integer_conv_pe(
            x_shift, i, qp, corrected, dense[i])
        overflows.append(torch.stack([ovf18, ovf20]))
        h = apply_requant_f32(y, qp.requant_m[i], qp.requant_n[i])
        if i == 0:
            shortcut = torch.relu(h)
        if i == L - 1:
            out_q = torch.clamp(torch.round(h + float(qp.a_zero[L])), qmin, qmax)
            h = dequantize_output(out_q, qp)
        else:
            h = torch.relu(h)
        if collect_dumps:
            dumps[f"input.{i}"] = x_q
            dumps[f"pe_out.{i}"] = pe_out
            dumps[f"pe_add.{i}"] = pe_add
            dumps[f"requant.{i}"] = h
            if i == 0:
                dumps["shortcut"] = shortcut
            if i == L - 1:
                dumps[f"input.{L}"] = out_q
    if collect_dumps:
        ovf = torch.stack(overflows)                       # (L, 2)
        dumps["overflow_counts"] = ovf.sum(dim=1)
        dumps["overflow_18"] = ovf[:, 0]
        dumps["overflow_20"] = ovf[:, 1]
    if spec.has_pixel_shuffle:
        h = pixel_shuffle_nhwc(h, spec.scaling_factor)
    return h, dumps


def integer_forward_int8(spec: SESRSpec, qp: QuantParams, x,
                         corrected: bool, compute: str, device=None,
                         fast_layers=None):
    """The raw int8 output image (pixel-shuffled) of integer_forward: the
    plain version of the kernels' int8 output contract."""
    _, dumps = integer_forward(spec, qp, x, collect_dumps=True,
                               corrected=corrected, compute=compute,
                               device=device, fast_layers=fast_layers)
    out_q = dumps[f"input.{spec.num_convs}"].to(torch.int8)
    if spec.has_pixel_shuffle:
        out_q = pixel_shuffle_nhwc(out_q, spec.scaling_factor)
    return out_q
