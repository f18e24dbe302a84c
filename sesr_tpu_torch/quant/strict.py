"""The strict per-MAC-saturating convolution: the hardware ground-truth spec.

The same model as the JAX package's ``sesr_tpu/quant/strict.py``. The
reference's ``conv_forward_naive`` clamps the running sum to PE_ACC_BIT
after every multiply-accumulate, in a fixed order (input channel, then
kernel row, then kernel column); the interpreter clamps once per PE after
the whole partial sum. The two agree unless a sum saturates on the way.

The JAX version stacks every shifted slice before a scan; here the taps
run as a loop in the same order, each one multiply-add and one clamp in
place on one int32 accumulator, so the memory is one accumulator and one
input whatever the frame. A tap whose weights are all zero (the channels
a PE does not own) is skipped: adding 0 to an accumulator that is already
in range and clamping it changes nothing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from sesr_tpu_torch.config import DEFAULT_HW, HardwareConfig
from sesr_tpu_torch.ops.conv import pixel_shuffle_nhwc
from sesr_tpu_torch.ops.fixedpoint import apply_requant_f32, saturate
from sesr_tpu_torch.quant.integer import (_conv_int, _domain_in, as_input,
                                          dequantize_output, graph_residual,
                                          pe_channel_mask, quant_limits)
from sesr_tpu_torch.quant.params import QuantParams


def conv_per_mac_saturating(x_nhwc, w_hwio, acc_bits: int = 18) -> torch.Tensor:
    """Stride-1 SAME conv whose accumulator saturates to ``acc_bits`` after
    every MAC, taps in the order input channel, kernel row, kernel column.
    x: NHWC integer values (tensor or numpy); w: HWIO integers (numpy).
    Returns the int32 (N, H, W, OC) accumulator on x's device."""
    x = torch.as_tensor(x_nhwc).to(torch.int32)
    w = np.asarray(w_hwio, np.int64)
    k, _, ic, oc = w.shape
    pad = k // 2
    n, h, wd, _ = x.shape
    xp = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad)).permute(0, 2, 3, 1)
    lo, hi = -(1 << (acc_bits - 1)), (1 << (acc_bits - 1)) - 1
    acc = torch.zeros((n, h, wd, oc), dtype=torch.int32, device=x.device)
    w_t = torch.as_tensor(w.astype(np.int32), device=x.device)
    for kc in range(ic):
        for kh in range(k):
            for kw in range(k):
                if not w[kh, kw, kc].any():
                    continue
                xs = xp[:, kh:kh + h, kw:kw + wd, kc:kc + 1]
                acc.addcmul_(xs, w_t[kh, kw, kc])
                acc.clamp_(lo, hi)
    return acc


def _pe_weights(w_int: np.ndarray, pe: int):
    """w_int split into ``pe`` kernels, each keeping the input channels of
    its PE (the others zero)."""
    w = np.asarray(w_int)
    return [w * pe_channel_mask(w.shape[2], pe, p)[None, None, :, None].astype(w.dtype)
            for p in range(pe)]


def strict_integer_forward(spec, qp: QuantParams, x, residual_mode: str = "sim",
                           qat_add_bounds=None, device=None) -> torch.Tensor:
    """Whole-network strict integer forward (the reference's hand-unrolled
    ``sesr_forward_sim``, generalized), on ``device`` (default: x's device,
    else ``cuda``). Per conv, as the reference composes it:

    1. the domain-in quantization of the reference-exact interpreter;
    2. each PE's conv through the per-MAC-saturating accumulator;
    3. that PE's zero restoration, clamped to 18 bits again;
    4. the 4-PE sum clamped to 20 bits, plus the fused bias;
    5. the requantization wiring and ReLU.

    Where no accumulator saturates on the way it equals the reference-exact
    ``integer_forward``. Returns the dequantized output, pixel-shuffled.
    """
    hw = qp.hw
    L = spec.num_convs
    qmin, qmax = quant_limits(qp)
    h = as_input(x, device)
    dev = h.device
    shortcut = None
    for i in range(L):
        if i == L - 1 and residual_mode != "sim":
            h = graph_residual(h, shortcut, qp, residual_mode, qat_add_bounds)
        x_q = _domain_in(h, i, L, qp, shortcut, corrected=False)
        x_shift = (x_q - float(qp.effective_zero(i))).to(torch.int32)
        z_eff = qp.effective_zero(i)
        total = None
        for w_p in _pe_weights(qp.w_int[i], hw.pe):
            y_p = conv_per_mac_saturating(x_shift, w_p, hw.pe_acc_bits)
            zsum = torch.as_tensor((w_p.sum(axis=(0, 1, 2)) * z_eff).astype(np.int32),
                                   device=dev)
            y_p = saturate(y_p + zsum, hw.pe_acc_bits)
            total = y_p if total is None else total + y_p
        pe_add = saturate(total, hw.pe_add_bits)
        y = pe_add + torch.as_tensor(np.asarray(qp.fused_bias(i), np.int32), device=dev)
        h = apply_requant_f32(y, qp.requant_m[i], qp.requant_n[i])
        if i == 0:
            shortcut = torch.relu(h)
        if i == L - 1:
            out_q = torch.clamp(torch.round(h + float(qp.a_zero[L])), qmin, qmax)
            h = dequantize_output(out_q, qp)
        else:
            h = torch.relu(h)
    if spec.has_pixel_shuffle:
        h = pixel_shuffle_nhwc(h, spec.scaling_factor)
    return h


def strict_vs_fast_divergence(x_nhwc, w_hwio, hw: HardwareConfig = DEFAULT_HW) -> int:
    """The number of outputs where the per-MAC-saturating model differs
    from the clamp-once conv: 0 means no transient saturation, so the fast
    kernels are exact against the strictest hardware model too."""
    x = torch.as_tensor(x_nhwc).to(torch.int32)
    strict = conv_per_mac_saturating(x, w_hwio, hw.pe_acc_bits)
    fast = saturate(_conv_int(x.to(torch.float64), np.asarray(w_hwio)), hw.pe_acc_bits)
    return int((strict != fast.to(torch.int32)).sum())
