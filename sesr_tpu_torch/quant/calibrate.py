"""Calibration and the fake-quant interpreter (the reference's test.py path).

The same numerics as the JAX package's ``sesr_tpu/quant/calibrate.py``:
every conv is preceded by a dynamic per-image fake-quant, and one forward
returns the output and the per-domain min/max of its input; the caller
folds min/max over the calibration set into static scales (``finalize``).

- Activations are quantized dynamically while calibrating: each image
  with its own min/max.
- Weights are fake-quantized once: w_int * w_scale.
- The PE accumulator and adder saturations are float clamps at
  (+-2^(bits-1) - zero) * s_a * s_w; with ``exact_pe`` the conv is split
  into the four per-PE partial convs, each clamped, before the adder clamp.
- The bias is added quantized-dequantized at scale s_a * s_w.
- The output domain L is observed on the last conv's biased output; its
  fake-quant applies only to nets with a pixel shuffle.

The dynamic scale, zero, s_eff and the clamp limits are float32 scalars
on the device, and every division is by a tensor on the device (a CUDA
division by a Python scalar is a multiply by its reciprocal). The float32
convs run inside ``float_exact()``: no TF32, deterministic algorithms.
"""

from __future__ import annotations

import warnings
from typing import Sequence

import numpy as np
import torch

from sesr_tpu_torch.config import DEFAULT_HW, HardwareConfig, SESRSpec
from sesr_tpu_torch.metrics import evaluate_pair
from sesr_tpu_torch.models.sesr import CollapsedParams, forward_float
from sesr_tpu_torch.ops.conv import conv2d_nhwc, float_exact, pixel_shuffle_nhwc
from sesr_tpu_torch.quant.integer import (as_input, integer_forward, pe_channel_mask,
                                          resolve_device)
from sesr_tpu_torch.quant.observers import (BINS_NUM, histogram_on_device, kl_bounds,
                                            percentile_bounds)
from sesr_tpu_torch.quant.params import CalibState, QuantParams, finalize, quantize_weights
from sesr_tpu_torch.quant.qat import quant_add_frozen

OBSERVERS = ("minmax", "percentile", "kl")


def _f32(v, device) -> torch.Tensor:
    """A float32 scalar on ``device``."""
    return torch.tensor(v, dtype=torch.float32, device=device)


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _dynamic_fake_quant(x: torch.Tensor, bits: int):
    """Per-tensor dynamic asymmetric fake-quant. Returns (x_fq, lo, hi,
    scale, zero), float32 scalars on x's device. An all-equal tensor gets
    the scale floor 1e-30 (the quantized tensor is then constant, not NaN;
    ``finalize`` refuses the degenerate range)."""
    qmax = float(2 ** (bits - 1) - 1)
    qmin = float(-(2 ** (bits - 1)))
    lo, hi = x.min(), x.max()
    scale = torch.clamp_min((hi - lo) / _f32(qmax - qmin, x.device), 1e-30)
    zero = qmin - torch.round(lo / scale)
    q = torch.clamp(torch.round(x / scale + zero), qmin, qmax)
    return (q - zero) * scale, lo, hi, scale, zero


def _fq_conv_layer(x_fq, w_fq, bias_f, scale, zero, w_scale: float,
                   hw: HardwareConfig, exact_pe: bool) -> torch.Tensor:
    """One conv of the fake-quant pipeline: the (PE-split) conv with float
    saturation clamps, plus the quantized bias."""
    acc_hi, acc_lo = float(2 ** (hw.pe_acc_bits - 1) - 1), float(-(2 ** (hw.pe_acc_bits - 1)))
    add_hi, add_lo = float(2 ** (hw.pe_add_bits - 1) - 1), float(-(2 ** (hw.pe_add_bits - 1)))
    s_eff = scale * _f32(w_scale, x_fq.device)
    if exact_pe:
        ic = w_fq.shape[2]
        y = None
        for p in range(hw.pe):
            mask = torch.as_tensor(pe_channel_mask(ic, hw.pe, p).astype(np.float32),
                                   device=x_fq.device)
            y_p = conv2d_nhwc(x_fq, w_fq * mask[None, None, :, None])
            y_p = torch.clamp(y_p, (acc_lo - zero) * s_eff, (acc_hi - zero) * s_eff)
            y = y_p if y is None else y + y_p
    else:
        y = conv2d_nhwc(x_fq, w_fq)
    y = torch.clamp(y, (add_lo - zero) * s_eff, (add_hi - zero) * s_eff)
    b_hi, b_lo = float(2 ** (hw.bias_bits - 1) - 1), float(-(2 ** (hw.bias_bits - 1)))
    b_q = torch.clamp(torch.round(bias_f / s_eff), b_lo, b_hi) * s_eff
    return y + b_q


def _calibration_forward_impl(spec: SESRSpec, fq_weights, x: torch.Tensor,
                              hw: HardwareConfig, exact_pe: bool, hist_bounds=None,
                              qat_add_bounds=None):
    """(y, minmax (2, L+1)), and with ``hist_bounds`` ((L+1, 2) float32 on
    the device) also the (L+1, BINS_NUM) histograms of every domain."""
    w_fq, w_scales, biases = fq_weights
    L = spec.num_convs
    lows, highs, hists = [], [], []

    def observe(h, d):
        lows.append(h.min())
        highs.append(h.max())
        if hist_bounds is not None:
            hists.append(histogram_on_device(h, hist_bounds[d, 0], hist_bounds[d, 1]))

    h = x
    c0 = None
    for i in range(L):
        if i == L - 1:
            # the outer residual add; in the qatf="qat_" composition the
            # frozen QuantAdd that replaced it
            h = (quant_add_frozen(h, c0, *qat_add_bounds, hw.quan_bits)
                 if qat_add_bounds is not None else h + c0)
        observe(h, i)
        h_fq, _, _, scale, zero = _dynamic_fake_quant(h, hw.quan_bits)
        h = _fq_conv_layer(h_fq, w_fq[i], biases[i], scale, zero, w_scales[i], hw, exact_pe)
        if i < L - 1:
            h = torch.relu(h)
        if i == 0:
            c0 = h
    observe(h, L)
    if spec.has_pixel_shuffle:
        h = pixel_shuffle_nhwc(_dynamic_fake_quant(h, hw.quan_bits)[0], spec.scaling_factor)
    minmax = torch.stack([torch.stack(lows), torch.stack(highs)])
    if hist_bounds is not None:
        return h, minmax, torch.stack(hists)
    return h, minmax


def _prep_fq_weights(params: CollapsedParams, hw: HardwareConfig, device,
                     w_int_override=None):
    """((w_fq, w_scales, biases) on ``device``, w_int, w_scale).
    ``w_int_override``: per-layer integer weights replacing round-to-nearest
    at the same per-tensor scales (adaptive rounding produces them)."""
    w_int, w_scale = quantize_weights([_np(w) for w in params.weights], hw)
    if w_int_override is not None:
        w_int = [np.asarray(q, np.int32) for q in w_int_override]
        lim = 1 << (hw.quan_bits - 1)
        if not all((q >= -lim).all() and (q < lim).all() for q in w_int):
            raise ValueError(f"w_int_override holds values outside [-{lim}, {lim})")
    w_fq = tuple(torch.as_tensor(q.astype(np.float32) * np.float32(s), device=device)
                 for q, s in zip(w_int, w_scale))
    biases = tuple(torch.as_tensor(_np(b), dtype=torch.float32, device=device)
                   for b in params.biases)
    return (w_fq, tuple(w_scale), biases), w_int, w_scale


def calibration_forward(spec: SESRSpec, params: CollapsedParams, x,
                        hw: HardwareConfig = DEFAULT_HW, exact_pe: bool = True,
                        qat_add_bounds=None, device=None):
    """Single-image fake-quant forward: (y, minmax (2, L+1)), on ``device``
    (default: x's device, else ``cuda``). ``qat_add_bounds``: (union_lo,
    union_hi) of the qatf="qat_" composition's frozen QuantAdd."""
    x = as_input(x, device)
    with torch.inference_mode(), float_exact():
        fq_weights, _, _ = _prep_fq_weights(params, hw, x.device)
        return _calibration_forward_impl(spec, fq_weights, x, hw, exact_pe,
                                         qat_add_bounds=qat_add_bounds)


def fake_quant_forward(spec: SESRSpec, params: CollapsedParams, x,
                       hw: HardwareConfig = DEFAULT_HW, exact_pe: bool = True,
                       device=None) -> torch.Tensor:
    """The fake-quant forward alone (the reference's PSNR-eval path)."""
    return calibration_forward(spec, params, x, hw, exact_pe, device=device)[0]


class ObserverRegressionWarning(UserWarning):
    """The chosen observer loses more than the threshold (1 dB) of
    ground-truth PSNR against minmax through the corrected integer path.
    KL gains about 0.5 dB on the SR tasks but clips the sparse Bayer
    ranges of the raw-domain tasks badly."""


def quantization_fidelity_psnr(spec: SESRSpec, params: CollapsedParams, qp: QuantParams,
                               images: Sequence[np.ndarray], device=None) -> float:
    """Mean PSNR (dB) of the corrected integer output against the float32
    forward over ``images``: how far quantization strays from the float
    model, with no ground truth (not the observer guard's metric)."""
    dev = resolve_device(None, device)
    tot = 0.0
    with torch.inference_mode():
        for img in images:
            y_f = forward_float(spec, params, img, device=dev).cpu().numpy()
            y_i = integer_forward(spec, qp, img, corrected=True, device=dev)[0].cpu().numpy()
            mse = float(np.mean((y_f - y_i) ** 2))
            tot += -10.0 * float(np.log10(max(mse, 1e-12)))
    return tot / max(len(images), 1)


def guarded_calibrate(spec: SESRSpec, params: CollapsedParams, data, task: str,
                      observer: str = "minmax", threshold_db: float = 1.0,
                      device=None, **calibrate_kwargs) -> QuantParams:
    """calibrate() with the observer guardrail: for an observer other than
    minmax, also calibrate minmax, score both artifacts through the
    corrected integer path against ground truth, and warn
    (ObserverRegressionWarning) when the chosen one loses more than
    ``threshold_db``. ``data``: (inp, gt[, ...]) pairs. Returns the chosen
    observer's artifact either way; the caller decides what a warning
    means (the CLI requires --force)."""
    images = [d[0] for d in data]
    qp = calibrate(spec, params, images, observer=observer, device=device,
                   **calibrate_kwargs)
    if observer == "minmax" or not data:
        return qp
    qp_mm = calibrate(spec, params, images, observer="minmax", device=device,
                      **calibrate_kwargs)
    dev = resolve_device(None, device)

    def score(q):
        tot = 0.0
        with torch.inference_mode():
            for inp, gt, *_ in data:
                y = integer_forward(spec, q, inp, corrected=True, device=dev)[0].cpu().numpy()
                tot += evaluate_pair(task, y[0], gt[0], inp[0])[0]
        return tot / len(data)

    p_obs, p_mm = score(qp), score(qp_mm)
    if p_obs < p_mm - threshold_db:
        warnings.warn(
            f"observer '{observer}' degrades the integer deployment path by "
            f"{p_mm - p_obs:.2f} dB vs minmax on this calibration set ({p_obs:.2f} vs "
            f"{p_mm:.2f} dB PSNR against ground truth): KL is known to clip sparse "
            f"raw-domain ranges; use minmax/percentile for this task, or keep it "
            f"deliberately (CLI: --force)", ObserverRegressionWarning, stacklevel=2)
    return qp


def calibrate(spec: SESRSpec, params: CollapsedParams, images: Sequence[np.ndarray],
              hw: HardwareConfig = DEFAULT_HW, exact_pe: bool = True,
              force_output_min_zero: bool = True, observer: str = "minmax",
              percentile: float = 0.9999, safe_zero_floor: bool = False,
              qat_add_bounds=None, w_int_override=None, device=None) -> QuantParams:
    """Run the calibration set (NHWC float images in [0, 1]) through the
    fake-quant pipeline on ``device`` (default ``cuda``) and finalize a
    complete QuantParams.

    ``observer``: "minmax", "percentile" or "kl"; the histogram observers
    take a second pass over the same forward, 2048-bin histograms per
    domain. ``qat_add_bounds``: the frozen QuantAdd of the qatf="qat_"
    composition at the outer residual. ``w_int_override``: per-layer
    integer weights at the same per-tensor scales (adaptive rounding).
    """
    if observer not in OBSERVERS:
        raise ValueError(f"observer must be one of {OBSERVERS}, got {observer!r}")
    dev = resolve_device(None, device)
    L = spec.num_convs
    with torch.inference_mode(), float_exact():
        fq_weights, w_int, w_scale = _prep_fq_weights(params, hw, dev, w_int_override)

        def fwd(img, hist_bounds=None):
            # one call site for both passes, so the histograms are taken
            # over the forward that produced their bounds
            return _calibration_forward_impl(spec, fq_weights, as_input(img, dev), hw,
                                             exact_pe, hist_bounds, qat_add_bounds)

        calib = CalibState.fresh(L + 1)
        for img in images:
            mm = fwd(img)[1].cpu().numpy().astype(np.float64)
            for d in range(L + 1):
                calib.update(d, mm[0, d], mm[1, d])
        if observer != "minmax":
            bounds = torch.as_tensor(np.stack([calib.min_vals, calib.max_vals], axis=1),
                                     dtype=torch.float32, device=dev)
            total = np.zeros((L + 1, BINS_NUM), np.int64)
            for img in images:
                total += fwd(img, bounds)[2].cpu().numpy()
            for d in range(L + 1):
                lo, hi = calib.min_vals[d], calib.max_vals[d]
                if observer == "percentile":
                    calib.min_vals[d], calib.max_vals[d] = percentile_bounds(
                        total[d], lo, hi, percentile)
                else:
                    calib.min_vals[d], calib.max_vals[d] = kl_bounds(total[d], lo, hi)
    return finalize(spec, w_int, w_scale, [_np(b) for b in params.biases], calib, hw,
                    force_output_min_zero=force_output_min_zero,
                    safe_zero_floor=safe_zero_floor)
