"""Activation-range observers for PTQ calibration.

The same observers as the JAX package's ``sesr_tpu/quant/observers.py``:

- "minmax"     running min/max (the reference's live PTQ observer);
- "percentile" each tail clipped at a cumulative-probability quantile;
- "kl"         the KL-entropy sweep the reference designed and abandoned
               (its define.py keeps only BINS_NUM=2048 / TGT_BINS_NUM=128).

Histograms are taken on the device, one per domain and image, and summed
on the host; the sweeps run on the host in numpy. ``dump_histograms``
draws them, with the weights', as the reference's histogram PNGs.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

BINS_NUM = 2048
TGT_BINS_NUM = 128


def histogram_on_device(x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                        bins: int = BINS_NUM) -> torch.Tensor:
    """Fixed-range histogram of x over [lo, hi] (float32 scalars on x's
    device), ``bins`` int64 counts. The bin index is (x - lo) / width cast
    to an integer by truncation, as the JAX package casts it, then clipped;
    the divisions are by tensors on the device, never by a Python scalar."""
    width = (hi - lo) / torch.tensor(float(bins), dtype=torch.float32, device=x.device)
    idx = torch.clamp(((x - lo) / width).to(torch.int32), 0, bins - 1)
    return torch.bincount(idx.reshape(-1), minlength=bins)


def percentile_bounds(hist: np.ndarray, lo: float, hi: float,
                      percentile: float = 0.9999):
    """Clip each tail at the given cumulative probability."""
    hist = np.asarray(hist, np.float64)
    total = hist.sum()
    if total == 0:
        return lo, hi
    edges = np.linspace(lo, hi, hist.size + 1)
    cdf = np.cumsum(hist) / total
    lo_idx = int(np.searchsorted(cdf, 1.0 - percentile))
    hi_idx = int(np.searchsorted(cdf, percentile))
    return float(edges[lo_idx]), float(edges[min(hi_idx + 1, hist.size)])


def _kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    p = p / p.sum()
    q = q / max(q.sum(), 1e-12)
    mask = p > 0
    q = np.where(q > 0, q, 1e-12)
    return float(np.sum(p[mask] * np.log(p[mask] / q[mask])))


def kl_threshold(hist: np.ndarray, num_quantized_bins: int = TGT_BINS_NUM) -> int:
    """TensorRT-style sweep: the bin count t whose clipped distribution
    minimizes KL(P||Q) against its num_quantized_bins-level reconstruction."""
    hist = np.asarray(hist, np.float64)
    n = hist.size
    best_t, best_kl = n, np.inf
    for t in range(num_quantized_bins, n + 1, num_quantized_bins // 2):
        p = hist[:t].copy()
        p[t - 1] += hist[t:].sum()           # outliers clamped into the last bin
        if p.sum() == 0:
            continue
        factor = t / num_quantized_bins
        q = np.zeros(t)
        for j in range(num_quantized_bins):
            start = int(round(j * factor))
            stop = int(round((j + 1) * factor))
            chunk = hist[start:stop]
            nonzero = (chunk > 0).sum()
            if nonzero:
                q[start:stop] = np.where(chunk > 0, chunk.sum() / nonzero, 0)
        kl = _kl_divergence(p, q)
        if kl < best_kl:
            best_kl, best_t = kl, t
    return best_t


def kl_bounds(hist: np.ndarray, lo: float, hi: float,
              num_quantized_bins: int = TGT_BINS_NUM):
    """(lo, hi) after KL clipping of the upper tail; the lower bound stays
    at the observed min (the domains are post-ReLU or [0, 1] inputs)."""
    t = kl_threshold(np.asarray(hist, np.float64), num_quantized_bins)
    width = (hi - lo) / np.asarray(hist).size
    return lo, float(lo + t * width)


@dataclasses.dataclass
class HistogramDump:
    files: List[str]                  # the PNGs written
    weight: List[np.ndarray]          # per conv, np.histogram counts of the float weights
    weight_quan: List[np.ndarray]     # per conv, the same of the int8 weights
    lo: List[float]                   # per activation domain, its min over the images
    hi: List[float]                   # and its max
    activation: np.ndarray            # (L + 1, BINS_NUM) int64 counts over [lo, hi]


CHART_HEIGHT = 240


def bar_chart(counts: np.ndarray) -> np.ndarray:
    """A bar per count, scaled to the largest, black on white, no text:
    float32 (CHART_HEIGHT, bars x 600 // bars (at least 1), 1) in [0, 1]."""
    counts = np.asarray(counts, np.float64)
    top = counts.max()
    bars = (np.round(counts / top * CHART_HEIGHT).astype(np.int64) if top > 0
            else np.zeros(counts.size, np.int64))
    rows = np.arange(CHART_HEIGHT)[:, None]
    img = np.where(rows >= CHART_HEIGHT - bars[None, :], 0.0, 1.0).astype(np.float32)
    return np.repeat(img, max(1, 600 // counts.size), axis=1)[:, :, None]


def dump_histograms(spec, params, images, out_dir: str, hw=None, bins: int = 300,
                    device=None) -> HistogramDump:
    """Weight, quantized-weight and per-domain activation histogram PNGs
    of the fake-quant forward, in the reference's tree (its
    WEIGHT_W_HIST_PNG / INPUT_W_HIST_PNG flags, define.py:34-36):
    ``weight/conv.weight.{i}.png``, ``weight_quan/conv.weightquan.{i}.png``
    and ``input/conv.input.{d}.png`` under ``out_dir``.

    Weight histograms are ``np.histogram(values, bins)``, what the
    reference's ``plt.hist(..., bins=300)`` counts. Activation histograms
    take calibration's two passes on ``device`` (default ``cuda``): each
    domain's min / max over ``images``, then BINS_NUM-bin histograms on
    the device over those bounds (the PE-exact fake-quant forward). Each
    chart is a plain bar chart (``bar_chart``) written with ``png.py``: the
    bounds and counts are in the returned ``HistogramDump``."""
    import os

    from sesr_tpu_torch.config import DEFAULT_HW
    from sesr_tpu_torch.ops.conv import float_exact
    from sesr_tpu_torch.png import save_png
    from sesr_tpu_torch.quant.calibrate import (_calibration_forward_impl, _np,
                                                _prep_fq_weights, observe_domains)
    from sesr_tpu_torch.quant.integer import as_input, resolve_device

    hw = hw or DEFAULT_HW
    dev = resolve_device(None, device)
    L = spec.num_convs
    with torch.inference_mode(), float_exact():
        fq_weights, w_int, _ = _prep_fq_weights(params, hw, dev)

        def fwd(img, hist_bounds=None):
            return _calibration_forward_impl(spec, fq_weights, as_input(img, dev), hw, True,
                                             hist_bounds)

        calib, total = observe_domains(fwd, images, L + 1, dev)
    weight = [np.histogram(_np(w).reshape(-1), bins=bins)[0] for w in params.weights]
    weight_quan = [np.histogram(np.asarray(q).reshape(-1), bins=bins)[0] for q in w_int]
    charts = ([(c, "weight", f"conv.weight.{i}.png") for i, c in enumerate(weight)]
              + [(c, "weight_quan", f"conv.weightquan.{i}.png")
                 for i, c in enumerate(weight_quan)]
              + [(c, "input", f"conv.input.{d}.png") for d, c in enumerate(total)])
    files = []
    for counts, sub, name in charts:
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        files.append(os.path.join(out_dir, sub, name))
        save_png(bar_chart(counts), files[-1])
    return HistogramDump(files, weight, weight_quan, list(calib.min_vals),
                         list(calib.max_vals), total)
