"""Activation-range observers for PTQ calibration.

The same observers as the JAX package's ``sesr_tpu/quant/observers.py``:

- "minmax"     running min/max (the reference's live PTQ observer);
- "percentile" each tail clipped at a cumulative-probability quantile;
- "kl"         the KL-entropy sweep the reference designed and abandoned
               (its define.py keeps only BINS_NUM=2048 / TGT_BINS_NUM=128).

Histograms are taken on the device, one per domain and image, and summed
on the host; the sweeps run on the host in numpy.
"""

from __future__ import annotations

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
