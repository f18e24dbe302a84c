"""Structural-reparameterization collapse, done analytically (numpy).

The same functions as the JAX package's ``sesr_tpu/models/blocks.py``. The
reference collapses a train-time expand(k x k, in->tmp) -> squeeze(1x1,
tmp->out) block by convolving a delta basis through the pair and flipping
the result; that is one tensor contraction over the tmp axis, done here
with one einsum. Residual blocks fold the skip as +1 on the kernel centre
diagonal.
"""

from __future__ import annotations

import numpy as np


def collapse_block(w_expand_oihw: np.ndarray, w_squeeze_oihw: np.ndarray,
                   b_squeeze: np.ndarray):
    """Collapse expand(k x k, IC->T, no bias) + squeeze(1x1, T->OC, bias).

    w_expand_oihw: (T, IC, k, k); w_squeeze_oihw: (OC, T, 1, 1); b_squeeze:
    (OC,). Returns (w_oihw (OC, IC, k, k), bias (OC,)), float32, such that
    conv(x, w) + b == squeeze(expand(x)) with SAME padding. The contraction
    runs in float64.
    """
    w_sq = w_squeeze_oihw[:, :, 0, 0]                      # (OC, T)
    w = np.einsum("ot,tikl->oikl", w_sq.astype(np.float64),
                  w_expand_oihw.astype(np.float64))
    return w.astype(np.float32), b_squeeze.astype(np.float32)


def fold_residual_identity(w_oihw: np.ndarray) -> np.ndarray:
    """Fold a residual skip into a collapsed kernel: +1 at the centre tap of
    each channel's own filter. Requires IC == OC."""
    oc, ic, kh, kw = w_oihw.shape
    if oc != ic:
        raise ValueError(f"a residual fold needs as many input as output "
                         f"channels, got {ic} -> {oc}")
    w = w_oihw.copy()
    idx = np.arange(oc)
    w[idx, idx, kh // 2, kw // 2] += 1.0
    return w


def oihw_to_hwio(w_oihw: np.ndarray) -> np.ndarray:
    """torch OIHW -> the NHWC convs' HWIO weight layout."""
    return np.transpose(w_oihw, (2, 3, 1, 0))


def hwio_to_oihw(w_hwio: np.ndarray) -> np.ndarray:
    return np.transpose(w_hwio, (3, 2, 0, 1))
