"""Image quality metrics with the reference's per-task conventions, numpy
only (the same functions as the JAX package's ``sesr_tpu/metrics.py``).

- sr_x4: compute_psnr(gt*255, pred*255) on the Y channel, eps=1e-8; SSIM
  single-channel
- sr_x2: compute_psnr on BT.601 luma (offset 16, clipped to [0, 255]);
  SSIM per channel; the model output first gets the nearest-upsampled
  input added
- nr: PSNR/SSIM on the three2one Bayer re-packing, data_range=1
- dm/nrdm: skimage-style PSNR (no eps) data_range=1, SSIM per channel

SSIM follows skimage's defaults: uniform 7x7 window, K1=0.01, K2=0.03,
the unbiased covariance estimator, mean over the valid region.
"""

from __future__ import annotations

import numpy as np


def compute_psnr(img_pred, img_true, data_range=255.0, eps=1e-8):
    """The reference's own PSNR: eps in the denominator."""
    err = np.mean((np.asarray(img_pred, np.float64) -
                   np.asarray(img_true, np.float64)) ** 2)
    return 10.0 * np.log10(data_range ** 2 / (err + eps))


def psnr(img_pred, img_true, data_range=1.0):
    """skimage-compatible PSNR (no eps), used for the nr/dm/nrdm tasks."""
    err = np.mean((np.asarray(img_pred, np.float64) -
                   np.asarray(img_true, np.float64)) ** 2)
    if err == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / err)


def rgb_to_yuv(img):
    """BT.601 luma in [0,255] from RGB in [0,1]."""
    rgb_weights = np.array([65.481, 128.553, 24.966])
    return np.clip(np.matmul(img, rgb_weights) + 16.0, 0, 255.0)


def three2one(img_hwc):
    """Re-pack a 3-channel pseudo-Bayer image into the single-plane mosaic:
    R at even/even, G at the two green sites, B at odd/odd."""
    out = np.zeros(img_hwc.shape[:2])
    out[0::2, 0::2] = img_hwc[0::2, 0::2, 0]
    out[1::2, 0::2] = img_hwc[1::2, 0::2, 1]
    out[0::2, 1::2] = img_hwc[0::2, 1::2, 1]
    out[1::2, 1::2] = img_hwc[1::2, 1::2, 2]
    return out


def _ssim_single(x, y, data_range):
    """Grayscale SSIM, skimage defaults, valid region only."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    win = 7
    k1, k2 = 0.01, 0.03
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2

    def filt(a):
        # uniform filter via cumulative sums, valid region only
        cs = np.cumsum(np.cumsum(a, axis=0), axis=1)
        cs = np.pad(cs, ((1, 0), (1, 0)))
        s = cs[win:, win:] - cs[:-win, win:] - cs[win:, :-win] + cs[:-win, :-win]
        return s / (win * win)

    ux, uy = filt(x), filt(y)
    uxx, uyy, uxy = filt(x * x), filt(y * y), filt(x * y)
    n = win * win
    cov_norm = n / (n - 1)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    num = (2 * ux * uy + c1) * (2 * vxy + c2)
    den = (ux ** 2 + uy ** 2 + c1) * (vx + vy + c2)
    return float((num / den).mean())


def ssim(img_pred, img_true, data_range=1.0, channel_axis=None):
    """SSIM matching skimage.metrics.structural_similarity defaults."""
    if channel_axis is None:
        return _ssim_single(img_pred, img_true, data_range)
    pred = np.moveaxis(np.asarray(img_pred), channel_axis, 0)
    true = np.moveaxis(np.asarray(img_true), channel_axis, 0)
    return float(np.mean([_ssim_single(p, t, data_range)
                          for p, t in zip(pred, true)]))


def evaluate_pair(task: str, pred_hwc, gt_hwc, inp_hwc=None):
    """Per-task (PSNR, SSIM). pred/gt: HWC numpy in [0,1]; for sr_x2 pass
    the network input as inp_hwc, for the nearest-upsampled global skip."""
    pred = np.clip(np.asarray(pred_hwc), 0, 1)
    gt = np.asarray(gt_hwc)
    if task == "sr_x2":
        if inp_hwc is None:
            raise ValueError("sr_x2 needs the input for the global skip")
        up = np.repeat(np.repeat(np.asarray(inp_hwc), 2, axis=0), 2, axis=1)
        pred = np.clip(np.asarray(pred_hwc) + up, 0, 1)
    if task == "nr":
        pred, gt = three2one(pred), three2one(gt)
    if task == "sr_x4":
        pred, gt = pred[:, :, 0], gt[:, :, 0]

    if task == "sr_x4":
        p = compute_psnr(gt * 255.0, pred * 255.0)
    elif task == "sr_x2":
        p = compute_psnr(rgb_to_yuv(gt), rgb_to_yuv(pred))
    else:
        p = psnr(gt, pred, data_range=1.0)

    if task in ("nr", "sr_x4"):
        s = ssim(gt, pred, data_range=1.0)
    else:
        s = ssim(gt, pred, data_range=1.0, channel_axis=2)
    return p, s
