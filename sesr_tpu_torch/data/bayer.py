"""Bayer-domain conversions and the shot/read noise model (numpy only), as
the JAX package's ``sesr_tpu/data/bayer.py``: the same numpy calls in the
same order, so that a generator seeded alike draws the same numbers.

RGGB mosaic extraction, 4-plane -> sparse 3-channel re-packing, the
single-plane raw -> sparse 3-channel expansion of the test loader, and the
log-log-linear shot/read noise model.
"""

from __future__ import annotations

import numpy as np


def mosaic(img_chw: np.ndarray) -> np.ndarray:
    """RGB (3, H, W) -> RGGB planes (4, H/2, W/2)."""
    red = img_chw[0, 0::2, 0::2]
    green_red = img_chw[1, 0::2, 1::2]
    green_blue = img_chw[1, 1::2, 0::2]
    blue = img_chw[2, 1::2, 1::2]
    return np.stack([red, green_red, green_blue, blue], axis=0)


def four2three(four_chw: np.ndarray) -> np.ndarray:
    """RGGB planes (4, H, W) -> sparse 3-channel (3, 2H, 2W): each value
    lands at its Bayer site."""
    _, h, w = four_chw.shape
    out = np.zeros((3, h * 2, w * 2), four_chw.dtype)
    out[0, 0::2, 0::2] = four_chw[0]
    out[1, 1::2, 0::2] = four_chw[1]
    out[1, 0::2, 1::2] = four_chw[2]
    out[2, 1::2, 1::2] = four_chw[3]
    return out


def expand_bayer_plane(raw_hw: np.ndarray) -> np.ndarray:
    """Single Bayer plane (H, W) -> sparse 3-channel (3, H, W), the test
    loader's packing."""
    out = np.zeros((3,) + raw_hw.shape, np.float32)
    out[0, 0::2, 0::2] = raw_hw[0::2, 0::2]
    out[1, 0::2, 1::2] = raw_hw[0::2, 1::2]
    out[1, 1::2, 0::2] = raw_hw[1::2, 0::2]
    out[2, 1::2, 1::2] = raw_hw[1::2, 1::2]
    return out


def random_noise_levels(rng: np.random.Generator):
    """(shot, read) noise levels from a log-log linear distribution."""
    log_min, log_max = np.log(0.0001), np.log(0.012)
    log_shot = rng.uniform(log_min, log_max)
    shot = np.exp(log_shot)
    log_read = 2.18 * log_shot + 1.20 + rng.normal(0.0, 0.26)
    return float(shot), float(np.exp(log_read))


def add_noise(image: np.ndarray, shot_noise: float, read_noise: float,
              rng: np.random.Generator):
    """Shot (signal-proportional) + read (constant) Gaussian noise.
    Returns (noisy, variance), float32."""
    variance = image * shot_noise + read_noise
    noisy = image + rng.normal(size=image.shape) * np.sqrt(variance)
    return noisy.astype(np.float32), variance.astype(np.float32)


def expand_bayer_plane_dense(raw_hw: np.ndarray) -> np.ndarray:
    """Single Bayer plane (H, W) -> DENSE 3-channel (3, H, W), the train
    loader's packing (the test loader's is sparse): red and blue fill all
    four sites of their 2x2 cell, each green fills its own row of the
    cell (G_r row 0, G_b row 1)."""
    out = np.zeros((3,) + raw_hw.shape, np.float32)
    r, b = raw_hw[0::2, 0::2], raw_hw[1::2, 1::2]
    gr, gb = raw_hw[0::2, 1::2], raw_hw[1::2, 0::2]
    for dy in (0, 1):
        for dx in (0, 1):
            out[0, dy::2, dx::2] = r
            out[2, dy::2, dx::2] = b
    out[1, 0::2, 1::2] = gr
    out[1, 0::2, 0::2] = gr
    out[1, 1::2, 0::2] = gb
    out[1, 1::2, 1::2] = gb
    return out


def augment_8way(img: np.ndarray, mode: int) -> np.ndarray:
    """The reference's 8-way dihedral augmentation: identity, flipud, and
    rot90 k = 1..3, each without and with flipud."""
    if mode == 0:
        return img
    if mode == 1:
        return np.ascontiguousarray(np.flipud(img))
    out = np.rot90(img, k=mode // 2)
    if mode % 2 == 1:
        out = np.flipud(out)
    return np.ascontiguousarray(out)


def rggb_to_linrgb(rggb_hw4: np.ndarray) -> np.ndarray:
    """(H, W, 4) RGGB planes -> (H, W, 3) linear RGB, the two greens
    averaged."""
    return np.stack((rggb_hw4[:, :, 0], np.mean(rggb_hw4[:, :, 1:3], axis=-1),
                     rggb_hw4[:, :, 3]), axis=2)
