"""The synthetic data path (numpy only): smooth random images through the
task's degradation, as the JAX package's ``sesr_tpu/data/datasets.py``
SyntheticDataset. Only the super-resolution tasks' degradation (stride
subsampling) is ported so far; the Bayer tasks' branch and real-photo
data wait (ROADMAP.md queue 1).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

SR_SCALE = {"sr_x2": 2, "sr_x4": 4}


def _to_y(img_hwc: np.ndarray) -> np.ndarray:
    """BT.601 Y in [0,1]."""
    y = (65.481 * img_hwc[:, :, 0] + 128.553 * img_hwc[:, :, 1]
         + 24.966 * img_hwc[:, :, 2] + 16.0) / 255.0
    return np.clip(y, 0, 1)


class SyntheticDataset:
    """Procedural (input, ground truth) pairs: smooth random images, 8x8
    blocks of uniform noise, at ground-truth size ``hw``."""

    def __init__(self, task: str, n: int = 8, hw=(96, 128), seed: int = 0):
        self.task, self.n, self.hw = task, n, hw
        self.seed = seed

    def __len__(self):
        return self.n

    def _smooth_image(self, rng, h, w, c=3):
        small = rng.random((h // 8, w // 8, c), dtype=np.float32)
        img = np.kron(small, np.ones((8, 8, 1), np.float32))
        return np.clip(img, 0, 1)

    def __getitem__(self, i) -> Tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(self.seed + i)
        h, w = self.hw
        linrgb = self._smooth_image(rng, h, w)
        return task_pair_from_image(self.task, linrgb, rng)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def task_pair_from_image(task: str, img_hwc: np.ndarray,
                         rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(inp, gt) NHWC pair for a super-resolution task from one HWC RGB
    image in [0, 1]: the input is the stride-subsampled image (the
    synthetic pipeline's downscale); sr_x4 works on BT.601 luma."""
    if task not in SR_SCALE:
        raise NotImplementedError(
            f"{task}: the Bayer tasks' degradation is not ported yet "
            "(ROADMAP.md queue 1: the Bayer data path)")
    scale = SR_SCALE[task]
    gt = img_hwc
    inp = gt[::scale, ::scale, :]
    if task == "sr_x4":
        gt, inp = _to_y(gt)[:, :, None], _to_y(inp)[:, :, None]
    return inp[None].astype(np.float32), gt[None].astype(np.float32)
