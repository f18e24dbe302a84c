"""Datasets (numpy only), as the JAX package's ``sesr_tpu/data/datasets.py``:
the synthetic set (smooth random images through the task's degradation:
stride subsampling for super-resolution, the Bayer mosaic and shot/read
noise for nr, dm, nrdm_3 and nrdm_6), Set5/Set14-style super-resolution
folders, DIV2K-RAW-style Bayer planes, and the two training loaders
(random crops of Bayer planes, and of 14-bit RGGB ``.mat`` crops). Images are read with the
port's own PNG reader (``sesr_tpu_torch/png.py``). Every item is NHWC
float32 in [0, 1].
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional, Tuple

import numpy as np

from sesr_tpu_torch.config import find_reference_root
from sesr_tpu_torch.data.bayer import (add_noise, augment_8way, expand_bayer_plane,
                                       expand_bayer_plane_dense, four2three, mosaic,
                                       random_noise_levels, rggb_to_linrgb)
from sesr_tpu_torch.png import imread_rgb

SR_SCALE = {"sr_x2": 2, "sr_x4": 4}
BAYER_TASKS = ("nr", "dm", "nrdm_3", "nrdm_6")


def _to_y(img_hwc: np.ndarray) -> np.ndarray:
    """BT.601 Y in [0,1]."""
    y = (65.481 * img_hwc[:, :, 0] + 128.553 * img_hwc[:, :, 1]
         + 24.966 * img_hwc[:, :, 2] + 16.0) / 255.0
    return np.clip(y, 0, 1)


class SRFolderDataset:
    """Set5/Set14-style GTmod12 + LRbicx{2,4} folder pairs: x4 yields
    Y-channel pairs, x2 RGB pairs."""

    def __init__(self, gt_dir: str, scale: int):
        if scale not in SR_SCALE.values():
            raise ValueError(f"scale must be 2 or 4, got {scale}")
        self.scale = scale
        self.gt_paths: List[str] = sorted(glob.glob(os.path.join(gt_dir, "*.png")))
        if not self.gt_paths:
            raise FileNotFoundError(f"no PNGs under {gt_dir}")
        self.lr_dir = gt_dir.replace("GTmod12", f"LRbicx{scale}")
        if self.lr_dir == gt_dir:
            # otherwise the ground truth would silently become the input
            raise ValueError(
                f"{gt_dir}: cannot derive the LRbicx{scale} directory — the "
                f"layout pairs .../GTmod12 with .../LRbicx{scale}; point "
                f"--data at the GTmod12 folder")
        if not os.path.isdir(self.lr_dir):
            raise FileNotFoundError(
                f"LR directory {self.lr_dir} missing next to {gt_dir}")

    def __len__(self):
        return len(self.gt_paths)

    def __getitem__(self, i) -> Tuple[np.ndarray, np.ndarray]:
        gt_path = self.gt_paths[i]
        lr_path = os.path.join(self.lr_dir, os.path.basename(gt_path))
        gt = imread_rgb(gt_path)
        inp = imread_rgb(lr_path)
        if self.scale == 4:
            gt, inp = _to_y(gt)[:, :, None], _to_y(inp)[:, :, None]
        return inp[None].astype(np.float32), gt[None].astype(np.float32)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


class RawBayerDataset:
    """DIV2K-RAW-style triples: ``.raw`` uint16 Bayer planes named
    name_H_W.raw (12-bit values) beside a 12-bit PNG ground truth
    name.png (in ``png_dir``, else the raw file's folder). The plane is
    expanded to the sparse 3-channel input.

    Yields (inp, gt, variance), the variance the per-pixel noise variance
    computed from the noisy input (zeros without ``add_test_noise``)."""

    def __init__(self, raw_dir: str, png_dir: Optional[str] = None,
                 add_test_noise: bool = False, seed: int = 0):
        self.raw_paths = sorted(glob.glob(os.path.join(raw_dir, "*.raw")))
        if not self.raw_paths:
            raise FileNotFoundError(f"no .raw files under {raw_dir}")
        self.png_dir = png_dir
        self.add_test_noise = add_test_noise
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.raw_paths)

    def __getitem__(self, i) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        path = self.raw_paths[i]
        base = os.path.basename(path)
        ww, hh = _raw_size(path)
        raw = np.fromfile(path, dtype=np.uint16).reshape(ww, hh)
        inp = expand_bayer_plane(raw.astype(np.float32) / (2 ** 12 - 1))
        if self.add_test_noise:
            shot, read = random_noise_levels(self.rng)
            inp, _ = add_noise(inp, shot, read, self.rng)
            # the variance of the noisy, unclamped input
            variance = (shot * inp + read).astype(np.float32)
        else:
            variance = np.zeros_like(inp, dtype=np.float32)
        png = os.path.join(self.png_dir or os.path.dirname(path),
                           base.split("_")[0] + ".png")
        gt = np.clip(imread_rgb(png, bit_depth=12), 0, 1)
        inp = np.clip(inp, 0, 1).transpose(1, 2, 0)           # CHW -> HWC
        return (inp[None].astype(np.float32), gt[None].astype(np.float32),
                variance.transpose(1, 2, 0)[None])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def _raw_size(path: str) -> Tuple[int, int]:
    """(rows, columns) from a name_R_C.raw file name."""
    base = os.path.basename(path)
    return int(base.split("_")[1]), int(base.split("_")[-1][:-4])


class TrainBayerDataset:
    """Training triples from a DIV2K-RAW-style tree: random even-aligned
    ``ps`` x ``ps`` crops of name_R_C.raw uint16 Bayer planes (12-bit)
    beside name.png, the 12-bit ground truth, with shot/read noise.

    Items are (inp, gt, variance), NHWC float32. Reference quirks kept:
    the variance is computed from the NOISY input, and the train-time
    packing is the DENSE 2x2 replication (``expand_bayer_plane_dense``),
    not the test loader's sparse one. The crop and the noise come from one
    generator seeded with ``seed``, in the JAX loader's order."""

    def __init__(self, raw_dir: str, png_dir: Optional[str] = None, ps: int = 128,
                 seed: int = 0):
        self.raw_paths = sorted(glob.glob(os.path.join(raw_dir, "*.raw")))
        if not self.raw_paths:
            raise FileNotFoundError(f"no .raw files under {raw_dir}")
        self.png_dir = png_dir
        self.ps = ps
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.raw_paths)

    def __getitem__(self, i) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        path = self.raw_paths[i]
        ww, hh = _raw_size(path)
        raw = np.fromfile(path, dtype=np.uint16).reshape(ww, hh)
        png = os.path.join(self.png_dir or os.path.dirname(path),
                           os.path.basename(path).split("_")[0] + ".png")
        gt = imread_rgb(png, bit_depth=12)
        ps = self.ps
        # an even-aligned crop keeps the RGGB phase
        bii = int(self.rng.integers(0, max(ww - ps, 1))) // 2 * 2
        bjj = int(self.rng.integers(0, max(hh - ps, 1))) // 2 * 2
        patch = raw[bii:bii + ps, bjj:bjj + ps]
        gt = gt[bii:bii + ps, bjj:bjj + ps]
        inp = expand_bayer_plane_dense(patch.astype(np.float32) / (2 ** 12 - 1))
        shot, read = random_noise_levels(self.rng)
        inp, _ = add_noise(inp, shot, read, self.rng)
        variance = shot * inp + read
        inp = np.clip(inp, 0, 1).transpose(1, 2, 0)
        return (inp[None].astype(np.float32), np.clip(gt, 0, 1)[None].astype(np.float32),
                variance.transpose(1, 2, 0)[None].astype(np.float32))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def _cubic_taps(n_src: int, n_dst: int, scale: float):
    """Per output position, the four source indices (edge-replicated) and
    the float32 weights of OpenCV's INTER_CUBIC (A = -0.75) at the
    half-pixel-centred source coordinate."""
    a = np.float32(-0.75)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    x = (f - s.astype(np.float32)).astype(np.float32)
    one = np.float32(1)
    c0 = ((a * (x + one) - 5 * a) * (x + one) + 8 * a) * (x + one) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + one
    c2 = ((a + 2) * (one - x) - (a + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    idx = np.clip(s[:, None] + np.arange(-1, 3)[None, :], 0, n_src - 1)
    return idx, [c.astype(np.float32) for c in (c0, c1, c2, c3)]


def bicubic_resize(img_hw: np.ndarray, factor: float) -> np.ndarray:
    """Bicubic resize of a 2-D float image by ``factor``, OpenCV
    INTER_CUBIC's taps and float32 weights (the reference's downscale),
    in the image's own precision: the rows first, then the columns, four
    taps each, edges replicated."""
    img = np.asarray(img_hw)
    if img.dtype not in (np.float32, np.float64):
        img = img.astype(np.float32)
    h, w = img.shape
    oh, ow = int(round(h * factor)), int(round(w * factor))
    xi, (a0, a1, a2, a3) = _cubic_taps(w, ow, 1.0 / factor)
    a0, a1, a2, a3 = (a.astype(img.dtype) for a in (a0, a1, a2, a3))
    rows = (((img[:, xi[:, 0]] * a0 + img[:, xi[:, 1]] * a1) + img[:, xi[:, 2]] * a2)
            + img[:, xi[:, 3]] * a3)
    yi, (b0, b1, b2, b3) = _cubic_taps(h, oh, 1.0 / factor)
    b0, b1, b2, b3 = (b.astype(img.dtype)[:, None] for b in (b0, b1, b2, b3))
    return (((rows[yi[:, 0]] * b0 + rows[yi[:, 1]] * b1) + rows[yi[:, 2]] * b2)
            + rows[yi[:, 3]] * b3)


class TrainMatDataset:
    """Training triples from 14-bit RGGB-plane ``.mat`` crops, the
    reference's primary train loader: a random ``ps`` crop, the greens
    averaged into linear RGB, the 8-way dihedral augmentation, then the
    task's degradation (gamma, luma and a bicubic 1/4 downscale for sr_x4;
    the RGGB mosaic and shot/read noise for nr and nrdm, the mosaic alone
    for dm). Items are (inp, gt, variance) NHWC float32; the variance is
    computed from the NOISY planes (the reference's quirk), a 0-d zero
    where there is no noise. ``.mat`` files are read with scipy."""

    TASKS = ("nr", "dm", "nrdm_3", "nrdm_6", "sr_x4")

    def __init__(self, mat_dir: str, task: str, ps: int = 128, key: str = "mat_crop",
                 seed: int = 0):
        if task not in self.TASKS:
            raise ValueError(f"TrainMatDataset serves {self.TASKS}, got {task!r}")
        self.paths = sorted(glob.glob(os.path.join(mat_dir, "*.mat")))
        if not self.paths:
            raise FileNotFoundError(f"no .mat files under {mat_dir}")
        self.task, self.ps, self.key = task, ps, key
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, i):
        import scipy.io

        img = np.asarray(scipy.io.loadmat(self.paths[i])[self.key]) / (2 ** 14 - 1.0)
        ww, hh = img.shape[:2]
        ps = self.ps
        bii = int(self.rng.integers(0, max(ww - ps, 1)))
        bjj = int(self.rng.integers(0, max(hh - ps, 1)))
        linrgb = rggb_to_linrgb(img[bii:bii + ps, bjj:bjj + ps, :])
        linrgb = np.clip(augment_8way(linrgb, int(self.rng.integers(0, 8))), 0, 1)
        if self.task == "sr_x4":
            linrgb = linrgb ** (1 / 2.2)
            gt = 0.299 * linrgb[:, :, 0] + 0.587 * linrgb[:, :, 1] + 0.114 * linrgb[:, :, 2]
            inp = bicubic_resize(gt, 1 / 4.0)
            return (inp[None, :, :, None].astype(np.float32),
                    gt[None, :, :, None].astype(np.float32), np.zeros((), np.float32))
        four = mosaic(np.clip(linrgb, 0, 1).transpose(2, 0, 1))
        shot, read = random_noise_levels(self.rng)
        if self.task == "dm":
            gt, inp, variance = linrgb, four2three(four), np.zeros((), np.float32)
        else:
            gt = four2three(four).transpose(1, 2, 0) if self.task == "nr" else linrgb
            noisy, _ = add_noise(four, shot, read, self.rng)
            variance = (shot * noisy + read).astype(np.float32)
            inp = four2three(noisy)
        inp = np.clip(inp.transpose(1, 2, 0), 0, 1)
        if variance.ndim:
            variance = variance.transpose(1, 2, 0)[None]
        return (inp[None].astype(np.float32), np.clip(np.asarray(gt), 0, 1)[None]
                .astype(np.float32), variance)

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


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
    """(inp, gt) NHWC pair for ``task`` from one HWC RGB image in [0, 1].
    Bayer tasks: the RGGB mosaic re-packed sparse, with shot/read noise
    drawn from ``rng`` for nr and nrdm (nr's ground truth is the clean
    sparse mosaic, dm's and nrdm's the image). Super-resolution: the
    stride-subsampled image (the synthetic pipeline's downscale); sr_x4
    works on BT.601 luma."""
    if task in BAYER_TASKS:
        four = mosaic(img_hwc.transpose(2, 0, 1))
        if task == "dm":
            gt, inp = img_hwc, four2three(four)
        else:
            gt = four2three(four).transpose(1, 2, 0) if task == "nr" else img_hwc
            noisy, _ = add_noise(four, *random_noise_levels(rng), rng)
            inp = four2three(noisy)
        inp = np.clip(inp.transpose(1, 2, 0), 0, 1)
        gt = np.clip(np.asarray(gt), 0, 1)
        return inp[None].astype(np.float32), gt[None].astype(np.float32)
    if task not in SR_SCALE:
        raise ValueError(f"unknown task {task!r}")
    scale = SR_SCALE[task]
    gt = img_hwc
    inp = gt[::scale, ::scale, :]
    if task == "sr_x4":
        gt, inp = _to_y(gt)[:, :, None], _to_y(inp)[:, :, None]
    return inp[None].astype(np.float32), gt[None].astype(np.float32)


def reference_fixture_path(task: str, reference_root: Optional[str] = None) -> str:
    """The reference's golden sim input for ``task`` (its sim.py:197-205):
    rand_SR_Input_80x960.pt for sr_x4, rand_DM_Input_80x960.pt for every
    other task, sr_x2 included; the file may be absent."""
    name = "rand_SR_Input_80x960.pt" if task == "sr_x4" else "rand_DM_Input_80x960.pt"
    return os.path.join(find_reference_root(reference_root), name)


def load_reference_fixture(task: str, reference_root: Optional[str] = None) -> np.ndarray:
    """The reference's golden sim input (``reference_fixture_path``) as NHWC
    float32 numpy; FileNotFoundError naming the file when it is absent."""
    import torch

    path = reference_fixture_path(task, reference_root)
    if not os.path.exists(path):
        raise FileNotFoundError(f"reference fixture {path} not found: point "
                                f"SESR_REFERENCE_ROOT at the reference checkout")
    x = torch.load(path, map_location="cpu")
    return np.ascontiguousarray(x.numpy().transpose(0, 2, 3, 1), np.float32)
