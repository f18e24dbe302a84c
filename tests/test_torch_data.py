"""The port's data path on the CPU against the JAX package's: the Bayer
conversions and noise model (sesr_tpu_torch/data/bayer.py), the synthetic
set of every task, the folder datasets, and the standard-library PNG
codec (sesr_tpu_torch/png.py) against ``_imread_rgb`` / ``_save_png`` on
files that cv2 and PIL write. Only the JAX side of a comparison, and the
writing of test files, uses cv2 or PIL."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from sesr_tpu import cli as jcli
from sesr_tpu.data import bayer as jbayer
from sesr_tpu.data import datasets as jdatasets
from sesr_tpu_torch import png
from sesr_tpu_torch.data import (RawBayerDataset, SRFolderDataset, SyntheticDataset,
                                 bayer, task_pair_from_image)

TASKS = ("nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2")


def _equal_items(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_bayer_functions_match_jax():
    rng = np.random.default_rng(3)
    img = rng.random((3, 12, 20), dtype=np.float32)
    np.testing.assert_array_equal(bayer.mosaic(img), jbayer.mosaic(img))
    four = bayer.mosaic(img)
    np.testing.assert_array_equal(bayer.four2three(four), jbayer.four2three(four))
    raw = rng.integers(0, 4096, (12, 20)).astype(np.float32) / 4095
    np.testing.assert_array_equal(bayer.expand_bayer_plane(raw), jbayer.expand_bayer_plane(raw))
    for seed in range(5):
        r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
        levels = bayer.random_noise_levels(r_t)
        assert levels == jbayer.random_noise_levels(r_j)
        _equal_items(bayer.add_noise(four, *levels, r_t), jbayer.add_noise(four, *levels, r_j))
        # both generators drew the same numbers
        assert r_t.random() == r_j.random()


@pytest.mark.parametrize("task", TASKS)
def test_synthetic_dataset_matches_jax(task):
    for item_t, item_j in zip(SyntheticDataset(task, n=3, hw=(32, 48), seed=4),
                              jdatasets.SyntheticDataset(task, n=3, hw=(32, 48), seed=4)):
        _equal_items(item_t, item_j)
    img = np.random.default_rng(6).random((16, 24, 3), dtype=np.float32)
    _equal_items(task_pair_from_image(task, img, np.random.default_rng(1)),
                 jdatasets.task_pair_from_image(task, img, np.random.default_rng(1)))


def test_unknown_task_is_refused():
    with pytest.raises(ValueError, match="unknown task"):
        task_pair_from_image("sr_x3", np.zeros((8, 8, 3), np.float32),
                             np.random.default_rng(0))


def _cv2_write(path, img):
    """img HWC RGB (or HW gray), uint8 or uint16, through cv2 (BGR)."""
    assert cv2.imwrite(str(path), img[:, :, ::-1] if img.ndim == 3 else img)


@pytest.mark.parametrize("kind", ["rgb8", "gray8", "rgba8", "rgb16", "gray16"])
def test_png_reader_matches_imread_rgb(tmp_path, kind):
    rng = np.random.default_rng(len(kind))
    h, w = 13, 22
    if kind.endswith("16"):
        # a 12-bit image in a 16-bit container, and a dark one whose
        # heuristic normalization differs from the declared bit depth's
        shape = (h, w, 3) if kind == "rgb16" else (h, w)
        imgs = [rng.integers(0, 4096, shape).astype(np.uint16),
                rng.integers(0, 200, shape).astype(np.uint16)]
    else:
        c = {"rgb8": 3, "gray8": 0, "rgba8": 4}[kind]
        imgs = [rng.integers(0, 256, (h, w, c) if c else (h, w)).astype(np.uint8)]
    for n, img in enumerate(imgs):
        # PIL writes no 16-bit RGB
        for writer in ("cv2",) if kind == "rgb16" else ("cv2", "pil"):
            path = tmp_path / f"{kind}_{n}_{writer}.png"
            if writer == "cv2":
                _cv2_write(path, img)
            else:
                Image.fromarray(img).save(path)
            for bit_depth in (None, 12):
                got = png.imread_rgb(str(path), bit_depth=bit_depth)
                want = jdatasets._imread_rgb(str(path), bit_depth=bit_depth)
                assert got.dtype == want.dtype == np.float32
                np.testing.assert_array_equal(got, want, err_msg=f"{path} {bit_depth}")


def _encode(img, filters, interlace=0, colour=None):
    """A PNG of uint8 img (H, W, C) whose row y uses filter filters[y]
    (None, Sub, Up, Average, Paeth), as the PNG specification defines
    them."""
    h, w, c = img.shape
    colour = {1: 0, 2: 4, 3: 2, 4: 6}[c] if colour is None else colour
    rows = img.reshape(h, w * c).astype(np.int64)
    out, prev = [], np.zeros(w * c, np.int64)
    for y in range(h):
        f, cur = filters[y % len(filters)], rows[y]
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        if f == 0:
            pred = np.zeros_like(cur)
        elif f == 1:
            pred = left
        elif f == 2:
            pred = prev
        elif f == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        out.append(bytes([f]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0,
                                                       interlace))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_reader_takes_every_filter_type(tmp_path, channels):
    img = np.random.default_rng(channels).integers(0, 256, (11, 9, channels)).astype(np.uint8)
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4, 4, 3, 2, 1]):
        path = tmp_path / f"f{''.join(map(str, filters))}.png"
        path.write_bytes(_encode(img, filters))
        np.testing.assert_array_equal(png.read_png(str(path)), img)
        np.testing.assert_array_equal(png.imread_rgb(str(path)),
                                      jdatasets._imread_rgb(str(path)))


def test_png_reader_refuses_palette_and_interlaced(tmp_path):
    pal = tmp_path / "palette.png"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("P").save(pal)
    with pytest.raises(ValueError, match="palette.png.*palette"):
        png.read_png(str(pal))
    inter = tmp_path / "interlaced.png"
    inter.write_bytes(_encode(np.zeros((4, 4, 3), np.uint8), [0], interlace=1))
    with pytest.raises(ValueError, match="interlaced.png.*interlaced"):
        png.read_png(str(inter))


@pytest.mark.parametrize("shape", [(9, 14, 3), (9, 14, 1)], ids=["rgb", "gray"])
def test_png_writer_matches_save_png(tmp_path, shape):
    y = np.random.default_rng(2).uniform(-0.1, 1.1, shape).astype(np.float32)
    y[0, :4, 0] = [0.5 / 255, 1.5 / 255, 254.5 / 255, 1.0]      # the rounding edges
    png.save_png(y, str(tmp_path / "port.png"))
    jcli._save_png(y, str(tmp_path / "jax.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    got = np.asarray(Image.open(tmp_path / "port.png"))
    assert Image.open(tmp_path / "port.png").mode == Image.open(tmp_path / "jax.png").mode
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.read_png(str(tmp_path / "port.png")).reshape(want.shape),
                                  want)


def _sr_folders(root, scale, n=2):
    gt_dir, lr_dir = root / "GTmod12", root / f"LRbicx{scale}"
    gt_dir.mkdir()
    lr_dir.mkdir()
    rng = np.random.default_rng(scale)
    for i in range(n):
        _cv2_write(gt_dir / f"img{i}.png", rng.integers(0, 256, (24, 36, 3)).astype(np.uint8))
        _cv2_write(lr_dir / f"img{i}.png",
                   rng.integers(0, 256, (24 // scale, 36 // scale, 3)).astype(np.uint8))
    return str(gt_dir)


@pytest.mark.parametrize("scale", [2, 4])
def test_sr_folder_dataset_matches_jax(tmp_path, scale):
    gt_dir = _sr_folders(tmp_path, scale)
    got, want = SRFolderDataset(gt_dir, scale), jdatasets.SRFolderDataset(gt_dir, scale)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        _equal_items(a, b)
    with pytest.raises(ValueError, match="GTmod12"):
        SRFolderDataset(str(tmp_path / f"LRbicx{scale}"), scale)


@pytest.mark.parametrize("noise", [False, True], ids=["clean", "noisy"])
def test_raw_bayer_dataset_matches_jax(tmp_path, noise):
    rng = np.random.default_rng(9)
    h, w = 12, 20
    for name in ("0801", "0802"):
        rng.integers(0, 4096, (h, w)).astype(np.uint16).tofile(tmp_path / f"{name}_{h}_{w}.raw")
        _cv2_write(tmp_path / f"{name}.png", rng.integers(0, 4096, (h, w, 3)).astype(np.uint16))
    got = RawBayerDataset(str(tmp_path), add_test_noise=noise, seed=3)
    want = jdatasets.RawBayerDataset(str(tmp_path), add_test_noise=noise, seed=3)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert len(a) == 3
        _equal_items(a, b)


def test_train_bayer_dataset_matches_jax(tmp_path):
    """Random even-aligned crops of .raw planes beside 12-bit PNGs, the
    dense packing, the noise and the noisy-input variance: equal items
    from equal seeds."""
    from sesr_tpu_torch.data import TrainBayerDataset

    rng = np.random.default_rng(11)
    h, w = 40, 52
    for name in ("0801", "0802", "0803"):
        rng.integers(0, 4096, (h, w)).astype(np.uint16).tofile(tmp_path / f"{name}_{h}_{w}.raw")
        _cv2_write(tmp_path / f"{name}.png", rng.integers(0, 4096, (h, w, 3)).astype(np.uint16))
    got = TrainBayerDataset(str(tmp_path), ps=16, seed=5)
    want = jdatasets.TrainBayerDataset(str(tmp_path), ps=16, seed=5)
    assert len(got) == len(want) == 3
    for _ in range(2):              # the generator runs on across epochs
        for a, b in zip(got, want):
            assert len(a) == 3 and a[0].shape == (1, 16, 16, 3)
            _equal_items(a, b)


@pytest.mark.parametrize("task", ["nr", "dm", "nrdm_3", "sr_x4"])
def test_train_mat_dataset_matches_jax(tmp_path, task):
    """14-bit RGGB .mat crops (scipy.io.savemat), the 8-way augmentation
    and each task's degradation, sr_x4's bicubic 1/4 downscale included
    (float64, as OpenCV's INTER_CUBIC computes it): equal items from
    equal seeds."""
    import scipy.io

    from sesr_tpu_torch.data import TrainMatDataset
    from sesr_tpu_torch.data.datasets import bicubic_resize

    rng = np.random.default_rng(12)
    for name in ("a", "b"):
        scipy.io.savemat(str(tmp_path / f"{name}.mat"),
                         {"mat_crop": rng.integers(0, 2 ** 14, (48, 56, 4)).astype(np.uint16)})
    got = TrainMatDataset(str(tmp_path), task, ps=32, seed=4)
    want = jdatasets.TrainMatDataset(str(tmp_path), task, ps=32, seed=4)
    for _ in range(2):
        for a, b in zip(got, want):
            _equal_items(a, b)
    img = rng.random((37, 45))
    np.testing.assert_array_equal(bicubic_resize(img, 0.25),
                                  cv2.resize(img, (0, 0), fx=0.25, fy=0.25,
                                             interpolation=cv2.INTER_CUBIC))
    with pytest.raises(ValueError, match="sr_x2"):
        TrainMatDataset(str(tmp_path), "sr_x2")


def test_train_bayer_helpers_match_jax():
    rng = np.random.default_rng(13)
    raw = rng.integers(0, 4096, (12, 20)).astype(np.float32) / 4095
    np.testing.assert_array_equal(bayer.expand_bayer_plane_dense(raw),
                                  jbayer.expand_bayer_plane_dense(raw))
    img = rng.random((6, 10, 3)).astype(np.float32)
    for mode in range(8):
        np.testing.assert_array_equal(bayer.augment_8way(img, mode),
                                      jbayer.augment_8way(img, mode))
    planes = rng.random((6, 10, 4))
    np.testing.assert_array_equal(bayer.rggb_to_linrgb(planes), jbayer.rggb_to_linrgb(planes))
