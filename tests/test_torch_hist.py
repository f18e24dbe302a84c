"""The port's histogram dump (sesr_tpu_torch/quant/observers.py
``dump_histograms``) against the JAX package's on the nrdm_3 golden
weights and calibration images: the weight histograms, the activation
histograms of the two calibration passes, the PNG tree, and the PNGs."""

import os

import jax.numpy as jnp
import numpy as np

from sesr_tpu.config import DEFAULT_HW as JDEFAULT_HW
from sesr_tpu.quant.calibrate import _calibration_forward_impl as jforward
from sesr_tpu.quant.calibrate import _prep_fq_weights as jprep
from sesr_tpu.quant.observers import dump_histograms as jdump_histograms
from sesr_tpu.quant.params import CalibState as JCalibState
from sesr_tpu_torch.png import read_png
from sesr_tpu_torch.quant.observers import BINS_NUM, CHART_HEIGHT, bar_chart, dump_histograms
from tests.test_torch_calibrate import _golden
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)


def _jax_activation_histograms(spec, jparams, images):
    """dump_histograms' two passes in the JAX package: (lo, hi, totals)."""
    fq, _, _ = jprep(jparams, JDEFAULT_HW)
    L = spec.num_convs
    calib = JCalibState.fresh(L + 1)
    for img in images:
        _, mm = jforward(spec, fq, jnp.asarray(img), JDEFAULT_HW, True)
        mm = np.asarray(mm, np.float64)
        for d in range(L + 1):
            calib.update(d, mm[0, d], mm[1, d])
    bounds = jnp.asarray(np.stack([calib.min_vals, calib.max_vals], axis=1), jnp.float32)
    total = np.zeros((L + 1, BINS_NUM), np.int64)
    for img in images:
        total += np.asarray(jforward(spec, fq, jnp.asarray(img), JDEFAULT_HW, True, bounds,
                                     True)[2], np.int64)
    return calib.min_vals, calib.max_vals, total


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def test_histograms_match_jax(tmp_path):
    g, spec, params, jparams, images, _ = _golden("nrdm_3")
    L = spec.num_convs
    res = dump_histograms(spec, params, images, str(tmp_path / "port"), device="cpu")
    # weights: np.histogram(values, bins=300), what plt.hist counts
    _, jw_int, _ = jprep(jparams, JDEFAULT_HW)
    for i in range(L):
        np.testing.assert_array_equal(
            res.weight[i], np.histogram(np.asarray(jparams.weights[i]).reshape(-1), 300)[0])
        np.testing.assert_array_equal(
            res.weight_quan[i], np.histogram(np.asarray(jw_int[i]).reshape(-1), 300)[0])
    # activations, pass 1: each domain's bounds are the golden bundle's
    # min / max (the reference's own observers on these images), and
    # within rel 1e-6 of the JAX package's
    lo, hi, total = _jax_activation_histograms(spec, jparams, images)
    assert res.lo == [float(g[f"min_val_{d}"]) for d in range(L + 1)]
    assert res.hi == [float(g[f"max_val_{d}"]) for d in range(L + 1)]
    np.testing.assert_allclose(res.lo, lo, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(res.hi, hi, rtol=1e-6, atol=1e-7)
    # pass 2: the input domain bin for bin, every domain's count, and the
    # deeper domains within 1 % of their count in L1: from conv 1 on, the
    # float32 fake-quant's rounding flips differ between the frameworks and
    # cascade (1.9e-4 of domain 2, 2.75e-3 of the output domain here)
    assert res.activation.shape == total.shape == (L + 1, BINS_NUM)
    np.testing.assert_array_equal(res.activation[0], total[0])
    pixels = sum(img.size // img.shape[-1] for img in images)
    channels = [spec.in_channels] + [spec.num_channels] * (L - 1) + [spec.conv_out_channels]
    for d in range(L + 1):
        n = int(total[d].sum())
        assert int(res.activation[d].sum()) == n == pixels * channels[d], d
        assert np.abs(res.activation[d] - total[d]).sum() <= 1e-2 * n, d
    # the reference's tree, as the JAX package writes it with matplotlib
    jdump_histograms(spec, jparams, images, str(tmp_path / "jax"))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert len(res.files) == 3 * L + 1
    for path, counts in zip(res.files, res.weight + res.weight_quan + list(res.activation)):
        img = read_png(path)
        assert img.shape == (CHART_HEIGHT, counts.size * max(1, 600 // counts.size), 1)
        np.testing.assert_array_equal(img[:, :, 0], np.round(bar_chart(counts)[:, :, 0] * 255))


def test_bar_chart_scales_bars_to_the_largest_count():
    img = bar_chart(np.array([0, 2, 4]))
    assert img.shape == (CHART_HEIGHT, 600, 1)
    heights = (img[:, ::200, 0] == 0).sum(axis=0)
    assert heights.tolist() == [0, CHART_HEIGHT // 2, CHART_HEIGHT]
    # black from the bar's top down to the axis
    assert (img[CHART_HEIGHT // 2:, 200:400] == 0).all()
    assert (img[:CHART_HEIGHT // 2, 200:400] == 1).all()
    assert (bar_chart(np.zeros(3)) == 1).all()
