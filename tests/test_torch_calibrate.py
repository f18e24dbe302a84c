"""The port's calibration (sesr_tpu_torch/quant/calibrate.py) and observers
(sesr_tpu_torch/quant/observers.py): the fake-quant forward and the scales
and zeros against all ten reference-generated golden bundles at the bounds
of tests/test_integer_bitexact.py, and against sesr_tpu's calibrate,
histograms, percentile and KL bounds and observer guardrail on the same
numpy inputs."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.data.datasets import SyntheticDataset as JSyntheticDataset
from sesr_tpu.quant import observers as jobservers
from sesr_tpu.quant.calibrate import ObserverRegressionWarning as JObserverRegressionWarning
from sesr_tpu.quant.calibrate import calibrate as jcalibrate
from sesr_tpu.quant.calibrate import guarded_calibrate as jguarded_calibrate
from sesr_tpu.quant.calibrate import quantization_fidelity_psnr as jfidelity
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.data import SyntheticDataset
from sesr_tpu_torch.models.blocks import oihw_to_hwio
from sesr_tpu_torch.models.sesr import CollapsedParams
from sesr_tpu_torch.quant import observers
from sesr_tpu_torch.quant.calibrate import (ObserverRegressionWarning, calibrate,
                                            calibration_forward, fake_quant_forward,
                                            guarded_calibrate, quantization_fidelity_psnr)
from tests.test_integer_bitexact import (GOLDEN_TASKS, SPEC_TASK, _collapsed_params,
                                         _load_golden, _qat_bounds)
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)


def _golden(task):
    """(spec, port params, JAX params, calibration images, qat bounds)."""
    g = _load_golden(task)
    L = int(g["num_convs"])
    params = CollapsedParams([oihw_to_hwio(g[f"w_collapsed_{i}"]) for i in range(L)],
                             [g[f"b_collapsed_{i}"] for i in range(L)])
    images = [g[f"calib_img_{j}"].transpose(0, 2, 3, 1) for j in range(int(g["n_calib"]))]
    return (g, spec_for_task(SPEC_TASK.get(task, task)), params, _collapsed_params(g)[1],
            images, _qat_bounds(task, g))


def _assert_within_golden_bounds(qp, ref_scale, ref_zero, L):
    """tests/test_integer_bitexact.py test_calibration_parity's bounds."""
    for d in range(L + 1):
        assert qp.a_scale[d] == pytest.approx(ref_scale[d], rel=3e-3), f"domain {d} scale"
        assert qp.a_zero[d] == pytest.approx(ref_zero[d], abs=2), f"domain {d} zero"


@pytest.mark.parametrize("task", GOLDEN_TASKS)
def test_fake_quant_outputs_close_to_golden(task):
    """tests/test_integer_bitexact.py test_fake_quant_outputs_close's
    bounds: the worst pixel within one step of the widest domain, the mean
    within two output-domain steps."""
    g, spec, params, _, images, bounds = _golden(task)
    L = int(g["num_convs"])
    lsb_max = max(float(g[f"a_scale_{d}"]) for d in range(L + 1))
    for j, x in enumerate(images):
        y, minmax = calibration_forward(spec, params, x, qat_add_bounds=bounds, device="cpu")
        assert minmax.shape == (2, L + 1)
        diff = np.abs(y.numpy() - g[f"fake_out_{j}"].transpose(0, 2, 3, 1))
        assert diff.max() <= lsb_max, (diff.max(), lsb_max)
        assert diff.mean() <= 2 * float(g[f"a_scale_{L}"]), diff.mean()


@pytest.mark.parametrize("task", GOLDEN_TASKS)
def test_calibrate_matches_golden_and_jax(task):
    g, spec, params, jparams, images, bounds = _golden(task)
    L = int(g["num_convs"])
    qp = calibrate(spec, params, images, qat_add_bounds=bounds, device="cpu")
    _assert_within_golden_bounds(qp, [float(g[f"a_scale_{d}"]) for d in range(L + 1)],
                                 [int(g[f"a_zero_{d}"]) for d in range(L + 1)], L)
    jqp = jcalibrate(spec, jparams, images, qat_add_bounds=bounds)
    _assert_within_golden_bounds(qp, jqp.a_scale, jqp.a_zero, L)
    for i in range(L):
        np.testing.assert_array_equal(qp.w_int[i], jqp.w_int[i])
    assert qp.w_scale == jqp.w_scale


@pytest.mark.parametrize("task,observer", [("sr_x4", "percentile"), ("dm", "kl"),
                                           ("nr_qat", "kl"), ("sr_x2_qat", "percentile")])
def test_histogram_observers_match_jax(task, observer):
    """The histogram pass of both packages on the same images (nr_qat: the
    second pass keeps the frozen QuantAdd composition). sr_x2 is not among
    them: there the JAX package's min/max of domain 4 is 1e-3 off the
    golden (its f32 conv order; tests/test_integer_bitexact.py notes it),
    where the port's equals the golden, and a clipping observer on 24 k
    values moves with its top few."""
    g, spec, params, jparams, images, bounds = _golden(task)
    L = int(g["num_convs"])
    qp = calibrate(spec, params, images, observer=observer, qat_add_bounds=bounds,
                   device="cpu")
    jqp = jcalibrate(spec, jparams, images, observer=observer, qat_add_bounds=bounds)
    _assert_within_golden_bounds(qp, jqp.a_scale, jqp.a_zero, L)


def test_histogram_matches_jax_bin_for_bin():
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.normal(0.3, 0.2, 20000), rng.uniform(-1, 3, 500),
                        [-1.0, 3.0]]).astype(np.float32)
    lo, hi = np.float32(x.min()), np.float32(x.max())
    for bins in (observers.BINS_NUM, 300):
        got = observers.histogram_on_device(torch.from_numpy(x), torch.tensor(lo),
                                            torch.tensor(hi), bins)
        want = jobservers.histogram_on_device(jnp.asarray(x), jnp.float32(lo), jnp.float32(hi),
                                              bins)
        assert got.shape == (bins,) and int(got.sum()) == x.size
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_percentile_and_kl_bounds_match_jax():
    rng = np.random.default_rng(11)
    hist = np.bincount(np.clip(rng.exponential(150.0, 50000).astype(int), 0, 2047),
                       minlength=2048)
    lo, hi = -0.25, 3.5
    for p in (0.9999, 0.99):
        assert observers.percentile_bounds(hist, lo, hi, p) == \
            jobservers.percentile_bounds(hist, lo, hi, p)
    assert observers.percentile_bounds(np.zeros(2048), lo, hi) == (lo, hi)
    assert observers.kl_threshold(hist) == jobservers.kl_threshold(hist)
    assert observers.kl_bounds(hist, lo, hi) == jobservers.kl_bounds(hist, lo, hi)


@pytest.mark.parametrize("task", ["nr", "sr_x2", "dm"])
def test_guardrail_decision_matches_jax(task):
    """KL on the raw-domain tasks loses more than 1 dB against minmax (nr by
    12 dB, dm by 3) and warns; on sr_x2 it does not. The same decision in
    both packages, on the same synthetic pairs."""
    _, spec, params, jparams, _, _ = _golden(task)
    data = list(SyntheticDataset(task, n=2, hw=(64, 96)))
    jdata = list(JSyntheticDataset(task, n=2, hw=(64, 96)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        guarded_calibrate(spec, params, data, task, observer="kl", device="cpu")
    with warnings.catch_warnings(record=True) as jcaught:
        warnings.simplefilter("always")
        jguarded_calibrate(spec, jparams, jdata, task, observer="kl")
    fired = [w for w in caught if w.category is ObserverRegressionWarning]
    jfired = [w for w in jcaught if w.category is JObserverRegressionWarning]
    assert len(fired) == len(jfired) == (0 if task == "sr_x2" else 1)
    if fired:
        # the message carries both PSNRs
        assert str(fired[0].message).split(" (")[1][:40] == \
            str(jfired[0].message).split(" (")[1][:40]


def test_fidelity_psnr_and_fake_quant_forward():
    g, spec, params, jparams, images, _ = _golden("sr_x4")
    qp = calibrate(spec, params, images, device="cpu")
    assert quantization_fidelity_psnr(spec, params, qp, images, device="cpu") == \
        pytest.approx(jfidelity(spec, jparams, qp, images), abs=1e-3)
    y = fake_quant_forward(spec, params, images[0], device="cpu")
    assert torch.equal(y, calibration_forward(spec, params, images[0], device="cpu")[0])


def test_calibrate_refuses_bad_arguments():
    _, spec, params, _, images, _ = _golden("sr_x4")
    with pytest.raises(ValueError, match="observer"):
        calibrate(spec, params, images, observer="mse", device="cpu")
    w_int = [np.full(np.shape(w), 128, np.int32) for w in params.weights]
    with pytest.raises(ValueError, match="w_int_override"):
        calibrate(spec, params, images, w_int_override=w_int, device="cpu")
    with pytest.raises(ValueError, match="degenerate"):
        calibrate(spec, params, [np.zeros_like(images[0])], device="cpu")
