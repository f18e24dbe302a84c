"""The port's AdaRound (sesr_tpu_torch/quant/adaround.py) against
sesr_tpu/quant/adaround.py on sr_x4's golden weights and calibration
images. Exact: the nearest baseline, the start point v0, the integer
inputs collected per layer, and the whole output with no optimizer step.
Bounded: after 120 Adam steps the two optimizers' trajectories differ in
their float summation order, so a few weights land on the other side of
0.5 (at most 1 % of a layer's weights)."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.models.sesr import CollapsedParams as JCollapsedParams
from sesr_tpu.quant import adaround as jadaround
from sesr_tpu.quant.calibrate import calibrate as jcalibrate
from sesr_tpu.quant.params import quantize_weights as jquantize_weights
from sesr_tpu_torch import cli
from sesr_tpu_torch.config import HardwareConfig, spec_for_task
from sesr_tpu_torch.models.sesr import CollapsedParams
from sesr_tpu_torch.quant import adaround
from sesr_tpu_torch.quant.calibrate import calibrate
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_integer_bitexact import _load_golden
from tests.test_torch_cli import _collapsed_npz
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

TASK = "sr_x4"


@pytest.fixture(scope="module")
def golden():
    """(port params, JAX params, images, port qp, JAX qp): the golden bundle's
    collapsed weights, its three 32x48 calibration images, and the nearest
    calibration of each package."""
    g = _load_golden(TASK)
    L = int(g["num_convs"])
    ws = [np.transpose(g[f"w_collapsed_{i}"], (2, 3, 1, 0)) for i in range(L)]
    bs = [g[f"b_collapsed_{i}"] for i in range(L)]
    images = [g[f"calib_img_{j}"].transpose(0, 2, 3, 1) for j in range(int(g["n_calib"]))]
    params = CollapsedParams(ws, bs)
    jparams = JCollapsedParams([jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    qp = calibrate(spec_for_task(TASK), params, images, device="cpu")
    jqp = jcalibrate(jspec_for_task(TASK), jparams, images)
    return params, jparams, images, qp, jqp


def _record(monkeypatch, module, calls):
    """Wrap module.optimize_layer_rounding: its arguments and result go to
    ``calls``."""
    inner = module.optimize_layer_rounding

    def recorder(w, s, xs, steps=800, **kw):
        out = inner(w, s, xs, steps=steps, **kw)
        calls.append((np.asarray(w), s, np.asarray(xs.cpu() if torch.is_tensor(xs) else xs),
                      out))
        return out

    monkeypatch.setattr(module, "optimize_layer_rounding", recorder)


def test_optimize_layer_rounding_guard_and_range():
    """tests/test_adaround.py's properties: a neighbour rounding of W / s in
    range, never worse than nearest on its own inputs."""
    rng = np.random.default_rng(1234)
    w = rng.standard_normal((3, 3, 8, 8)).astype(np.float32) * 0.1
    s = float(np.abs(w).max() / 127.0)
    xs = rng.integers(-128, 128, (4, 12, 16, 8)).astype(np.float32)
    res = adaround.optimize_layer_rounding(w, s, xs, steps=120, device="cpu")
    assert res.w_int.dtype == np.int32
    assert (res.w_int >= -128).all() and (res.w_int <= 127).all()
    base = np.floor(np.asarray(w, np.float64) / s)
    assert np.isin(res.w_int - base.astype(np.int64), [0, 1]).all()
    assert res.mse_final <= res.mse_nearest
    assert 0.0 <= res.moved <= 1.0


def test_start_point_and_baseline_exact(golden, monkeypatch):
    """v0 equals the start JAX hands its optimizer (recorded from
    optax.adam's init), and the nearest baseline equals the shipped
    round-to-nearest (quantize_weights)."""
    params, _, _, qp, _ = golden
    starts = []
    adam = optax.adam

    def recording_adam(lr):
        opt = adam(lr)
        return optax.GradientTransformation(lambda p: (starts.append(np.asarray(p)),
                                                       opt.init(p))[1], opt.update)

    monkeypatch.setattr(optax, "adam", recording_adam)
    rng = np.random.default_rng(0)
    xs = rng.integers(-20, 20, (1, 6, 8, 16)).astype(np.float32)
    w_int, _ = jquantize_weights([np.asarray(w) for w in params.weights])
    for i in (1, 3):
        jadaround.optimize_layer_rounding(params.weights[i], qp.w_scale[i], xs, steps=0)
        _, _, v0, w_nearest = adaround.rounding_start(params.weights[i], qp.w_scale[i])
        np.testing.assert_array_equal(v0, starts[-1])
        np.testing.assert_array_equal(w_nearest, w_int[i])


def test_no_step_output_and_inputs_equal_jax(golden, monkeypatch):
    """With steps=0 h(v0) > 0.5 is nearest rounding: every layer's w_int,
    and every layer's collected integer inputs, equal JAX's."""
    params, jparams, images, qp, jqp = golden
    np.testing.assert_array_equal(qp.w_scale, jqp.w_scale)
    port_calls, jax_calls = [], []
    _record(monkeypatch, adaround, port_calls)
    _record(monkeypatch, jadaround, jax_calls)
    got = [r.w_int for r in adaround.adaround_weights(spec_for_task(TASK), params, qp, images,
                                                      steps=0, device="cpu")]
    want = jadaround.adaround_weights(jspec_for_task(TASK), jparams, jqp, images, steps=0)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=f"layer {i}")
        np.testing.assert_array_equal(port_calls[i][2], jax_calls[i][2], err_msg=f"layer {i}")


def test_optimizer_bounded_against_jax(golden, monkeypatch):
    """120 steps per layer on the inputs JAX collected: w_int differs on at
    most 1 % of each layer's weights, mse_nearest within rel 1e-5, and on
    both sides mse_final <= mse_nearest; the port's own adaround_weights
    differs from JAX's on at most 1 % of each layer too."""
    params, jparams, images, qp, jqp = golden
    jax_calls = []
    _record(monkeypatch, jadaround, jax_calls)
    want = jadaround.adaround_weights(jspec_for_task(TASK), jparams, jqp, images, steps=120)
    moved = 0.0
    for i, (w, s, xs, (j_int, j_moved, j_near, j_final)) in enumerate(jax_calls):
        res = adaround.optimize_layer_rounding(w, s, xs, steps=120, device="cpu")
        assert np.mean(res.w_int != np.asarray(j_int)) <= 0.01, f"layer {i}"
        assert res.mse_nearest == pytest.approx(j_near, rel=1e-5)
        assert res.mse_final <= res.mse_nearest and j_final <= j_near
        moved = max(moved, res.moved)
    assert moved > 0                       # the optimizer moved something
    got = adaround.adaround_weights(spec_for_task(TASK), params, qp, images, steps=120,
                                    device="cpu")
    for r, b in zip(got, want):
        assert np.mean(r.w_int != np.asarray(b)) <= 0.01
        assert r.mse_final <= r.mse_nearest


def test_six_bit_hardware_keeps_weights_in_range(golden):
    """The nearest baseline and the final snap clip to hw.quan_bits' range
    (the JAX package clips to int8 whatever the width)."""
    params, _, images, _, _ = golden
    hw = HardwareConfig(quan_bits=6)
    qp6 = calibrate(spec_for_task(TASK), params, images, hw=hw, device="cpu")
    w_new = [r.w_int for r in adaround.adaround_weights(spec_for_task(TASK), params, qp6,
                                                        images, steps=30, device="cpu")]
    for w in w_new:
        assert w.min() >= -32 and w.max() <= 31
    qp = calibrate(spec_for_task(TASK), params, images, hw=hw, w_int_override=w_new,
                   device="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(qp.w_int, w_new))


def test_calibrate_cli_weight_rounding_adaround(tmp_path, capsys):
    """calibrate --weight-rounding adaround: with --adaround-steps 0 the
    artifact equals the JAX command's (w_int, scales and zeros); with
    steps, weights move off nearest to a neighbour."""
    from sesr_tpu import cli as jcli

    args = ["calibrate", "--task", TASK, "--checkpoint", _collapsed_npz(tmp_path, TASK),
            "--n-images", "2", "--no-eval", "--weight-rounding", "adaround"]
    qp0 = cli.main(args + ["--adaround-steps", "0", "--out", str(tmp_path / "a.npz"),
                           "--device", "cpu"])
    jcli.main(args + ["--adaround-steps", "0", "--out", str(tmp_path / "j.npz")])
    jqp = QuantParams.load(str(tmp_path / "j.npz"))
    for a, b in zip(qp0.w_int, jqp.w_int):
        np.testing.assert_array_equal(a, b)
    for d in range(len(qp0.a_scale)):
        assert qp0.a_scale[d] == pytest.approx(jqp.a_scale[d], rel=3e-3)
        assert abs(qp0.a_zero[d] - jqp.a_zero[d]) <= 2
    qp = cli.main(args + ["--adaround-steps", "40", "--out", str(tmp_path / "b.npz"),
                          "--device", "cpu"])
    assert "saved" in capsys.readouterr().out
    moved = [np.mean(a != b) for a, b in zip(qp.w_int, qp0.w_int)]
    assert max(moved) > 0, moved
    assert all(np.abs(a.astype(np.int64) - b).max() <= 1 for a, b in zip(qp.w_int, qp0.w_int))
    assert qp.w_scale == qp0.w_scale
