"""The residual modes of the port's integer interpreter
(sesr_tpu_torch/quant/integer.py ``residual_mode``) and the frozen QuantAdd
(sesr_tpu_torch/quant/qat.py): every stage of the four graph_add bundles
(nr, dm: "graph_add"; nr_qat, dm_qat: "graph_add_qat") against the
reference-generated goldens, and the whole interpreter against
sesr_tpu.quant.integer.integer_forward in both modes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu.quant.qat import quant_add_frozen as jquant_add_frozen
from sesr_tpu.quant.qat import quant_add_scale_from_bounds as jscale
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.quant.integer import integer_forward
from sesr_tpu_torch.quant.qat import quant_add_frozen, quant_add_scale_from_bounds
from tests.test_integer_bitexact import RESIDUAL_MODE, SPEC_TASK, _load_golden, _qat_bounds
from tests.test_torch_params import _port_golden_qparams
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

GRAPH_GOLDENS = ["nr", "dm", "nr_qat", "dm_qat"]


def _nchw(a):
    return a.numpy().transpose(0, 3, 1, 2)


@pytest.mark.parametrize("task", GRAPH_GOLDENS)
def test_golden_stages(task):
    g = _load_golden(task)
    spec = spec_for_task(SPEC_TASK.get(task, task))
    qp = _port_golden_qparams(task, g)
    L = qp.num_convs
    y, dumps = integer_forward(spec, qp, g["fixture"].transpose(0, 2, 3, 1),
                               collect_dumps=True, device="cpu",
                               residual_mode=RESIDUAL_MODE[task],
                               qat_add_bounds=_qat_bounds(task, g))
    for i in range(L):
        np.testing.assert_array_equal(_nchw(dumps[f"input.{i}"]), g[f"input_{i}"],
                                      err_msg=f"input.{i}")
        for p in range(4):
            np.testing.assert_array_equal(_nchw(dumps[f"pe_out.{i}"][p]),
                                          g[f"pe_out_{i}_{p}"][None],
                                          err_msg=f"pe_out {i} pe {p}")
        np.testing.assert_array_equal(_nchw(dumps[f"pe_add.{i}"]), g[f"pe_add_{i}"],
                                      err_msg=f"pe_add.{i}")
    np.testing.assert_array_equal(_nchw(dumps["shortcut"]), g["shortcut"])
    np.testing.assert_array_equal(_nchw(dumps[f"input.{L}"]), g[f"input_{L}"])
    np.testing.assert_array_equal(y.numpy(), g["gfake"].transpose(0, 2, 3, 1))


@pytest.mark.parametrize("task", GRAPH_GOLDENS)
@pytest.mark.parametrize("mode", ["graph_add", "graph_add_qat"])
def test_matches_jax_interpreter(task, mode):
    """Both residual modes on each bundle's artifact (the corrected datapath
    for nr and dm, the reference one for their QAT bundles): the output and
    every dump equal sesr_tpu's."""
    corrected = not task.endswith("_qat")
    g = _load_golden(task)
    base = SPEC_TASK.get(task, task)
    qp = _port_golden_qparams(task, g)
    bounds = (float(g["qat_add_lo"]), float(g["qat_add_hi"])) if "qat_add_lo" in g \
        else (-0.25, 0.75)
    kw = dict(residual_mode=mode, qat_add_bounds=bounds if mode == "graph_add_qat" else None,
              corrected=corrected)
    x = np.random.default_rng(5).random((1, 24, 40, 3), dtype=np.float32)
    y_j, d_j = jinteger_forward(jspec_for_task(base), qp, jnp.asarray(x),
                                collect_dumps=True, **kw)
    y_t, d_t = integer_forward(spec_for_task(base), qp, x, collect_dumps=True,
                               device="cpu", **kw)
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert sorted(d_t) == sorted(d_j)
    for k in d_j:
        np.testing.assert_array_equal(d_t[k].numpy(), np.asarray(d_j[k]), err_msg=k)


def test_quant_add_frozen_matches_jax():
    """The scale (float32, eps floor) and the fake-quant's half-away-from-zero
    rounding: values on the half steps round away from zero, not to even."""
    for lo, hi in ((0.0, 0.5096381902694702), (-1.3, 0.2), (0.0, 0.0)):
        assert quant_add_scale_from_bounds(lo, hi) == jscale(lo, hi)
    lo, hi = 0.0, 1.275                   # scale 0.01: half steps at +-0.005 + k/100
    rng = np.random.default_rng(2)
    res = rng.uniform(-1.6, 1.6, (2, 9, 11, 16)).astype(np.float32)
    res[0, 0, 0, :4] = np.float32(quant_add_scale_from_bounds(lo, hi)) * \
        np.array([0.5, -0.5, 2.5, -2.5], np.float32)
    sc = rng.uniform(0.0, 1.6, res.shape).astype(np.float32)
    got = quant_add_frozen(torch.from_numpy(res), torch.from_numpy(sc), lo, hi)
    want = np.asarray(jquant_add_frozen(jnp.asarray(res), jnp.asarray(sc), lo, hi))
    np.testing.assert_array_equal(got.numpy(), want)
    half = quant_add_frozen(torch.from_numpy(res[:1, :1, :1, :4]),
                            torch.zeros(1, 1, 1, 4), lo, hi)
    steps = half.numpy().reshape(-1) / np.float32(quant_add_scale_from_bounds(lo, hi))
    np.testing.assert_allclose(steps, [1.0, -1.0, 3.0, -3.0], rtol=1e-6)


def test_residual_mode_arguments():
    g = _load_golden("nr")
    qp = _port_golden_qparams("nr", g)
    x = np.zeros((1, 8, 8, 3), np.float32)
    with pytest.raises(ValueError, match="residual_mode"):
        integer_forward(spec_for_task("nr"), qp, x, residual_mode="add", device="cpu")
    with pytest.raises(ValueError, match="qat_add_bounds"):
        integer_forward(spec_for_task("nr"), qp, x, residual_mode="graph_add_qat",
                        device="cpu")
