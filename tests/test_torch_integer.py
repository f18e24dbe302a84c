"""The port's plain integer interpreter (sesr_tpu_torch/quant/integer.py):
value for value against sesr_tpu.quant.integer.integer_forward on the
shipped artifacts (outputs, every dump, the saturation counts), and every
stage against the reference-generated goldens of the sim-wiring tasks."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu.quant.integer import pe_channel_mask as jpe_channel_mask
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.quant.integer import integer_forward, pe_channel_mask
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_torch_params import SIM_GOLDENS, _port_golden_qparams
from tests.test_integer_bitexact import SPEC_TASK, _load_golden

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")
TASKS = ["nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2"]
CERTIFIED = ["dm", "nrdm_3", "sr_x4", "sr_x2"]
CASES = ([(t, "reference") for t in TASKS] + [(t, "corrected") for t in TASKS]
         + [(t, "fast") for t in CERTIFIED])
MODE_ARGS = {"reference": (False, "exact", "bf16"),
             "corrected": (True, "exact", "bf16"),
             "fast": (True, "fast", "fast")}


def _load(task):
    path = os.path.join(ARTIFACT_DIR, f"qparams_{task}.npz")
    return QuantParams.load(path), JQuantParams.load(path)


def _assert_same_run(spec, jspec, qp, jqp, x, corrected, compute, jcompute):
    y_j, d_j = jinteger_forward(jspec, jqp, jnp.asarray(x), collect_dumps=True,
                                corrected=corrected, compute=jcompute)
    y_t, d_t = integer_forward(spec, qp, x, collect_dumps=True,
                               corrected=corrected, compute=compute, device="cpu")
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert y_t.dtype == torch.float32
    assert sorted(d_t) == sorted(d_j)
    for k in d_j:
        np.testing.assert_array_equal(d_t[k].numpy(), np.asarray(d_j[k]), err_msg=k)
    return d_t


def test_certified_set_matches_artifacts():
    assert CERTIFIED == [t for t in TASKS if _load(t)[0].fast_cert_ok]


@pytest.mark.parametrize("task,mode", CASES)
def test_matches_jax_interpreter(task, mode):
    qp, jqp = _load(task)
    spec, jspec = spec_for_task(task), jspec_for_task(task)
    x = np.random.default_rng(17).random((1, 24, 40, spec.in_channels),
                                         dtype=np.float32)
    d = _assert_same_run(spec, jspec, qp, jqp, x, *MODE_ARGS[mode])
    assert d["overflow_counts"].shape == (spec.num_convs,)


def test_matches_jax_with_unusual_zero_points():
    """Zeros below -128 (restoration floors, the fused bias does not), odd
    and positive zeros (round(h) + zero differs from round(h + zero)), and
    a batch of two."""
    qp, jqp = _load("sr_x2")
    az = [-120, -131, -100, 5, -127, -128]
    qp, jqp = dataclasses.replace(qp, a_zero=az), dataclasses.replace(jqp, a_zero=az)
    x = np.random.default_rng(3).random((2, 20, 28, 3), dtype=np.float32)
    for mode in ("reference", "corrected", "fast"):
        _assert_same_run(spec_for_task("sr_x2"), jspec_for_task("sr_x2"), qp, jqp,
                         x, *MODE_ARGS[mode])


@pytest.mark.parametrize("task", SIM_GOLDENS)
def test_golden_stages(task):
    g = _load_golden(task)
    spec = spec_for_task(SPEC_TASK.get(task, task))
    qp = _port_golden_qparams(task, g)
    L = qp.num_convs
    x = g["fixture"].transpose(0, 2, 3, 1)
    y, dumps = integer_forward(spec, qp, x, collect_dumps=True, device="cpu")

    def nchw(a):
        return a.numpy().transpose(0, 3, 1, 2)

    for i in range(L):
        np.testing.assert_array_equal(nchw(dumps[f"input.{i}"]), g[f"input_{i}"],
                                      err_msg=f"input.{i}")
        for p in range(4):
            np.testing.assert_array_equal(nchw(dumps[f"pe_out.{i}"][p]),
                                          g[f"pe_out_{i}_{p}"][None],
                                          err_msg=f"pe_out {i} pe {p}")
        np.testing.assert_array_equal(nchw(dumps[f"pe_add.{i}"]), g[f"pe_add_{i}"],
                                      err_msg=f"pe_add.{i}")
    np.testing.assert_array_equal(nchw(dumps["shortcut"]), g["shortcut"])
    np.testing.assert_array_equal(nchw(dumps[f"input.{L}"]), g[f"input_{L}"])
    np.testing.assert_array_equal(y.numpy(), g["gfake"].transpose(0, 2, 3, 1))


def test_fast_refuses_uncertified():
    qp, _ = _load("nr")
    assert not qp.fast_cert_ok
    x = np.zeros((1, 8, 8, 3), np.float32)
    with pytest.raises(ValueError, match="certified"):
        integer_forward(spec_for_task("nr"), qp, x, corrected=True,
                        compute="fast", device="cpu")
    qp2, _ = _load("sr_x2")
    with pytest.raises(ValueError, match="corrected"):
        integer_forward(spec_for_task("sr_x2"), qp2, x, compute="fast", device="cpu")
    with pytest.raises(ValueError, match="compute"):
        integer_forward(spec_for_task("sr_x2"), qp2, x, compute="bf16", device="cpu")


def test_pe_channel_mask():
    for ic in (1, 3, 16):
        for p in range(4):
            np.testing.assert_array_equal(pe_channel_mask(ic, 4, p),
                                          jpe_channel_mask(ic, 4, p))
