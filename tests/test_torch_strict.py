"""The port's strict per-MAC-saturating interpreter
(sesr_tpu_torch/quant/strict.py) against sesr_tpu.quant.strict on the same
numpy inputs: the conv (transient saturation included), the whole network
on sr_x2 and nr, and the divergence counts."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu.quant.strict import conv_per_mac_saturating as jconv
from sesr_tpu.quant.strict import strict_integer_forward as jstrict_forward
from sesr_tpu.quant.strict import strict_vs_fast_divergence as jdivergence
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.data import SyntheticDataset
from sesr_tpu_torch.quant.integer import integer_forward
from sesr_tpu_torch.quant.params import QuantParams
from sesr_tpu_torch.quant.strict import (conv_per_mac_saturating, strict_integer_forward,
                                         strict_vs_fast_divergence)
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

ARTIFACTS = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")


@pytest.mark.parametrize("k,scale", [(3, 1), (5, 1), (3, 60)])
def test_conv_matches_jax(k, scale):
    """scale=60 saturates on the way, so the clamp order is exercised; a
    zero input channel exercises the skipped taps."""
    rng = np.random.default_rng(k * scale)
    x = rng.integers(-128, 128, (2, 10, 12, 8)).astype(np.int32) * scale
    w = rng.integers(-127, 128, (k, k, 8, 4)).astype(np.int32)
    w[:, :, 3] = 0
    got = conv_per_mac_saturating(torch.from_numpy(x), w)
    want = np.asarray(jconv(jnp.asarray(x), w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert strict_vs_fast_divergence(x, w) == jdivergence(x, w)
    if scale > 1:
        assert strict_vs_fast_divergence(x, w) > 0


@pytest.mark.parametrize("task", ["sr_x2", "nr"])
def test_strict_forward_and_divergence_match_jax(task):
    path = os.path.join(ARTIFACTS, f"qparams_{task}.npz")
    qp, jqp = QuantParams.load(path), JQuantParams.load(path)
    spec = spec_for_task(task)
    x = SyntheticDataset(task, n=1, hw=(48, 64))[0][0]
    got = strict_integer_forward(spec, qp, x, device="cpu")
    want = np.asarray(jstrict_forward(jspec_for_task(task), jqp, jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    # where no accumulator saturates (sr_x2; nr's last conv does), strict
    # equals the clamp-once interpreter
    ref, dumps = integer_forward(spec, qp, x, collect_dumps=True, device="cpu")
    saturates = int(dumps["overflow_counts"].sum()) > 0
    assert saturates == (task == "nr")
    assert torch.equal(got, ref) != saturates
    # the last conv at its real input, its weights widened until it
    # saturates on the way
    i = spec.num_convs - 1
    x_shift = dumps[f"input.{i}"].to(torch.int32) - qp.effective_zero(i)
    w = np.asarray(qp.w_int[i]) * 40
    count = strict_vs_fast_divergence(x_shift, w, qp.hw)
    assert count == jdivergence(x_shift.numpy(), w, jqp.hw) and count > 0
