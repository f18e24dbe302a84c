"""The port's uncollapsed network (sesr_tpu_torch/models/expanded.py)
against sesr_tpu/models/expanded.py on the same numpy-seeded weights: the
float forward, both collapses, the state-dict loader, and the expanded
forward against the collapsed one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.models import expanded as jexpanded
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.models.expanded import (ExpandedSESR, collapse_expanded,
                                            collapse_expanded_qat, expanded_from_arrays,
                                            expanded_from_state_dict, forward_expanded,
                                            init_expanded)
from sesr_tpu_torch.models.sesr import forward_float
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

TASKS = ("nrdm_3", "sr_x4", "sr_x2")


def seeded_blocks(spec, seed=0):
    """(w_expand, w_squeeze, b_squeeze) numpy float32 per block, HWIO,
    N(0, 1/fan_in) weights and small random biases."""
    rng = np.random.default_rng(seed)
    chans = ([spec.in_channels] + [spec.num_channels] * (spec.num_convs - 1)
             + [spec.conv_out_channels])
    t = spec.tmp_channels
    out = []
    for i, k in enumerate(spec.kernel_sizes):
        w_e = rng.standard_normal((k, k, chans[i], t)) / np.sqrt(k * k * chans[i])
        w_s = rng.standard_normal((1, 1, t, chans[i + 1])) / np.sqrt(t)
        out.append((w_e.astype(np.float32), w_s.astype(np.float32),
                    (0.01 * rng.standard_normal(chans[i + 1])).astype(np.float32)))
    return out


def jax_params(blocks):
    return jexpanded.ExpandedParams([jexpanded.ExpandedBlock(*(jnp.asarray(a) for a in blk))
                                     for blk in blocks])


@pytest.mark.parametrize("task", TASKS)
def test_forward_expanded_matches_jax(task):
    spec = spec_for_task(task)
    blocks = seeded_blocks(spec)
    x = np.random.default_rng(1).random((1, 12, 18, spec.in_channels), dtype=np.float32)
    got = forward_expanded(spec, expanded_from_arrays(blocks), x, device="cpu").numpy()
    want = np.asarray(jexpanded.forward_expanded(jspec_for_task(task), jax_params(blocks),
                                                 jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("task", TASKS)
def test_collapses_equal_jax(task):
    """The same numpy arithmetic: array_equal, float and fake-quant delta."""
    spec = spec_for_task(task)
    blocks = seeded_blocks(spec, seed=2)
    params = expanded_from_arrays(blocks)
    for port, jax_fn in ((collapse_expanded, jexpanded.collapse_expanded),
                         (collapse_expanded_qat, jexpanded.collapse_expanded_qat)):
        got = port(spec, params)
        want = jax_fn(jspec_for_task(task), jax_params(blocks))
        for a, b in zip(got.weights + got.biases, want.weights + want.biases):
            assert a.dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, np.asarray(b))


def test_expanded_from_state_dict_matches_jax():
    """A seeded state dict under the reference's key names (OIHW), extra
    quantizer buffers beside them as in a QAT checkpoint."""
    spec = spec_for_task("nrdm_3")
    names = (["conv_first"] + [f"residual_block.{i}" for i in range(spec.num_lblocks)]
             + ["conv_last"])
    state = {}
    for name, (w_e, w_s, b) in zip(names, seeded_blocks(spec, seed=3)):
        state[f"{name}.conv_expand.weight"] = np.transpose(w_e, (3, 2, 0, 1))
        state[f"{name}.conv_squeeze.weight"] = np.transpose(w_s, (3, 2, 0, 1))
        state[f"{name}.conv_squeeze.bias"] = b
        state[f"{name}.conv_expand.weight_quantizer.observer.min_val"] = np.float32([-1])
    got = expanded_from_state_dict(spec, state)
    want = jexpanded.expanded_from_state_dict(jspec_for_task("nrdm_3"), state)
    for gb, wb in zip(got.blocks, want.blocks):
        for a, b in zip(gb, wb):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    del state["conv_last.conv_squeeze.bias"]
    with pytest.raises(KeyError, match="conv_last.conv_squeeze.bias"):
        expanded_from_state_dict(spec, state)


@pytest.mark.parametrize("task", ["nrdm_3", "sr_x4"])
def test_expanded_forward_matches_collapsed(task):
    """tests/test_qat.py test_expanded_forward_matches_collapsed's bounds,
    from init_expanded's weights."""
    spec = spec_for_task(task)
    params = init_expanded(spec, torch.Generator().manual_seed(0))
    x = np.random.default_rng(4).random((1, 12, 18, spec.in_channels), dtype=np.float32)
    y_exp = forward_expanded(spec, params, x, device="cpu").numpy()
    y_col = forward_float(spec, collapse_expanded(spec, params), x, device="cpu").numpy()
    np.testing.assert_allclose(y_exp, y_col, rtol=5e-3, atol=5e-4)


def test_init_and_module():
    """init_expanded draws from its generator alone; ExpandedSESR holds the
    blocks as parameters and runs forward_expanded."""
    spec = spec_for_task("sr_x4")
    a = init_expanded(spec, torch.Generator().manual_seed(7))
    b = init_expanded(spec, torch.Generator().manual_seed(7))
    for ba, bb, k in zip(a.blocks, b.blocks, spec.kernel_sizes):
        assert ba.w_expand.shape[:2] == (k, k) and ba.w_expand.shape[3] == spec.tmp_channels
        for u, v in zip(ba, bb):
            assert torch.equal(u, v)
    model = ExpandedSESR(spec, a)
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.numel() for blk in a.blocks for v in blk)
    x = torch.from_numpy(np.random.default_rng(5).random((1, 8, 10, 1), dtype=np.float32))
    assert torch.equal(model(x), forward_expanded(spec, a, x))
    assert model(x).shape == (1, 32, 40, 1)
