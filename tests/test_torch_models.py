"""The port's float network and checkpoint loader (sesr_tpu_torch/models/,
sesr_tpu_torch/io/torch_import.py) against the JAX package: the collapse
on seeded state dicts, the float forward on every golden bundle's collapsed
weights, the collapsed .npz and .pth loaders."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import REFERENCE_CHECKPOINTS as JREFERENCE_CHECKPOINTS
from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.io import torch_import as jimport
from sesr_tpu.models import blocks as jblocks
from sesr_tpu.models.sesr import CollapsedParams as JParams
from sesr_tpu.models.sesr import forward_float as jforward_float
from sesr_tpu_torch.config import REFERENCE_CHECKPOINTS, spec_for_task
from sesr_tpu_torch.io import torch_import
from sesr_tpu_torch.models import blocks
from sesr_tpu_torch.models.sesr import SESR, CollapsedParams, forward_float, init_params
from tests.test_integer_bitexact import GOLDEN_TASKS, SPEC_TASK, _load_golden
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
COLLAPSED_NPZ = os.path.join(REPO, "artifacts", "sr_x4_qat_collapsed.npz")


def _state_dict(spec, seed, collapsed_last=False):
    """A seeded reference-layout state dict (expand/squeeze per block, with
    the extra buffers a QAT checkpoint carries)."""
    rng = np.random.default_rng(seed)
    chans = [spec.in_channels] + [spec.num_channels] * (spec.num_convs - 1) + \
        [spec.conv_out_channels]
    names = ["conv_first"] + [f"residual_block.{i}" for i in range(spec.num_lblocks)] + \
        ["conv_last"]
    state = {}
    for i, (name, k) in enumerate(zip(names, spec.kernel_sizes)):
        if collapsed_last and i == spec.num_convs - 1:
            state[f"{name}.conv_expand.weight"] = rng.normal(
                0, 0.1, (chans[i + 1], chans[i], k, k)).astype(np.float32)
            state[f"{name}.conv_expand.bias"] = rng.normal(0, 0.1, chans[i + 1]).astype(np.float32)
            continue
        state[f"{name}.conv_expand.weight"] = rng.normal(
            0, 0.1, (spec.tmp_channels, chans[i], k, k)).astype(np.float32)
        state[f"{name}.conv_squeeze.weight"] = rng.normal(
            0, 0.1, (chans[i + 1], spec.tmp_channels, 1, 1)).astype(np.float32)
        state[f"{name}.conv_squeeze.bias"] = rng.normal(0, 0.1, chans[i + 1]).astype(np.float32)
    state["add_residual.observer_res.min_val"] = np.float32(-0.1)
    return state


def _assert_params_equal(a, b):
    assert len(a.weights) == len(b.weights)
    for x, y in zip(list(a.weights) + list(a.biases), list(b.weights) + list(b.biases)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_collapse_block_and_fold_match_jax():
    rng = np.random.default_rng(0)
    w_e = rng.normal(size=(256, 16, 3, 3)).astype(np.float32)
    w_s = rng.normal(size=(16, 256, 1, 1)).astype(np.float32)
    b = rng.normal(size=16).astype(np.float32)
    for got, want in zip(blocks.collapse_block(w_e, w_s, b), jblocks.collapse_block(w_e, w_s, b)):
        np.testing.assert_array_equal(got, want)
    w = rng.normal(size=(16, 16, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(blocks.fold_residual_identity(w),
                                  jblocks.fold_residual_identity(w))
    np.testing.assert_array_equal(blocks.hwio_to_oihw(blocks.oihw_to_hwio(w)), w)
    np.testing.assert_array_equal(blocks.oihw_to_hwio(w), jblocks.oihw_to_hwio(w))
    with pytest.raises(ValueError, match="residual fold"):
        blocks.fold_residual_identity(w[:, :3])


@pytest.mark.parametrize("task", ["sr_x2", "nrdm_6", "sr_x4"])
@pytest.mark.parametrize("qat", [False, True])
def test_collapse_state_dict_matches_jax(task, qat):
    spec = spec_for_task(task)
    state = _state_dict(spec, seed=len(task))
    if qat:
        got = torch_import.collapse_state_dict_qat(spec, state)
        want = jimport.collapse_state_dict_qat(jspec_for_task(task), state)
    else:
        got = torch_import.collapse_state_dict(spec, state)
        want = jimport.collapse_state_dict(jspec_for_task(task), state)
    _assert_params_equal(got, want)


@pytest.mark.parametrize("task", GOLDEN_TASKS)
def test_forward_float_matches_jax(task):
    g = _load_golden(task)
    spec = spec_for_task(SPEC_TASK.get(task, task))
    L = int(g["num_convs"])
    weights = [blocks.oihw_to_hwio(g[f"w_collapsed_{i}"]) for i in range(L)]
    biases = [g[f"b_collapsed_{i}"] for i in range(L)]
    x = np.random.default_rng(L).random((1, 32, 48, spec.in_channels), dtype=np.float32)
    got = forward_float(spec, CollapsedParams(weights, biases), x, device="cpu").numpy()
    want = np.asarray(jforward_float(jspec_for_task(spec.name),
                                     JParams([jnp.asarray(w) for w in weights],
                                             [jnp.asarray(b) for b in biases]),
                                     jnp.asarray(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_sesr_module_and_init_params():
    spec = spec_for_task("sr_x2")
    params = init_params(spec, torch.Generator().manual_seed(3))
    again = init_params(spec, torch.Generator().manual_seed(3))
    _assert_params_equal(params, again)
    assert [tuple(w.shape) for w in params.weights] == \
        [(5, 5, 3, 16), (3, 3, 16, 16), (3, 3, 16, 16), (3, 3, 16, 16), (5, 5, 16, 12)]
    net = SESR(spec, params)
    assert len(list(net.parameters())) == 2 * spec.num_convs
    x = torch.rand(2, 16, 24, 3, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        y = net(x)
    assert y.shape == (2, 32, 48, 3)
    assert torch.equal(y, forward_float(spec, params, x, device="cpu"))


def test_collapsed_npz_loads_as_jax():
    got = torch_import.load_reference_checkpoint("sr_x4", path=COLLAPSED_NPZ)
    want = jimport.load_reference_checkpoint("sr_x4", path=COLLAPSED_NPZ)
    _assert_params_equal(got, want)
    with pytest.raises(ValueError, match="meaningless"):
        torch_import.load_reference_checkpoint("sr_x4", path=COLLAPSED_NPZ, qat=True)
    with pytest.raises(ValueError, match="input channels"):
        torch_import.load_reference_checkpoint("nr", path=COLLAPSED_NPZ)


def test_collapsed_npz_shape_checks(tmp_path):
    with np.load(COLLAPSED_NPZ) as ck:
        arrays = dict(ck)
    bad = dict(arrays, w_1=np.transpose(arrays["w_1"], (3, 2, 0, 1)))
    np.savez(tmp_path / "oihw.npz", **bad)
    with pytest.raises(ValueError, match="HWIO"):
        torch_import.load_reference_checkpoint("sr_x4", path=str(tmp_path / "oihw.npz"))
    short = {k: v for k, v in arrays.items() if k != "b_4"}
    np.savez(tmp_path / "short.npz", **short)
    with pytest.raises(ValueError, match="b_4"):
        torch_import.load_reference_checkpoint("sr_x4", path=str(tmp_path / "short.npz"))


@pytest.mark.parametrize("wrapped", [False, True])
def test_pth_loader_matches_jax(tmp_path, wrapped):
    """A .pth the way the reference ships them (plain, or the x2sesr dict
    under 'state_dict'), with a collapsed last block and an extra buffer."""
    spec = spec_for_task("sr_x2")
    state = {k: torch.from_numpy(np.asarray(v)) for k, v in
             _state_dict(spec, seed=9, collapsed_last=True).items()}
    path = str(tmp_path / "x2sesr.pth.tar")
    torch.save({"state_dict": state} if wrapped else state, path)
    _assert_params_equal(torch_import.load_reference_checkpoint("sr_x2", path=path),
                         jimport.load_reference_checkpoint("sr_x2", path=path))


def test_qat_add_bounds_and_missing_reference(tmp_path):
    for task in ("sr_x2", "sr_x4"):
        assert torch_import.load_qat_add_bounds(task) == (0.0, 0.0) == \
            jimport.load_qat_add_bounds(task)
    with pytest.raises(ValueError, match="no QAT checkpoint"):
        torch_import.load_qat_add_bounds("x8")
    empty = str(tmp_path / "no_reference")
    with pytest.raises(FileNotFoundError, match="x2sesr.pth.tar"):
        torch_import.load_reference_checkpoint("sr_x2", reference_root=empty)
    with pytest.raises(FileNotFoundError, match="nr_qat_G.pth"):
        torch_import.load_qat_add_bounds("nr", reference_root=empty)
    assert torch_import.QAT_CHECKPOINTS == jimport.QAT_CHECKPOINTS
    assert REFERENCE_CHECKPOINTS == JREFERENCE_CHECKPOINTS
