"""Overlapping windows on one device (sesr_tpu_torch/ops/slab.py): H-slabs
and the virtual ranks of the sharded deployment forwards
(parallel/tiling.py ``virtual_rank_forward``) must equal the monolithic
deployment forward value for value, and the JAX package's; the mirror of
tests/test_slab.py on the plain version, and the windows at other
HardwareConfigs."""

import os

import numpy as np
import pytest
import jax.numpy as jnp

from sesr_tpu.config import spec_for_task as jspec_for_task
from sesr_tpu.ops import slab as jslab
from sesr_tpu.ops.packed import packed_fast_forward, packed_hybrid_forward, select_packed_forward
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch.config import HardwareConfig, SESRSpec, spec_for_task
from sesr_tpu_torch.data import SyntheticDataset
from sesr_tpu_torch.deploy import select_forward
from sesr_tpu_torch.ops.corrected import hybrid_forward
from sesr_tpu_torch.ops.fast import fast_forward
from sesr_tpu_torch.ops.slab import pick_slab_h, receptive_radius, slab_forward
from sesr_tpu_torch.parallel.tiling import virtual_rank_forward
from sesr_tpu_torch.quant.calibrate import calibrate
from sesr_tpu_torch.quant.certify import certify_fast
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_torch_calibrate import _golden

ARTIFACTS = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")


def _qp(task):
    path = os.path.join(ARTIFACTS, f"qparams_{task}.npz")
    return QuantParams.load(path), JQuantParams.load(path)


def _jax_mono(task, x, fwd=None):
    _, jqp = _qp(task)
    fwd = fwd or select_packed_forward(jqp)[1]
    return np.asarray(fwd(jspec_for_task(task), jqp, jnp.asarray(x), s=(2, 4)))


@pytest.mark.parametrize("task,slab_h", [("sr_x2", 32), ("sr_x2", 24), ("sr_x4", 32),
                                         ("nrdm_3", 32), ("dm", 24)])
def test_slab_bitexact_vs_monolithic(task, slab_h):
    spec = spec_for_task(task)
    qp, _ = _qp(task)
    for inp, _ in SyntheticDataset(task, n=2, hw=(88, 64), seed=11):
        y_slab = slab_forward(spec, qp, inp, slab_h=slab_h, device="cpu").numpy()
        np.testing.assert_array_equal(
            y_slab, select_forward(qp)[1](spec, qp, inp, device="cpu").numpy())
        np.testing.assert_array_equal(y_slab, _jax_mono(task, inp))


def test_slab_bitexact_odd_height():
    """H a multiple of neither the slab nor the cell: the last slab is short
    and its window clamps at the bottom edge."""
    spec = spec_for_task("sr_x2")
    qp, _ = _qp("sr_x2")
    x = np.random.default_rng(5).random((1, 77, 48, 3), dtype=np.float32)
    y = slab_forward(spec, qp, x, slab_h=32, fwd=fast_forward, device="cpu").numpy()
    np.testing.assert_array_equal(y, fast_forward(spec, qp, x, device="cpu").numpy())
    np.testing.assert_array_equal(y, _jax_mono("sr_x2", x, packed_fast_forward))


def test_slab_hybrid_lowering():
    spec = spec_for_task("nr")
    qp, _ = _qp("nr")
    assert qp.fast_cert_layers is not None and any(qp.fast_cert_layers)
    inp, _ = SyntheticDataset("nr", n=1, hw=(80, 64), seed=3)[0]
    y = slab_forward(spec, qp, inp, slab_h=24, fwd=hybrid_forward, device="cpu").numpy()
    np.testing.assert_array_equal(y, hybrid_forward(spec, qp, inp, device="cpu").numpy())
    np.testing.assert_array_equal(y, _jax_mono("nr", inp, packed_hybrid_forward))


@pytest.mark.parametrize("out_dtype", ["f32", "int8"])
def test_slab_batch_serial(out_dtype):
    spec = spec_for_task("sr_x2")
    qp, _ = _qp("sr_x2")
    x = np.random.default_rng(9).random((3, 40, 48, 3), dtype=np.float32)
    y = slab_forward(spec, qp, x, slab_h=16, batch_serial=True, out_dtype=out_dtype,
                     device="cpu")
    np.testing.assert_array_equal(
        y.numpy(), fast_forward(spec, qp, x, out_dtype=out_dtype, device="cpu").numpy())


def test_pick_slab_h():
    spec, jspec = spec_for_task("sr_x2"), jspec_for_task("sr_x2")
    for H in (77, 540, 545, 1080, 1081, 2160):
        assert pick_slab_h(spec, H) == jslab.pick_slab_h(jspec, H), H
    h = pick_slab_h(spec, 1080)
    assert h < 1080 and h % 2 == 0 and -(-1080 // h) * h >= 1080
    assert pick_slab_h(spec, 1080) == 270 and len(range(0, 1080, 270)) == 4
    for task in ("sr_x2", "nrdm_6"):
        assert receptive_radius(spec_for_task(task)) == \
            jslab.receptive_radius(jspec_for_task(task))
    assert receptive_radius(spec) == 7


@pytest.mark.parametrize("task,grid", [("sr_x2", (1, 4)), ("sr_x2", (2, 2)), ("nr", (1, 4)),
                                       ("nr", (2, 2)), ("nr", (4, 1)), ("sr_x4", (3, 3))])
def test_virtual_ranks_equal_monolithic(task, grid):
    """Every rank's window in turn on one device: 45 x 58 splits into blocks
    of unequal size along both axes, and nr (hybrid) and sr_x2 (fast) equal
    the monolithic forward, in both output contracts."""
    spec = spec_for_task(task)
    qp, _ = _qp(task)
    x = np.random.default_rng(13).random((1, 45, 58, spec.in_channels), dtype=np.float32)
    for out_dtype in ("f32", "int8"):
        y = virtual_rank_forward(spec, qp, x, grid, out_dtype=out_dtype, device="cpu").numpy()
        want = select_forward(qp)[1](spec, qp, x, out_dtype=out_dtype, device="cpu").numpy()
        np.testing.assert_array_equal(y, want)


@pytest.mark.parametrize("task,hw", [
    ("sr_x2", HardwareConfig(pe=2, bias_bits=12, requant_bits=12, requant_n_max=24)),
    ("nr", HardwareConfig(pe=8, pe_acc_bits=20, pe_add_bits=22)),
    ("nr", HardwareConfig(pe=3))], ids=["sr_x2-pe2_servable", "nr-pe8_wide", "nr-pe3"])
def test_windows_at_other_configs(task, hw):
    """The windows keep R = spec.halo_width() at any HardwareConfig: the
    golden float weights calibrated and certified at one of
    tests/test_hwconfig_sweep.py's configs, served as slabs and as virtual
    ranks, equal the monolithic forward of the mode their certificate
    selects."""
    _, spec, params, _, images, _ = _golden(task)
    qp = calibrate(spec, params, images, hw=hw, device="cpu")
    qp = certify_fast(spec, qp, [x for x, _ in SyntheticDataset(task, n=1, hw=(48, 64))],
                      device="cpu")
    x = np.random.default_rng(17).random((1, 45, 58, spec.in_channels), dtype=np.float32)
    want = select_forward(qp)[1](spec, qp, x, device="cpu").numpy()
    np.testing.assert_array_equal(slab_forward(spec, qp, x, slab_h=16, device="cpu").numpy(),
                                  want)
    np.testing.assert_array_equal(virtual_rank_forward(spec, qp, x, (2, 2),
                                                       device="cpu").numpy(), want)


def test_an_overlap_of_r_minus_one_is_not_exact(monkeypatch):
    """The window's reach R = sum(k // 2) is the least that is exact."""
    spec = spec_for_task("nr")
    qp, _ = _qp("nr")
    x = np.random.default_rng(17).random((1, 40, 64, 3), dtype=np.float32)
    want = hybrid_forward(spec, qp, x, device="cpu").numpy()
    monkeypatch.setattr(SESRSpec, "halo_width", lambda self: 6)
    y = virtual_rank_forward(spec, qp, x, (2, 4), device="cpu").numpy()
    assert not np.array_equal(y, want)
