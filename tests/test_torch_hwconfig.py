"""The port at the JAX package's alternate HardwareConfigs
(tests/test_hwconfig_sweep.py): 2 PEs with a 16/18-bit accumulator /
adder, a 12-bit bias and 12-bit x 2^-24 requantization; 8 PEs at 20/22
bits; 3 PEs, whose channel round-robin leaves the PEs unequal channel
counts; and PE2_SERVABLE. On the sweep's 8-channel net, on the CPU:

- the plain interpreter equals the sweep's independent numpy spec and the
  JAX package's interpreter, array_equal, on a JAX-calibrated artifact
  carried across with ``convert.quantparams_from_fields``;
- the port's ``calibrate`` equals the JAX package's (a_zero and w_int
  equal, a_scale within rel 1e-6);
- ``certify_fast`` stamps as the JAX package stamps, and
  ``deploy.select_forward`` picks the mode ``select_packed_forward``
  picks, its output equal to the corrected interpreter's;
- the npz round trip keeps the config, in both packages;
- the rounding tie recorded in ROADMAP (queue 3), where the JAX package
  rounds the other way from the reference;
- ``convert.kernel_constants`` takes every config at widths 8 and 16 and
  refuses what the kernels cannot hold.
The kernels themselves are held against the plain version at these
configs by chip_smoke.py phase 12."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.ops.packed import select_packed_forward
from sesr_tpu.quant.calibrate import calibrate as jcalibrate
from sesr_tpu.quant.certify import certify_fast as jcertify_fast
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu.quant.params import QuantParams as JQuantParams
from sesr_tpu_torch import convert, deploy
from sesr_tpu_torch.config import HardwareConfig, SESRSpec
from sesr_tpu_torch.models.sesr import CollapsedParams
from sesr_tpu_torch.quant.calibrate import calibrate
from sesr_tpu_torch.quant.certify import certify_fast
from sesr_tpu_torch.quant.integer import integer_forward
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_hwconfig_sweep import (ALT_CONFIGS, PE2_SERVABLE, SPEC as JSPEC, _images,
                                       _params, _params_sparse, numpy_integer_forward)
from tests.test_torch_params import _same
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

CONFIGS = {"pe2_narrow": ALT_CONFIGS[0], "pe8_wide": ALT_CONFIGS[1],
           "pe3_nondivisible": ALT_CONFIGS[2], "pe2_servable": PE2_SERVABLE}
SPEC = SESRSpec(**{f.name: getattr(JSPEC, f.name) for f in dataclasses.fields(SESRSpec)})
NETS = {"dense": _params, "sparse": _params_sparse}


def _hw(jhw) -> HardwareConfig:
    return HardwareConfig(**dataclasses.asdict(jhw))


def _port_params(jparams) -> CollapsedParams:
    return CollapsedParams([np.asarray(w) for w in jparams.weights],
                           [np.asarray(b) for b in jparams.biases])


def _carried(jqp) -> QuantParams:
    """The JAX package's QuantParams as the port's, through its fields."""
    fields = {f.name: getattr(jqp, f.name) for f in dataclasses.fields(jqp)}
    return convert.quantparams_from_fields(fields)


@functools.lru_cache(maxsize=None)
def _calibrated(config: str, net: str, seed: int = 3):
    """(JAX QuantParams, the port's carried copy) calibrated by the JAX
    package at ``config`` on the sweep's images."""
    jqp = jcalibrate(JSPEC, NETS[net](), _images(seed=seed), hw=CONFIGS[config],
                     safe_zero_floor=True)
    return jqp, _carried(jqp)


def _net_of(config):
    return "sparse" if config == "pe2_servable" else "dense"


@pytest.mark.parametrize("config", list(CONFIGS))
def test_interpreter_matches_numpy_spec_and_jax(config):
    jqp, qp = _calibrated(config, _net_of(config))
    assert qp.hw == _hw(jqp.hw) == _hw(CONFIGS[config])
    _same(qp, jqp)
    for img in _images():
        y = integer_forward(SPEC, qp, img, device="cpu")[0].numpy()
        np.testing.assert_array_equal(y, numpy_integer_forward(JSPEC, jqp, img).astype(np.float32))
        jy = jinteger_forward(JSPEC, jqp, jnp.asarray(img), compute="int32")[0]
        np.testing.assert_array_equal(y, np.asarray(jy))
        yc = integer_forward(SPEC, qp, img, corrected=True, device="cpu")[0].numpy()
        jyc = jinteger_forward(JSPEC, jqp, jnp.asarray(img), corrected=True)[0]
        np.testing.assert_array_equal(yc, np.asarray(jyc))


@pytest.mark.parametrize("config", list(CONFIGS))
def test_calibrate_matches_jax(config):
    jqp, _ = _calibrated(config, _net_of(config))
    qp = calibrate(SPEC, _port_params(NETS[_net_of(config)]()), _images(),
                   hw=_hw(CONFIGS[config]), safe_zero_floor=True, device="cpu")
    assert qp.hw == _hw(jqp.hw)
    assert list(qp.a_zero) == list(jqp.a_zero)
    for a, b in zip(qp.w_int, jqp.w_int):
        np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_allclose(qp.a_scale, jqp.a_scale, rtol=1e-6, atol=0)


@pytest.mark.parametrize("net", list(NETS))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_certify_and_select_match_jax(config, net):
    """The same stamps, the same deployment mode, and the mode's output
    (the kernels' plain version) equal to the corrected interpreter."""
    jqp, qp = _calibrated(config, net)
    images = _images(seed=5)
    got = certify_fast(SPEC, qp, images, device="cpu")
    want = jcertify_fast(JSPEC, jqp, images)
    _same(got, want)
    assert (got.cert_grade, got.cert_stamps) == (want.cert_grade, want.cert_stamps)
    mode, fn = deploy.select_forward(got)
    assert mode == select_packed_forward(want)[0]
    for img in images:
        y = fn(SPEC, got, img, device="cpu")
        want_y = integer_forward(SPEC, got, img, corrected=True, device="cpu")[0]
        assert torch.equal(y, want_y), (config, net, mode)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_npz_round_trip_keeps_the_config(config, tmp_path):
    _, qp = _calibrated(config, _net_of(config))
    path = str(tmp_path / "qp.npz")
    qp.save(path)
    back, jback = QuantParams.load(path), JQuantParams.load(path)
    assert back.hw == qp.hw == _hw(jback.hw)
    _same(back, jback)
    img = _images(n=1, seed=9)[0]
    assert torch.equal(integer_forward(SPEC, back, img, device="cpu")[0],
                       integer_forward(SPEC, qp, img, device="cpu")[0])


def test_rounding_tie_pin():
    """ROADMAP queue 3: at PE2_SERVABLE, the sparse net calibrated on
    _images(seed=7), the last conv's output at [0, 18, 22, 2] sits on a
    rounding tie (pe_add 37110, y * 2714 * 2^-19 - 128 = 53.5): the port and
    the numpy spec round it half to even, to 54; the JAX package's fused
    product gives 53.49999237, so 53."""
    jqp, qp = _calibrated("pe2_servable", "sparse", seed=7)
    img = _images(seed=7)[0]
    L = SPEC.num_convs
    at = (0, 18, 22, 2)
    _, dumps = integer_forward(SPEC, qp, img, collect_dumps=True, device="cpu")
    _, jdumps = jinteger_forward(JSPEC, jqp, jnp.asarray(img), collect_dumps=True,
                                 compute="int32")
    assert int(dumps[f"pe_add.{L - 1}"][at]) == int(np.asarray(jdumps[f"pe_add.{L - 1}"])[at]) \
        == 37110
    assert int(dumps[f"input.{L}"][at]) == 54
    assert int(np.asarray(jdumps[f"input.{L}"])[at]) == 53
    y_np = numpy_integer_forward(JSPEC, jqp, img)
    s, z = np.float32(qp.a_scale[L]), np.float32(qp.a_zero[L])
    assert y_np[at] == (np.float32(54) - z) * s
    y = integer_forward(SPEC, qp, img, device="cpu")[0].numpy()
    np.testing.assert_array_equal(y, y_np.astype(np.float32))
    differs = np.argwhere(y != np.asarray(jinteger_forward(JSPEC, jqp, jnp.asarray(img),
                                                           compute="int32")[0]))
    assert [tuple(d) for d in differs] == [at]


@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_kernel_constants_take_the_config(config, width):
    """Every datapath's constants build at every config and width <= 16;
    off 4 PEs K1's and the corrected kernel's are the general
    instantiation's, and K2's where its conv 0 can reach the adder clamp.
    quan_bits above 8, more than 16 PEs and a width above 32 are refused."""
    spec = dataclasses.replace(SPEC, num_channels=width)
    hw = _hw(CONFIGS[config])
    rng = np.random.default_rng(width)
    params = CollapsedParams(
        [rng.standard_normal((k, k, ci, co)).astype(np.float32) * (rng.random((k, k, ci, co))
                                                                   < 0.1)
         for k, ci, co in zip(spec.kernel_sizes,
                              [spec.in_channels] + [width] * (spec.num_convs - 1),
                              [width] * (spec.num_convs - 1) + [spec.conv_out_channels])],
        [np.zeros(width if i < spec.num_convs - 1 else spec.conv_out_channels, np.float32)
         for i in range(spec.num_convs)])
    qp = calibrate(spec, params, _images(n=1), hw=hw, safe_zero_floor=True, device="cpu")
    L = spec.num_convs
    for datapath, split in (("exact", None), ("corrected", convert.corrected_split_layers(qp)),
                            ("corrected", (True,) * L), ("fast", None)):
        kc = convert.kernel_constants(spec, qp, datapath, split)
        assert kc.pe == hw.pe and kc.params.shape == (convert.param_words(hw.pe, L),)
        assert kc.general == (convert.clamp20_layers(qp)[0] if datapath == "fast"
                              else hw.pe != 4)
        assert kc.weights.dtype == np.int32 and kc.weights.size > 0
    for bad in (dataclasses.replace(hw, quan_bits=16), dataclasses.replace(hw, pe=17)):
        with pytest.raises(NotImplementedError, match="quan_bits|PEs"):
            convert.kernel_constants(spec, dataclasses.replace(qp, hw=bad), "exact")
    with pytest.raises(NotImplementedError, match="widths of at most 64"):
        convert.kernel_constants(dataclasses.replace(spec, num_channels=80), qp, "exact")
