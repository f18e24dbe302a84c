"""The rest of the HardwareConfig family on the CPU: 16 PEs (at width 16 a
PE owns one channel), 16 PEs with a 20-bit accumulator and a 24-bit adder
(|pe_add + bias| can pass 2^22, so every kernel takes the wide-sum form),
and 6- and 4-bit activations and weights at 4 PEs. On a 16-channel sweep
net (the JAX package's ``init_params``, seed 0), calibrated by the JAX
package on two seeded 24x32 images and carried across with
``convert.quantparams_from_fields``:

- the port's plain interpreter equals the JAX package's and the sweep's
  independent numpy spec (tests/test_hwconfig_sweep.py), array_equal, in
  reference and corrected mode;
- the port's ``calibrate`` equals the JAX package's (a_zero and w_int
  equal, a_scale within rel 1e-6, but the 4-bit output domain's; see
  ``test_calibrate_matches_jax``), and its ``finalize`` on the JAX
  package's own observations gives the JAX package's scales;
- ``certify_fast`` stamps as the JAX package's does, and
  ``deploy.select_forward`` picks the mode ``select_packed_forward`` picks;
- ``convert.kernel_constants`` builds K1's, K2's and the corrected
  kernel's constants in the general instantiation, with the config's
  parameter block, head word "quant" (the activations' half range) and
  the wide kernels where sums may pass 2^22, and the numpy models of K1's
  per-PE passes and of the
  corrected kernel's column groups hold the plain interpreter's sums on
  the carried artifact; it refuses quan_bits above 8 and more than 16 PEs;
- the corrected kernel's model on the sweep net at scale 4 (48 outputs:
  48 columns a PE group, chunks of whole groups) with its last conv at
  +127, every layer split, at 4, 8 and 16 PEs (B resident, staged a layer
  at a time, and in pieces), each layer's sums and the counting form's
  counts equal to the plain interpreter's;
- a numpy float32 model of the wide form's conversion (the clamped int32
  sum, one round-to-nearest-even cast, one multiply by m 2^-n) equals the
  plain version's requantization at sums past 2^22 and 2^24, where the
  kMagic conversion of the other forms does not hold.

The kernels themselves are held against the plain version at these
configs by chip_smoke.py phases 12 and 14."""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import HardwareConfig as JHardwareConfig
from sesr_tpu.config import SESRSpec as JSESRSpec
from sesr_tpu.models.sesr import init_params as jinit_params
from sesr_tpu.ops.packed import select_packed_forward
from sesr_tpu.quant.calibrate import calibrate as jcalibrate
from sesr_tpu.quant.certify import certify_fast as jcertify_fast
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu_torch import convert, deploy
from sesr_tpu_torch.config import HardwareConfig, SESRSpec
from sesr_tpu_torch.models.sesr import CollapsedParams
from sesr_tpu_torch.ops.fixedpoint import apply_requant_f32, requant_factors
from sesr_tpu_torch.quant.calibrate import calibrate
from sesr_tpu_torch.quant.certify import certify_fast
from sesr_tpu_torch.quant.integer import integer_forward, pe_channel_mask
from sesr_tpu_torch.quant.params import CalibState, finalize
from tests.test_hwconfig_sweep import _images, numpy_integer_forward
from sesr_tpu_torch.ops.kernels import corrected_net
from tests.test_torch_corrected import _kernel_layer_sums, _pieces_of
from tests.test_torch_mma_layout import _model_layer, _pack, _valid_conv
from tests.test_torch_params import _same
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

NET = dict(name="sweep16", in_channels=3, out_channels=3, num_channels=16, num_lblocks=2)
JSPEC, SPEC = JSESRSpec(**NET), SESRSpec(**NET)
CONFIGS = {"pe16": dict(pe=16),
           "pe16_wide": dict(pe=16, pe_acc_bits=20, pe_add_bits=24),
           "q6": dict(quan_bits=6),
           "q4": dict(quan_bits=4)}


def _jparams():
    return jinit_params(JSPEC, jax.random.PRNGKey(0))


def _port_params():
    p = _jparams()
    return CollapsedParams([np.asarray(w) for w in p.weights], [np.asarray(b) for b in p.biases])


@functools.lru_cache(maxsize=None)
def _calibrated(config: str):
    """(JAX QuantParams, the port's carried copy) calibrated by the JAX
    package at ``config`` on two seeded 24x32 images."""
    jqp = jcalibrate(JSPEC, _jparams(), _images(), hw=JHardwareConfig(**CONFIGS[config]),
                     safe_zero_floor=True)
    fields = {f.name: getattr(jqp, f.name) for f in dataclasses.fields(jqp)}
    return jqp, convert.quantparams_from_fields(fields)


@functools.lru_cache(maxsize=None)
def _certified(config: str):
    """(JAX certified, the port's certified), each package on two images."""
    jqp, qp = _calibrated(config)
    images = _images(seed=5)
    return jcertify_fast(JSPEC, jqp, images), certify_fast(SPEC, qp, images, device="cpu")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_interpreter_matches_numpy_spec_and_jax(config):
    jqp, qp = _calibrated(config)
    assert qp.hw == HardwareConfig(**CONFIGS[config])
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
    """The port's calibration against the JAX package's: a_zero and w_int
    equal, and every a_scale within rel 1e-6 but one. The two fake-quant
    forwards' float32 convs sum in different orders (oneDNN here, XLA
    there), so their observations differ in the last ulp or two (domain
    3's max 0.88041764 here, 0.88041776 there, on the second image); at 4
    bits one quantization step is 1/15 of a domain's range, and a value of
    the last conv's input that such an ulp moves across a rounding tie
    moves the output domain's max by 0.9 % (0.9567 here, 0.9483 there), so
    at q4 the output domain's scale is held within rel 1e-2. The port's
    ``finalize`` on the JAX package's own observations gives the JAX
    package's scales within rel 1e-6 at every config."""
    jqp, _ = _calibrated(config)
    hw = HardwareConfig(**CONFIGS[config])
    qp = calibrate(SPEC, _port_params(), _images(), hw=hw, safe_zero_floor=True, device="cpu")
    assert qp.hw == hw
    assert list(qp.a_zero) == list(jqp.a_zero)
    for a, b in zip(qp.w_int, jqp.w_int):
        np.testing.assert_array_equal(a, np.asarray(b))
    L = SPEC.num_convs
    np.testing.assert_allclose(qp.a_scale[:L], jqp.a_scale[:L], rtol=1e-6, atol=0)
    np.testing.assert_allclose(qp.a_scale[L], jqp.a_scale[L],
                               rtol=1e-2 if hw.quan_bits == 4 else 1e-6, atol=0)
    jcal = importlib.import_module("sesr_tpu.quant.calibrate")
    fq, w_int, w_scale = jcal._prep_fq_weights(_jparams(), jqp.hw)
    calib = CalibState.fresh(L + 1)
    for img in _images():
        mm = np.asarray(jcal._calibration_forward_impl(JSPEC, fq, jnp.asarray(img), jqp.hw,
                                                       True)[1], np.float64)
        for d in range(L + 1):
            calib.update(d, mm[0, d], mm[1, d])
    fin = finalize(SPEC, w_int, w_scale, [np.asarray(b) for b in _jparams().biases], calib, hw,
                   safe_zero_floor=True)
    assert list(fin.a_zero) == list(jqp.a_zero)
    np.testing.assert_allclose(fin.a_scale, jqp.a_scale, rtol=1e-6, atol=0)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_certify_and_select_match_jax(config):
    """The same stamps, the same deployment mode, and the mode's output
    (the kernels' plain version) equal to the corrected interpreter."""
    want, got = _certified(config)
    _same(got, want)
    assert (got.cert_grade, got.cert_stamps) == (want.cert_grade, want.cert_stamps)
    mode, fn = deploy.select_forward(got)
    assert mode == select_packed_forward(want)[0]
    for img in _images(seed=7):
        y = fn(SPEC, got, img, device="cpu")
        assert torch.equal(y, integer_forward(SPEC, got, img, corrected=True, device="cpu")[0])


@pytest.mark.parametrize("config", list(CONFIGS))
def test_kernel_constants_take_the_config(config):
    """All three datapaths build in the general instantiation (K2 at 16
    PEs with int8 and narrow sums in its shipped one), with the config's
    PE count in the parameter block, the activations' half range
    2^(quan_bits - 1) in head word "quant", and the wide kernels exactly
    where a pe_add_bits sum plus a bias_bits bias can reach 2^22; the
    corrected kernel's split layers have pe_groups column groups (16 at 16
    PEs)."""
    _, qp = _certified(config)
    hw = qp.hw
    L = SPEC.num_convs
    wide = (1 << (hw.pe_add_bits - 1)) + (1 << (hw.bias_bits - 1)) >= convert.MAGIC_RANGE
    assert wide == (config == "pe16_wide")
    for datapath, split in (("exact", None), ("fast", None),
                            ("corrected", convert.corrected_split_layers(qp)),
                            ("corrected", (True,) * L)):
        kc = convert.kernel_constants(SPEC, dataclasses.replace(qp, fast_cert_ok=True),
                                      datapath, split)
        # K2 is one pass whatever the PE count: general off int8, past 2^22
        # or where its conv 0 can reach the adder clamp
        assert kc.general == (datapath != "fast" or hw.quan_bits != 8 or wide
                              or convert.clamp20_layers(qp)[0])
        assert kc.pe == hw.pe and (kc.clamp20 == (True,) * L or not kc.general)
        assert kc.params.shape == (convert.param_words(hw.pe, L, 16),)
        assert kc.param("quant") == 1 << (hw.quan_bits - 1) and kc.wide == wide
        if datapath == "corrected" and split[1]:
            assert convert.wgmma_geometry(3, 16, 16, True, False, hw.pe)[1:] == \
                (convert.pe_groups(hw.pe), 16 * convert.pe_groups(hw.pe))
    assert convert.pe_groups(hw.pe) == (16 if hw.pe == 16 else 4)


@pytest.mark.parametrize("bad", [dict(quan_bits=9), dict(quan_bits=16), dict(quan_bits=1),
                                 dict(pe=17)])
def test_kernel_constants_refuse_past_the_family(bad):
    """quan_bits above 8 (the kernels' operands are int8) or below 2, and
    more than 16 PEs, are refused, each naming its limit."""
    _, qp = _calibrated("pe16")
    hw = dataclasses.replace(qp.hw, **bad)
    with pytest.raises(NotImplementedError, match="quan_bits" if "quan_bits" in bad else "PEs"):
        convert.kernel_constants(SPEC, dataclasses.replace(qp, hw=hw), "exact")


@pytest.mark.parametrize("config", list(CONFIGS))
def test_kernel_models_hold_the_plain_sums(config):
    """On the carried artifact, per layer: K1's split passes (at 16 PEs each
    over its PE's word p % 4) through the mma.sync model give each PE's
    partial conv on its channels, and the corrected kernel's model (16
    column groups at 16 PEs, 256 columns in two chunks) gives the plain
    interpreter's bias + pe_add with every layer split and with the
    PE-exact mask."""
    _, qp = _certified(config)
    L = SPEC.num_convs
    x = np.random.default_rng(31).random((1, 6, 11, 3), dtype=np.float32)
    rng = np.random.default_rng(32)
    eh, ew = 5, 11
    for i, w in enumerate(qp.w_int):
        w = np.asarray(w)
        k, _, ic, oc = w.shape
        q = rng.integers(qp.hw.quan_min, qp.hw.quan_max + 1,
                         size=(eh + k - 1, ew + k - 1, ic)).astype(np.int8)
        words, ps = _pack(q)
        frag = convert._fragment_words(w, True, qp.hw.pe, last=i == L - 1)
        got, _ = _model_layer(words, ps, frag, k, ic, oc, True, i == L - 1, eh, ew, qp.hw.pe)
        want = [_valid_conv(q[..., m], w[:, :, m, :])
                for m in (pe_channel_mask(ic, qp.hw.pe, p) for p in range(qp.hw.pe)) if m.any()]
        np.testing.assert_array_equal(got.reshape(-1, eh, ew, oc), np.stack(want),
                                      err_msg=f"{config} K1 layer {i}")
    for split in (convert.corrected_split_layers(qp), (True,) * L):
        kc = convert.kernel_constants(SPEC, qp, "corrected", split)
        _, dumps = integer_forward(SPEC, qp, x, collect_dumps=True, corrected=True,
                                   fast_layers=tuple(not f for f in split), device="cpu")
        hi16 = (1 << (qp.hw.bias_bits - 1)) - 1
        for i, k in enumerate(SPEC.kernel_sizes):
            x_q = dumps[f"input.{i}"][0].numpy().astype(np.int64)
            got = _kernel_layer_sums(qp, kc, i, k, x_q, qp.effective_zero(i), i == L - 1, rng)
            want = dumps[f"pe_add.{i}"][0].numpy().astype(np.int64) + np.clip(
                np.asarray(qp.bias_int[i], np.int64), -hi16 - 1, hi16)
            np.testing.assert_array_equal(got, want, err_msg=f"{config} {split} layer {i}")


NET48 = dict(NET, name="sweep16_x4", scaling_factor=4)


@functools.lru_cache(maxsize=None)
def _calibrated48(pe: int):
    """The sweep net at scale 4 (48 outputs) calibrated by the JAX package
    at ``pe`` PEs, carried across, its last conv at +127."""
    jspec = JSESRSpec(**NET48)
    jqp = jcalibrate(jspec, jinit_params(jspec, jax.random.PRNGKey(0)), _images(),
                     hw=JHardwareConfig(pe=pe), safe_zero_floor=True)
    qp = convert.quantparams_from_fields({f.name: getattr(jqp, f.name)
                                          for f in dataclasses.fields(jqp)})
    L = jspec.num_convs
    return SESRSpec(**NET48), dataclasses.replace(qp, w_int=[
        np.full_like(np.asarray(w), 127) if i == L - 1 else np.asarray(w)
        for i, w in enumerate(qp.w_int)])


@pytest.mark.parametrize("pe", [4, 8, 16])
def test_corrected_model_at_48_outputs(pe):
    """A last conv of 48 channels split per PE: 48 columns a group, its
    4, 8 or 16 groups in chunks of two (96 columns, a wgmma N), B resident
    at 4 PEs, staged a layer at a time at 8 and in pieces at 16 (the plan at
    the wrapper's tile); every layer split. The model's sums equal the plain
    interpreter's bias + pe_add on every layer, and its counting rule the
    plain overflow_18 (the +127 last conv fires the 18-bit clamp)."""
    spec, qp = _calibrated48(pe)
    L = spec.num_convs
    split = (True,) * L
    kc = convert.kernel_constants(spec, qp, "corrected", split)
    assert kc.general and kc.out_channels == 48 and kc.param("out", L - 1) == 48
    assert convert.wgmma_geometry(5, 16, 48, True, True, pe)[1:] == (
        convert.pe_groups(pe), 48 * convert.pe_groups(pe))
    tile = corrected_net.tile(spec, split, pe, True)
    plan, pieces = _pieces_of(spec, kc, tile)
    assert (plan.regions, plan.pieces) == {4: (0, False), 8: (1, False), 16: (1, True)}[pe]
    assert pieces[L - 1] == (pe == 16)
    x = np.random.default_rng(41).random((1, 6, 11, 3), dtype=np.float32)
    _, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True, device="cpu")
    rng = np.random.default_rng(42)
    ovf18 = dumps["overflow_18"].tolist()
    for i, k in enumerate(spec.kernel_sizes):
        x_q = dumps[f"input.{i}"][0].numpy().astype(np.int64)
        events = np.zeros(x_q.shape[:2], np.int64)
        got = _kernel_layer_sums(qp, kc, i, k, x_q, qp.effective_zero(i), i == L - 1, rng,
                                 events, pieces=pieces[i])
        want = dumps[f"pe_add.{i}"][0].numpy().astype(np.int64) + np.clip(
            np.asarray(qp.bias_int[i], np.int64), -32768, 32767)
        np.testing.assert_array_equal(got, want, err_msg=f"{pe} PEs layer {i}")
        assert events.sum() == ovf18[i], (pe, i)
    assert ovf18[L - 1] > 0


def _magic_form(y, m, n):
    """The kMagic form (sesr_common.cuh): the int32 bits kMagicBits + y read
    as a float32, then one FMA fl(a s - kMagic s), s = f32(m) f32(2^-n)."""
    s = np.float32(np.float32(m) * np.float32(2.0 ** -n))
    a = (np.int32(0x4B400000) + np.int32(y)).view(np.float32)
    return np.float32(np.float64(a) * np.float64(s) - np.float64(np.float32(12582912.0) * s))


def _wide_form(y, m, n, bias, add_hi):
    """The wide form: the sum y_int = pe_add + bias clamped to [bias -
    add_hi - 1, bias + add_hi] as an int32, converted once (round to
    nearest, ties to even, as __int2float_rn), times f32(m) f32(2^-n)."""
    yi = np.int32(np.clip(np.int64(y), bias - add_hi - 1, bias + add_hi))
    m_f, p_f = requant_factors(m, n)
    return np.float32(np.float32(yi) * np.float32(np.float32(m_f) * np.float32(p_f)))


@pytest.mark.parametrize("y", [(1 << 22) + 1, -(1 << 22) - 1, (1 << 23) + 3, -(1 << 23) - 3,
                               (1 << 24) + 1, (1 << 24) + 3, -(1 << 24) - 3, (1 << 25) + 6,
                               (1 << 23) + (1 << 15) - 1])
def test_wide_sum_conversion_models_the_plain_cast(y):
    """At sums past 2^22, and past 2^24 where the int32 -> float32 cast
    itself rounds (2^24 + 1 to 2^24, 2^24 + 3 to 2^24 + 4, ties to even),
    the wide form gives the plain version's (y * m) * 2^-n bit for bit,
    for the shipped 16-bit mantissas and a 12-bit one; the kMagic form
    past 2^22 does not (its bits are not kMagic + y there)."""
    add_hi = (1 << 30) - 1                  # a sum the adder clamp leaves as it is
    for m, n in ((40503, 24), (65535, 32), (2714, 19), (4095, 12)):
        want = apply_requant_f32(torch.tensor([y], dtype=torch.int32), m, n).numpy()[0]
        got = _wide_form(y, m, n, 0, add_hi)
        assert got.view(np.int32) == want.view(np.int32), (y, m, n, got, want)
        if abs(y) > 1 << 24:
            assert int(np.float32(np.int32(y))) != y     # the cast rounded
    assert _magic_form((1 << 22) - 1, 40503, 24) == apply_requant_f32(
        torch.tensor([(1 << 22) - 1], dtype=torch.int32), 40503, 24).numpy()[0]
    if abs(y) >= 1 << 23:
        assert _magic_form(y, 40503, 24) != apply_requant_f32(
            torch.tensor([y], dtype=torch.int32), 40503, 24).numpy()[0]
    # the adder clamp in the wide form: a 24-bit adder and a 16-bit bias
    add24 = (1 << 23) - 1
    for bias in (-32768, 0, 32767):
        want = apply_requant_f32(torch.tensor([int(np.clip(y, -add24 - 1, add24)) + bias],
                                              dtype=torch.int32), 40503, 24).numpy()[0]
        assert _wide_form(np.int64(np.clip(y, -add24 - 1, add24)) + bias, 40503, 24, bias,
                          add24) == want
