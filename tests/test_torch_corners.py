"""Two network shapes the fused kernels' layer-group form takes, on the CPU.

- A network of two convs (``num_lblocks`` 0, 5x5 then 5x5; depth is the
  SESR family's own knob): a 16-channel, 3-in SESR at x2 and x4 RGB, the
  JAX package's ``init_params`` from ``PRNGKey(0)``, calibrated by the JAX
  package (``safe_zero_floor``) on two numpy ``default_rng(0)`` 24x32
  images and certified by it on them, carried across with
  ``convert.quantparams_from_fields``. Its first conv is also the one
  before the last: the last conv's domain-in adds the shortcut (conv 0's
  ReLU output) to that same output. The port's plain interpreter is held
  to the JAX package's, every dump, in the corrected and fast modes and in
  each ``graph_add`` wiring; its reference mode to the numpy spec
  ``numpy_integer_forward`` everywhere and to the JAX package's wherever
  the two agree, with the one rounding tie at x2 named (ROADMAP queue 3).
  ``kernel_constants`` takes it on every datapath at 4 PEs, pe16 and a
  sweep config as one layer group, GROUP_FIRST | GROUP_LAST, whose plan
  fits a block, and ``group_forward`` of that group is the whole
  interpreter.
- A last conv past 16 output channels past 16 convs: the 48-output
  artifact of ``tests/test_torch_out_channels.py`` deepened to 18 convs
  (``tests/test_torch_deep.py`` ``deepened``). The corrected kernel plans
  it in groups (its last group in the tail instantiations of
  csrc/sesr_corrected_group.cu), each fitting a block, and the chain of
  those groups is the whole corrected interpreter.
- chip_smoke.py's networks of both corners: phase 17's (their MACs a pixel
  and bounds at 1,979 int8 TOP/s, and their groups in every kernel at
  each config it runs) and the two-conv networks of phase 16's sweep.

The kernels themselves run on the card only (chip_smoke.py phases 16 and
17)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import SESRSpec as JSESRSpec
from sesr_tpu.models.sesr import init_params as jinit_params
from sesr_tpu.quant.calibrate import calibrate as jcalibrate
from sesr_tpu.quant.certify import certify_fast as jcertify_fast
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu_torch import convert, costs
from sesr_tpu_torch.config import HardwareConfig, SESRSpec
from sesr_tpu_torch.ops.corrected import split_layers
from sesr_tpu_torch.ops.kernels import (NET_KERNELS, SMEM_LIMIT, corrected_group_plan,
                                        corrected_net, tail_group)
from sesr_tpu_torch.quant.integer import group_chain, group_forward, integer_forward
from tests.test_hwconfig_sweep import ALT_CONFIGS, numpy_integer_forward
from tests.test_torch_deep import _calibrated, _chip_smoke, _modes, deepened
from tests.test_torch_out_channels import _calibrated as _calibrated_out
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

H, W = 24, 32
SCALES = (2, 4)
# the configs the plans are checked at: the shipped 4 PEs, 16 PEs and the
# JAX sweep's 3-PE config (18/20-bit, PEs of unequal channel counts)
CONFIGS = {"pe4": HardwareConfig(), "pe16": HardwareConfig(pe=16),
           "pe3_nondivisible": HardwareConfig(**dataclasses.asdict(ALT_CONFIGS[2]))}
# the JAX package's wirings the plain interpreter is held to it in
MODES = {"corrected": dict(corrected=True),
         "fast": dict(corrected=True, compute="fast"),
         "graph_add": dict(residual_mode="graph_add"),
         "graph_add corrected": dict(residual_mode="graph_add", corrected=True),
         "graph_add_qat": dict(residual_mode="graph_add_qat", qat_add_bounds=(0.0, 4.0)),
         "graph_add_qat corrected": dict(residual_mode="graph_add_qat",
                                         qat_add_bounds=(0.0, 4.0), corrected=True)}
# the rounding tie of the x2 network's reference mode: (port function, the
# dump where the values differ, its index, JAX's value, the port's and the
# numpy spec's value); every earlier dump is equal, requant.1 (the last
# conv's dequantized output) is the first stage that differs
TIE = ("sesr_tpu_torch.quant.integer.integer_forward (corrected=False)", "input.2",
       (0, 16, 29, 4), -55, -56)


def _kw(scale):
    return dict(name=f"sesr_m0_x{scale}_rgb", in_channels=3, out_channels=3, num_channels=16,
                num_lblocks=0, scaling_factor=scale)


def _images():
    rng = np.random.default_rng(0)
    return [rng.random((1, H, W, 3), dtype=np.float32) for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _two_conv(scale):
    """(port spec, JAX spec, port QuantParams, JAX QuantParams) of the
    two-conv network at ``scale``, calibrated and certified by the JAX
    package."""
    jspec = JSESRSpec(**_kw(scale))
    jqp = jcalibrate(jspec, jinit_params(jspec, jax.random.PRNGKey(0)), _images(),
                     safe_zero_floor=True)
    jqp = jcertify_fast(jspec, jqp, _images())
    qp = convert.quantparams_from_fields({f.name: getattr(jqp, f.name)
                                          for f in dataclasses.fields(jqp)})
    return SESRSpec(**_kw(scale)), jspec, qp, jqp


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("scale", SCALES)
def test_two_conv_network_matches_jax(scale, mode, one_torch_thread):
    """The two-conv network, certified by the JAX package, has the port's
    plain interpreter's output and every dump array_equal with the JAX
    package's in the corrected and fast modes and in each graph_add wiring
    (reference and corrected datapaths)."""
    spec, jspec, qp, jqp = _two_conv(scale)
    assert qp.fast_cert_ok and spec.num_convs == 2
    x = _images()[0]
    y_j, d_j = jinteger_forward(jspec, jqp, jnp.asarray(x), collect_dumps=True, **MODES[mode])
    y_t, d_t = integer_forward(spec, qp, x, collect_dumps=True, device="cpu", **MODES[mode])
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert sorted(d_t) == sorted(d_j)
    for k in d_j:
        np.testing.assert_array_equal(d_t[k].numpy(), np.asarray(d_j[k]), err_msg=k)


@pytest.mark.parametrize("scale", SCALES)
def test_two_conv_reference_mode_and_its_rounding_tie(scale, one_torch_thread):
    """Reference mode: the port's output equals the numpy spec's at every
    value, and the JAX package's wherever the JAX package and the spec
    agree. They disagree at one value of x2's 9,216 (none at x4), the
    recorded tie (TIE, ROADMAP queue 3): the last conv's domain-in input.2
    at (0, 16, 29, 4) is -55 in JAX and -56 in the port and the spec; the
    dumps before requant.1 (the last conv's dequantized output) are equal.
    The port follows the reference's two float32 multiplies; JAX's jitted
    forward leaves y * m * 2^-n unrounded (ROADMAP's ground rules)."""
    spec, jspec, qp, jqp = _two_conv(scale)
    L = spec.num_convs
    x = _images()[0]
    _, d_t = integer_forward(spec, qp, x, collect_dumps=True, device="cpu")
    _, d_j = jinteger_forward(jspec, jqp, jnp.asarray(x), collect_dumps=True)
    spec_np = numpy_integer_forward(jspec, jqp, x)            # before the shuffle
    s, z = np.float32(qp.a_scale[L]), np.float32(qp.a_zero[L])
    port_out = d_t[f"input.{L}"].numpy()
    np.testing.assert_array_equal((port_out - z) * s, spec_np.astype(np.float32))
    jax_out = np.asarray(d_j[f"input.{L}"])
    agree = (jax_out - z) * s == spec_np.astype(np.float32)
    np.testing.assert_array_equal(port_out[agree], jax_out[agree])
    differs = [tuple(int(v) for v in i) for i in np.argwhere(port_out != jax_out)]
    order = [f"{stage}.{i}" for i in range(L) for stage in ("input", "pe_out", "pe_add",
                                                             "requant")]
    order.insert(4, "shortcut")
    first = next((k for k in order
                  if not np.array_equal(d_t[k].numpy(), np.asarray(d_j[k]))), None)
    if scale == 4:
        assert differs == [] and first is None
        return
    fn, key, at, jax_value, port_value = TIE
    assert key == f"input.{L}" and first == f"requant.{L - 1}" and differs == [at]
    assert port_out.size == 9216
    assert (int(jax_out[at]), int(port_out[at])) == (jax_value, port_value)
    assert spec_np[at] == (np.float32(port_value) - z) * s          # the spec's value: -56
    assert fn.endswith("(corrected=False)")


def _split_masks(qp, datapath):
    L = qp.num_convs
    if datapath != "corrected":
        return (None,)
    return (split_layers(qp, "pe-exact"), split_layers(qp, "hybrid"), (True,) * L)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("scale", SCALES)
def test_two_conv_plans_one_group(scale, config, one_torch_thread):
    """On every datapath (the corrected kernel with the PE-exact mode's,
    the hybrid mode's and an all-split mask) the two-conv network is one
    layer group, convs 0-1, GROUP_FIRST | GROUP_LAST, in the general
    instantiation, whose plan fits a block (the corrected kernel's in its
    tail instantiations); ``group_forward`` of that group from input.0 is
    the whole interpreter's output and overflow_18."""
    spec, _, qp, _ = _two_conv(scale)
    qp = dataclasses.replace(qp, hw=CONFIGS[config])
    x = _images()[1]
    for kern in NET_KERNELS:
        for split in _split_masks(qp, kern.datapath):
            kc = convert.kernel_constants(spec, qp, kern.datapath, split)
            (g,) = kc.groups
            assert (g.first, g.last, g.flags) == (0, 1, convert.GROUP_FIRST | convert.GROUP_LAST)
            assert kc.general
            (_, tile, need), = kern.launch_plans(spec, kc)
            assert need <= SMEM_LIMIT, (kern.symbol, tile)
            if kern is corrected_net:
                assert tail_group(2, g.flags, spec.conv_out_channels)
                assert corrected_group_plan(2, g.flags, 3, spec.conv_out_channels, tile,
                                            kc.pe_split, kc.pe, kc.width).bytes == need
            corrected = kern.datapath != "exact"
            dense = (True,) * 2 if kern.datapath == "fast" else (
                None if split is None else tuple(not f for f in split))
            fqp = dataclasses.replace(qp, fast_cert_ok=True)
            kw = dict(corrected=corrected, compute="fast") if kern.datapath == "fast" else \
                dict(corrected=corrected, fast_layers=dense if corrected else None)
            _, d = integer_forward(spec, fqp, x, collect_dumps=True, device="cpu", **kw)
            got, _, counts = group_forward(spec, fqp, d["input.0"], None, 0, 1, corrected, dense)
            assert torch.equal(got, d["input.2"]) and torch.equal(counts, d["overflow_18"])


@functools.lru_cache(maxsize=None)
def _deep48():
    """The 48-output artifact of tests/test_torch_out_channels.py (SESR-M5's
    widths, RGB x4) deepened to 18 convs, and its spec."""
    spec, _, _, qp = _calibrated_out(48)
    return dataclasses.replace(spec, num_lblocks=16), deepened(qp, 18)


@pytest.mark.parametrize("config", ["pe4", "pe8", "pe16"])
def test_corrected_groups_take_48_outputs_past_16_convs(config, one_torch_thread):
    """The corrected kernel takes the 18-conv, 48-output network, refused
    before: in groups, the last one in the tail instantiations, each
    group's plan fitting a block, with the PE-exact mode's mask, an
    all-split one and none split; the chain of the rule's groups equals the
    whole corrected interpreter, every crossing value and overflow_18."""
    spec, qp = _deep48()
    pe = {"pe4": 4, "pe8": 8, "pe16": 16}[config]
    qp = dataclasses.replace(qp, hw=HardwareConfig(pe=pe))
    L = spec.num_convs
    assert L == 18 and spec.conv_out_channels == 48
    for split in (split_layers(qp, "pe-exact"), (True,) * L, (False,) * L):
        kc = convert.kernel_constants(spec, qp, "corrected", split)
        assert len(kc.groups) >= 2 and kc.general
        for g, tile, need in corrected_net.launch_plans(spec, kc):
            plan = corrected_group_plan(g.convs, g.flags, 3, 48, tile, kc.pe_split[g.first:
                                                                              g.last + 1],
                                        pe, kc.width)
            assert plan.bytes == need <= SMEM_LIMIT
            assert tail_group(g.convs, g.flags, 48) == (g.last == L - 1)
    x = _images()[1]
    y, d = integer_forward(spec, qp, x, collect_dumps=True, corrected=True, device="cpu")
    groups = [(g.first, g.last) for g in kc.groups]
    got, seen = group_chain(spec, qp, x, groups, corrected=True, device="cpu")
    assert torch.equal(got, y)
    for first, _ in groups:
        assert torch.equal(seen[f"input.{first}"], d[f"input.{first}"])
    assert torch.equal(seen["overflow_18"], d["overflow_18"])


# chip_smoke.py phase 17's networks, with each one's MACs a pixel
# (costs.conv_macs), input frame (its output 1080x1920) and bound a frame
# in us at 1,979 int8 TOP/s
PHASE17 = {"m16_x4": (dict(name="sesr_m16_x4_rgb", in_channels=3, out_channels=3,
                           num_channels=16, num_lblocks=16, scaling_factor=4),
                      57264, (270, 480), 7.50),
           "xl22_x3": (dict(name="sesr_xl22_x3_rgb", in_channels=3, out_channels=3,
                            num_channels=32, num_lblocks=22, scaling_factor=3),
                       226752, (360, 640), 52.80),
           "m0_x2": (dict(name="sesr_m0_x2", in_channels=3, out_channels=3, num_channels=16,
                          num_lblocks=0, scaling_factor=2), 6000, (540, 960), 3.14),
           "xl0_x4": (dict(name="sesr_xl0_x4_rgb", in_channels=3, out_channels=3,
                           num_channels=32, num_lblocks=0, scaling_factor=4),
                      40800, (270, 480), 5.34)}


@pytest.mark.parametrize("net", sorted(PHASE17))
def test_the_phase17_networks_run_in_groups_that_fit(net, monkeypatch, one_torch_thread):
    """chip_smoke.py phase 17's networks: their MACs a pixel, input frame
    and bound; at 4 PEs, pe16 and their sweep config, in every kernel (the
    corrected kernel in the PE-exact mode and with every conv split): two
    groups or more past 16 convs, one for two convs, each fitting a block
    at its tile, the corrected kernel's last group past 16 outputs (and the
    two-conv group) in its tail instantiations."""
    monkeypatch.setattr(convert, "_fragment_words", lambda *a, **k: np.zeros(8, np.int32))
    monkeypatch.setattr(convert, "_wgmma_b_words", lambda *a, **k: np.zeros(8, np.int32))
    cs = _chip_smoke()
    kw, macs, frame, bound_us = PHASE17[net]
    assert cs.CORNER_NETS[net] == kw
    spec, qp = _calibrated(tuple(sorted(kw.items())))
    assert costs.conv_macs(spec) == macs and cs.out_frame(spec) == frame
    ms, by = cs.bound(2 * macs * frame[0] * frame[1], 0, cs.INT8_OPS_PER_S)
    assert by == "operations" and round(ms * 1e3, 2) == bound_us
    for cname in ("pe4", "pe16", cs.CORNER_CONFIG[net]):
        cqp = dataclasses.replace(qp, hw=HardwareConfig(**cs.HW_CONFIGS.get(cname, {})))
        for kern in NET_KERNELS:
            for split in _modes(kern, cqp):
                kc = convert.kernel_constants(spec, cqp, kern.datapath, split)
                assert len(kc.groups) == 1 if spec.num_convs == 2 else len(kc.groups) >= 2
                for g, tile, need in kern.launch_plans(spec, kc):
                    assert need <= SMEM_LIMIT, (net, cname, kern.symbol, g)
                    if kern is corrected_net:
                        assert tail_group(g.convs, g.flags, spec.conv_out_channels) == (
                            g.last == spec.num_convs - 1 and (
                                spec.conv_out_channels > 16 or spec.num_convs == 2))


@pytest.mark.parametrize("width", [16, 32])
def test_the_sweep_two_conv_networks_run_one_group(width, monkeypatch, one_torch_thread):
    """chip_smoke.py phase 16's sweep of two-conv networks (PAIR_NETS: each
    padded count of the last conv at widths 16 and 32) at each sweep config,
    in each kernel and mode the sweep runs: one group, GROUP_FIRST |
    GROUP_LAST, fitting a block at its tile."""
    monkeypatch.setattr(convert, "_fragment_words", lambda *a, **k: np.zeros(8, np.int32))
    monkeypatch.setattr(convert, "_wgmma_b_words", lambda *a, **k: np.zeros(8, np.int32))
    cs = _chip_smoke()
    nets = [kw for kw in cs.PAIR_NETS.values() if kw["num_channels"] == width]
    assert sorted(convert.out_columns(3 * kw["scaling_factor"] ** 2) for kw in nets) == \
        [8, 16, 32, 48]
    for kw in nets:
        spec, qp = _calibrated(tuple(sorted(kw.items())))
        for cname, hw in cs.SWEEP_HW.items():
            cqp = dataclasses.replace(qp, hw=HardwareConfig(**hw), fast_cert_layers=None,
                                      fast_cert_ok=False)
            for mode in (["sim", "k2"] if cqp.hw.pe == 4 else ["sim"]) + ["pe-exact", "audit"]:
                kern, _, kc = cs.mode_constants(mode, spec, cqp)
                (g, _, need), = kern.launch_plans(spec, kc)
                assert g.flags == convert.GROUP_FIRST | convert.GROUP_LAST and need <= SMEM_LIMIT
