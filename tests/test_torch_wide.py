"""Networks of hidden width 33 to 64, on the CPU: they run at width 64
(``convert.kernel_width``; a narrower one padded with zero channels) in the
width-64 instantiations of the forms of other conv sizes
(csrc/sesr_net_w64.cu, csrc/sesr_corrected_w64.cu and its counting form's
csrc/sesr_corrected_w64_audit.cu), whatever their conv sizes.

- The networks: 3-in SESRs of four convs, at width 64 (5x5 / 3x3 / 5x5,
  x2) and width 48 (3x3 / 5x5 / 3x3, RGB x4: 48 outputs), the JAX
  package's ``init_params`` from ``PRNGKey(0)``, calibrated by the JAX
  package (``safe_zero_floor``) on two numpy ``default_rng(0)`` 24x32
  images, carried across with ``convert.quantparams_from_fields``.
- The port's plain interpreter against the JAX package's, every dump
  array_equal, in the corrected and fast modes; in reference mode against
  the numpy spec ``numpy_integer_forward`` everywhere and against the JAX
  package's wherever the two agree.
- The weights: the JAX package's float ``init_params`` at width 64 carried
  across (``io/torch_import.py save_collapsed_npz``) give the port's float
  forward the JAX package's (float32, within 1e-5).
- The plans: chip_smoke.py phase 19's networks at full depth (their MACs a
  pixel and bounds) and these two, at 4 PEs, pe16 and the sweep config, in
  every kernel: width 64, in groups that fit a block, routed to the
  width-64 libraries; a faked library records each group's launch.
- Widths past 64 are refused, naming the limit.

The kernels themselves run on the card only (chip_smoke.py phase 19)."""

import dataclasses
import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.config import SESRSpec as JSESRSpec
from sesr_tpu.models.sesr import forward_float as jforward_float
from sesr_tpu.models.sesr import init_params as jinit_params
from sesr_tpu.quant.calibrate import calibrate as jcalibrate
from sesr_tpu.quant.integer import integer_forward as jinteger_forward
from sesr_tpu_torch import convert, costs
from sesr_tpu_torch.config import HardwareConfig, SESRSpec
from sesr_tpu_torch.io.torch_import import save_collapsed_npz
from sesr_tpu_torch.models.sesr import CollapsedParams, forward_float
from sesr_tpu_torch.ops import _build, kernels
from sesr_tpu_torch.ops.kernels import NET_KERNELS, SMEM_LIMIT, corrected_net
from sesr_tpu_torch.quant.integer import integer_forward
from tests.test_hwconfig_sweep import numpy_integer_forward
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

H, W = 24, 32
# width, (k_first, k_block, k_last), scale (x4: 48 outputs)
NETS = {"w64": (64, (5, 3, 5), 2), "w48_x4": (48, (3, 5, 3), 4)}
MODES = {"corrected": dict(corrected=True), "fast": dict(corrected=True, compute="fast")}
CONFIGS = {"pe4": {}, "pe16": dict(pe=16), "pe3": dict(pe=3)}
# chip_smoke.py phase 19's networks: MACs a pixel (costs.conv_macs, at the
# network's own width), input frame (its output 1080x1920) and bound a
# frame in us at 1,979 int8 TOP/s
PHASE19 = {"m5_w64": (208320, (540, 960), 109.14), "xl_w48": (246096, (540, 960), 128.93),
           "m5_w64_x4": (265920, (270, 480), 34.83), "m0_w64": (24000, (540, 960), 12.57)}


def _kw(net):
    width, (kf, kb, kl), scale = NETS[net]
    return dict(name=f"sesr_{net}", in_channels=3, out_channels=3, num_channels=width,
                num_lblocks=2, scaling_factor=scale, k_first=kf, k_block=kb, k_last=kl)


def _images():
    rng = np.random.default_rng(0)
    return [rng.random((1, H, W, 3), dtype=np.float32) for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _network(net):
    """(port spec, JAX spec, port QuantParams, JAX QuantParams) of ``net``,
    calibrated by the JAX package."""
    jspec = JSESRSpec(**_kw(net))
    jqp = jcalibrate(jspec, jinit_params(jspec, jax.random.PRNGKey(0)), _images(),
                     safe_zero_floor=True)
    qp = convert.quantparams_from_fields({f.name: getattr(jqp, f.name)
                                          for f in dataclasses.fields(jqp)})
    return SESRSpec(**_kw(net)), jspec, qp, jqp


def _chip_smoke():
    from tests.test_torch_deep import _chip_smoke as load

    return load()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("net", list(NETS))
def test_plain_interpreter_matches_jax(net, mode, one_torch_thread):
    """The port's plain interpreter's output and every dump array_equal with
    the JAX package's, corrected and fast datapaths."""
    spec, jspec, qp, jqp = _network(net)
    qp, jqp = dataclasses.replace(qp, fast_cert_ok=True), dataclasses.replace(jqp, fast_cert_ok=True)
    x = _images()[1]
    y_j, d_j = jinteger_forward(jspec, jqp, jnp.asarray(x), collect_dumps=True, **MODES[mode])
    y_t, d_t = integer_forward(spec, qp, x, collect_dumps=True, device="cpu", **MODES[mode])
    np.testing.assert_array_equal(y_t.numpy(), np.asarray(y_j))
    assert sorted(d_t) == sorted(d_j)
    for k in d_j:
        np.testing.assert_array_equal(d_t[k].numpy(), np.asarray(d_j[k]), err_msg=k)


@pytest.mark.parametrize("net", list(NETS))
def test_reference_mode_against_the_numpy_spec(net, one_torch_thread):
    """Reference mode: the port's output equals the numpy spec's at every
    value, and the JAX package's wherever the spec and the JAX package
    agree (they agree everywhere on these networks: no rounding tie)."""
    spec, jspec, qp, jqp = _network(net)
    L = spec.num_convs
    x = _images()[0]
    _, d_t = integer_forward(spec, qp, x, collect_dumps=True, device="cpu")
    _, d_j = jinteger_forward(jspec, jqp, jnp.asarray(x), collect_dumps=True)
    s, z = np.float32(qp.a_scale[L]), np.float32(qp.a_zero[L])
    port_out = d_t[f"input.{L}"].numpy()
    np.testing.assert_array_equal((port_out - z) * s,
                                  numpy_integer_forward(jspec, jqp, x).astype(np.float32))
    np.testing.assert_array_equal(port_out, np.asarray(d_j[f"input.{L}"]))


def test_jax_float_weights_carry_across_at_width_64(one_torch_thread):
    """The JAX package's float init_params at width 64, written as a
    collapsed checkpoint (save_collapsed_npz) and read back, are the same
    arrays, and give the port's float forward the JAX package's output
    within 1e-5 (float32 convs in two frameworks)."""
    spec, jspec, _, _ = _network("w64")
    jparams = jinit_params(jspec, jax.random.PRNGKey(3))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "w64.npz")
        save_collapsed_npz(path, jparams)
        with np.load(path) as ck:
            params = CollapsedParams([ck[f"w_{i}"] for i in range(spec.num_convs)],
                                     [ck[f"b_{i}"] for i in range(spec.num_convs)])
    assert [w.shape[2:] for w in params.weights] == [(3, 64), (64, 64), (64, 64), (64, 12)]
    for w, jw in zip(params.weights, jparams.weights):
        np.testing.assert_array_equal(w, np.asarray(jw))
    x = _images()[0]
    want = np.asarray(jforward_float(jspec, jparams, jnp.asarray(x)))
    got = forward_float(spec, params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _masks(kern, spec, qp):
    from sesr_tpu_torch.ops.corrected import split_layers

    if kern is not corrected_net:
        return (None,)
    return (split_layers(qp, "pe-exact"), (True,) * spec.num_convs)


@pytest.mark.parametrize("net", list(NETS) + sorted(PHASE19))
def test_width_64_plans_in_groups_that_fit(net, monkeypatch, one_torch_thread):
    """Each network (chip_smoke.py phase 19's at full depth, calibrated by
    the port; these two) at 4 PEs, pe16 and its sweep config, in every
    kernel (the corrected kernel with the PE-exact mode's mask and an
    all-split one): width 64 in the forms of other conv sizes, in groups
    whose plans fit a block, their first and last convs the network's,
    routed to the width-64 libraries; phase 19's MACs a pixel and bounds."""
    from tests.test_torch_deep import _calibrated

    monkeypatch.setattr(convert, "_fragment_words", lambda *a, **k: np.zeros(8, np.int32))
    monkeypatch.setattr(convert, "_wgmma_b_words", lambda *a, **k: np.zeros(8, np.int32))
    cs = _chip_smoke()
    if net in NETS:
        spec, _, qp, _ = _network(net)
        configs = ("pe4", "pe16", "pe3_nondivisible")
    else:
        spec, qp = _calibrated(tuple(sorted(cs.W64_NETS[net].items())))
        macs, frame, bound_us = PHASE19[net]
        assert costs.conv_macs(spec) == macs and cs.out_frame(spec) == frame
        ms, by = cs.bound(2 * macs * frame[0] * frame[1], 0, cs.INT8_OPS_PER_S)
        assert by == "operations" and round(ms * 1e3, 2) == bound_us
        configs = ("pe4", "pe16", cs.W64_CONFIG[net])
    for cname in configs:
        cqp = dataclasses.replace(qp, hw=HardwareConfig(**cs.HW_CONFIGS.get(cname, {})))
        for kern in NET_KERNELS:
            for split in _masks(kern, spec, cqp):
                kc = convert.kernel_constants(spec, cqp, kern.datapath, split)
                assert kc.width == 64 and kc.ksize_form and kc.general
                assert kc.groups[0].first == 0 and kc.groups[-1].last == spec.num_convs - 1
                assert kernels.chain_form(kc) == "w64"
                for audit in (False, True) if kern is corrected_net else (False,):
                    lib, symbol = kern.chain_entry(kc, audit)
                    assert symbol in _build.SIGNATURES[lib] and "w64" in lib
                for g, tile, need in kern.launch_plans(spec, kc):
                    assert need <= SMEM_LIMIT, (net, cname, kern.symbol, g)


def test_the_sweep_launches_every_width_64_form(monkeypatch, one_torch_thread):
    """chip_smoke.py phase 19's sweep: each padded count of the last conv
    (8, 16, 32, 48 columns) at three convs and at two, widths 48 and 64, and
    every network in one group in each kernel at each sweep config (its
    calls are timed one group each)."""
    from tests.test_torch_deep import _calibrated

    monkeypatch.setattr(convert, "_fragment_words", lambda *a, **k: np.zeros(8, np.int32))
    monkeypatch.setattr(convert, "_wgmma_b_words", lambda *a, **k: np.zeros(8, np.int32))
    cs = _chip_smoke()
    for nets in (cs.W64_SWEEP, cs.W64_PAIRS):
        assert {convert.out_columns(3 * kw["scaling_factor"] ** 2) for kw in nets.values()} == \
            set(convert.OUT_COLUMNS)
        assert {kw["num_channels"] for kw in nets.values()} == {48, 64}
    assert {lib for lib, _ in cs.W64_FAMILIES} == {"sesr_net_w64", "sesr_corrected_w64",
                                                  "sesr_corrected_w64_audit"}
    for kw in [*cs.W64_SWEEP.values(), *cs.W64_PAIRS.values()]:
        spec, qp = _calibrated(tuple(sorted(kw.items())))
        for hw in cs.KSIZE_SWEEP_HW.values():
            hq = dataclasses.replace(qp, hw=HardwareConfig(**hw))
            for kern in NET_KERNELS:
                for split in _masks(kern, spec, hq):
                    kc = convert.kernel_constants(spec, hq, kern.datapath, split)
                    assert kc.width == 64 and [(g.first, g.last) for g in kc.groups] == \
                        [(0, spec.num_convs - 1)]


class _Recorder:
    """A faked kernel library: every entry point records its arguments and
    returns 0 (cudaSuccess)."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, symbol):
        return lambda *args: self.calls.append((self.name, symbol, args)) or 0


def test_a_width_64_chain_launches_the_width_64_entry_points(monkeypatch, one_torch_thread):
    """The wrappers' chain (NetKernel._chain) of the width-48 network on a
    faked library and device: one launch a group, each of the width-64
    library's entry point (K1 and K2 sesr_net_w64, the corrected kernel
    sesr_corrected_w64, its counting form sesr_corrected_w64_audit), with
    the group's convs, flags, split bits, width 64 and packed sizes."""
    from sesr_tpu_torch.ops.corrected import split_layers

    spec, _, qp, _ = _network("w48_x4")
    qp = dataclasses.replace(qp, hw=HardwareConfig(pe=16))
    calls = []
    monkeypatch.setattr(_build, "load", lambda name: _Recorder(name, calls))
    monkeypatch.setattr(kernels.NetKernel, "_check", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", lambda *_a: contextlib_null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    x_q = torch.zeros((1, 8, 8, 3), dtype=torch.int8)
    split = split_layers(qp, "pe-exact")
    runs = [(kernels.pe_exact_net, None, "sesr_net_w64"), (kernels.fast_net, None, "sesr_net_w64"),
            (corrected_net, split, "sesr_corrected_w64")]
    for kern, mask, lib in runs:
        calls.clear()
        kern.reset()
        kern(spec, qp, x_q, split=mask)
        kc = convert.device_constants(spec, qp, kern.datapath, x_q.device, mask)[0]
        assert kern.launches == len(kc.groups) == len(calls)
        for (name, symbol, args), g in zip(calls, kc.groups):
            assert name == symbol == lib
            lead = 1 if kern is not corrected_net else 0
            assert args[lead + 5:lead + 10] == (1, 8, 8, g.convs, g.flags)
            assert args[-6:-1] == (g.split, 16, 2 if kc.wide else 1, 64,
                                   convert.pack_sizes(spec.kernel_sizes[g.first:g.last + 1]))
    calls.clear()
    corrected_net.audit(spec, qp, x_q, split)
    assert [(name, symbol) for name, symbol, _ in calls] == \
        [("sesr_corrected_w64_audit", "sesr_corrected_w64_audit")] * len(kc.groups)


def contextlib_null():
    import contextlib

    return contextlib.nullcontext()


def test_widths_past_64_are_refused(one_torch_thread):
    """A hidden width of 65 or 80 is refused by kernel_width and
    kernel_constants, naming the limit; 33 to 64 run at 64."""
    assert [convert.kernel_width(c) for c in (1, 16, 17, 32, 33, 48, 64)] == \
        [16, 16, 32, 32, 64, 64, 64]
    spec, _, qp, _ = _network("w64")
    for c in (65, 80):
        with pytest.raises(NotImplementedError, match="widths of at most 64 channels"):
            convert.kernel_width(c)
        for datapath in convert.DATAPATHS:
            with pytest.raises(NotImplementedError, match="widths of at most 64"):
                convert.kernel_constants(dataclasses.replace(spec, num_channels=c), qp, datapath,
                                         (True,) * spec.num_convs
                                         if datapath == "corrected" else None)
