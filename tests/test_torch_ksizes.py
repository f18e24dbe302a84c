"""Networks of other conv sizes, on the CPU: each conv of any odd size from
1 to 9, the first conv, the block convs and the last conv each on its own
(``SESRSpec`` k_first, k_block, k_last).

- The networks: 16-channel, 3-in SESRs of five convs at (3, 3, 3), (7, 1,
  7), (9, 5, 9) and (1, 3, 1), a 32-channel one at (7, 3, 9) and a 48-output
  RGB x4 one at (9, 3, 9), the JAX package's ``init_params`` from
  ``PRNGKey(0)``, calibrated by the JAX package (``safe_zero_floor``) on two
  numpy ``default_rng(0)`` 24x32 images (the (3, 3, 3) one also certified
  by it), carried across with ``convert.quantparams_from_fields``.
- The port's plain interpreter against the JAX package's, every dump, in the
  corrected and fast modes; in reference mode against the numpy spec
  ``numpy_integer_forward`` everywhere and against the JAX package's
  wherever the two agree (no rounding tie on these networks).
- The kernels' plans: ``kernel_constants`` takes each network on all three
  datapaths at 4 PEs, pe16 and the JAX sweep's 3-PE config in the forms of
  other conv sizes (csrc/sesr_net_ksize.cu, csrc/sesr_corrected_ksize.cu),
  each group's plan within a block; ``group_forward`` over the groups is the
  whole interpreter; an even size and a size past 9 are refused, naming the
  size.
- The rings, pieces and B layouts: ``_ring`` sums k // 2 over each group's
  sizes; ``pieces`` divides 41, 49 and 81 steps; K1 / K2's B fragments
  through the numpy model of mma.sync (tests/test_torch_mma_layout.py) and
  the corrected kernel's layers through its numpy model
  (tests/test_torch_corrected.py, its index maps read from the source,
  layer 0 of a 9x9 conv two k32 steps a kernel row) equal the plain sums
  at every size.

The kernels themselves run on the card only (chip_smoke.py phase 18)."""

import dataclasses
import functools
import re

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
from sesr_tpu_torch import convert
from sesr_tpu_torch.config import HardwareConfig, SESRSpec
from sesr_tpu_torch.ops import _build, kernels
from sesr_tpu_torch.ops.corrected import split_layers
from sesr_tpu_torch.ops.kernels import NET_KERNELS, SMEM_LIMIT, corrected_net, pieces
from sesr_tpu_torch.quant.integer import group_chain, integer_forward, pe_channel_mask
from tests.test_hwconfig_sweep import ALT_CONFIGS, numpy_integer_forward
from tests import test_torch_corrected
from tests.test_torch_corrected import CONST, FNS, _kernel_layer_sums, piece_steps
from tests.test_torch_mma_layout import _model_layer, _pack, _valid_conv
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

H, W = 24, 32
KS_SRC = (_build.CSRC / "sesr_corrected_ksize.cu").read_text()


def _ks_expr(fn):
    """The one-line function ``fn`` of csrc/sesr_corrected_ksize.cu as a
    Python function (tests/test_torch_corrected.py's reading)."""
    m = re.search(rf"int {fn}\(([^)]*)\) \{{ return (.*?); \}}", KS_SRC)
    assert m, fn
    args = [a.split()[-1] for a in m.group(1).split(",")]
    return eval(f"lambda {', '.join(args)}: {m.group(2).replace(' / ', ' // ')}", dict(FNS))


ks_steps_of, ks_half_off = _ks_expr("ks_steps_of"), _ks_expr("ks_half_off")
w64_steps_of, w64_half_off = _ks_expr("w64_steps_of"), _ks_expr("w64_half_off")
# (k_first, k_block, k_last), hidden width, scale (x4: 48 outputs)
NETS = {"k333": ((3, 3, 3), 16, 1), "k717": ((7, 1, 7), 16, 1), "k959": ((9, 5, 9), 16, 1),
        "k131": ((1, 3, 1), 16, 1), "k739_w32": ((7, 3, 9), 32, 1),
        "k939_x4": ((9, 3, 9), 16, 4)}
# a network of width 64 (tests/test_torch_wide.py holds the width's own
# networks), three convs: the corrected kernel's numpy model at width 64
WIDE_NETS = {"k735_w64": ((7, 3, 5), 64, 1)}
CERTIFIED = ("k333",)
CONFIGS = {"pe4": HardwareConfig(), "pe16": HardwareConfig(pe=16),
           "pe3_nondivisible": HardwareConfig(**dataclasses.asdict(ALT_CONFIGS[2]))}
MODES = {"corrected": dict(corrected=True), "fast": dict(corrected=True, compute="fast")}


def _kw(net):
    (kf, kb, kl), width, scale = {**NETS, **WIDE_NETS}[net]
    return dict(name=f"sesr_{net}", in_channels=3, out_channels=3, num_channels=width,
                num_lblocks=1 if net in WIDE_NETS else 3, scaling_factor=scale, k_first=kf,
                k_block=kb, k_last=kl)


def _images():
    rng = np.random.default_rng(0)
    return [rng.random((1, H, W, 3), dtype=np.float32) for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _network(net):
    """(port spec, JAX spec, port QuantParams, JAX QuantParams) of ``net``,
    calibrated (and, in CERTIFIED, certified) by the JAX package."""
    jspec = JSESRSpec(**_kw(net))
    jqp = jcalibrate(jspec, jinit_params(jspec, jax.random.PRNGKey(0)), _images(),
                     safe_zero_floor=True)
    if net in CERTIFIED:
        jqp = jcertify_fast(jspec, jqp, _images())
    qp = convert.quantparams_from_fields({f.name: getattr(jqp, f.name)
                                          for f in dataclasses.fields(jqp)})
    return SESRSpec(**_kw(net)), jspec, qp, jqp


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("net", list(NETS))
def test_plain_interpreter_matches_jax(net, mode, one_torch_thread):
    """The port's plain interpreter's output and every dump array_equal with
    the JAX package's, corrected and fast datapaths."""
    spec, jspec, qp, jqp = _network(net)
    assert spec.kernel_sizes == jspec.kernel_sizes
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
    value, and the JAX package's wherever the spec and the JAX package agree
    (they agree everywhere on these networks: no rounding tie)."""
    spec, jspec, qp, jqp = _network(net)
    L = spec.num_convs
    x = _images()[1]
    _, d_t = integer_forward(spec, qp, x, collect_dumps=True, device="cpu")
    _, d_j = jinteger_forward(jspec, jqp, jnp.asarray(x), collect_dumps=True)
    s, z = np.float32(qp.a_scale[L]), np.float32(qp.a_zero[L])
    port_out = d_t[f"input.{L}"].numpy()
    np.testing.assert_array_equal((port_out - z) * s,
                                  numpy_integer_forward(jspec, jqp, x).astype(np.float32))
    jax_out = np.asarray(d_j[f"input.{L}"])
    np.testing.assert_array_equal(port_out, jax_out)


def test_the_certified_network_serves_fast(one_torch_thread):
    """The (3, 3, 3) network certified by the JAX package carries its
    stamps across and serves the fast mode."""
    from sesr_tpu_torch.deploy import select_forward

    spec, _, qp, jqp = _network("k333")
    assert qp.fast_cert_ok and jqp.fast_cert_ok and select_forward(qp)[0] == "fast"


def _masks(kern, qp):
    L = qp.num_convs
    if kern.datapath != "corrected":
        return (None,)
    return (split_layers(qp, "pe-exact"), (True,) * L)


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("net", list(NETS))
def test_kernel_constants_plan_other_sizes_in_groups(net, config, monkeypatch,
                                                     one_torch_thread):
    """Every datapath (the corrected kernel with the PE-exact mode's mask and
    an all-split one) takes each network at each config in the forms of
    other conv sizes: one group, GROUP_FIRST | GROUP_LAST, in the general
    instantiation, whose plan (the library's wrapper's) fits a block, each
    record's "k" word its conv's size."""
    spec, _, qp, _ = _network(net)
    qp = dataclasses.replace(qp, hw=CONFIGS[config])
    for kern in NET_KERNELS:
        for split in _masks(kern, qp):
            kc = convert.kernel_constants(spec, qp, kern.datapath, split)
            assert kc.other_sizes and kc.general and kc.ksizes == spec.kernel_sizes
            assert [(g.first, g.last, g.flags) for g in kc.groups] == \
                [(0, spec.num_convs - 1, convert.GROUP_FIRST | convert.GROUP_LAST)]
            assert [int(kc.param("k", i)) for i in range(spec.num_convs)] == \
                list(spec.kernel_sizes)
            for _, _, need in kern.launch_plans(spec, kc):
                assert need <= SMEM_LIMIT, (kern.symbol, split)


@pytest.mark.parametrize("net", ["k959", "k739_w32"])
def test_group_chain_equals_the_interpreter(net, one_torch_thread):
    """A forced partition of each network into two groups (group_chain), in
    the reference and corrected datapaths: the output and every crossing
    value of the whole interpreter."""
    spec, _, qp, _ = _network(net)
    x = _images()[0]
    for corrected in (False, True):
        y, d = integer_forward(spec, qp, x, collect_dumps=True, corrected=corrected,
                               device="cpu")
        got, seen = group_chain(spec, qp, x, ((0, 1), (2, 4)), corrected=corrected,
                                device="cpu")
        assert torch.equal(got, y)
        assert torch.equal(seen["input.2"], d["input.2"])


def test_deep_networks_of_other_sizes_run_in_several_groups(monkeypatch, one_torch_thread):
    """A 22-conv network of 7x7 block convs runs in two groups or more, each
    within a block, and a network whose smallest groups fit no block is
    refused with the shared memory they need."""
    monkeypatch.setattr(convert, "_fragment_words", lambda *a, **k: np.zeros(8, np.int32))
    monkeypatch.setattr(convert, "_wgmma_b_words", lambda *a, **k: np.zeros(8, np.int32))
    spec, _, qp, _ = _network("k717")
    deep = dataclasses.replace(spec, num_lblocks=20, k_block=7)
    w = list(qp.w_int[:1]) + [np.resize(np.asarray(qp.w_int[1]), (7, 7, 16, 16))] * 20 \
        + list(qp.w_int[-1:])
    dqp = dataclasses.replace(
        qp, w_int=w, bias_int=[qp.bias_int[0]] + [qp.bias_int[1]] * 20 + [qp.bias_int[-1]],
        bias_f=[qp.bias_f[0]] + [qp.bias_f[1]] * 20 + [qp.bias_f[-1]],
        w_scale=[qp.w_scale[0]] + [qp.w_scale[1]] * 20 + [qp.w_scale[-1]],
        a_scale=[qp.a_scale[0]] + [qp.a_scale[1]] * 21 + [qp.a_scale[-1]],
        a_zero=[qp.a_zero[0]] + [qp.a_zero[1]] * 21 + [qp.a_zero[-1]],
        requant_m=[qp.requant_m[0]] + [qp.requant_m[1]] * 20 + [qp.requant_m[-1]],
        requant_n=[qp.requant_n[0]] + [qp.requant_n[1]] * 20 + [qp.requant_n[-1]],
        fast_cert_layers=None, fast_cert_ok=False)
    for kern in NET_KERNELS:
        split = (True,) * deep.num_convs if kern.datapath == "corrected" else None
        kc = convert.kernel_constants(deep, dqp, kern.datapath, split)
        assert len(kc.groups) >= 2
        for _, _, need in kern.launch_plans(deep, kc):
            assert need <= SMEM_LIMIT
    monkeypatch.setattr(kernels.NetKernel, "group_smem_bytes", lambda *a: SMEM_LIMIT + 1)
    with pytest.raises(NotImplementedError, match=r"the smallest groups .* need \[232449"):
        convert.kernel_constants(deep, dqp, "fast")


@pytest.mark.parametrize("k", [2, 4, 11])
def test_even_and_large_sizes_are_refused(k, one_torch_thread):
    """An even size (its SAME padding grows the frame: not a JAX
    configuration) and a size past 9 are refused, naming the conv and its
    size."""
    spec, _, qp, _ = _network("k333")
    bad = dataclasses.replace(spec, k_block=k)
    w = [np.asarray(qp.w_int[0])] + [np.zeros((k, k, 16, 16), np.int8)] * 3 + \
        [np.asarray(qp.w_int[-1])]
    with pytest.raises(NotImplementedError, match=rf"conv 1 of sesr_k333 is {k}x{k}"
                                                  + (r" \(an even size" if k % 2 == 0 else "")):
        convert.kernel_constants(bad, dataclasses.replace(qp, w_int=w), "fast")


@pytest.mark.parametrize("flags", [0, 1, 2, 3])
def test_rings_sum_each_convs_half_size(flags):
    """``_ring`` over a group's sizes (``_group_sizes``): the sum of k // 2
    over its convs from j on; without sizes, 5x5 the network's first and
    last conv and 3x3 between (the 5 / 3 / 5 kernels' group_ring)."""
    sizes = (9, 1, 7, 3, 5)
    n = len(sizes)
    for j in range(n + 1):
        assert kernels._ring(j, kernels._group_sizes(n, flags, sizes)) == \
            sum(k // 2 for k in sizes[j:])
        old = n - j + (j == 0 and bool(flags & 1)) + bool(flags & 2) if j < n else 0
        assert kernels._ring(j, kernels._group_sizes(n, flags)) == old
    assert kernels._ring(0, convert.shipped_sizes(7)) == 2 + 5 + 2


@pytest.mark.parametrize("steps,cols,want", [(41, 128, (41, 1)), (49, 128, (7, 7)),
                                             (81, 128, (9, 9)), (81, 96, (9, 9)),
                                             (41, 32, (1, 41)), (25, 128, (5, 5)),
                                             (13, 128, (1, 13))])
def test_pieces_divide_the_steps(steps, cols, want):
    """``pieces``: the whole chunk where it fits PIECE_MAX, else the largest
    divisor of the steps whose piece fits; nothing is dropped, and at the
    5 / 3 / 5 networks' counts it is the one-launch kernels' piece_steps."""
    count, per = pieces(steps, cols)
    assert (count, per) == want and count * per == steps
    assert per * cols * 32 <= CONST["kPieceMax"]
    if steps in (5, 9, 13, 25):
        assert per == piece_steps(steps, cols)


@pytest.mark.parametrize("width", [16, 32, 64])
@pytest.mark.parametrize("k", [1, 3, 5, 7, 9])
@pytest.mark.parametrize("layer", ["first", "hidden", "last"])
def test_mma_fragments_at_every_size(k, layer, width):
    """K1's and K2's B fragments of a k x k conv (convert.py
    _fragment_words; conv_layer_ks reads the offsets the model forms)
    through the numpy model of mma.sync: each PE's partial (4, 16 and 3
    PEs) and the one-pass sum equal the plain conv, at widths 16, 32 and 64
    (a one-pass tap of 16 words two k32 chunks) and a 48-output last
    conv."""
    rng = np.random.default_rng(k)
    ic, oc = {"first": (3, width), "hidden": (width, width), "last": (width, 48)}[layer]
    w = rng.integers(-127, 128, (k, k, ic, oc)).astype(np.int8)
    q = rng.integers(-128, 128, size=(5 + k - 1, 11 + k - 1, ic)).astype(np.int8)
    words, ps = _pack(q)
    for pe, split in ((4, True), (16, True), (3, True), (4, False)):
        frag = convert._fragment_words(w, split, pe, last=layer == "last")
        got, _ = _model_layer(words, ps, frag, k, ic, oc, split, layer == "last", 5, 11, pe)
        got = got.reshape(-1, 5, 11, oc)
        masks = [pe_channel_mask(ic, pe, p) for p in range(pe)] if split else \
            [np.ones(ic, bool)]
        want = [_valid_conv(q[..., m], w[:, :, m, :]) for m in masks if m.any()]
        np.testing.assert_array_equal(got, np.stack(want), err_msg=f"{layer} {width} {pe}")


def _w64_desc(s, k, iw, wide, width, plane):
    """FormKS::issue_run's A descriptor at width 64 (csrc/sesr_corrected_ksize.cu):
    the start at w64_half_off's half 0 (its plane's offset in it), the LBO
    the distance to half 1."""
    o0, o1 = w64_half_off(s, 0, k, iw, wide, plane), w64_half_off(s, 1, k, iw, wide, plane)
    return o0, (o1 - o0) * CONST["kPix"]


@pytest.mark.parametrize("config", ["pe4", "pe16"])
@pytest.mark.parametrize("net", ["k959", "k739_w32", "k131", "k735_w64"])
def test_corrected_kernel_layers_at_other_sizes(net, config, monkeypatch, one_torch_thread):
    """The numpy model of the corrected kernel (tests/test_torch_corrected.py,
    its index maps read from csrc/sesr_corrected.cu, the steps and offsets
    from csrc/sesr_corrected_ksize.cu's ks_steps_of and ks_half_off: a 9x9
    layer 0 two k32 steps a kernel row; at width 64 w64_steps_of and
    w64_half_off, each tap two steps over two of the four planes) on each
    layer of the network with every conv split: y = bias + pe_add equals
    the plain interpreter's."""
    if net in WIDE_NETS:
        # the buffer's extent per plane (ks_group_cap: a plane's pixels), the
        # descriptors with the planes
        monkeypatch.setattr(test_torch_corrected, "steps_of", lambda k, w, c: w64_steps_of(k, w))
        monkeypatch.setattr(test_torch_corrected, "half_off",
                            lambda s, h, k, iw, w, c: w64_half_off(s, h, k, iw, w, 0))
        monkeypatch.setattr(test_torch_corrected, "_a_desc", _w64_desc)
        monkeypatch.setattr(test_torch_corrected, "piece_steps", lambda s, nc: pieces(s, nc)[1])
        monkeypatch.setattr(test_torch_corrected, "piece_count", lambda s, nc: pieces(s, nc)[0])
    else:
        monkeypatch.setattr(test_torch_corrected, "steps_of", ks_steps_of)
        monkeypatch.setattr(test_torch_corrected, "half_off", ks_half_off)
    spec, _, qp, _ = _network(net)
    qp = dataclasses.replace(qp, hw=CONFIGS[config])
    L = spec.num_convs
    split = (True,) * L
    kc = convert.kernel_constants(spec, qp, "corrected", split)
    x = np.random.default_rng(3).random((1, 6, 11, 3), dtype=np.float32)
    _, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True,
                               fast_layers=(False,) * L, device="cpu")
    rng = np.random.default_rng(4)
    for i, k in enumerate(spec.kernel_sizes):
        if i == 0:
            assert ks_steps_of(k, 1, 32) == w64_steps_of(k, 1) == k * (2 if k == 9 else 1)
        assert all(ks_steps_of(k, w, c) == FNS["steps_of"](k, w, c)
                   for w in (0, 1) for c in (16, 32) if k < 9 or not w)
        assert w64_steps_of(k, 0) == 2 * ks_steps_of(k, 0, 32)
        x_q = dumps[f"input.{i}"][0].numpy().astype(np.int64)
        want = dumps[f"pe_add.{i}"][0].numpy().astype(np.int64) + np.clip(
            np.asarray(qp.bias_int[i], np.int64), -32768, 32767)
        # at width 64 also with B in pieces of piece_span steps (conv_pieces_ks:
        # every layer past a block's whole B, layer 0 too, in pieces)
        for in_pieces in (False, True) if net in WIDE_NETS else (False,):
            got = _kernel_layer_sums(qp, kc, i, k, x_q, qp.effective_zero(i), i == L - 1, rng,
                                     pieces=in_pieces)
            np.testing.assert_array_equal(got, want, err_msg=f"{net} {config} layer {i}")


# chip_smoke.py phase 18's networks: MACs a pixel (costs.conv_macs), input
# frame (its output 1080x1920) and bound a frame in us at 1,979 int8 TOP/s
PHASE18 = {"m5_k3": (13680, (540, 960), 7.17), "m5_k717": (13040, (540, 960), 6.83),
           "xl_k5": (293600, (540, 960), 153.82), "m5_k939_x4": (77616, (270, 480), 10.17)}


@pytest.mark.parametrize("net", sorted(PHASE18))
def test_the_phase18_networks_run_in_groups_that_fit(net, monkeypatch, one_torch_thread):
    """chip_smoke.py phase 18's networks: their sizes, MACs a pixel, input
    frame and bound; at 4 PEs, pe16 and their sweep config, in every kernel
    (the corrected kernel in the PE-exact mode and with every conv split):
    in the forms of other conv sizes, each group within a block at its
    tile."""
    from tests.test_torch_deep import _calibrated, _chip_smoke, _modes

    from sesr_tpu_torch import costs

    monkeypatch.setattr(convert, "_fragment_words", lambda *a, **k: np.zeros(8, np.int32))
    monkeypatch.setattr(convert, "_wgmma_b_words", lambda *a, **k: np.zeros(8, np.int32))
    cs = _chip_smoke()
    kw = cs.KSIZE_NETS[net]
    macs, frame, bound_us = PHASE18[net]
    spec, qp = _calibrated(tuple(sorted(kw.items())))
    assert spec.kernel_sizes != convert.shipped_sizes(spec.num_convs)
    assert costs.conv_macs(spec) == macs and cs.out_frame(spec) == frame
    ms, by = cs.bound(2 * macs * frame[0] * frame[1], 0, cs.INT8_OPS_PER_S)
    assert by == "operations" and round(ms * 1e3, 2) == bound_us
    for cname in ("pe4", "pe16", cs.KSIZE_CONFIG[net]):
        cqp = dataclasses.replace(qp, hw=HardwareConfig(**cs.HW_CONFIGS.get(cname, {})))
        for kern in NET_KERNELS:
            for split in _modes(kern, cqp) + ([(True,) * spec.num_convs]
                                              if kern is corrected_net else []):
                kc = convert.kernel_constants(spec, cqp, kern.datapath, split)
                assert kc.other_sizes and len(kc.groups) >= 1
                for g, tile, need in kern.launch_plans(spec, kc):
                    assert need <= SMEM_LIMIT, (net, cname, kern.symbol, g)


def test_the_sweep_puts_every_size_in_every_position(monkeypatch, one_torch_thread):
    """chip_smoke.py phase 18's sweep: each of 1, 3, 5, 7 and 9 is the first,
    a block and the last conv's size of a five-conv network at widths 16
    and 32, each padded count of the last conv (8, 16, 32, 48 columns) is
    there at both widths, five-conv and two-conv, and every network plans
    in each kernel at each sweep config within a block."""
    from tests.test_torch_deep import _calibrated, _chip_smoke

    monkeypatch.setattr(convert, "_fragment_words", lambda *a, **k: np.zeros(8, np.int32))
    monkeypatch.setattr(convert, "_wgmma_b_words", lambda *a, **k: np.zeros(8, np.int32))
    cs = _chip_smoke()
    for width in (16, 32):
        fives = [kw for kw in cs.KSIZE_SWEEP.values() if kw["num_channels"] == width]
        pairs = [kw for kw in cs.KSIZE_PAIRS.values() if kw["num_channels"] == width]
        for pos in ("k_first", "k_block", "k_last"):
            assert sorted(kw[pos] for kw in fives) == list(convert.KSIZES)
        for nets in (fives, pairs):
            assert {convert.out_columns(3 * kw["scaling_factor"] ** 2) for kw in nets} == \
                set(convert.OUT_COLUMNS)
    for kw in [*cs.KSIZE_SWEEP.values(), *cs.KSIZE_PAIRS.values()]:
        spec, qp = _calibrated(tuple(sorted(kw.items())))
        for hw in cs.KSIZE_SWEEP_HW.values():
            hq = dataclasses.replace(qp, hw=HardwareConfig(**hw))
            for kern in NET_KERNELS:
                split = (True,) * spec.num_convs if kern is corrected_net else None
                kc = convert.kernel_constants(spec, hq, kern.datapath, split)
                assert kc.other_sizes and [(g.first, g.last) for g in kc.groups] == \
                    [(0, spec.num_convs - 1)]
                assert all(need <= SMEM_LIMIT for _, _, need in kern.launch_plans(spec, kc))


def test_even_sizes_grow_the_frame_in_jax():
    """Why an even size is refused, not ported: it is no configuration of
    the JAX package either. At (4, 3, 4) its ``integer_forward`` returns a
    26x34 frame from a 24x32 input (SAME padding of k // 2 on both sides
    adds a row and a column at each even conv)."""
    kw = dict(_kw("k333"), name="sesr_k434", k_first=4, k_last=4)
    jspec = JSESRSpec(**kw)
    jqp = jcalibrate(jspec, jinit_params(jspec, jax.random.PRNGKey(0)), _images(),
                     safe_zero_floor=True)
    y = jinteger_forward(jspec, jqp, jnp.asarray(_images()[0]))[0]
    assert y.shape[1:3] == (H + 2, W + 2) == (26, 34)
