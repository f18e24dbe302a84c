"""The corrected kernel's constants (sesr_tpu_torch/convert.py) and the
choice of its layer forms (sesr_tpu_torch/ops/corrected.py), on the CPU:

- the proof of where the corrected datapath's per-PE 18-bit clamp can fire
  (``corrected_split_layers``) against a brute-force range of each PE's
  partial conv(q - z_eff);
- the per-PE zero terms z_eff * sum(W_p), which sum to the layer's;
- the split masks of the hybrid and PE-exact modes on every artifact;
- ``shortcut_bound`` on a conv 0 that runs one pass per PE;
- a model of the kernel's per-layer datapath (csrc/sesr_net.cu conv_layer
  with DP == CORRECTED): the MMA sums of tests/test_torch_mma_layout.py
  over z_eff-padded int8 inputs, each PE's accumulator started from
  -z_eff * sum(W_p) and clamped to 18 bits on a split layer, the one-pass
  sum started from bias - z_eff * sum(W) and clamped to 20 bits where its
  bit is set, equal to the plain interpreter's bias + pe_add at every
  layer. The kernel itself is held against its plain version on the card
  by chip_smoke.py."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sesr_tpu_torch import convert
from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.ops.corrected import MODES, split_layers
from sesr_tpu_torch.ops.kernels import corrected_net
from sesr_tpu_torch.quant.integer import integer_forward, pe_channel_mask
from sesr_tpu_torch.quant.params import QuantParams
from tests.test_torch_mma_layout import _model_layer, _pack

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")
TASKS = ("nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2")
ACC_HI, ADD_HI = 2 ** 17 - 1, 2 ** 19 - 1


def _artifact(task):
    return spec_for_task(task), QuantParams.load(
        os.path.join(ARTIFACT_DIR, f"qparams_{task}.npz"))


def _saturated(qp, layers, value=127):
    """qp with the weights of ``layers`` at +-value."""
    w = list(qp.w_int)
    for i in layers:
        w[i] = np.where(np.asarray(w[i]) >= 0, value, -value).astype(np.asarray(w[i]).dtype)
    return dataclasses.replace(qp, w_int=w)


def _brute_pe_range(w, z, pe):
    """Per PE, (lo, hi) per output channel of conv(q - z) over the PE's
    input channels, by enumeration: every weight meets each of the 256
    int8 values at its own position (and a padded position holds q = z),
    so the extremes are sums of each weight's extremes over those values."""
    q = np.arange(-128, 128, dtype=np.int64) - z                  # every q - z
    terms = np.asarray(w, np.int64)[..., None] * q                # (k, k, ic, oc, 256)
    out = []
    for p in range(pe):
        m = pe_channel_mask(w.shape[2], pe, p)
        t = terms[:, :, m]
        out.append((t.min(axis=-1).sum(axis=(0, 1, 2)), t.max(axis=-1).sum(axis=(0, 1, 2))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_corrected_split_proof_against_brute_force(seed):
    """corrected_split_layers flags a layer exactly where some PE's partial
    conv(q - z_eff) can leave 18 bits; the bound is over q - z_eff, so a
    zero point moves it (the reference datapath's pe_split_layers, over q,
    does not see the zero)."""
    spec, qp = _artifact("nr")
    rng = np.random.default_rng(seed)
    L = spec.num_convs
    # weights of each conv scaled so that some layers can reach 18 bits and
    # some cannot; zero points across the int8 range, one of them floored
    scale = rng.integers(20, 128, L)
    w = [np.clip(rng.integers(-s, s + 1, np.asarray(x).shape), -127, 127).astype(np.int8)
         for s, x in zip(scale, qp.w_int)]
    a_zero = [int(z) for z in rng.integers(-140, 128, L + 1)]
    cqp = dataclasses.replace(qp, w_int=w, a_zero=a_zero)
    split = convert.corrected_split_layers(cqp)
    for i in range(L):
        z = cqp.effective_zero(i)
        ranges = _brute_pe_range(w[i], z, qp.hw.pe)
        assert [tuple(map(tuple, r)) for r in ranges] == \
            [tuple(map(tuple, r)) for r in convert._pe_ranges(cqp, i, z)]
        fires = any((hi > ACC_HI).any() or (lo < -ACC_HI - 1).any() for lo, hi in ranges)
        assert split[i] == fires, (i, z)
    assert convert.pe_split_layers(cqp) == convert._pe_clamp_fires(cqp, lambda i: 0)


def test_corrected_split_proof_holds_on_data():
    """On data, a layer the proof leaves unsplit never saturates a PE's
    corrected partial; with weights at +-127 the layer is split and its
    clamp does fire."""
    spec, qp = _artifact("sr_x2")
    x = np.random.default_rng(8).random((1, 20, 28, 3), dtype=np.float32)
    sat = _saturated(qp, (1,))
    for cqp in (qp, sat):
        split = convert.corrected_split_layers(cqp)
        _, dumps = integer_forward(spec, cqp, x, collect_dumps=True, corrected=True,
                                   device="cpu")
        ovf = dumps["overflow_18"].tolist()
        assert not any(ovf[i] for i in range(spec.num_convs) if not split[i])
    assert split[1] and ovf[1] > 0


@pytest.mark.parametrize("task", TASKS)
def test_pe_zero_terms_sum_to_the_layer_zc(task):
    spec, qp = _artifact(task)
    L = spec.num_convs
    split = convert.corrected_split_layers(qp)
    kc = convert.kernel_constants(spec, qp, "corrected", split)
    lay = convert.PARAM_LAYOUT
    assert kc.params.shape == (convert.PARAM_WORDS,)
    assert kc.params[lay["pe_split"]] == sum(1 << i for i in range(L) if split[i])
    for i, w in enumerate(qp.w_int):
        w = np.asarray(w, np.int64)
        oc = w.shape[3]
        terms = convert.pe_zero_terms(qp, i)
        assert terms.shape == (qp.hw.pe, oc)
        np.testing.assert_array_equal(terms.sum(axis=0),
                                      qp.effective_zero(i) * w.sum(axis=(0, 1, 2)))
        zc = kc.params[lay["zc"] + 16 * i: lay["zc"] + 16 * i + oc]
        zc_pe = np.stack([kc.params[lay["zc_pe"] + 16 * (4 * i + p):
                                    lay["zc_pe"] + 16 * (4 * i + p) + oc] for p in range(4)])
        # a split layer subtracts each PE's share before its 18-bit clamp,
        # a one-pass layer the layer's term before its 20-bit clamp
        np.testing.assert_array_equal(zc_pe, terms if split[i] else 0)
        np.testing.assert_array_equal(zc, 0 if split[i] else terms.sum(axis=0))
        np.testing.assert_array_equal(
            kc.params[lay["bias"] + 16 * i: lay["bias"] + 16 * i + oc],
            np.clip(qp.bias_int[i], -32768, 32767))


@pytest.mark.parametrize("task", TASKS)
def test_split_masks_of_both_modes(task):
    """hybrid: exactly the layers without a stamp; pe-exact: exactly the
    layers the corrected proof cannot clear. The kernel's constants carry
    the mask, and clamp to 20 bits only one-pass layers that can reach it."""
    spec, qp = _artifact(task)
    L = spec.num_convs
    want = {"nr": ((False,) * 4 + (True,), (True,) + (False,) * 3 + (True,)),
            "nrdm_6": ((False,) * 7 + (True,), (True,) + (False,) * 6 + (True,)),
            "sr_x2": ((False,) * 5, (False,) * 3 + (True,) * 2)}
    hybrid, pe_exact = (split_layers(qp, m) for m in MODES)
    assert hybrid == tuple(not s for s in qp.fast_cert_layers)
    assert pe_exact == convert.corrected_split_layers(qp)
    if task in want:
        assert (hybrid, pe_exact) == want[task]
    clamp = convert.clamp20_layers(qp)
    for split in (hybrid, pe_exact):
        kc = convert.kernel_constants(spec, qp, "corrected", split)
        assert kc.pe_split == split
        assert kc.clamp20 == tuple(c and not s for c, s in zip(clamp, split))
        want_w = [convert._fragment_words(np.asarray(w), split[i], qp.hw.pe, i == L - 1)
                  for i, w in enumerate(qp.w_int)]
        np.testing.assert_array_equal(kc.weights, np.concatenate(want_w))
    # the corrected kernel's tile keeps two blocks an SM: 24x32 for 8 convs
    assert corrected_net.tile(spec) == ((24, 32) if L == 8 else (32, 32))
    with pytest.raises(ValueError, match="stamps"):
        split_layers(dataclasses.replace(qp, fast_cert_layers=None), "hybrid")
    with pytest.raises(ValueError, match="mode"):
        split_layers(qp, "fast")


def test_shortcut_bound_on_a_split_conv0():
    """Where conv 0 runs one pass per PE, the shortcut's bound sums each
    PE's largest partial clamped to 18 bits: with conv 0's weights at
    +-127 that clamp fires and the bound is below the one-pass bound, and
    the shortcut the plain interpreter computes stays within it."""
    spec, qp = _artifact("nr")
    sat = _saturated(qp, (0,))
    assert convert.corrected_split_layers(sat)[0]
    z = sat.effective_zero(0)
    his = [hi for _, hi in convert._pe_ranges(sat, 0, z)]
    assert max(int(h.max()) for h in his) > ACC_HI
    y = np.minimum(sum(np.minimum(h, ACC_HI) for h in his), ADD_HI) \
        + np.clip(np.asarray(sat.bias_int[0], np.int64), -32768, 32767)
    from sesr_tpu_torch.ops.fixedpoint import requant_factors
    m_f, p_f = requant_factors(sat.requant_m[0], sat.requant_n[0])
    want = float(np.rint(max(float(((y.astype(np.float32) * np.float32(m_f))
                                     * np.float32(p_f)).max()), 0.0)))
    assert convert.shortcut_bound(sat, True) == want
    assert convert.shortcut_bound(sat, True) < convert.shortcut_bound(sat)
    x = np.random.default_rng(4).random((1, 20, 28, 3), dtype=np.float32)
    _, dumps = integer_forward(spec, sat, x, collect_dumps=True, corrected=True, device="cpu")
    assert dumps["overflow_18"][0] > 0
    assert float(torch.round(dumps["shortcut"]).max()) <= convert.shortcut_bound(sat, True)
    # an unsaturated artifact: both bounds hold the data, the split one is tighter
    for task in TASKS:
        _, tqp = _artifact(task)
        assert convert.shortcut_bound(tqp, True) <= convert.shortcut_bound(tqp) <= 32767


def _kernel_layer_sums(qp, kc, i, k, x_q, z_eff, last):
    """The corrected kernel's y = bias + pe_add of conv i over the int8
    input x_q (H, W, ic), from its constants: the MMA model's per-pass sums
    over the z_eff-padded input, then the kernel's accumulator rules."""
    lay = convert.PARAM_LAYOUT
    h, w, ic = x_q.shape
    oc = np.asarray(qp.w_int[i]).shape[3]
    r = k // 2
    q = np.pad(x_q, ((r, r), (r, r), (0, 0)), constant_values=z_eff).astype(np.int8)
    words, ps = _pack(q)
    offs = list(kc.params[lay["w_off"]: lay["w_off"] + kc.num_layers]) + [kc.weights.size]
    frag = kc.weights[offs[i]: offs[i + 1]]
    split = kc.pe_split[i]
    sums, _ = _model_layer(words, ps, frag, k, ic, oc, split, last, h, w)
    bias = kc.params[lay["bias"] + 16 * i: lay["bias"] + 16 * i + oc].astype(np.int64)
    zc = kc.params[lay["zc"] + 16 * i: lay["zc"] + 16 * i + oc].astype(np.int64)
    tot = bias - zc
    if split:
        pes = [p for p in range(qp.hw.pe) if pe_channel_mask(ic, qp.hw.pe, p).any()]
        for s, p in zip(sums, pes):
            at = lay["zc_pe"] + 16 * (4 * i + p)
            start = -kc.params[at: at + oc].astype(np.int64)
            tot = tot + np.clip(start + s, -ACC_HI - 1, ACC_HI)
    else:
        tot = tot + sums[0]
        if kc.clamp20[i]:
            tot = np.clip(tot, bias - ADD_HI - 1, bias + ADD_HI)
    return tot.reshape(h, w, oc)


def _all_127(qp, layers):
    """qp with every weight of ``layers`` at +127: on any input well above
    the zero point the sums leave 18 and 20 bits."""
    w = [np.full_like(np.asarray(x), 127) if i in layers else np.asarray(x)
         for i, x in enumerate(qp.w_int)]
    return dataclasses.replace(qp, w_int=w)


@pytest.mark.parametrize("case", ["nr-hybrid", "nr-pe-exact", "nrdm_6-hybrid",
                                  "sr_x2-pe-exact", "sr_x4-pe-exact",
                                  "sr_x2-odd-zeros-pe-exact", "nr-saturating-hybrid",
                                  "nr-saturating-pe-exact"])
def test_corrected_kernel_layers_model_the_plain_sums(case):
    task = case.split("-")[0]
    mode = "hybrid" if case.endswith("hybrid") else "pe-exact"
    spec, qp = _artifact(task)
    L = spec.num_convs
    if "saturating" in case:
        # hybrid: conv 0 runs one pass (stamped) and its 20-bit clamp fires,
        # the last conv runs per PE and its 18-bit clamp fires; pe-exact:
        # conv 0 runs per PE and its 18-bit clamp fires
        qp = _all_127(qp, (0, L - 1))
    if "odd-zeros" in case:
        qp = dataclasses.replace(qp, a_zero=[-120, -131, -100, 5, -127, -128])
    split = split_layers(qp, mode)
    kc = convert.kernel_constants(spec, qp, "corrected", split)
    fast_layers = tuple(qp.fast_cert_layers) if mode == "hybrid" else None
    x = np.random.default_rng(12).random((1, 6, 11, spec.in_channels), dtype=np.float32)
    _, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True,
                               fast_layers=fast_layers, device="cpu")
    for i, k in enumerate(spec.kernel_sizes):
        x_q = dumps[f"input.{i}"][0].numpy().astype(np.int64)
        got = _kernel_layer_sums(qp, kc, i, k, x_q, qp.effective_zero(i), i == L - 1)
        want = dumps[f"pe_add.{i}"][0].numpy().astype(np.int64) + np.clip(
            np.asarray(qp.bias_int[i], np.int64), -32768, 32767)
        np.testing.assert_array_equal(got, want, err_msg=f"{case} layer {i}")
    ovf18 = dumps["overflow_18"].tolist()
    if case == "nr-saturating-hybrid":
        assert kc.clamp20[0] and not kc.pe_split[0] and kc.pe_split[L - 1]
        assert int((dumps["pe_add.0"] == ADD_HI).sum()) > 0 and ovf18[L - 1] > 0
    if case == "nr-saturating-pe-exact":
        assert kc.pe_split[0] and ovf18[0] > 0
