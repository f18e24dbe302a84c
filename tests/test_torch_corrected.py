"""The corrected kernel's constants (sesr_tpu_torch/convert.py) and the
choice of its layer forms (sesr_tpu_torch/ops/corrected.py), on the CPU:

- the proof of where the corrected datapath's per-PE 18-bit clamp can fire
  (``corrected_split_layers``) against a brute-force range of each PE's
  partial conv(q - z_eff);
- the per-PE zero terms z_eff * sum(W_p), which sum to the layer's;
- the split masks of the hybrid and PE-exact modes on every artifact;
- ``shortcut_bound`` on a conv 0 that runs one pass per PE;
- a numpy model of the kernel (csrc/sesr_corrected.cu), which the CPU
  cannot compile: the wide implicit GEMM of each layer over the z_eff-padded
  input (layer 0's pixels widened to four neighbours), the wgmma
  descriptors' addressing (start, LBO and SBO over no-swizzle K-major core
  matrices) of A and of convert.py's per-PE-expanded B, the accumulator
  fragment, and the epilogue: each PE's column group started from -z_eff *
  sum(W_p) and clamped to 18 bits on a split layer, the one-pass sum started
  from bias - z_eff * sum(W) and clamped to 20 bits where its bit is set,
  equal to the plain interpreter's bias + pe_add at every layer. The index
  maps are read from the source, so the model and the kernel cannot drift
  apart; the hardware's side (the descriptor's addressing, the fragment) is
  written here from the PTX ISA;
- the same model on SESR-M11's 13 convs in both modes, and on SESR-XL's
  (13 convs of 32 channels: two planes of 16 bytes a pixel, one tap a k32
  step with LBO the planes' distance, 32 columns a PE group, and past four
  PEs a split layer's 256 columns in two chunks of 128, one after another)
  in both modes at 4 and 8 PEs; at 16 PEs the 16 column groups of a split
  layer, 256 columns (width 16) or 512 (width 32) in chunks of 128, on the
  sweep's networks and on SESR-M11, and the counting form's per-tile sums
  on SESR-M11 at 16 PEs;
- that the accumulator map gives one thread four consecutive channels of a
  pixel in each plane (the epilogue's 32-bit stores are the next layer's
  input words), and the shared-memory plan and default tiles.
The kernel itself is held against its plain version on the card by
chip_smoke.py."""

import dataclasses
import functools
import os
import re

import numpy as np
import pytest
import torch

from sesr_tpu_torch import convert
from sesr_tpu_torch.config import HardwareConfig, SESRSpec, spec_for_task
from sesr_tpu_torch.models.sesr import CollapsedParams, init_params
from sesr_tpu_torch.quant.calibrate import calibrate
from sesr_tpu_torch.ops import _build
from sesr_tpu_torch.ops.corrected import MODES, split_layers
from sesr_tpu_torch.ops.kernels import (CORRECTED_TILES, SMEM_LIMIT, corrected_net,
                                        corrected_plan, corrected_smem_bytes, layer_pieces,
                                        net_group_smem_bytes, net_smem_bytes, pe_exact_net)
from sesr_tpu_torch.quant.integer import integer_forward, pe_channel_mask
from sesr_tpu_torch.quant.params import QuantParams

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")
TASKS = ("nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2")
ACC_HI, ADD_HI = 2 ** 17 - 1, 2 ** 19 - 1
XL = SESRSpec("sesr_xl_x2", in_channels=3, out_channels=3, num_channels=32, num_lblocks=11,
              scaling_factor=2)
SRC = (_build.CSRC / "sesr_corrected.cu").read_text()
CONST = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", SRC)}


def _expr(fn, scope):
    """The return expression of the one-line function ``fn`` of the kernel's
    source as a Python function (C's integer division translated; every
    operand is non-negative, and C's comparisons give 0 or 1 as Python's
    give False or True), calling the functions of ``scope``."""
    m = re.search(rf"int {fn}\(([^)]*)\) \{{ return (.*?); \}}", SRC)
    assert m, fn
    args = [a.split()[-1] for a in m.group(1).split(",")]
    return eval(f"lambda {', '.join(args)}: {m.group(2).replace(' / ', ' // ')}", scope)


FNS = dict(CONST)
for _fn in ("tap_of", "tap_pix", "half_off", "a_lbo", "steps_of", "b_byte", "col_chan",
            "acc_row", "acc_col", "pe_groups", "count_lo", "count_hi", "chunk_groups",
            "piece_count", "piece_steps", "piece_src"):
    FNS[_fn] = _expr(_fn, FNS)
(steps_of, half_off, a_lbo, b_byte, col_chan, acc_row, acc_col, pe_groups, count_lo, count_hi,
 chunk_groups, piece_count, piece_steps, piece_src) = (
    FNS[f] for f in ("steps_of", "half_off", "a_lbo", "b_byte", "col_chan", "acc_row",
                     "acc_col", "pe_groups", "count_lo", "count_hi", "chunk_groups",
                     "piece_count", "piece_steps", "piece_src"))


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
    clamp does fire. Also on nr's adversarial frame and on the saturated
    SESR-XL at 4 and 8 PEs, whose events the counting form counts on the
    split layers alone."""
    from sesr_tpu_torch.quant.certify import adversarial_image

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
    nr, nr_qp = _artifact("nr")
    x_xl = np.random.default_rng(9).random((1, 20, 28, 3), dtype=np.float32)
    for tspec, tqp, tx in ((nr, nr_qp, adversarial_image(nr_qp, hw=(20, 28))),
                           (XL, _xl_saturated(4), x_xl), (XL, _xl_saturated(8), x_xl)):
        split = convert.corrected_split_layers(tqp)
        _, dumps = integer_forward(tspec, tqp, tx, collect_dumps=True, corrected=True,
                                   device="cpu")
        ovf = dumps["overflow_18"].tolist()
        assert not any(ovf[i] for i in range(tspec.num_convs) if not split[i]), (tspec.name, ovf)
        assert any(ovf), (tspec.name, tqp.hw.pe)
    assert ovf[3] > 0


@pytest.mark.parametrize("task", TASKS)
def test_pe_zero_terms_sum_to_the_layer_zc(task):
    spec, qp = _artifact(task)
    L = spec.num_convs
    split = convert.corrected_split_layers(qp)
    kc = convert.kernel_constants(spec, qp, "corrected", split)
    assert kc.params.shape == (convert.param_words(qp.hw.pe, L),)
    assert kc.param("pe_split") == sum(1 << i for i in range(L) if split[i])
    for i, w in enumerate(qp.w_int):
        w = np.asarray(w, np.int64)
        oc = w.shape[3]
        terms = convert.pe_zero_terms(qp, i)
        assert terms.shape == (qp.hw.pe, oc)
        np.testing.assert_array_equal(terms.sum(axis=0),
                                      qp.effective_zero(i) * w.sum(axis=(0, 1, 2)))
        zc = kc.param("zc", i)[:oc]
        zc_pe = np.stack([kc.zc_pe(i, p)[:oc] for p in range(4)])
        # a split layer subtracts each PE's share before its 18-bit clamp,
        # a one-pass layer the layer's term before its 20-bit clamp
        np.testing.assert_array_equal(zc_pe, terms if split[i] else 0)
        np.testing.assert_array_equal(zc, 0 if split[i] else terms.sum(axis=0))
        np.testing.assert_array_equal(
            kc.param("bias", i)[:oc],
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
        want_w = [convert._wgmma_b_words(np.asarray(w), split[i], qp.hw.pe, i == L - 1)
                  for i, w in enumerate(qp.w_int)]
        np.testing.assert_array_equal(kc.weights, np.concatenate(want_w))
        # the corrected kernel's tile: the first of CORRECTED_TILES whose
        # plan fits a block (nr hybrid 48x48, the sweep's fastest)
        tile = corrected_net.tile(spec, split, qp.hw.pe)
        fits = [t for t in CORRECTED_TILES if corrected_smem_bytes(
            L, spec.in_channels, spec.conv_out_channels, t, split, qp.hw.pe) <= SMEM_LIMIT]
        assert tile == fits[0]
        if task in ("nr", "nrdm_6"):
            mode = "hybrid" if split == hybrid else "pe-exact"
            assert tile == {("nr", "hybrid"): (48, 48), ("nr", "pe-exact"): (32, 64),
                            ("nrdm_6", "hybrid"): (32, 48),
                            ("nrdm_6", "pe-exact"): (32, 48)}[task, mode]
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


def _hw_a(buf, start, lbo, sbo):
    """The 64 x 32-byte A operand that a wgmma descriptor without swizzle
    (K-major) reads at byte ``start``: row r, k byte kb at start + (r / 8)
    SBO + (r % 8) 16 + (kb / 16) LBO + kb % 16 (8 x 16-byte core matrices;
    LBO between the two k halves, SBO between 8-row groups)."""
    r, kb = np.arange(64)[:, None], np.arange(32)[None, :]
    return buf[start + (r // 8) * sbo + (r % 8) * 16 + (kb // 16) * lbo + kb % 16]


def _hw_b(buf, start, n_cols, lbo, sbo):
    """The 32-byte x N B operand (K-major) the same descriptor reads: k byte
    kb of column n at start + (n / 8) SBO + (n % 8) 16 + (kb / 16) LBO +
    kb % 16."""
    kb, n = np.arange(32)[:, None], np.arange(n_cols)[None, :]
    return buf[start + (n // 8) * sbo + (n % 8) * 16 + (kb // 16) * lbo + kb % 16]


def _smem_input(x_q, k, z_eff, wide, rng, width=16):
    """Layer input as the kernel holds it in shared memory (bytes, int8):
    the z_eff-padded extent, 16 bytes a pixel (layer 0: each pixel's word,
    channel c in byte c, widened to the words of pixels p .. p + 3; a pad's
    word is z_eff in every byte; width 32: two such planes, channels 0-15
    and 16-31, ``plane`` bytes apart), then the pixels the GEMM reads past
    the extent, holding whatever the buffer held before (random bytes
    here). Returns the bytes, the extent, the number of GEMM rows and the
    plane's bytes."""
    h, w, ic = x_q.shape
    r = k // 2
    ih, iw = h + 2 * r, w + 2 * r
    s_n = steps_of(k, int(wide), width)
    rows = -(-h * iw // 64) * 64
    cap = rows + half_off(s_n - 1, 1, k, iw, int(wide), width)
    planes = 1 if wide else width // 16
    plane = -(-cap * 16 // 128) * 128
    buf = rng.integers(-128, 128, (planes, plane // 16, 16)).astype(np.int8)
    if wide:
        raw = np.full((ih, iw, 4), z_eff, np.int8)
        raw[r:r + h, r:r + w] = 0
        raw[r:r + h, r:r + w, :ic] = x_q
        raw = raw.reshape(-1, 4)
        at = np.minimum(np.arange(cap)[:, None] + np.arange(4), len(raw) - 1)
        buf[0, :cap] = raw[at].reshape(cap, 16)
    else:
        padded = np.pad(x_q, ((r, r), (r, r), (0, 0)), constant_values=z_eff)
        for pl in range(planes):
            buf[pl, :ih * iw] = padded[..., 16 * pl:16 * pl + 16].reshape(-1, 16)
    return buf.reshape(-1), ih, iw, rows, plane


def _a_desc(s, k, iw, wide, width, plane):
    """(pixel of A's start from the buffer's, LBO in bytes) of step s of a k
    x k layer: half_off and a_lbo's."""
    o0, o1 = half_off(s, 0, k, iw, wide, width), half_off(s, 1, k, iw, wide, width)
    return o0, a_lbo(o0, o1, wide, width, plane)


def _kernel_layer_sums(qp, kc, i, k, x_q, z_eff, last, rng, events=None, pieces=False):
    """The corrected kernel's y = bias + pe_add of conv i over the int8
    input x_q (H, W, ic), from its constants: the layer's wide GEMM through
    the descriptors (a chunk of whole PE groups at a time, chunk_groups),
    the accumulator fragment, and the epilogue's rules, with the extent of
    one tile over the whole input. A network narrower than its kernel width
    runs padded: its padded input channels hold random bytes here (their
    weights are zero). ``pieces``: B staged in pieces (conv_pieces), each
    piece's 16-byte units copied from the layer's B as piece_src maps them
    into a region of random bytes, and read there by issue_piece's
    descriptors (each step from its piece, ``cols`` columns apart).
    ``events`` (H, W), if given: the counting form's rule
    added per output, the partials of the real PEs (p < pe) and channels
    that the 18-bit clamp changes on a split layer."""
    acc_hi = (1 << (qp.hw.pe_acc_bits - 1)) - 1
    add_hi = (1 << (qp.hw.pe_add_bits - 1)) - 1
    width = kc.width
    h, w, ic = x_q.shape
    oc = np.asarray(qp.w_int[i]).shape[3]
    split = kc.pe_split[i]
    wide = i == 0
    if not wide and ic < width:
        x_q = np.concatenate([x_q, rng.integers(-128, 128, (h, w, width - ic))], axis=-1)
        ic = width
    steps, groups, n_cols = convert.wgmma_geometry(k, ic, oc if last else width, split, last,
                                                   qp.hw.pe)
    assert steps == steps_of(k, int(wide), width)
    ocp = n_cols // groups
    gc = chunk_groups(groups, ocp)
    chunks, nc = groups // gc, gc * ocp
    assert nc <= CONST["kMaxN"] and nc in (8, 16, 24, 32, 48, 64, 80, 96, 112, 128)   # wgmma's N
    buf, ih, iw, rows, plane = _smem_input(x_q.astype(np.int8), k, z_eff, wide, rng, width)
    offs = [kc.param("w_off", j) for j in range(kc.num_layers)] + [kc.weights.size]
    bsm = kc.weights[offs[i]: offs[i + 1]].view(np.int8)
    assert bsm.size == steps * n_cols * 32
    # where B lies for step s of chunk hc: the layer's B (resident or staged
    # whole), or the piece holding that step, copied into a region of
    # random bytes
    where = {}
    for hc in range(chunks):
        if not pieces:
            where.update({(s, hc): (bsm, b_byte(s, hc * nc, 0, n_cols)) for s in range(steps)})
            continue
        per = piece_steps(steps, nc)
        assert piece_count(steps, nc) * per == steps and per * nc * 32 <= CONST["kPieceMax"]
        for s0 in range(0, steps, per):
            region = rng.integers(-128, 128, CONST["kPieceMax"]).astype(np.int8)
            for u in range(per * 2 * nc):
                at = piece_src(u, s0, hc, n_cols, nc)
                region[16 * u:16 * u + 16] = bsm[at:at + 16]
            where.update({(s, hc): (region, b_byte(s - s0, 0, 0, nc))
                          for s in range(s0, s0 + per)})
    # the GEMM's D, m-tile by m-tile and chunk by chunk
    acc = np.zeros((chunks, rows, nc), np.int64)
    for mt in range(rows // 64):
        for s in range(steps):
            o0, lbo = _a_desc(s, k, iw, int(wide), width, plane)
            a = _hw_a(buf, (mt * 64 + o0) * CONST["kPix"], lbo, CONST["kSboA"])
            for hc in range(chunks):
                src, start = where[s, hc]
                b = _hw_b(src, start, nc, CONST["kLboB"], CONST["kSboB"])
                acc[hc, mt * 64:mt * 64 + 64] += a.astype(np.int64) @ b.astype(np.int64)
    bias = kc.param("bias", i)[:oc].astype(np.int64)
    zc = kc.param("zc", i)[:oc].astype(np.int64)
    if split:
        assert not zc.any()          # the kernel's split bounds are bias + kMagicBits +- add_hi
    # the PE zero terms where the kernel reads them: word zcp_at(.., 0) +
    # (2 or 4) tq + col_chan(acc_col(v / 2, 0, v % 2)) + p C of the block,
    # or, for a last layer past C channels, of its own rows (R_ROWS): from
    # rows + 2 OC, OC words a PE
    own = last and oc > width
    row_words = oc if own else width
    zc_at = (kc.param("rows", i) + 2 * oc if own
             else convert.zc_pe_at(kc.num_layers, width, kc.pe, i, 0))
    got = np.full((h, w, oc), np.iinfo(np.int64).min)
    j_n = ocp // 8
    # each thread's registers (warp, lane, 4 j + i) of each m-tile and
    # chunk, as the epilogue reads them: value v = 2 j' + e of group p of
    # chunk c is register 4 (p J + j') + 2 h + e for the row acc_row(warp,
    # lane, 2 h)
    for mt in range(rows // 64):
        for warp in range(4):
            for lane in range(32):
                tq = lane & 3
                d = [{(j, ii): acc[hc, mt * 64 + acc_row(warp, lane, ii), acc_col(j, lane, ii)]
                      for j in range(nc // 8) for ii in range(4)} for hc in range(chunks)]
                for hh in range(2):
                    r = mt * 64 + acc_row(warp, lane, 2 * hh)
                    y, x = r // iw, r % iw
                    if y >= ih - k + 1 or x >= iw - k + 1:
                        continue
                    for v in range(2 * j_n):
                        o = col_chan(acc_col(v >> 1, lane, v & 1), int(last))
                        if o >= oc:
                            continue
                        reg = lambda p: d[p // gc][((p % gc) * j_n + (v >> 1), 2 * hh + (v & 1))]
                        at = zc_at + (2 if last else 4) * tq + col_chan(
                            acc_col(v >> 1, 0, v & 1), int(last))
                        assert at == zc_at + o
                        start = [-int(kc.params[at + p * row_words]) if p < kc.pe else 0
                                 for p in range(groups)]
                        if split:
                            val = bias[o] - zc[o] + sum(
                                np.clip(reg(p) + start[p], -acc_hi - 1, acc_hi)
                                for p in range(groups))
                            if events is not None:
                                events[y, x] += sum(
                                    p < kc.pe and reg(p) + start[p] != np.clip(
                                        reg(p) + start[p], -acc_hi - 1, acc_hi)
                                    for p in range(groups))
                        else:
                            val = reg(0) + bias[o] - zc[o]
                        if kc.clamp20[i]:
                            val = np.clip(val, bias[o] - add_hi - 1, bias[o] + add_hi)
                        assert got[y, x, o] == np.iinfo(np.int64).min   # written once
                        got[y, x, o] = val
    return got


# the JAX sweep's configurations (tests/test_hwconfig_sweep.py ALT_CONFIGS)
ALT_HW = {"pe2_narrow": HardwareConfig(pe=2, pe_acc_bits=16, pe_add_bits=18, bias_bits=12,
                                       requant_bits=12, requant_n_max=24),
          "pe8_wide": HardwareConfig(pe=8, pe_acc_bits=20, pe_add_bits=22),
          "pe3_nondivisible": HardwareConfig(pe=3),
          "pe16": HardwareConfig(pe=16)}


def _alt_artifact(hw, width, in_ch, seed):
    """A random network ``width`` channels wide (3 convs of the sweep's
    nrdm-family shape, 1 or 3 input channels, 3 out) calibrated at ``hw``
    on the CPU, with half its hidden weights cut to a tenth so that some
    layers' clamps cannot fire and others can."""
    spec = SESRSpec("sweep", in_channels=in_ch, out_channels=3, num_channels=width,
                    num_lblocks=2)
    params = init_params(spec, torch.Generator().manual_seed(seed))
    ws = [w * (0.1 if j % 2 else 1.0) for j, w in enumerate(params.weights)]
    images = [np.random.default_rng(seed).random((1, 12, 16, in_ch), dtype=np.float32)]
    qp = calibrate(spec, CollapsedParams(ws, params.biases), images, hw=hw,
                   safe_zero_floor=True, device="cpu")
    return spec, qp


@pytest.mark.parametrize("split_of", ["proof", "all", "saturating"])
@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("config", list(ALT_HW))
def test_corrected_kernel_layers_at_other_configs(config, width, split_of):
    """The numpy model of the kernel at 2, 3, 8 and 16 PEs with the sweep's
    widths (16/18-bit accumulator / adder and a 12-bit bias at 2 PEs;
    20/22 at 8; at 16 a split hidden layer's 256 or 512 columns run in
    chunks of 128), for networks 8 (padded), 16 and 32 channels wide with 3 and
    1 input channels: the layers the corrected proof splits, or all of them,
    in the general instantiation (pe_groups column groups, the groups past
    the PE count zero; every sum clamped to pe_add_bits), each layer's
    y = bias + pe_add equal to the plain interpreter's with the same
    layers split; "saturating": every layer split, convs 0, 1 and 3 at
    +127, where conv 1's accumulator clamp fires (and at 8 PEs, whose
    eight 20-bit sums can pass 22 bits, its adder clamp)."""
    hw = ALT_HW[config]
    for in_ch, seed in ((3, 1), (1, 2)):
        spec, qp = _alt_artifact(hw, width, in_ch, seed)
        L = spec.num_convs
        if split_of == "saturating":
            qp = _all_127(qp, (0, 1, L - 1))
        split = (convert.corrected_split_layers(qp) if split_of == "proof" else (True,) * L)
        kc = convert.kernel_constants(spec, qp, "corrected", split)
        assert kc.general and kc.pe == hw.pe and kc.clamp20 == (True,) * L
        assert [pe_groups(p) for p in range(1, 17)] == [convert.pe_groups(p)
                                                        for p in range(1, 17)]
        x = np.random.default_rng(seed + 10).random((1, 6, 11, in_ch), dtype=np.float32)
        _, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True,
                                   fast_layers=tuple(not f for f in split), device="cpu")
        rng = np.random.default_rng(seed + 20)
        for i, k in enumerate(spec.kernel_sizes):
            x_q = dumps[f"input.{i}"][0].numpy().astype(np.int64)
            got = _kernel_layer_sums(qp, kc, i, k, x_q, qp.effective_zero(i), i == L - 1, rng)
            want = dumps[f"pe_add.{i}"][0].numpy().astype(np.int64) + np.clip(
                np.asarray(qp.bias_int[i], np.int64), -(1 << (hw.bias_bits - 1)),
                (1 << (hw.bias_bits - 1)) - 1)
            np.testing.assert_array_equal(got, want, err_msg=f"{config} {width} layer {i}")
        if split_of == "saturating":
            ovf = dumps["overflow_20" if hw.pe == 8 else "overflow_18"]
            assert ovf[1] > 0, (config, width, dumps["overflow_18"], dumps["overflow_20"])


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
    rng = np.random.default_rng(13)
    _, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True,
                               fast_layers=fast_layers, device="cpu")
    ovf18 = dumps["overflow_18"].tolist()
    for i, k in enumerate(spec.kernel_sizes):
        x_q = dumps[f"input.{i}"][0].numpy().astype(np.int64)
        events = np.zeros(x_q.shape[:2], np.int64)
        got = _kernel_layer_sums(qp, kc, i, k, x_q, qp.effective_zero(i), i == L - 1, rng,
                                 events)
        want = dumps[f"pe_add.{i}"][0].numpy().astype(np.int64) + np.clip(
            np.asarray(qp.bias_int[i], np.int64), -32768, 32767)
        np.testing.assert_array_equal(got, want, err_msg=f"{case} layer {i}")
        # the counting form's rule on the same registers: the plain count
        assert events.sum() == ovf18[i], (case, i)
    if case == "nr-saturating-hybrid":
        assert kc.clamp20[0] and not kc.pe_split[0] and kc.pe_split[L - 1]
        assert int((dumps["pe_add.0"] == ADD_HI).sum()) > 0 and ovf18[L - 1] > 0
    if case == "nr-saturating-pe-exact":
        assert kc.pe_split[0] and ovf18[0] > 0


M11 = SESRSpec("sesr_m11_x2", in_channels=3, out_channels=3, num_channels=16, num_lblocks=11,
               scaling_factor=2)
M5X4 = SESRSpec("sesr_m5_x4_rgb", in_channels=3, out_channels=3, num_channels=16, num_lblocks=5,
                scaling_factor=4)


def _m11_saturated(pe):
    """SESR-M11 x2 from seeded weights calibrated on the CPU at ``pe`` PEs,
    convs 3 and 9 at +127 as in chip_smoke.py phase 14, with the stamps its
    certificate gives at 4 PEs (convs 3, 4 and 9-11 unstamped)."""
    params = init_params(M11, torch.Generator().manual_seed(0))
    images = [np.random.default_rng(3).random((1, 24, 32, 3), dtype=np.float32)]
    qp = _all_127(calibrate(M11, params, images, hw=HardwareConfig(pe=pe), safe_zero_floor=True,
                            device="cpu"), (3, 9))
    stamps = tuple(i not in (3, 4, 9, 10, 11) for i in range(M11.num_convs))
    return dataclasses.replace(qp, fast_cert_layers=stamps, fast_cert_ok=False)


@pytest.mark.parametrize("pe", [4, 16])
@pytest.mark.parametrize("mode", MODES)
def test_corrected_kernel_layers_on_sesr_m11(mode, pe):
    """The model at SESR-M11 x2's 13 convs (Bhardwaj et al., MLSys 2022),
    seeded weights calibrated on the CPU, convs 3 and 9 at +127 as in
    chip_smoke.py phase 14: hybrid with the stamps its certificate gives
    there (convs 3, 4 and 9-11 unstamped, so split), pe-exact where the
    proof splits; every layer 0..12 equal to the plain interpreter's
    bias + pe_add, in the shipped instantiation at 4 PEs and at 16 PEs in
    the general one (16 column groups: a split hidden layer's 256 columns
    in two chunks of 128)."""
    spec = M11
    L = spec.num_convs
    qp = _m11_saturated(pe)
    stamps = qp.fast_cert_layers
    split = split_layers(qp, mode)
    kc = convert.kernel_constants(spec, qp, "corrected", split)
    assert kc.general == (pe != 4) and kc.pe_split == split and any(split)
    x = np.random.default_rng(14).random((1, 6, 11, 3), dtype=np.float32)
    _, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True,
                               fast_layers=stamps if mode == "hybrid" else None, device="cpu")
    rng = np.random.default_rng(15)
    for i, k in enumerate(spec.kernel_sizes):
        x_q = dumps[f"input.{i}"][0].numpy().astype(np.int64)
        got = _kernel_layer_sums(qp, kc, i, k, x_q, qp.effective_zero(i), i == L - 1, rng)
        want = dumps[f"pe_add.{i}"][0].numpy().astype(np.int64) + np.clip(
            np.asarray(qp.bias_int[i], np.int64), -32768, 32767)
        np.testing.assert_array_equal(got, want, err_msg=f"m11 {mode} {pe} PEs layer {i}")
    assert corrected_net.tile(spec, split, pe) in CORRECTED_TILES


@functools.lru_cache(maxsize=None)
def _xl_saturated(pe):
    """SESR-XL x2 from seeded weights calibrated on the CPU at ``pe`` PEs,
    convs 3 and 9 at +127 as in chip_smoke.py phase 14, with the stamps its
    certificate gives at 4 PEs (convs 3-5 and 7-10 unstamped)."""
    params = init_params(XL, torch.Generator().manual_seed(0))
    images = [np.random.default_rng(3).random((1, 24, 32, 3), dtype=np.float32)]
    qp = _all_127(calibrate(XL, params, images, hw=HardwareConfig(pe=pe), safe_zero_floor=True,
                            device="cpu"), (3, 9))
    stamps = tuple(i not in (3, 4, 5, 7, 8, 9, 10) for i in range(XL.num_convs))
    return dataclasses.replace(qp, fast_cert_layers=stamps, fast_cert_ok=False)


@pytest.mark.parametrize("pe", [4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_corrected_kernel_layers_on_sesr_xl(mode, pe):
    """The model at SESR-XL x2's 13 convs of 32 channels: two planes of 16
    bytes a pixel, one tap a k32 step (LBO the distance between the
    planes), 32 columns a PE group, and at 8 PEs a split hidden layer's 256
    columns in two chunks of 128 over the same A, the first chunk's clamped
    partials carried into the second's epilogue. Hybrid with the stamps of
    its certificate at 4 PEs, pe-exact where the proof splits; every layer
    0..12 equal to the plain interpreter's bias + pe_add."""
    qp = _xl_saturated(pe)
    L = XL.num_convs
    split = split_layers(qp, mode)
    kc = convert.kernel_constants(XL, qp, "corrected", split)
    assert kc.width == 32 and kc.pe == pe and (kc.general or pe == 4)
    assert split[3] and split[9] and any(split[1:L - 1])
    x = np.random.default_rng(14).random((1, 6, 11, 3), dtype=np.float32)
    _, dumps = integer_forward(XL, qp, x, collect_dumps=True, corrected=True,
                               fast_layers=qp.fast_cert_layers if mode == "hybrid" else None,
                               device="cpu")
    rng = np.random.default_rng(15)
    ovf18 = dumps["overflow_18"].tolist()
    for i, k in enumerate(XL.kernel_sizes):
        x_q = dumps[f"input.{i}"][0].numpy().astype(np.int64)
        events = np.zeros(x_q.shape[:2], np.int64)
        got = _kernel_layer_sums(qp, kc, i, k, x_q, qp.effective_zero(i), i == L - 1, rng,
                                 events)
        want = dumps[f"pe_add.{i}"][0].numpy().astype(np.int64) + np.clip(
            np.asarray(qp.bias_int[i], np.int64), -32768, 32767)
        np.testing.assert_array_equal(got, want, err_msg=f"xl {mode} {pe} PEs layer {i}")
        # the counting form's rule, past four PEs over both chunks
        assert events.sum() == ovf18[i], (mode, pe, i)
    # a split hidden layer runs 128 or 2 x 128 columns
    assert convert.wgmma_geometry(3, 32, 32, True, False, pe)[2] == 32 * convert.pe_groups(pe)
    assert int(dumps["overflow_18"][3]) > 0


def _pieces_of(spec, kc, tile):
    """Per layer, whether the kernel stages its B in pieces at ``tile``: the
    plan's choice (corrected_plan), on the layers of more than one piece."""
    L = spec.num_convs
    plan = corrected_plan(L, spec.in_channels, spec.conv_out_channels, tile, kc.pe_split, kc.pe,
                          kc.width, kc.general)
    assert plan.bytes <= SMEM_LIMIT
    return plan, [plan.pieces and layer_pieces(
        k, spec.in_channels if i == 0 else kc.width,
        spec.conv_out_channels if i == L - 1 else kc.width, kc.pe_split[i], i == L - 1,
        kc.pe)[0] > 1 for i, k in enumerate(spec.kernel_sizes)]


@pytest.mark.parametrize("split_of", ["conv12", "all"])
def test_corrected_kernel_layers_on_sesr_xl_at_16_pes(split_of):
    """SESR-XL at 16 PEs with a split conv, which no tile holds with a
    layer's B whole (conv 12's B alone is 25 steps x 256 columns x 32 B):
    the plan stages the split layers' B in pieces at 16x16 (two regions of
    the largest piece with conv 12 split, one with every conv split), a
    split hidden layer's 512 columns in four chunks of 128, each one piece
    of its 9 steps, the last conv's 256 in two chunks in five pieces of 5
    steps. The model, each piece copied into a region as piece_src maps
    it, gives every layer 0..12 equal to the plain interpreter's bias +
    pe_add with only conv 12 split and with every conv split, and the
    counting form's rule the plain overflow_18."""
    qp = _xl_saturated(16)
    L = XL.num_convs
    split = tuple(i == 12 for i in range(L)) if split_of == "conv12" else (True,) * L
    kc = convert.kernel_constants(XL, qp, "corrected", split)
    assert kc.general and kc.pe == 16 and kc.pe_split == split
    tile = corrected_net.tile(XL, split, 16, True)
    plan, pieces = _pieces_of(XL, kc, tile)
    assert tile == (16, 16) and plan.pieces and plan.regions == (2 if split_of == "conv12" else 1)
    assert pieces == [f and i > 0 for i, f in enumerate(split)]
    assert layer_pieces(5, 32, 12, True, True, 16) == (2 * 5, 5 * 128 * 32)
    assert layer_pieces(3, 32, 32, True, False, 16) == (4 * 1, 9 * 128 * 32)
    # a tile with conv 12's B whole needs more than a block
    whole = corrected_plan(L, 3, 12, (8, 8), split, 16, 32, False)
    assert whole.bytes > SMEM_LIMIT and not whole.pieces
    x = np.random.default_rng(16).random((1, 6, 11, 3), dtype=np.float32)
    _, dumps = integer_forward(XL, qp, x, collect_dumps=True, corrected=True,
                               fast_layers=tuple(not f for f in split), device="cpu")
    rng = np.random.default_rng(17)
    ovf18 = dumps["overflow_18"].tolist()
    for i, k in enumerate(XL.kernel_sizes):
        x_q = dumps[f"input.{i}"][0].numpy().astype(np.int64)
        events = np.zeros(x_q.shape[:2], np.int64)
        got = _kernel_layer_sums(qp, kc, i, k, x_q, qp.effective_zero(i), i == L - 1, rng,
                                 events, pieces=pieces[i])
        want = dumps[f"pe_add.{i}"][0].numpy().astype(np.int64) + np.clip(
            np.asarray(qp.bias_int[i], np.int64), -32768, 32767)
        np.testing.assert_array_equal(got, want, err_msg=f"xl {split_of} 16 PEs layer {i}")
        assert events.sum() == (ovf18[i] if split[i] else 0), (split_of, i)
    if split_of == "all":
        assert ovf18[3] > 0 and ovf18[9] > 0


XL48 = SESRSpec("sesr_xl_x4_rgb", in_channels=3, out_channels=3, num_channels=32,
                num_lblocks=11, scaling_factor=4)


@functools.lru_cache(maxsize=None)
def _xl48_saturated(pe):
    """SESR-XL at x4 on RGB (48 outputs) from seeded weights calibrated on
    the CPU at ``pe`` PEs, its last conv at +127."""
    params = init_params(XL48, torch.Generator().manual_seed(0))
    images = [np.random.default_rng(3).random((1, 24, 32, 3), dtype=np.float32)]
    return _all_127(calibrate(XL48, params, images, hw=HardwareConfig(pe=pe),
                              safe_zero_floor=True, device="cpu"), (XL48.num_convs - 1,))


@pytest.mark.parametrize("pe", [4, 8, 16])
def test_corrected_model_at_xl_width_and_48_outputs(pe):
    """A last conv of 48 channels at width 32, every conv split: its bias,
    zero and per-PE zero rows past the record's 32 (the block's own rows,
    R_ROWS), 48 columns a PE group in chunks of two groups (96 columns, a
    wgmma N), its B in pieces at 4, 8 and 16 PEs, and at 16 every split
    layer's past layer 0 (the plan at the wrapper's tile: the 16x16 tile,
    two regions of the largest piece at 4 PEs, one at 8 and 16). The
    model's sums equal the plain
    interpreter's bias + pe_add on every layer, and its counting rule the
    plain overflow_18 (the +127 last conv fires the 18-bit clamp)."""
    qp = _xl48_saturated(pe)
    L = XL48.num_convs
    split = (True,) * L
    kc = convert.kernel_constants(XL48, qp, "corrected", split)
    assert kc.general and kc.width == 32 and kc.pe == pe
    assert kc.param("out", L - 1) == 48 and kc.param("rows", L - 1) == convert.param_words(pe, L, 32)
    assert convert.wgmma_geometry(5, 32, 48, True, True, pe)[1:] == (
        convert.pe_groups(pe), 48 * convert.pe_groups(pe))
    tile = corrected_net.tile(XL48, split, pe, True)
    plan, pieces = _pieces_of(XL48, kc, tile)
    assert tile == (16, 16) and plan.pieces and plan.regions == (2 if pe == 4 else 1)
    assert pieces == [i == L - 1 or (pe == 16 and i > 0) for i in range(L)]
    x = np.random.default_rng(48).random((1, 6, 11, 3), dtype=np.float32)
    _, dumps = integer_forward(XL48, qp, x, collect_dumps=True, corrected=True, device="cpu")
    rng = np.random.default_rng(49)
    ovf18 = dumps["overflow_18"].tolist()
    for i, k in enumerate(XL48.kernel_sizes):
        x_q = dumps[f"input.{i}"][0].numpy().astype(np.int64)
        events = np.zeros(x_q.shape[:2], np.int64)
        got = _kernel_layer_sums(qp, kc, i, k, x_q, qp.effective_zero(i), i == L - 1, rng,
                                 events, pieces=pieces[i])
        want = dumps[f"pe_add.{i}"][0].numpy().astype(np.int64) + np.clip(
            np.asarray(qp.bias_int[i], np.int64), -32768, 32767)
        np.testing.assert_array_equal(got, want, err_msg=f"xl48 {pe} PEs layer {i}")
        assert events.sum() == ovf18[i], (pe, i)
    assert ovf18[L - 1] > 0


def test_k1_takes_a_48_output_xl_at_16_pes_in_one_group():
    """The corner K1 refused until the layer-group form: at 16 PEs K1 runs a
    split conv in 16 passes, and SESR-XL x4's split last conv of 48 columns
    fits no tile of the one-launch kernel beside its buffers (not even
    8x8). K1 now plans it as one group of csrc/sesr_net_group.cu, that
    conv's B staged one PE pass at a time (net_group_smem_bytes), at a tile
    that fits; K2 and the corrected kernel take it in one launch."""
    qp = _xl48_saturated(16)
    L = XL48.num_convs
    kc = convert.kernel_constants(XL48, qp, "exact")
    split = convert.pe_split_layers(qp)
    assert split[L - 1] and kc.pe_split == split and kc.general
    assert net_smem_bytes("exact", L, 3, 48, (8, 8), split, 16, True, 32) > SMEM_LIMIT
    (g, tile, need), = pe_exact_net.launch_plans(XL48, kc)
    assert (g.first, g.last, g.flags) == (0, L - 1, convert.GROUP_FIRST | convert.GROUP_LAST)
    assert need == net_group_smem_bytes("exact", L, 3, 3, 48, tile, split, 16, 32) <= SMEM_LIMIT
    assert not convert.kernel_constants(XL48, qp, "fast").groups
    assert convert.kernel_constants(XL48, qp, "fast").general
    assert convert.kernel_constants(XL48, qp, "corrected", (True,) * L).general


def _tiled_counts(spec, qp, x, regions):
    """The corrected kernel's counting form (sesr_corrected_audit) in the
    PE-exact mode, modelled tile by tile: per region (y0, y1, x0, x1) and
    layer, the PE partials that the 18-bit clamp changes. The frame is cut
    into the tiles of the wrapper's plan; on each split layer a tile
    computes every PE's partial conv(q - z_eff) over its output extent
    (its core and the ring r of the convs after it) from the layer's input
    over that extent and k // 2 more, z_eff outside the image (the plain
    interpreter's input dumps inside it), and counts those in the window
    count_lo .. count_hi of the source: the core, inside the image and the
    region. Returns (counts (regions, L), the plain overflow_18, tile)."""
    L = spec.num_convs
    split = split_layers(qp, "pe-exact")
    kc = convert.kernel_constants(spec, qp, "corrected", split)
    tile, _ = corrected_net.plan(spec, kc.pe_split, kc.pe, kc.general)
    th, tw = tile
    acc_hi = (1 << (qp.hw.pe_acc_bits - 1)) - 1
    _, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True, device="cpu")
    n, H, W, _ = x.shape
    counts = np.zeros((len(regions), L), np.int64)
    for i, k in enumerate(spec.kernel_sizes):
        if not split[i]:
            continue
        r_out = sum(kk // 2 for kk in spec.kernel_sizes[i + 1:])
        r_in = r_out + k // 2
        z = qp.effective_zero(i)
        x_q = dumps[f"input.{i}"].numpy().astype(np.float64)
        pad = r_in + max(th, tw)                    # past the last ragged tile's extent
        shifted = np.pad(x_q, ((0, 0), (pad, pad), (pad, pad), (0, 0)), constant_values=z) - z
        w = np.asarray(qp.w_int[i], np.float64)
        for oy0 in range(0, H, th):
            for ox0 in range(0, W, tw):
                ext = torch.from_numpy(shifted[:, pad + oy0 - r_in:pad + oy0 + th + r_in,
                                               pad + ox0 - r_in:pad + ox0 + tw + r_in])
                events = 0
                for p in range(qp.hw.pe):
                    m = pe_channel_mask(w.shape[2], qp.hw.pe, p)
                    if not m.any():
                        continue
                    part = torch.nn.functional.conv2d(
                        ext[..., m].permute(0, 3, 1, 2),
                        torch.from_numpy(w[:, :, m].transpose(3, 2, 0, 1).copy()))
                    events = events + ((part > acc_hi) | (part < -acc_hi - 1)).numpy()
                for j, (y0, y1, x0, x1) in enumerate(regions):
                    ylo, yhi = count_lo(oy0, r_out, y0), count_hi(oy0, th, r_out, H, y1)
                    xlo, xhi = count_lo(ox0, r_out, x0), count_hi(ox0, tw, r_out, W, x1)
                    if ylo < yhi and xlo < xhi:         # (a negative bound would wrap)
                        counts[j, i] += events[:, :, ylo:yhi, xlo:xhi].sum()
    return counts, dumps["overflow_18"].numpy(), tile


@pytest.mark.parametrize("case", ["nr-adversarial", "xl-pe4", "xl-pe8", "m11-pe16"])
def test_counting_form_counts_each_output_once(case):
    """The counting form's count window (count_lo / count_hi, read from the
    source) over the tiles of the wrapper's plan, on a frame whose sides
    are no multiple of the tile: the tiles' counts add up to the plain
    interpreter's overflow_18 on every layer (so no halo output is counted
    twice and none is missed), with the whole frame as one region and as
    the sum over 2 and 4 W blocks given as regions. nr: the adversarial
    frame (layer 0 fires); the saturated SESR-XL at 4 and 8 PEs (past four
    PEs the tile is 8x16) and SESR-M11 at 16, each frame at least two tiles
    a side."""
    from sesr_tpu_torch.ops.slab import blocks
    from sesr_tpu_torch.quant.certify import adversarial_image

    if case == "nr-adversarial":
        spec, qp = _artifact("nr")
        qp = dataclasses.replace(qp, fast_cert_layers=None)
        x = adversarial_image(qp, hw=(70, 150))
    elif case == "m11-pe16":
        spec, qp = M11, _m11_saturated(16)
        x = np.random.default_rng(10).random((1, 45, 83, 3), dtype=np.float32)
    else:
        spec, qp = XL, _xl_saturated(int(case[-1]))
        x = np.random.default_rng(10).random((2, 19, 37, 3), dtype=np.float32)
    H, W = x.shape[1:3]
    regions = [(0, H, 0, W)] + [(0, H, a, b) for n in (2, 4) for a, b in blocks(W, n)]
    counts, want, tile = _tiled_counts(spec, qp, x, regions)
    assert H % tile[0] and W % tile[1] and H > tile[0] and W > tile[1], tile
    np.testing.assert_array_equal(counts[0], want)
    np.testing.assert_array_equal(counts[1:3].sum(axis=0), want)
    np.testing.assert_array_equal(counts[3:].sum(axis=0), want)
    assert want.any() and (want[0] > 0 if case == "nr-adversarial" else want[3] > 0)
    # a region past the frame counts nothing
    assert not _tiled_counts(spec, qp, x, [(0, H, W, W)])[0].any()


@pytest.mark.parametrize("width", [16, 32])
def test_accumulator_map_gives_a_thread_one_word_of_a_pixel(width):
    """wgmma's fragment (acc_row / acc_col) through the hidden layers'
    column permutation (col_chan): the four values a thread holds for one
    row in n-tiles 2w and 2w + 1 are channels 16w + 4 tq .. 16w + 4 tq + 3
    in byte order, so its 32-bit store at word (pixel * 4 + tq) of plane w
    is that word of the next layer's input (width 16: one plane, width 32:
    two), and the 32 lanes of a warp store 32 consecutive words of a plane
    (8 pixels, no bank conflict). The last layer keeps the columns in order.
    Over every warp, lane and register the fragment covers the 64 x N tile
    once, at every N a layer uses."""
    for n_cols in (8, 16, 24, 32, 48, 64, 96, 128):
        seen = np.zeros((64, n_cols), int)
        for warp in range(4):
            for lane in range(32):
                for j in range(n_cols // 8):
                    for i in range(4):
                        seen[acc_row(warp, lane, i), acc_col(j, lane, i)] += 1
        assert (seen == 1).all(), n_cols
    for warp in range(4):
        for h in range(2):
            words = []
            for lane in range(32):
                tq = lane & 3
                row = acc_row(warp, lane, 2 * h)
                assert row == 16 * warp + (lane >> 2) + 8 * h
                chans = [col_chan(acc_col(v >> 1, lane, v & 1), 0) for v in range(width // 4)]
                assert chans == [16 * (v // 4) + 4 * tq + v % 4 for v in range(width // 4)]
                assert [col_chan(acc_col(v >> 1, lane, v & 1), 1) for v in range(12)] == \
                    [8 * (v >> 1) + 2 * tq + (v & 1) for v in range(12)]
                words.append((row - 16 * warp - 8 * h) * 4 + tq)
            assert sorted(words) == list(range(32))
    assert sorted(col_chan(n, 0) for n in range(width)) == list(range(width))
    # the epilogue stores value 4 w + b of the thread's word of plane w at
    # byte b (pack_bytes), the planes next_plane words apart
    assert "int* word = kept ? next + w * next_plane + (y * ow + x) * 4 + tq : scratch;" in SRC
    assert ("*word = inside ? pack_bytes(v[4 * w], v[4 * w + 1], v[4 * w + 2], v[4 * w + 3]) "
            ": pad_next;") in SRC
    np.testing.assert_array_equal(convert._wgmma_columns(width, False),
                                  [col_chan(n, 0) for n in range(width)])
    np.testing.assert_array_equal(convert._wgmma_columns(12, True),
                                  [n if n < 12 else -1 for n in range(16)])
    np.testing.assert_array_equal(convert._wgmma_columns(3, True), [0, 1, 2] + [-1] * 5)
    # a last layer past 16 channels: 32 or 48 columns a group, in order,
    # and its chunks whole groups whose N wgmma takes (s8: 8, 16, 24, 32,
    # 48, 64, 80, ... 256)
    for oc, cols in ((1, 8), (4, 8), (9, 16), (17, 32), (27, 32), (33, 48), (48, 48)):
        np.testing.assert_array_equal(convert._wgmma_columns(oc, True),
                                      [n if n < oc else -1 for n in range(cols)])
        for groups in (1, 4, 8, 16):
            gc = chunk_groups(groups, cols)
            assert groups % gc == 0 and gc * cols <= 128 and gc * cols in (
                8, 16, 24, 32, 48, 64, 80, 96, 112, 128), (oc, groups, gc)
            assert gc == groups or (gc * cols > 64 and 2 * gc * cols > 128)


def _xl_weights(pe, out=12):
    """SESR-XL x2 and seeded int8 weights of its 13 convs (3 -> 32 -> ... ->
    12), or of its layers with a last conv of ``out`` channels."""
    spec = XL
    rng = np.random.default_rng(pe)
    chans = [3] + [32] * 12 + [out]
    w = [rng.integers(-127, 128, (k, k, chans[i], chans[i + 1])).astype(np.int8)
         for i, k in enumerate(spec.kernel_sizes)]
    return spec, w


@pytest.mark.parametrize("task", TASKS + ("xl-pe4", "xl-pe8", "xl-pe16", "xl48-pe16", "xl27-pe8"))
def test_wgmma_b_holds_each_weight_once(task):
    """convert.py's B for the corrected kernel, read back through the
    source's b_byte: every weight of every layer sits once, in the column
    group of its PE on a split layer (layer 0: of its input channel), at the
    k byte of its tap and channel (layer 0: 4 taps of a widened pixel in
    each 16-byte half; a 32-channel layer: one tap a step, channels 0-15 in
    the first half and 16-31 in the second); everything else is zero. On the
    shipped artifacts, and on seeded SESR-XL weights at 4, 8 and 16 PEs
    (32, 256 or 512 columns a split hidden layer), also with a last conv of
    48 channels (48 columns a group) at 16 PEs and of 27 (32 columns, five
    past the channels zero) at 8."""
    if task.startswith("xl"):
        head, pe = task.split("-pe")
        pe = int(pe)
        spec, w_int = _xl_weights(pe, int(head[2:] or 12))
        splits = ((True,) * spec.num_convs, (False,) * spec.num_convs)
    else:
        spec, qp = _artifact(task)
        w_int, pe = qp.w_int, qp.hw.pe
        splits = (convert.corrected_split_layers(qp), (True,) * spec.num_convs,
                  (False,) * spec.num_convs)
    L = spec.num_convs
    for split in splits:
        for i, w in enumerate(w_int):
            w = np.asarray(w, np.int64)
            k, _, ic, oc = w.shape
            last = i == L - 1
            steps, groups, n_cols = convert.wgmma_geometry(k, ic, oc, split[i], last, pe)
            g = n_cols // groups
            raw = convert._wgmma_b_words(w, split[i], pe, last).view(np.int8)
            assert raw.size == steps * n_cols * 32
            rebuilt = np.zeros_like(w)
            seen = np.zeros(w.shape, int)
            for s in range(steps):
                for n in range(n_cols):
                    o = col_chan(n % g, int(last))
                    for kb in range(32):
                        val = int(raw[b_byte(s, n, kb, n_cols)])
                        hh, b = kb >> 4, kb & 15
                        if i == 0:
                            dy, dx, ch = s, 4 * hh + b // 4, b % 4
                            ok = dx < k and ch < ic
                        elif ic == 16:
                            tap = 2 * s + hh
                            dy, dx, ch = tap // k, tap % k, b
                            ok = tap < k * k
                        else:
                            dy, dx, ch = s // k, s % k, kb
                            ok = True
                        owner = ch % pe if split[i] else 0
                        if not ok or o >= oc or owner != n // g:
                            assert val == 0, (task, i, s, n, kb)
                            continue
                        rebuilt[dy, dx, ch, o] += val
                        seen[dy, dx, ch, o] += 1
            np.testing.assert_array_equal(rebuilt, w, err_msg=f"{task} layer {i}")
            assert (seen == 1).all()


def test_smem_plan_and_its_limit():
    """The wrapper's shared-memory plan (kernels.corrected_smem_bytes,
    csrc/sesr_corrected.cu smem_plan; chip_smoke.py checks the two agree on
    the card) gives the bytes the source note states, grows with the tile,
    and a tile beyond a block's shared memory is refused before any build
    or launch."""
    assert (CONST["kSmemLimit"], CONST["kRows"], CONST["kPix"]) == (SMEM_LIMIT, 64, 16)
    nr, nr_qp = _artifact("nr")
    hybrid = split_layers(nr_qp, "hybrid")
    assert corrected_smem_bytes(5, 3, 3, (32, 64), hybrid, 4) == 213008
    assert "213,008 bytes for nr at 32x64" in SRC
    sizes = [corrected_smem_bytes(5, 3, 3, t, hybrid, 4) for t in ((16, 16), (32, 32), (32, 64))]
    assert sizes == sorted(sizes)
    assert corrected_smem_bytes(5, 3, 3, (48, 64), hybrid, 4) > SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        corrected_net.check_tile(nr, (48, 64), hybrid, 4)
    corrected_net.check_tile(nr, (32, 64), hybrid, 4)
    # width 16 holds every layer's B (no regions) up to four PEs, width 32
    # and past four PEs stage it: two regions (even and odd layers) where
    # they fit, else one; past that, in the general instantiation, in
    # pieces (two regions of the largest piece where they fit, else one)
    assert corrected_plan(5, 3, 3, (32, 64), hybrid, 4) == (213008, 0, False)
    L = XL.num_convs
    xl_hybrid = tuple(i in (3, 4, 5, 7, 8, 9, 10) for i in range(L))
    conv12 = tuple(i == 12 for i in range(L))
    want = {(xl_hybrid, 4): ((16, 16), 2, False), ((True,) * L, 4): ((16, 16), 1, False),
            (xl_hybrid, 8): ((16, 16), 1, False), ((True,) * L, 8): ((8, 16), 1, False),
            ((False,) * L, 4): ((16, 32), 2, False), (xl_hybrid, 16): ((16, 16), 1, True),
            ((True,) * L, 16): ((16, 16), 1, True), (conv12, 16): ((16, 16), 2, True)}
    for (split, pe), (tile, bufs, pieces) in want.items():
        general = pe != 4
        assert corrected_net.tile(XL, split, pe, general) == tile
        need, regions, in_pieces = corrected_plan(L, 3, 12, tile, split, pe, 32, general)
        assert (regions, in_pieces) == (bufs, pieces) and need <= SMEM_LIMIT
        assert corrected_net.smem_bytes(XL, tile, split, pe, general) == need
        if pieces:
            # not even one region of the largest layer's B fits at any tile,
            # and the shipped instantiation has no pieces
            assert all(corrected_plan(L, 3, 12, t, split, pe, 32).bytes > SMEM_LIMIT
                       for t in CORRECTED_TILES)
            continue
        # two regions hold the largest even and the largest odd layer's B
        # (rounded up), one the largest layer's: the plans differ by that
        b = [convert.wgmma_geometry(k, 3 if i == 0 else 32, 12 if i == L - 1 else 32, split[i],
                                    i == L - 1, pe) for i, k in enumerate(XL.kernel_sizes)]
        b = [s * n * 32 for s, _, n in b]
        two = -(-max(b[0::2]) // 128) * 128 + max(b[1::2])
        if regions == 1:
            assert need - max(b) + two > SMEM_LIMIT
    # XL at 16 PEs, conv 12 split (25 steps x 256 columns x 32 B = 204,800
    # B): the room B leaves at 8x16 and 16x16, and its pieces fit it
    b12 = 25 * 256 * 32
    unit = layer_pieces(5, 32, 12, True, True, 16)[1]
    for tile, total, room in (((8, 16), 338192, 99056), ((16, 16), 370960, 66288)):
        whole = corrected_plan(L, 3, 12, tile, conv12, 16, 32)
        assert (whole.bytes, whole.regions, SMEM_LIMIT - (whole.bytes - b12)) == (total, 1, room)
        assert b12 > room >= -(-unit // 128) * 128 + unit
    # a 48-output network (SESR-M5's widths, RGB at scale 4) with a split
    # last layer: 13 steps x G x 48 columns x 32 B, resident at 4 PEs,
    # staged a layer at a time at 8 (a smaller tile before pieces), in
    # pieces at 16
    for pe, (tile, regions, pieces) in {4: ((32, 32), 0, False), 8: ((16, 16), 2, False),
                                        16: ((32, 48), 1, True)}.items():
        split = (False,) * 6 + (True,)
        assert corrected_net.tile(M5X4, split, pe, True) == tile, pe
        plan = corrected_plan(7, 3, 48, tile, split, pe, 16, True)
        assert (plan.regions, plan.pieces) == (regions, pieces) and plan.bytes <= SMEM_LIMIT


def test_ab_variants_apply_to_the_source():
    """Every edit of ``python -m sesr_tpu_torch.corrected_ab --variants``
    finds its text in csrc/sesr_corrected.cu exactly once, so a variant
    differs from the kernel only as its name says."""
    from sesr_tpu_torch import corrected_ab

    for name, edits in corrected_ab.VARIANTS.items():
        for text, _ in edits:
            assert SRC.count(text) == 1, (name, text)


def test_ab_tree_worker_reports_ptxas(monkeypatch, tmp_path):
    """``corrected_ab --base``: each tree's worker returns its libraries'
    build logs, and ``run_tree`` reads them with ``_build.ptxas_report``
    into one report per kernel instantiation."""
    import json
    import subprocess

    from sesr_tpu_torch import corrected_ab
    from tests.test_torch_probes import PTXAS_LOG

    def worker(cmd, cwd, **_kw):
        assert cmd[1:3] == ["-c", corrected_ab.WORKER] and cwd == tmp_path
        out = {"device": "card", "nr hybrid": {"ms": 1.0, "digest": "d"},
               "build_logs": {lib: PTXAS_LOG for lib in corrected_ab.PTXAS_FAMILIES}}
        return subprocess.CompletedProcess(cmd, 0, stdout=json.dumps(out) + "\n", stderr="")

    monkeypatch.setattr(subprocess, "run", worker)
    monkeypatch.setattr(corrected_ab, "artifact", lambda net: tmp_path / f"{net}.npz")
    got = corrected_ab.run_tree(tmp_path, 3)
    assert got["ptxas"] == {"sesr_net_kernel<Li1ELi16ELb0ELi32>": [128, 4],
                            "sesr_corrected_kernel<Li4ELb0>": [90, 0]}
    assert "build_logs" not in got and got["nr hybrid"]["digest"] == "d"
