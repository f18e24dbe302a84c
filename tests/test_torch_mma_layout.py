"""A numpy model of the fused kernels' tensor-core operand mapping
(sesr_tpu_torch/csrc/sesr_net.cu conv_layer). One layer runs as an
implicit GEMM of mma.sync.m16n8k32.row.col s8 x s8 -> s32: the A registers
of lane 4g + t are activation words read from the planar input buffers at
the kernel's offsets, the B registers come from convert.py's
fragment-ordered weight words, and the accumulators go back to (pixel,
channel) as the kernel's epilogue reads them. Every layer's per-PE
partials (the split form, which K1 runs where its 18-bit clamp can fire)
and full sums (the one-pass form of K2, and of K1 elsewhere) must equal
the plain version's exact integer conv (quant/integer.py ``_conv_int``)
on the PE's channels or on all of them, for every instantiation the
kernels build: sr_x2 (3 in, 12 out), sr_x4 (1 in, 16 out), nrdm_3 (3
out) and nrdm_6 (8 convs), at an extent whose pixel count is no multiple
of 16; at 2, 3, 8 and 16 PEs, for networks 8 (padded) and 16 channels
wide; and on the SESR paper's deepest and widest members, SESR-M11 (13
convs, 16 channels) and SESR-XL (13 convs, 32 channels: eight activation
words a pixel), at 4 PEs and at 2, 3, 8 and 16."""

import dataclasses
import functools
import importlib.util
import os

import numpy as np
import pytest
import torch

from sesr_tpu_torch import convert
from sesr_tpu_torch.config import SESRSpec, spec_for_task
from sesr_tpu_torch.quant.integer import _conv_int, integer_forward, pe_channel_mask
from sesr_tpu_torch.quant.params import QuantParams

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), os.pardir, "artifacts")
EXTENT = (5, 11)            # a layer's output extent: 55 pixels, 3 sixteens and 7


def _bytes(words):
    """int32 words (...) -> signed bytes (..., 4), byte 0 first."""
    return np.ascontiguousarray(words, np.int32).view(np.int8).reshape(np.shape(words) + (4,))


def _mma(a, b):
    """One warp's mma.sync.m16n8k32.row.col.s32.s8.s8.s32 (PTX ISA fragment
    layouts). a: (32, 4) A registers, b: (32, 2) B registers of lanes
    4g + t. Returns (32, 4): c0, c1 at row g, columns 2t, 2t+1; c2, c3 at
    row g + 8."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    ab, bb = _bytes(a), _bytes(b)
    g, t = np.arange(32) // 4, np.arange(32) % 4
    k = 4 * t[:, None] + np.arange(4)                       # (lane, byte)
    A[g[:, None], k] = ab[:, 0]
    A[g[:, None] + 8, k] = ab[:, 1]
    A[g[:, None], k + 16] = ab[:, 2]
    A[g[:, None] + 8, k + 16] = ab[:, 3]
    B[k, g[:, None]] = bb[:, 0]
    B[k + 16, g[:, None]] = bb[:, 1]
    C = A @ B
    return np.stack([C[g, 2 * t], C[g, 2 * t + 1], C[g + 8, 2 * t], C[g + 8, 2 * t + 1]], -1)


def _plane_stride(n):
    return ((n + 23) & ~31) + 8


def _pack(q):
    """Planar activation words of an int8 (h, w, ic) extent, as the
    kernel's buffers hold them: one plane (channel c in byte c) for ic <= 4,
    else ic / 4 planes, word p holding channels p % 4 + 16 (p // 4) + 4 j in
    byte j (16 channels: p, p+4, p+8, p+12)."""
    h, w, ic = q.shape
    if ic <= 4:
        b = np.zeros((h * w, 4), np.int8)
        b[:, :ic] = q.reshape(h * w, ic)
        return b.view(np.int32).reshape(-1), 0
    ps = _plane_stride(h * w)
    words = np.zeros(ic // 4 * ps, np.int32)
    for p in range(ic // 4):
        chans = p % 4 + 16 * (p // 4) + 4 * np.arange(4)
        b = np.ascontiguousarray(q.reshape(h * w, ic)[:, chans])
        words[p * ps:p * ps + h * w] = b.view(np.int32).reshape(-1)
    return words, ps


def _model_layer(words, ps, frag, k, ic, oc, split, last, eh, ew, pe=4):
    """Per-pass int32 sums (pass, eh * ew, oc) of one layer, through the
    kernel's A offsets, the B fragments and the MMA model. Returns them
    and the number of MMAs issued."""
    npass, chunks, tap_major = convert.layer_geometry(k, ic, split, pe)
    wpt = convert.words_per_tap(ic, split, pe)
    nt = -(-oc // 8)
    frag = frag.reshape(npass, chunks, 32, nt, 2)
    kk, iw, npix = k * k, ew + k - 1, eh * ew
    g, t = np.arange(32) // 4, np.arange(32) % 4

    def off(tap):
        return np.where(tap < kk, (tap // k) * iw + tap % k, 0)

    out = np.zeros((npass, npix, oc), np.int64)
    mmas = 0
    for mt in range(-(-npix // 16)):
        rows = mt * 16 + g[:, None] + 8 * np.arange(2)             # (lane, g / g + 8)
        rc = np.minimum(rows, npix - 1)
        base = (rc // ew) * iw + rc % ew
        for p in range(npass):
            acc = np.zeros((32, nt, 4), np.int64)
            for c in range(chunks):
                # k-slot s: k word 8 c + s, the pass's word (8 c + s) % wpt
                # (tap-major: word p % 4 + 4 j is j) of tap (8 c + s) // wpt
                # (8 / wpt taps a chunk; at 16 words a tap, two chunks a tap)
                def slot(s):
                    j = (8 * c + s) % wpt
                    plane = (p % 4 + 4 * j if ic > 4 else 0) if tap_major else j
                    return plane * ps + off((8 * c + s) // wpt)
                oa, ob = slot(t), slot(t + 4)
                a = np.stack([words[base[:, 0] + oa], words[base[:, 1] + oa],
                              words[base[:, 0] + ob], words[base[:, 1] + ob]], -1)
                for n in range(nt):
                    acc[:, n] += _mma(a, frag[p, c, :, n])
                    mmas += 1
            for n in range(nt):
                for i in range(4):
                    # the kernel's epilogue: a hidden layer's lane t holds
                    # channel t + 4j in accumulator (n, i), j = 2n + (i & 1)
                    # (byte j & 3 of word t + 4 (j >> 2)); the last layer's n-tile n, column
                    # 2t + (i & 1) is channel 8n + 2t + (i & 1)
                    r = rows[:, i // 2]
                    o = 8 * n + 2 * t + (i & 1) if last else t + 4 * (2 * n + (i & 1))
                    ok = (r < npix) & (o < oc)
                    out[p, r[ok], o[ok]] = acc[ok, n, i]
    return out, mmas


def _valid_conv(q, w):
    """The plain version's exact integer conv, cropped to the valid extent."""
    k = w.shape[0]
    y = _conv_int(torch.from_numpy(q[None].astype(np.float64)), w)[0].numpy()
    return y[k // 2:y.shape[0] - k // 2, k // 2:y.shape[1] - k // 2]


def _artifact(task):
    return spec_for_task(task), QuantParams.load(
        os.path.join(ARTIFACT_DIR, f"qparams_{task}.npz"))


@pytest.mark.parametrize("split", [True, False], ids=["per-PE", "one-pass"])
@pytest.mark.parametrize("task", ["sr_x2", "sr_x4", "nrdm_3", "nrdm_6"])
def test_mma_fragments_compute_the_layer_convs(task, split):
    spec, qp = _artifact(task)
    L = spec.num_convs
    rng = np.random.default_rng(7)
    eh, ew = EXTENT
    for i, w in enumerate(qp.w_int):
        w = np.asarray(w)
        k, _, ic, oc = w.shape
        q = rng.integers(-128, 128, size=(eh + k - 1, ew + k - 1, ic)).astype(np.int8)
        words, ps = _pack(q)
        frag = convert._fragment_words(w, split, qp.hw.pe, last=i == L - 1)
        got, mmas = _model_layer(words, ps, frag, k, ic, oc, split, i == L - 1, eh, ew)
        got = got.reshape(-1, eh, ew, oc)
        if split:                               # one pass per PE
            want = [_valid_conv(q[..., m], w[:, :, m, :])
                    for m in (pe_channel_mask(ic, qp.hw.pe, p) for p in range(qp.hw.pe))
                    if m.any()]
        else:
            want = [_valid_conv(q, w)]
        np.testing.assert_array_equal(got, np.stack(want), err_msg=f"{task} layer {i}")
        passes, chunks, _ = convert.layer_geometry(k, ic, split, qp.hw.pe)
        assert mmas == -(-eh * ew // 16) * passes * chunks * -(-oc // 8)


@pytest.mark.parametrize("split", [True, False], ids=["per-PE", "one-pass"])
@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("pe", [2, 3, 8, 16])
def test_mma_fragments_at_other_pe_counts(pe, width, split):
    """The same model at 2, 3, 8 and 16 PEs (K1's general instantiation: a
    split hidden layer takes one pass per PE, at 8 and 16 PEs over the PE's
    words p % 4 and p % 4 + 4, at 2 and 3 over all its words, B zero
    outside the PE's channels), for a network ``width`` channels wide,
    padded to the kernels' width (16 or 32) with zero weights
    (convert._padded): layer 0 with 1 and 3 input channels, a hidden layer,
    and last layers of 3 and 12 channels. Each per-PE partial and the full
    sum equal the plain version's conv on the PE's real channels (zero for
    a PE that owns only padded channels), whatever the padded channels'
    activations hold; the padded output channels' sums are zero."""
    rng = np.random.default_rng(100 * pe + width)
    eh, ew = EXTENT
    for k, ic, oc, last in ((5, 1, width, False), (5, 3, width, False),
                            (3, width, width, False), (5, width, 3, True),
                            (5, width, 12, True)):
        w = rng.integers(-127, 128, (k, k, ic, oc))
        kw = convert.kernel_width(width)
        kic, koc = (ic if ic <= 4 else kw), (oc if last else kw)
        q = rng.integers(-128, 128, size=(eh + k - 1, ew + k - 1, kic)).astype(np.int8)
        words, ps = _pack(q)
        frag = convert._fragment_words(convert._padded(w, kic, koc), split, pe, last)
        got, mmas = _model_layer(words, ps, frag, k, kic, koc, split, last, eh, ew, pe)
        got = got.reshape(-1, eh, ew, koc)
        np.testing.assert_array_equal(got[..., oc:], 0)
        if split:           # one pass per PE owning a channel, padded ones included
            want = [_valid_conv(q[..., :ic][..., pe_channel_mask(ic, pe, p)],
                                w[:, :, pe_channel_mask(ic, pe, p), :])
                    for p in range(pe) if pe_channel_mask(kic, pe, p).any()]
        else:
            want = [_valid_conv(q[..., :ic], w)]
        np.testing.assert_array_equal(got[..., :oc], np.stack(want),
                                      err_msg=f"pe {pe} width {width} {ic}->{oc}")
        passes, chunks, tap_major = convert.layer_geometry(k, kic, split, pe)
        assert passes == len(want) and tap_major == (kic <= 4 or (split and pe % 4 == 0))
        assert mmas == -(-eh * ew // 16) * passes * chunks * -(-koc // 8)


# SESR-M11 x2 and SESR-XL x2 (Bhardwaj et al., MLSys 2022): 13 convs, 16
# and 32 channels
FAMILY = {"m11": SESRSpec(name="sesr_m11_x2", in_channels=3, out_channels=3, num_channels=16,
                          num_lblocks=11, scaling_factor=2),
          "xl": SESRSpec(name="sesr_xl_x2", in_channels=3, out_channels=3, num_channels=32,
                         num_lblocks=11, scaling_factor=2)}


@functools.lru_cache(maxsize=None)
def _family_weights(net):
    """Seeded int8 weights (HWIO) of every conv of a FAMILY network."""
    spec = FAMILY[net]
    rng = np.random.default_rng(13 if net == "m11" else 32)
    L, f = spec.num_convs, spec.num_channels
    return [rng.integers(-127, 128, (k, k, spec.in_channels if i == 0 else f,
                                     spec.conv_out_channels if i == L - 1 else f))
            for i, k in enumerate(spec.kernel_sizes)]


@pytest.mark.parametrize("split", [True, False], ids=["per-PE", "one-pass"])
@pytest.mark.parametrize("pe", [4, 2, 3, 8, 16])
@pytest.mark.parametrize("net", list(FAMILY))
def test_mma_fragments_on_the_family(net, pe, split):
    """SESR-M11's and SESR-XL's layers through the model: layer 0 (3 -> f),
    the first and the last hidden layer (f -> f) and the last conv (f ->
    12) of the 13-conv network, at 4 PEs (a split XL layer's pass p reads
    PE p's words p and p + 4, four taps a chunk; one pass reads all eight
    words of one tap a chunk), at 8 and 16 (pass p reads words p % 4 and
    p % 4 + 4) and at 2 and 3 (the masked passes). Each
    per-PE partial and the full sum equal the plain version's conv, and
    the MMA count is the geometry's."""
    spec = FAMILY[net]
    weights = _family_weights(net)
    L = spec.num_convs
    rng = np.random.default_rng(pe)
    eh, ew = EXTENT
    for i in (0, 1, L - 2, L - 1):
        w = weights[i]
        k, _, ic, oc = w.shape
        q = rng.integers(-128, 128, size=(eh + k - 1, ew + k - 1, ic)).astype(np.int8)
        words, ps = _pack(q)
        frag = convert._fragment_words(w, split, pe, last=i == L - 1)
        got, mmas = _model_layer(words, ps, frag, k, ic, oc, split, i == L - 1, eh, ew, pe)
        got = got.reshape(-1, eh, ew, oc)
        if split:
            want = [_valid_conv(q[..., m], w[:, :, m, :])
                    for m in (pe_channel_mask(ic, pe, p) for p in range(pe)) if m.any()]
        else:
            want = [_valid_conv(q, w)]
        np.testing.assert_array_equal(got, np.stack(want), err_msg=f"{net} pe {pe} layer {i}")
        passes, chunks, tap_major = convert.layer_geometry(k, ic, split, pe)
        assert tap_major == (ic <= 4 or (split and pe % 4 == 0))
        assert chunks == -(-k * k * convert.words_per_tap(ic, split, pe) // 8)
        assert mmas == -(-eh * ew // 16) * passes * chunks * -(-oc // 8)


@pytest.mark.parametrize("layer", ["first", "hidden", "last"])
@pytest.mark.parametrize("pe", [8, 5, 16])
def test_k1_fragments_meet_their_channels_past_four_pes(pe, layer):
    """K1's split passes on SESR-XL past four PEs, byte by byte: every B
    fragment byte of pass p (lane 4g + t, register r of n-tile n, chunk c)
    meets k-slot t + 4r, i.e. byte b of the pass's word s % wpt of tap (8 /
    wpt) c + s // wpt (a hidden layer at 8 or 16 PEs: word p % 4 + 4 (s %
    wpt)), and the activation byte there holds channel _act_word^-1 (word,
    b); the fragment byte must hold that channel's weight for the column's
    output channel where the channel is PE p's (c % pe == p), else 0. Each
    weight of the layer sits in exactly one pass."""
    spec = FAMILY["xl"]
    L = spec.num_convs
    i = {"first": 0, "hidden": 1, "last": L - 1}[layer]
    w = np.asarray(_family_weights("xl")[i], np.int64)
    k, _, ic, oc = w.shape
    last = i == L - 1
    npass, chunks, tap_major = convert.layer_geometry(k, ic, True, pe)
    wpt = convert.words_per_tap(ic, True, pe)
    assert tap_major == (ic <= 4 or pe % 4 == 0)
    cols = convert._fragment_columns(oc, last).reshape(-1, 8)
    frag = _bytes(convert._fragment_words(w, True, pe, last)).reshape(
        npass, chunks, 32, cols.shape[0], 2, 4)
    chan_of = {convert._act_word(ic, c): c for c in range(ic)}
    seen = np.zeros(w.shape, int)
    for p in range(npass):
        for c in range(chunks):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                for r in range(2):
                    s = t + 4 * r
                    tap, word = (8 // wpt) * c + s // wpt, s % wpt
                    if tap_major and ic > 4:
                        word = p % 4 + 4 * word
                    for n in range(cols.shape[0]):
                        o = cols[n, g]
                        for b in range(4):
                            got = int(frag[p, c, lane, n, r, b])
                            ch = chan_of.get((word if ic > 4 else 0, b))
                            owner = ch is not None and tap < k * k and o >= 0 and ch % pe == p
                            if not owner:
                                assert got == 0, (p, c, lane, n, r, b)
                                continue
                            assert got == np.int8(w[tap // k, tap % k, ch, o]), (p, c, lane, b)
                            seen[tap // k, tap % k, ch, o] += 1
    assert (seen == 1).all()
    # at width 32 K1's general instantiation keeps one weight buffer where
    # two do not fit a block at the tile (at 16x16 with every conv split at
    # 5 and 16 PEs; at 8, whose passes read a PE's words only, two fit),
    # at four PEs two: the plans differ by that, and by nothing else
    from sesr_tpu_torch.ops.kernels import SMEM_LIMIT, net_smem_bytes

    def largest(n_pe):
        return max(int(np.prod(convert.layer_geometry(kk, 3 if j == 0 else 32, True, n_pe)[:2]))
                   * 32 * 2 * -(-(12 if j == L - 1 else 32) // 8)
                   for j, kk in enumerate(spec.kernel_sizes))

    plans = [net_smem_bytes("exact", L, 3, 12, (16, 16), (True,) * L, n_pe, True, 32)
             for n_pe in (pe, 4)]
    two = plans[1] + 8 * (largest(pe) - largest(4))
    assert plans[0] == (two - 4 * largest(pe) if two > SMEM_LIMIT else two)
    assert (two > SMEM_LIMIT) == (pe != 8)


@pytest.mark.parametrize("exact", [True, False], ids=["K1", "K2"])
@pytest.mark.parametrize("task", ["sr_x2", "sr_x4", "nrdm_3", "nrdm_6"])
def test_kernel_constants_take_each_layers_form(task, exact):
    """K2 runs every layer in one pass and clamps to 20 bits exactly where
    that clamp can fire; K1 splits exactly the layers where the 18-bit clamp
    can fire, never clamps to 20 bits, and its weights are those layers'
    per-PE fragments and the others' one-pass fragments."""
    spec, qp = _artifact(task)
    kc = convert.kernel_constants(spec, qp, "exact" if exact else "fast")
    L = spec.num_convs
    assert kc.pe_split == (convert.pe_split_layers(qp) if exact else (False,) * L)
    assert kc.clamp20 == ((False,) * L if exact else convert.clamp20_layers(qp))
    for key, flags in (("pe_split", kc.pe_split), ("clamp20", kc.clamp20)):
        assert kc.params[convert.param_at(key)] == sum(1 << i for i in range(L) if flags[i])
    want = [convert._fragment_words(np.asarray(w), kc.pe_split[i], qp.hw.pe, i == L - 1)
            for i, w in enumerate(qp.w_int)]
    np.testing.assert_array_equal(kc.weights, np.concatenate(want))


def test_pe_split_proof():
    """A layer left unsplit never saturates a PE's 18-bit sum on data; a
    layer with weights at +-127 must be split, and then does saturate."""
    spec, qp = _artifact("sr_x2")
    assert convert.pe_split_layers(qp) == (False, False, False, False, True)
    w = list(qp.w_int)
    w[1] = np.where(np.asarray(w[1]) >= 0, 127, -127).astype(np.asarray(w[1]).dtype)
    sat = dataclasses.replace(qp, w_int=w)
    assert convert.pe_split_layers(sat)[1]
    x = np.random.default_rng(5).random((1, 20, 28, 3), dtype=np.float32)
    for cqp in (qp, sat):
        _, dumps = integer_forward(spec, cqp, x, collect_dumps=True, device="cpu")
        ovf = dumps["overflow_18"].numpy()
        split = convert.pe_split_layers(cqp)
        assert not any(ovf[i] for i in range(spec.num_convs) if not split[i])
    assert ovf[1] > 0


def test_clamp20_proof():
    """A layer the fast kernel runs without its 20-bit clamp never reaches
    it on data; weights at +-127 need it. An artifact whose conv 0 could
    reach it would run in the general instantiation (which clamps every
    conv); with conv 0 at +-127 it is refused for its int16 shortcut."""
    spec, qp = _artifact("sr_x2")
    assert convert.clamp20_layers(qp) == (False,) * 5
    hi = 2 ** (qp.hw.pe_add_bits - 1) - 1
    w = list(qp.w_int)
    for i in (1, 4):
        w[i] = np.where(np.asarray(w[i]) >= 0, 127, -127).astype(np.asarray(w[i]).dtype)
    sat = dataclasses.replace(qp, w_int=w)
    assert convert.clamp20_layers(sat) == (False, True, False, False, True)
    x = np.random.default_rng(6).random((1, 20, 28, 3), dtype=np.float32)
    for cqp in (qp, sat):
        _, dumps = integer_forward(spec, cqp, x, collect_dumps=True, corrected=True,
                                   compute="fast", device="cpu")
        clamp = convert.clamp20_layers(cqp)
        at = [int(((dumps[f"pe_add.{i}"] == hi) | (dumps[f"pe_add.{i}"] == -hi - 1)).sum())
              for i in range(spec.num_convs)]
        assert not any(at[i] for i in range(spec.num_convs) if not clamp[i])
    assert at[1] > 0
    w0 = list(qp.w_int)
    w0[0] = np.where(np.asarray(w0[0]) >= 0, 127, -127).astype(np.asarray(w0[0]).dtype)
    assert convert.clamp20_layers(dataclasses.replace(qp, w_int=w0))[0]
    with pytest.raises(NotImplementedError, match="shortcut"):
        convert.kernel_constants(spec, dataclasses.replace(qp, w_int=w0), "fast")
    assert not convert.kernel_constants(spec, qp, "fast").general


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), os.pardir, "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("split,want", [((False,) * 5, 3_023_280), ((True,) * 5, 5_312_160),
                                        ((False,) * 4 + (True,), 3_219_120)],
                         ids=["K2", "all-split", "K1"])
def test_mma_count_sr_x2_frame(split, want):
    """MMAs per 540x960 sr_x2 frame at the 16x32 tile, as chip_smoke.py
    computes them from the tile geometry: 1020 blocks, each over the
    extents 26x42, 24x40, 22x38, 20x36 and 16x32."""
    mma_count = _chip_smoke().mma_count
    assert mma_count(spec_for_task("sr_x2"), split, 1, 540, 960, (16, 32), 4) == want
