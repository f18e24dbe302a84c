"""Carrying weights across: from the JAX package's parameters to the port's
``QuantParams``, and from a ``QuantParams`` to the device constants of the
fused kernels in ``csrc/sesr_net.cu`` (K1, K2) and ``csrc/sesr_corrected.cu``.

The JAX side is given as plain numpy arrays and Python scalars (the fields
of a ``sesr_tpu`` QuantParams), so nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from sesr_tpu_torch.config import HardwareConfig, SESRSpec
from sesr_tpu_torch.ops.fixedpoint import requant_factors
from sesr_tpu_torch.quant.integer import pe_channel_mask
from sesr_tpu_torch.quant.params import QuantParams

# The int32 parameter block of the kernels (csrc/sesr_common.cuh): a head
# of HEAD_WORDS words, one record of ``record_words(width)`` words per conv
# (its scalars, then its bias row and its z_eff * sum(W) row, ``width``
# words each), then, for the corrected kernel, z_eff * sum(W_p) per conv,
# PE and channel. A last conv of more output channels than ``width`` keeps
# its rows past those (``out_rows``): its bias, z_eff * sum(W) and each
# PE's z_eff * sum(W_p), ``out_channels`` words each, its record's "rows"
# word the first one's offset. The last record's "out" word is the last
# conv's output channels, each record's "k" word its conv's size. Float
# fields travel as their float32 bits. The block of an L-conv network holds
# L records: K1 and K2 copy the head and the records (``net_words``) into
# shared memory, the corrected kernel all of it (``block_words``).
MAX_LAYERS = 16                    # the most convs one launch runs: a deeper network runs in groups
GROUP_FIRST, GROUP_LAST = 1, 2     # a group's flags (sesr_common.cuh G_FIRST, G_LAST)
WIDTHS = (16, 32, 64)              # the hidden widths every fused kernel runs (64: in groups)
MAX_PES = 16
HEAD = dict(res_m=0, res_p=1, z_out=2, acc_hi=3, add_hi=4, pe_split=5, clamp20=6, quant=7)
HEAD_WORDS = 8
RECORD = dict(w_off=0, z_eff=1, z_in=2, rq_m=3, rq_p=4, rows=5, out=6, k=7,
              bias=8)                                     # zc: bias + width
# the last conv's output channels every fused kernel takes: 1 to 3 x 4^2
# (an RGB network of scale 4), run as OUT_COLUMNS padded columns, the
# first that holds them (``out_columns``); K1 and K2 serve 3, 12 and 16 in
# the instantiations the shipped artifacts use, and every count in the
# general ones, at its padded columns
MAX_OUT = 48
OUT_COLUMNS = (8, 16, 32, 48)
SHIPPED_OUT = (3, 12, 16)
DATAPATHS = ("exact", "fast", "corrected")
# the conv sizes every fused kernel runs, each position on its own (the
# first conv, the block convs, the last conv): odd, 1 to 9. A network of the
# shipped sizes (``shipped_sizes``) keeps its kernels; any other runs in the
# layer-group form's forms of other conv sizes (KernelConstants.ksizes)
KSIZES = (1, 3, 5, 7, 9)
# the tile the groups of such a network must fit where any partition lets
# them (kernel_constants), before the smallest
OTHER_SIZES_TILE = (16, 16)
# the kernels' magic-number conversions (sesr_common.cuh kMagic) hold an
# integer exactly while |y| < 2^22; an artifact whose sums may pass it runs
# the wide kernels (KernelConstants.wide: a plain int32, converted once)
MAGIC_RANGE = 1 << 22
QUAN_BITS = (2, 8)                 # the activation widths the kernels hold (int8 lanes)


def shipped_sizes(num_layers: int) -> tuple:
    """5x5 / 3x3 ... / 5x5: the conv sizes whose extents and B every
    kernel but the forms of other conv sizes derives from the position."""
    return (5,) + (3,) * (num_layers - 2) + (5,)


def pack_sizes(sizes) -> int:
    """A group's conv sizes as the kernels take them (sesr_common.cuh
    ks_at): four bits a conv, conv j in bits 4 j .. 4 j + 3."""
    return sum(int(k) << (4 * j) for j, k in enumerate(sizes))


def kernel_width(num_channels: int) -> int:
    """The hidden width a network of ``num_channels`` runs at in the
    kernels: the first of WIDTHS that holds it (padded with zero
    channels, ``_padded``; 33 to 64 run at 64, always in the forms of other
    conv sizes). Raises NotImplementedError past the widest."""
    for width in WIDTHS:
        if num_channels <= width:
            return width
    raise NotImplementedError(
        f"the fused kernels run hidden widths of at most {WIDTHS[-1]} channels, this "
        f"network has {num_channels}")


def record_words(width: int) -> int:
    return RECORD["bias"] + 2 * width


def param_at(field: str, layer: int = 0, width: int = 16) -> int:
    """Word of ``field`` in the parameter block (sesr_common.cuh p_at): a
    head field, or conv ``layer``'s record field at hidden width
    ``width``; "bias" and "zc" are the first of ``width`` words."""
    if field in HEAD:
        return HEAD[field]
    at = HEAD_WORDS + layer * record_words(width)
    return at + (RECORD["bias"] + width if field == "zc" else RECORD[field])


def net_words(num_layers: int, width: int) -> int:
    """The head and the records: the words K1 and K2 read."""
    return HEAD_WORDS + num_layers * record_words(width)


def zc_pe_at(num_layers: int, width: int, pe: int, layer: int, p: int) -> int:
    """First of the ``width`` words of z_eff * sum(W_p), conv ``layer``'s PE
    p (sesr_common.cuh zcp_at)."""
    return net_words(num_layers, width) + (layer * pe + p) * width


def param_words(pe: int, num_layers: int, width: int = 16) -> int:
    """Words of the head, the records and the per-PE rows at ``pe`` PEs
    (sesr_common.cuh param_words): where ``out_rows`` starts."""
    return net_words(num_layers, width) + num_layers * pe * width


def out_columns(oc: int) -> int:
    """The padded columns of a last conv of ``oc`` output channels in every
    fused kernel (sesr_common.cuh out_cols): a count of mma.sync n-tiles
    (K1, K2) and a wgmma N (the corrected kernel) both take."""
    for cols in OUT_COLUMNS:
        if oc <= cols:
            return cols
    raise NotImplementedError(f"the fused kernels run last convs of at most {MAX_OUT} output "
                              f"channels, this network has {oc}")


def out_rows(oc: int, width: int, pe: int) -> int:
    """Words of the last conv's own rows (sesr_common.cuh out_rows): its
    bias, z_eff * sum(W) and each PE's z_eff * sum(W_p), ``oc`` words each,
    where ``oc`` passes the hidden width (the record's rows hold ``width``);
    none otherwise."""
    return (2 + pe) * oc if oc > width else 0


def block_words(pe: int, num_layers: int, width: int, oc: int) -> int:
    """Words of the whole parameter block."""
    return param_words(pe, num_layers, width) + out_rows(oc, width, pe)


def pe_groups(pe: int) -> int:
    """PE column groups of a split hidden layer in the corrected kernel
    (sesr_corrected.cu pe_groups): 4 up to four PEs, 8 up to eight, else
    16, so that every PE count runs in one of three instantiations; the
    groups past ``pe`` hold zero weights."""
    return 4 if pe <= 4 else 8 if pe <= 8 else 16


def quantparams_from_fields(fields: Mapping[str, Any]) -> QuantParams:
    """The port's QuantParams from the fields of a JAX-package QuantParams:
    numpy arrays, Python scalars and tuples; ``hw`` as a mapping of the
    HardwareConfig fields (or any object that carries them)."""
    hw = fields["hw"]
    if not isinstance(hw, Mapping):
        hw = {f.name: getattr(hw, f.name)
              for f in dataclasses.fields(HardwareConfig)}
    kw = {}
    for f in dataclasses.fields(QuantParams):
        v = fields.get(f.name, f.default)
        if f.name in ("w_int", "bias_f", "bias_int"):
            v = [np.array(a) for a in v]
        elif f.name in ("w_scale", "a_scale"):
            v = [float(s) for s in v]
        elif f.name in ("a_zero", "requant_m", "requant_n"):
            v = [int(s) for s in v]
        elif f.name == "hw":
            v = HardwareConfig(**{k: int(x) for k, x in hw.items()})
        elif f.name in ("fast_cert_layers", "fast_cert_static"):
            v = None if v is None else tuple(bool(b) for b in v)
        elif f.name == "cert_cells":
            v = None if v is None else tuple(tuple(int(c) for c in cell)
                                            for cell in v)
        kw[f.name] = v
    return QuantParams(**kw)


@dataclasses.dataclass(frozen=True)
class GroupConstants:
    """One group of the layer-group form (csrc/sesr_net_group.cu,
    csrc/sesr_corrected_group.cu): convs ``first`` .. ``first + convs - 1``
    of the network, its flags (GROUP_FIRST: it starts at conv 0; GROUP_LAST:
    it ends at the last conv) and its own parameter block: the head with
    the group's split and clamp bits (its layer j is conv first + j), the
    network's records of its convs and, before the last group, of the next
    conv (``group_records``), their per-PE rows, and the last conv's own
    rows past the hidden width, its "rows" word pointing at them."""

    first: int
    convs: int
    flags: int
    params: np.ndarray
    split: int                   # the group's split bits

    @property
    def last(self) -> int:
        return self.first + self.convs - 1


@dataclasses.dataclass(frozen=True)
class KernelConstants:
    """What one fused kernel needs besides its input: the packed weight
    words of every layer, the parameter block, and the shapes."""

    weights: np.ndarray          # int32 B words of every layer (_fragment_words; corrected: _wgmma_b_words)
    params: np.ndarray           # int32 (block_words(pe, num_layers, width, out_channels),)
    num_layers: int
    in_channels: int
    out_channels: int
    pe_split: tuple              # per layer: one accumulation pass per PE
    clamp20: tuple               # per layer: the kernel clamps the layer's sum to pe_add_bits
    pe: int                      # PEs of the artifact's datapath
    general: bool                # the instantiation for any PE count, widths and quan_bits
    width: int                   # the hidden width the network runs at (kernel_width)
    wide: bool = False           # general, and |pe_add + bias| may pass 2^22: the wide kernels
    groups: tuple = ()           # GroupConstants of the layer-group form; () one launch
    ksizes: tuple = ()           # each conv's size

    @property
    def other_sizes(self) -> bool:
        """Whether the network's conv sizes are not 5x5 / 3x3 ... / 5x5."""
        return tuple(self.ksizes) != shipped_sizes(self.num_layers)

    @property
    def ksize_form(self) -> bool:
        """Whether the network runs in the forms of other conv sizes, in
        groups: other conv sizes (csrc/sesr_net_ksize.cu,
        csrc/sesr_corrected_ksize.cu), or any sizes at width 64 (their
        width-64 instantiations, csrc/sesr_net_w64.cu,
        csrc/sesr_corrected_w64.cu)."""
        return self.other_sizes or self.width == 64

    def _own_rows(self, layer: int) -> bool:
        return layer == self.num_layers - 1 and self.out_channels > self.width

    def param(self, field: str, layer: int = 0):
        """A field of the parameter block: a head or record word, or conv
        ``layer``'s row of ``width`` words ("bias", "zc"; the last conv's
        own rows of ``out_channels`` words where it has them)."""
        if field in ("bias", "zc") and self._own_rows(layer):
            oc = self.out_channels
            at = self.param("rows", layer) + (oc if field == "zc" else 0)
            return self.params[at: at + oc]
        at = param_at(field, layer, self.width)
        return self.params[at: at + self.width] if field in ("bias", "zc") else self.params[at]

    def zc_pe(self, layer: int, p: int) -> np.ndarray:
        """The row of z_eff * sum(W_p) of conv ``layer``'s PE p."""
        if self._own_rows(layer):
            oc = self.out_channels
            at = self.param("rows", layer) + (2 + p) * oc
            return self.params[at: at + oc]
        at = zc_pe_at(self.num_layers, self.width, self.pe, layer, p)
        return self.params[at: at + self.width]


def _f32_bits(v: float) -> int:
    return int(np.array(v, np.float32).view(np.int32))


def _act_word(ic: int, c: int) -> tuple:
    """(word, byte) of input channel c in a pixel's 32-bit activation
    words: a pixel of a <= 4-channel input is one word (channel c in byte
    c); a 16-, 32- or 64-channel pixel is ic / 4 words, word w holding
    channels w % 4 + 16 (w // 4) + 4 j in byte j, so that at a PE count that
    is a multiple of four, PE p's channels (c % pe == p, so c % 4 == p % 4)
    lie in words p % 4 + 4 j."""
    return (0, c) if ic <= 4 else (c % 4 + 4 * (c // 16), (c // 4) % 4)


def _passes(ic: int, split: bool, pe: int):
    """The input channels of each accumulation pass of a layer: one PE's
    channels per pass (the PEs that own a channel) where the kernel clamps
    each PE's sum to pe_acc_bits (``split``), else one pass over all
    channels."""
    if split:
        groups = [np.flatnonzero(pe_channel_mask(ic, pe, p)) for p in range(pe)]
        return [g for g in groups if len(g)]
    return [np.arange(ic)]


def _tap_words(w_hwio: np.ndarray, split: bool, pe: int) -> np.ndarray:
    """uint32 words (pass, k*k tap, input word, OC): in the word of pass g
    for output channel o, the byte of each channel c of the pass holds
    w[dy, dx, c, o], in the word and byte where the activations hold
    channel c (``_act_word``)."""
    k, _, ic, oc = w_hwio.shape
    passes = _passes(ic, split, pe)
    words = np.zeros((len(passes), k * k, 1 if ic <= 4 else ic // 4, oc), np.uint32)
    taps = np.asarray(w_hwio, np.int64).reshape(k * k, ic, oc)
    for g, chans in enumerate(passes):
        for c in chans:
            word, byte = _act_word(ic, c)
            words[g, :, word, :] |= (taps[:, c, :] & 0xFF).astype(np.uint32) << np.uint32(8 * byte)
    return words


def pe_words(split: bool, pe: int) -> bool:
    """Whether a split hidden layer's pass reads only its PE's words in K1
    (``_act_word``): at a PE count that is a multiple of four; at any other
    a pass reads all of them against B zero outside the PE's channels."""
    return split and pe % 4 == 0


def words_per_tap(ic: int, split: bool, pe: int) -> int:
    """Activation words one pass of a layer reads per tap in K1 and K2:
    one for a <= 4-channel input; a split layer at 4, 8, 12 or 16 PEs PE
    p's own (words p % 4 + 4 j: ic / 16); else all ic / 4."""
    if ic <= 4:
        return 1
    return ic // 16 if pe_words(split, pe) else ic // 4


def layer_geometry(k: int, ic: int, split: bool, pe: int):
    """(passes, k32 chunks, tap_major) of one layer's implicit GEMM in K1
    and K2, with one pass per PE (``split``) or one over all channels. A
    pass reads ``words_per_tap`` words a tap (wpt): k-slot s of chunk c is
    the pass's k word 8 c + s, its word (8 c + s) % wpt of tap (8 c + s) //
    wpt (8 / wpt taps a chunk, or at 16 words a tap two chunks a tap).
    Tap-major (any layer that reads one word per pixel, and a split
    hidden layer at a PE count that is a multiple of four, whose pass p
    reads PE p's words: word j is p % 4 + 4 j); else (one pass over all
    channels, or a split layer at another PE count, each pass over all
    ic / 4 words with zero weights outside the PE's channels) word j is
    word j."""
    tap_major = ic <= 4 or pe_words(split, pe)
    passes = len(_passes(ic, split, pe))
    chunks = -(-k * k * words_per_tap(ic, split, pe) // 8)
    return passes, chunks, tap_major


def _fragment_columns(oc: int, last: bool) -> np.ndarray:
    """Output channel of each B column (n-tile n, column g) -> 8n + g index,
    -1 past OC. A hidden layer permutes them so that the accumulators a lane
    (g, t) holds for a pixel (columns 2t, 2t+1 of both n-tiles) are channels
    t, t+4, t+8, t+12: word t of the next layer's input. The last layer
    keeps them in order (n-tile n, columns 2t, 2t+1 -> channels 8n + 2t,
    8n + 2t + 1) for its NHWC int8 stores, ``out_columns(oc)`` of them."""
    n = np.arange(out_columns(oc) if last else 8 * -(-oc // 8))
    g = n % 8
    cols = n if last else (g >> 1) + 4 * (g & 1) + 8 * (n // 8)
    return np.where(cols < oc, cols, -1)


def _fragment_words(w_hwio: np.ndarray, split: bool, pe: int, last: bool) -> np.ndarray:
    """B fragments of one layer for mma.sync.m16n8k32.row.col.s8: int32
    words (pass, chunk, lane, n-tile, reg), the order in which lane
    4g + t loads its registers. reg 0 is k-slot word t of the chunk, reg 1
    word t + 4 (``layer_geometry``), both for column g of the n-tile; a
    padded tap or channel is a zero word."""
    k, _, ic, oc = w_hwio.shape
    words = _tap_words(w_hwio, split, pe)
    npass, chunks, tap_major = layer_geometry(k, ic, split, pe)
    wpt = words_per_tap(ic, split, pe)
    cols = _fragment_columns(oc, last).reshape(-1, 8)          # (n-tile, g)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    slot = np.stack([t, t + 4], axis=-1)                       # (lane, reg)
    frag = np.zeros((npass, chunks, 32, cols.shape[0], 2), np.uint32)
    for p in range(npass):
        for c in range(chunks):
            tap, j = (8 * c + slot) // wpt, (8 * c + slot) % wpt
            word = (0 if ic <= 4 else p % 4 + 4 * j) if tap_major else j
            for n in range(cols.shape[0]):
                o = cols[n, g][:, None]                        # (lane, 1)
                ok = (tap < k * k) & (o >= 0)
                frag[p, c, :, n, :] = np.where(
                    ok, words[p, np.minimum(tap, k * k - 1), word, np.maximum(o, 0)], 0)
    return frag.view(np.int32).reshape(-1)


def _wgmma_columns(oc: int, last: bool) -> np.ndarray:
    """Output channel of each column of one PE group of the corrected
    kernel's B (csrc/sesr_corrected.cu ``col_chan``), -1 past OC: a hidden
    layer's ``oc`` (its width, 16, 32 or 64) columns, a last layer's
    ``out_columns(oc)``. The last layer's are in order; a hidden layer's are
    permuted so that the four accumulators a thread holds for one row in
    n-tiles 2w and 2w + 1 (wgmma columns 8j + 2t + e, j - 2w and e in
    {0, 1}) are channels 16w + 4t + 2(j - 2w) + e, the bytes of word t of
    the next layer's input plane w."""
    n = np.arange(out_columns(oc) if last else oc)
    cols = n if last else (n >> 4) * 16 + ((n >> 1) & 3) * 4 + ((n >> 3) & 1) * 2 + (n & 1)
    return np.where(cols < oc, cols, -1)


def wgmma_geometry(k: int, ic: int, oc: int, split: bool, last: bool, pe: int):
    """(k32 steps, PE groups of columns, N) of one layer's GEMM in the
    corrected kernel: layer 0 (ic <= 4, its pixels widened to four
    horizontal neighbours, eight taps a step) takes one step per kernel row
    (two past eight columns: a 9x9 conv), a 16-channel layer
    two taps a step, a 32-channel layer one (its two planes the two halves
    of k), a 64-channel layer two a tap (planes 0-1, then 2-3); a split
    layer has one group of columns per PE that owns an input channel
    (layer 0: min(ic, pe), but 4 for 3 at width 64, whose chunks are two
    groups: csrc/sesr_corrected_ksize.cu first_groups; a hidden layer
    ``pe_groups``), a one-pass layer one."""
    wide = ic <= 4
    steps = k * -(-k // 8) if wide else -(-k * k * ic // 32)
    groups = (min(ic, pe) + (oc == 64 and min(ic, pe) == 3) if wide else pe_groups(pe)) \
        if split else 1
    return steps, groups, groups * len(_wgmma_columns(oc, last))


def _wgmma_b_words(w_hwio: np.ndarray, split: bool, pe: int, last: bool) -> np.ndarray:
    """B of one layer of the corrected kernel (csrc/sesr_corrected.cu), the
    bytes as int32 words: byte ``b_byte(s, n, kb, N)`` holds the weight that
    k byte kb of step s meets in column n. Column n is output channel
    ``_wgmma_columns[n % G]`` of PE group n // G (G columns a group); k byte
    16h + b of step s is channel b of tap 2s + h (a 16-channel layer),
    channel 16h + b of tap s (a 32-channel layer: plane h), channel 32 (s %
    2) + 16h + b of tap s // 2 (a 64-channel layer: plane 2 (s % 2) + h), or channel
    b % 4 of tap (s // r, 8 (s % r) + 4h + b // 4) (layer 0, widened pixels,
    r = ceil(k / 8) steps a kernel row). A
    split layer's group p holds only PE p's channels (c % pe == p); a
    padded tap or channel, a group past the PEs, or a column past OC, is
    zero."""
    k, _, ic, oc = w_hwio.shape
    wide = ic <= 4
    cols = _wgmma_columns(oc, last)
    g = len(cols)
    steps, groups, n_cols = wgmma_geometry(k, ic, oc, split, last, pe)
    w = np.asarray(w_hwio, np.int64)
    s, kb, n = np.meshgrid(np.arange(steps), np.arange(32), np.arange(n_cols), indexing="ij")
    h, b = kb >> 4, kb & 15
    if wide:
        spr = -(-k // 8)
        dy, dx, ch = s // spr, 8 * (s % spr) + 4 * h + b // 4, b % 4
        ok = (dx < k) & (ch < ic)
    elif ic == 64:
        tap = s // 2
        dy, dx, ch = tap // k, tap % k, 32 * (s % 2) + 16 * h + b
        ok = tap < k * k
    else:
        tap = 32 // ic * s + (32 // ic - 1) * h
        dy, dx, ch = tap // k, tap % k, b + 16 * h * (ic // 16 - 1)
        ok = tap < k * k
    o = cols[n % g]
    ok &= o >= 0
    if split:
        ok &= ch % pe == n // g
    vals = np.where(ok, w[np.minimum(dy, k - 1), np.minimum(dx, k - 1),
                          np.minimum(ch, ic - 1), np.maximum(o, 0)], 0)
    at = s * n_cols * 32 + (n >> 3) * 256 + (kb >> 4) * 128 + (n & 7) * 16 + (kb & 15)
    out = np.zeros(steps * n_cols * 32, np.uint8)
    out[at.reshape(-1)] = (vals.reshape(-1) & 0xFF).astype(np.uint8)
    return out.view(np.int32)


def _conv_range(w: np.ndarray, z: int, hw: HardwareConfig):
    """(lo, hi) per output channel of conv(q - z) with weights w (k, k, ic,
    oc) over every activation q in [quan_min, quan_max] (int8's [-128, 127]
    at quan_bits 8): q - z lies in [quan_min - z, quan_max - z], widened to
    hold the 0 that a position outside the image contributes."""
    w = np.asarray(w, np.int64)
    pos, neg = np.maximum(w, 0), np.minimum(w, 0)
    d_lo, d_hi = min(hw.quan_min - z, 0), max(hw.quan_max - z, 0)
    hi = (d_hi * pos + d_lo * neg).sum(axis=(0, 1, 2))
    lo = (d_lo * pos + d_hi * neg).sum(axis=(0, 1, 2))
    return lo, hi


def _pe_ranges(qp: QuantParams, i: int, z: int) -> list:
    """_conv_range of conv i over each PE's input channels."""
    w = np.asarray(qp.w_int[i])
    return [_conv_range(w[:, :, pe_channel_mask(w.shape[2], qp.hw.pe, p), :], z, qp.hw)
            for p in range(qp.hw.pe)]


def _pe_clamp_fires(qp: QuantParams, z_of) -> tuple:
    acc_hi = (1 << (qp.hw.pe_acc_bits - 1)) - 1
    return tuple(any(bool((hi > acc_hi).any() or (lo < -acc_hi - 1).any())
                     for lo, hi in _pe_ranges(qp, i, z_of(i)))
                 for i in range(len(qp.w_int)))


def pe_split_layers(qp: QuantParams) -> tuple:
    """Per layer: whether the PE-exact datapath's 18-bit clamp of a PE's
    partial sum can fire. The kernels' partial is conv(q, pads = z_eff) on
    activations in [quan_min, quan_max] ([-128, 127] at 8 bits), so over
    every input it lies in [sum_{w>0} quan_min w + sum_{w<0} quan_max w,
    sum_{w>0} quan_max w + sum_{w<0} quan_min w]; where that range
    fits 18 bits for every PE and output channel, the clamp is the
    identity and the sum of the clamped partials is the full conv: the
    PE-exact kernel then runs the layer in one pass, as the fast kernel
    does."""
    return _pe_clamp_fires(qp, lambda i: 0)


def corrected_split_layers(qp: QuantParams) -> tuple:
    """Per layer: whether the corrected datapath's 18-bit clamp of a PE's
    partial can fire. That partial is conv(q - z_eff) over the PE's input
    channels (no zero restoration), bounded per output channel by
    ``_conv_range`` with z = z_eff: a bound over q - z_eff, not over q as
    in ``pe_split_layers``. Where every PE's range fits 18 bits, the
    clamped partials sum to the full conv(q - z_eff), which also fits 20
    bits: one pass computes the layer exactly."""
    return _pe_clamp_fires(qp, qp.effective_zero)


def adder_clamp_layers(qp: QuantParams, z_of, split) -> tuple:
    """Per layer: whether the PE adder's clamp (pe_add_bits) can fire on the
    sum a kernel forms: conv over every activation q with pads z_of(i) in a
    one-pass layer (``_conv_range``), or on a layer flagged in ``split`` the
    sum of each PE's range clamped to pe_acc_bits. z_of(i) = z_eff for the
    corrected datapath's conv(q - z_eff), 0 for the reference datapath's
    zero-restored partials."""
    hw = qp.hw
    acc_hi = (1 << (hw.pe_acc_bits - 1)) - 1
    add_hi = (1 << (hw.pe_add_bits - 1)) - 1
    fire = []
    for i, w in enumerate(qp.w_int):
        if split[i]:
            ranges = _pe_ranges(qp, i, z_of(i))
            lo = sum(np.clip(r[0], -acc_hi - 1, acc_hi) for r in ranges)
            hi = sum(np.clip(r[1], -acc_hi - 1, acc_hi) for r in ranges)
        else:
            lo, hi = _conv_range(w, z_of(i), hw)
        fire.append(bool((hi > add_hi).any() or (lo < -add_hi - 1).any()))
    return tuple(fire)


def clamp20_layers(qp: QuantParams) -> tuple:
    """Per layer: whether the fast datapath's 20-bit clamp of conv(q -
    z_eff) can fire: where ``_conv_range`` with z = z_eff fits 20 bits for
    every output channel the fast kernel skips the clamp."""
    return adder_clamp_layers(qp, qp.effective_zero, (False,) * len(qp.w_int))


def pe_zero_terms(qp: QuantParams, i: int) -> np.ndarray:
    """(PE, OC) int64: z_eff * sum(W_p) of conv i, each PE's share of the
    layer's zero term z_eff * sum(W) (the rows sum to it)."""
    w = np.asarray(qp.w_int[i], np.int64)
    return np.stack([qp.effective_zero(i)
                     * w[:, :, pe_channel_mask(w.shape[2], qp.hw.pe, p), :].sum(axis=(0, 1, 2))
                     for p in range(qp.hw.pe)])


def shortcut_bound(qp: QuantParams, split0: bool = False) -> float:
    """The largest round(h) the corrected datapath's kernels can store as
    their residual shortcut (conv 0's ReLU output, kept as int16): over
    every input, conv(q - z_eff) is at most ``_conv_range``'s hi per
    channel; or, where conv 0 runs one pass per PE (``split0``), the sum
    over PEs of each PE's hi clamped to 18 bits. Then the 20-bit clamp, the
    clipped bias and the float32 requantization, all monotone."""
    hw = qp.hw
    z = qp.effective_zero(0)
    if split0:
        acc_hi = (1 << (hw.pe_acc_bits - 1)) - 1
        hi = sum(np.clip(h, -acc_hi - 1, acc_hi) for _, h in _pe_ranges(qp, 0, z))
    else:
        hi = _conv_range(qp.w_int[0], z, hw)[1]
    hi16 = (1 << (hw.bias_bits - 1)) - 1
    y = np.minimum(hi, (1 << (hw.pe_add_bits - 1)) - 1) \
        + np.clip(np.asarray(qp.bias_int[0], np.int64), -hi16 - 1, hi16)
    m_f, p_f = requant_factors(qp.requant_m[0], qp.requant_n[0])
    h = (y.astype(np.float32) * np.float32(m_f)) * np.float32(p_f)
    return float(np.rint(max(float(h.max()), 0.0)))


def group_records(convs: int, flags: int) -> int:
    """Records of a group's parameter block (sesr_common.cuh group_records):
    its convs', and before the last group the next conv's (the zero and pad
    of the activation the group writes)."""
    return convs + (not flags & GROUP_LAST)


def group_flags(first: int, last: int, num_layers: int) -> int:
    return (GROUP_FIRST if first == 0 else 0) | (GROUP_LAST if last == num_layers - 1 else 0)


def balanced_groups(num_layers: int, count: int) -> tuple:
    """``count`` groups of consecutive convs, (first, last) each, with
    lengths as equal as possible, the longer first."""
    q, r = divmod(num_layers, count)
    out, at = [], 0
    for g in range(count):
        n = q + (g < r)
        out.append((at, at + n - 1))
        at += n
    return tuple(out)


def layer_groups(num_layers: int, fits) -> tuple:
    """The partition rule of the layer-group form: the fewest groups of at
    most MAX_LAYERS convs (and at least two: the last group holds the conv
    that adds the shortcut and the last conv) whose plans fit a block
    (``fits(first, last)``), with lengths as equal as possible
    (``balanced_groups``); None where no such partition fits. A network
    that one launch runs is not partitioned (``kernel_constants``)."""
    for count in range(-(-num_layers // MAX_LAYERS), num_layers // 2 + 1):
        groups = balanced_groups(num_layers, count)
        if all(fits(a, b) for a, b in groups):
            return groups
    return None


def group_constants(prm: np.ndarray, num_layers: int, width: int, pe: int, out_ch: int,
                    split, clamp, first: int, last: int) -> GroupConstants:
    """The group of convs first..last of a network whose whole parameter
    block is ``prm`` (``kernel_constants``), with the network's per-layer
    ``split`` and ``clamp`` flags."""
    L = num_layers
    n = last - first + 1
    flags = group_flags(first, last, L)
    R = group_records(n, flags)
    own = last == L - 1 and out_ch > width
    blk = np.zeros(block_words(pe, R, width, out_ch if last == L - 1 else 0), np.int32)
    blk[:HEAD_WORDS] = prm[:HEAD_WORDS]
    bits = sum(1 << j for j in range(n) if split[first + j])
    blk[HEAD["pe_split"]] = bits
    blk[HEAD["clamp20"]] = sum(1 << j for j in range(n) if clamp[first + j])
    at = param_at("w_off", first, width)
    blk[HEAD_WORDS:net_words(R, width)] = prm[at:at + R * record_words(width)]
    for j in range(R):
        for p in range(pe):
            src = zc_pe_at(L, width, pe, first + j, p)
            blk[zc_pe_at(R, width, pe, j, p):][:width] = prm[src:src + width]
    if own:
        rows = param_words(pe, R, width)
        src = int(prm[param_at("rows", L - 1, width)])
        blk[rows:] = prm[src:src + (2 + pe) * out_ch]
        blk[param_at("rows", n - 1, width)] = rows
    return GroupConstants(first, n, flags, blk, bits)


def _padded(w: np.ndarray, ic: int, oc: int) -> np.ndarray:
    """w (k, k, i, o) with zero weights for the input channels i..ic - 1 and
    output channels o..oc - 1: a network narrower than a kernel width runs
    padded to it (``kernel_width``), its padded channels adding nothing to any sum (their
    weights in and out are zero) and keeping the real channels' indices,
    and with them each channel's PE."""
    k = w.shape[0]
    out = np.zeros((k, k, ic, oc), w.dtype)
    out[:, :, :w.shape[2], :w.shape[3]] = w
    return out


def kernel_constants(spec: SESRSpec, qp: QuantParams, datapath: str,
                     split=None) -> KernelConstants:
    """Constants of one fused kernel: the PE-exact kernel ("exact", the
    reference datapath), the fast kernel ("fast", the certified corrected
    datapath) or the corrected kernel ("corrected", the corrected datapath
    with one pass per PE on the layers flagged in ``split``, one flag per
    layer, which the caller chooses: ops/corrected.py ``split_layers``).

    The kernels keep raw int8 activations and hold z_eff at positions
    outside the image, so conv(q, pads=z_eff) = conv(q - z_eff) +
    z_eff * sum(W). Per PE that is the reference's zero-restored partial,
    so the PE-exact kernel needs no restoration term; the corrected
    datapath's kernels subtract ``zc`` = z_eff * sum(W) before the adder
    clamp, or on a split layer each PE's share ``zc_pe`` = z_eff * sum(W_p)
    before that PE's accumulator clamp (``pe_zero_terms``). The PE-exact
    kernel runs one pass per PE only on the layers where the accumulator
    clamp can fire (``pe_split_layers``); the fast and corrected kernels
    clamp a one-pass layer to pe_add_bits only where that clamp can fire
    (``clamp20_layers``).

    Any PE count from 1 to MAX_PES, activations of 2 to 8 bits (QUAN_BITS)
    and any widths whose sums fit int32 run: at four PEs with int8
    activations, sums the kernels' kMagic conversions hold (|pe_add + bias|
    < 2^22), no adder clamp that can fire on a K1 layer, a split
    corrected layer or K2's conv 0, and a last conv of SHIPPED_OUT output
    channels (K1, K2) or at most 16 (the corrected kernel), in the
    instantiations the shipped artifacts use; otherwise in the ``general``
    ones, which clamp every
    layer's sum to pe_add_bits (the identity where it cannot fire) and clip
    activations to [quan_min, quan_max] (head word "quant": 2^(quan_bits -
    1)); where a pe_add_bits sum plus a bias_bits bias can reach 2^22
    (``wide``) they run as the wide kernels, whose sums stay plain int32,
    converted to float32 once. Networks
    of 2 or more convs run at hidden widths of 16 and 32, with 1 to
    4 input channels and a last conv of 1 to MAX_OUT output channels, each
    conv of any odd size from 1 to 9 (KSIZES: the first conv, the block
    convs and the last conv each on its own), and a narrower network runs
    padded with zero channels (``_padded``); a network of 33 to 64 hidden
    channels runs at 64, in the forms of other conv sizes. Raises
    NotImplementedError for a network or artifact outside that (quan_bits
    above 8, more than MAX_PES PEs, a hidden width above 64, an even conv
    size or one past 9,
    more than 4 input or MAX_OUT output channels, an int16 shortcut that may
    not hold round(s), ``shortcut_bound``).

    A network that one launch of the kernel runs (3 to MAX_LAYERS convs,
    and a plan that fits a block at the kernel's smallest tile) keeps that
    one launch (``groups`` empty). Any other runs in the layer-group form:
    a chain of launches of the general group kernels, one per group of
    ``layer_groups`` (each group's plan fitting a block at the smallest
    tile), its constants in ``groups`` (``group_constants``), a last conv of
    any 1 to MAX_OUT output channels included. A network of two convs
    (``num_lblocks`` 0) is one group, GROUP_FIRST | GROUP_LAST, whose first
    conv also adds the shortcut (the group kernels' two-conv form). A
    network whose convs are not 5x5 / 3x3 ... / 5x5, or of width 64, always
    runs in groups, in the forms of other conv sizes (``ksizes``,
    ``ksize_form``; one group where its plan fits a block). Raises
    NotImplementedError where no partition fits, naming the shared memory
    the smallest groups need.
    """
    if datapath not in DATAPATHS:
        raise ValueError(f"datapath must be one of {DATAPATHS}, got {datapath!r}")
    hw = qp.hw
    L = spec.num_convs
    ks = spec.kernel_sizes
    exact = datapath == "exact"
    if datapath == "corrected":
        if split is None or len(split) != L:
            raise ValueError(f"the corrected kernel takes one split flag per layer "
                             f"({L}), got {split!r}")
        split = tuple(bool(f) for f in split)
    if not QUAN_BITS[0] <= hw.quan_bits <= QUAN_BITS[1]:
        raise NotImplementedError(
            f"the fused kernels hold activations and weights as int8 (quan_bits "
            f"{QUAN_BITS[0]} to {QUAN_BITS[1]}), this artifact has quan_bits={hw.quan_bits}")
    if not 1 <= hw.pe <= MAX_PES:
        raise NotImplementedError(f"the fused kernels run 1 to {MAX_PES} PEs, this "
                                  f"artifact has {hw.pe}")
    reach = (1 << (hw.pe_add_bits - 1)) + (1 << (hw.bias_bits - 1))
    if reach >= 1 << 31:
        raise NotImplementedError(
            f"a {hw.pe_add_bits}-bit PE sum plus a {hw.bias_bits}-bit bias can pass the "
            f"kernels' int32 sums")
    wide = reach >= MAGIC_RANGE
    width = kernel_width(spec.num_channels)
    out_ch = spec.conv_out_channels
    for i, k in enumerate(ks):
        if k not in KSIZES:
            raise NotImplementedError(
                f"the fused kernels run convs of odd sizes {KSIZES[0]} to {KSIZES[-1]}; conv {i} "
                f"of {spec.name} is {k}x{k}" + (" (an even size: its SAME padding grows the "
                                                 "frame)" if k % 2 == 0 else ""))
        if np.shape(qp.w_int[i])[:2] != (k, k):
            raise ValueError(f"conv {i} of {spec.name} is {k}x{k}, its weights "
                             f"{np.shape(qp.w_int[i])[:2]}")
    other = ks != shipped_sizes(L) or width > 32       # the forms of other conv sizes
    if not (1 <= spec.in_channels <= 4 and 1 <= out_ch <= MAX_OUT):
        raise NotImplementedError(
            f"the fused kernels run 1-4 input channels and a last conv of 1-{MAX_OUT} output "
            f"channels; {spec.name} has {spec.in_channels} in and {out_ch} out, outside that")
    for i in range(L):
        z = qp.effective_zero(i)
        if not -128 <= z <= 127:
            raise NotImplementedError(
                f"layer {i}: effective zero {z} does not fit int8, and the "
                f"kernels hold it in the int8 pads of their input buffers")
    for m, n in [*zip(qp.requant_m, qp.requant_n), (qp.res_requant_m, qp.res_requant_n)]:
        if not (0 <= m < 1 << 22 and -64 <= n <= 64):
            raise NotImplementedError(
                f"requantization (m={m}, n={n}): the kernels round y * (m * 2^-n) "
                f"once, which equals the reference's (y * m) * 2^-n only while "
                f"m < 2^22 and |n| <= 64 keep every product a normal float")
    # the general instantiation: every config but the shipped one's int8
    # activations and sums the kMagic conversions hold
    off_int8 = hw.quan_bits != 8 or wide
    if exact:
        split = pe_split_layers(qp)
        clamp = adder_clamp_layers(qp, lambda i: 0, split)
        general = hw.pe != 4 or any(clamp) or off_int8 or out_ch not in SHIPPED_OUT
    elif datapath == "fast":
        split = (False,) * L
        clamp = clamp20_layers(qp)
        general = clamp[0] or off_int8 or out_ch not in SHIPPED_OUT
    else:
        clamp = adder_clamp_layers(qp, qp.effective_zero, split)
        general = hw.pe != 4 or any(c and f for c, f in zip(clamp, split)) or off_int8 \
            or out_ch > 16
    if not exact and shortcut_bound(qp, split[0]) > 32767:
        raise NotImplementedError(
            f"the {datapath} kernel keeps the residual shortcut round(s) as int16; "
            f"this artifact bounds it only by {shortcut_bound(qp, split[0])}")
    # the kernels' shared-memory plans (ops/kernels.py; imported here, as
    # that module builds on this one): a network that one launch runs at
    # the kernel's smallest tile keeps one launch, any other runs in groups
    from sesr_tpu_torch.ops.kernels import SMEM_LIMIT, kernel_of
    kern = kernel_of(datapath)
    smallest = kern.tiles[-1]
    if not other and 3 <= L <= MAX_LAYERS \
            and kern.smem_bytes(spec, smallest, split, hw.pe, general) <= SMEM_LIMIT:
        groups = ()
    else:
        general = True                   # the group kernels are general instantiations

        def need(a, b, tile=smallest):
            return kern.group_smem_bytes(spec, a, b, split, hw.pe, tile)

        # other conv sizes: the fewest groups that fit a block at 16x16 where
        # there are such (a 13-conv 5x5 network of width 32 in one group fits
        # only at 8x8, where it computes 18 times the MACs it needs)
        for tile in ((OTHER_SIZES_TILE,) if other else ()) + (smallest,):
            groups = layer_groups(L, lambda a, b: need(a, b, tile) <= SMEM_LIMIT)
            if groups:
                break
        if groups is None:
            pairs = balanced_groups(L, L // 2)
            raise NotImplementedError(
                f"no tile of the {datapath} kernel fits {spec.name} (convs {ks}) at {hw.pe} "
                f"PEs, in one launch or in groups of 2 to {MAX_LAYERS} convs: at the smallest "
                f"tile {smallest} "
                + ("" if other else f"one launch needs "
                   f"{kern.smem_bytes(spec, smallest, split, hw.pe, general)} B, ")
                + f"the smallest groups {pairs} need {[need(a, b) for a, b in pairs]} B of "
                f"shared memory, a block has {SMEM_LIMIT}")
    if general:
        clamp = (True,) * L

    prm = np.zeros(block_words(hw.pe, L, width, out_ch), np.int32)
    rows = param_words(hw.pe, L, width)       # the last conv's own rows, if it has them
    chunks, off = [], 0
    hi16 = (1 << (hw.bias_bits - 1)) - 1
    if L <= MAX_LAYERS:                  # a deeper network's masks are its groups'
        prm[HEAD["pe_split"]] = sum(1 << i for i in range(L) if split[i])
        prm[HEAD["clamp20"]] = sum(1 << i for i in range(L) if clamp[i])
    b_words = _wgmma_b_words if datapath == "corrected" else _fragment_words
    for i in range(L):
        w = np.asarray(qp.w_int[i])
        oc = w.shape[3]
        padded = _padded(w, spec.in_channels if i == 0 else width,
                         spec.conv_out_channels if i == L - 1 else width)
        words = b_words(padded, split[i], hw.pe, last=i == L - 1)
        prm[param_at("w_off", i, width)] = off
        chunks.append(words)
        off += words.size
        prm[param_at("z_eff", i, width)] = qp.effective_zero(i)
        prm[param_at("z_in", i, width)] = _f32_bits(float(qp.a_zero[i]))
        m_f, p_f = requant_factors(qp.requant_m[i], qp.requant_n[i])
        prm[param_at("rq_m", i, width)] = _f32_bits(m_f)
        prm[param_at("rq_p", i, width)] = _f32_bits(p_f)
        prm[param_at("k", i, width)] = ks[i]
        zc_pe = np.zeros((hw.pe, oc), np.int64)
        if exact:
            bias = qp.fused_bias(i)
            zc = np.zeros(oc, np.int64)
        else:
            bias = np.clip(np.asarray(qp.bias_int[i]), -hi16 - 1, hi16)
            zc_pe = pe_zero_terms(qp, i)
            zc = zc_pe.sum(axis=0)
            if split[i]:
                zc = np.zeros(oc, np.int64)
            else:
                zc_pe[:] = 0
        if oc > width:                           # the last conv, past the records' rows
            prm[param_at("rows", i, width)] = rows
            prm[rows:rows + (2 + hw.pe) * oc] = np.concatenate([bias, zc, *zc_pe])
        else:
            prm[param_at("bias", i, width):][:oc] = bias
            prm[param_at("zc", i, width):][:oc] = zc
            for p in range(hw.pe):
                prm[zc_pe_at(L, width, hw.pe, i, p):][:oc] = zc_pe[p]
    prm[param_at("out", L - 1, width)] = out_ch
    res_m, res_p = requant_factors(qp.res_requant_m, qp.res_requant_n)
    prm[HEAD["res_m"]] = _f32_bits(res_m)
    prm[HEAD["res_p"]] = _f32_bits(res_p)
    prm[HEAD["z_out"]] = _f32_bits(float(qp.a_zero[L]))
    prm[HEAD["acc_hi"]] = (1 << (hw.pe_acc_bits - 1)) - 1
    prm[HEAD["add_hi"]] = (1 << (hw.pe_add_bits - 1)) - 1
    prm[HEAD["quant"]] = -hw.quan_min
    return KernelConstants(np.concatenate(chunks), prm, L, spec.in_channels,
                           out_ch, split, clamp, hw.pe, general, width, wide,
                           tuple(group_constants(prm, L, width, hw.pe, out_ch, split, clamp, a, b)
                                 for a, b in groups), ks)


def device_constants(spec: SESRSpec, qp: QuantParams, datapath: str,
                     device: torch.device, split=None):
    """(KernelConstants, weights, params) of kernel_constants, the last two
    as int32 tensors on ``device`` (params: the whole block, or in the
    layer-group form a tuple of each group's block), built once per
    QuantParams instance, datapath, split mask and device, and kept on the
    instance (a ``dataclasses.replace`` copy builds its own)."""
    cache = qp.__dict__.setdefault("_kernel_constants", {})
    key = (spec.name, datapath, None if split is None else tuple(map(bool, split)),
           str(device))
    if key not in cache:
        kc = kernel_constants(spec, qp, datapath, split)
        params = tuple(torch.as_tensor(g.params, device=device) for g in kc.groups) \
            if kc.groups else torch.as_tensor(kc.params, device=device)
        cache[key] = (kc, torch.as_tensor(kc.weights, device=device), params)
    return cache[key]
