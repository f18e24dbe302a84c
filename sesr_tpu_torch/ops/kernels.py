"""ctypes wrappers of the three fused whole-network kernels, each with its
launch counter.

``pe_exact_net``   csrc/sesr_net.cu, replaces sesr_tpu/ops/pallas_pipeline.py
                   build_pallas_forward
``fast_net``       csrc/sesr_net.cu, replaces sesr_tpu/ops/pallas_packed.py
                   build_pallas_packed_forward
``corrected_net``  csrc/sesr_corrected.cu, replaces sesr_tpu/ops/packed.py
                   _packed_exact_impl(corrected=True) (XLA, no Pallas kernel:
                   packed_hybrid_forward and packed_exact_forward(corrected=True));
                   ``corrected_net.audit`` launches its counting form (the
                   runtime audit's shadow run, counted in ``audit_launches``)

A network that no single launch runs (more than 16 convs, or no tile of
its plan fits a block: convert.py ``kernel_constants``) runs in the
layer-group form: each wrapper launches a chain, one launch per group of
consecutive convs, of csrc/sesr_net_group.cu (K1, K2) or
csrc/sesr_corrected_group.cu (the corrected kernel and its counting form),
the int8 activation and the shortcut crossing each boundary in device
memory; every launch of the chain is counted. A network whose convs are not
5x5 / 3x3 ... / 5x5 (KernelConstants.other_sizes) runs its chain in the
forms of other conv sizes, csrc/sesr_net_ksize.cu and
csrc/sesr_corrected_ksize.cu (the counting form:
csrc/sesr_corrected_ksize_audit.cu), each group's sizes passed with its
launch; a network of width 64 (33 to 64 hidden channels) in those forms'
width-64 instantiations, csrc/sesr_net_w64.cu and csrc/sesr_corrected_w64.cu
(csrc/sesr_corrected_w64_audit.cu), whatever its sizes (``chain_form``).

A wrapper takes the quantized int8 input on the card and returns the int8
output of the last conv (before the pixel shuffle); ``ops/pe_exact.py``,
``ops/fast.py`` and ``ops/corrected.py`` put the quantization,
dequantization and shuffle around it. The kernel is built (nvcc, at first
use) and launched on PyTorch's current stream; the wrapper raises if the
launch is refused.
"""

from __future__ import annotations

import collections
from typing import NamedTuple

import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.convert import (GROUP_FIRST, GROUP_LAST, MAX_LAYERS, block_words,
                                    device_constants, group_flags, group_records, kernel_width,
                                    layer_geometry, net_words, out_columns, pack_sizes, pe_groups,
                                    shipped_sizes, wgmma_geometry)
from sesr_tpu_torch.ops import _build
from sesr_tpu_torch.ops.conv import pixel_shuffle_nhwc
from sesr_tpu_torch.quant.integer import dequantize_output, quantize_input
from sesr_tpu_torch.quant.params import QuantParams

# output tile (rows, columns) of one thread block of K1 and K2: the fastest
# of the sweep in chip_smoke.py phase 5 on the 5-conv networks; about 112 KB
# (K2) and 94 KB (K1) of shared memory for sr_x2, so two blocks share an SM
# (csrc/sesr_net.cu smem_plan). A network whose plan at TILE does not fit a
# block (SESR-XL: 32 channels, 13 convs) takes the first of NET_TILES that
# does: the largest, since every tile recomputes its halo on every layer
TILE = (32, 32)
NET_TILES = (TILE, (24, 32), (24, 24), (16, 32), (16, 24), (16, 16), (8, 16), (8, 8))
# the corrected kernel's tiles in order of preference (one block an SM, so
# a larger tile only cuts the halo's share): it takes the first whose
# shared memory (corrected_smem_bytes) fits a block. nr hybrid takes 48x48
# (228,880 B), nr pe-exact 32x64, nrdm_6 32x48 (chip_smoke.py phase 5 sweeps
# them); a network whose weights or activations leave less room takes a
# smaller one (SESR-M11's 13 convs: 24x32 hybrid, 16x16 with every conv
# split; SESR-XL's 32 channels, its B staged a layer at a time: 16x32 with
# no conv split, 16x16 up to four PEs with some or all split, and past four
# PEs with its hybrid mask, 8x16 past four PEs with every conv split; at
# 9-16 PEs with a split conv its split layers' B in pieces, 16x16). A tile
# whose plan stages every layer's B whole is taken before one in pieces
# (CorrectedKernel.tile)
CORRECTED_TILES = ((48, 48), (32, 64), (32, 48), (32, 32), (24, 32), (16, 32), (16, 16), (8, 16))
SMEM_LIMIT = 232448                 # a block's shared memory on the H100
OUT_DTYPES = ("f32", "int8")
MAX_N = 128                         # csrc/sesr_corrected.cu kMaxN: most columns of a wgmma
PIECE_MAX = 53248                   # kPieceMax: most bytes of a piece of a layer's B
WHOLE_MAX = 106496                  # kWholeMax: most bytes of a split layer's B run whole
# K1 and K2 at width 64 (csrc/sesr_net_ksize.cu): most words of a piece of a
# conv's B, and of a one-pass conv's B staged whole
PIECE_WORDS, WHOLE_WORDS = 13312, 26624


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


def _ring(i: int, ks) -> int:
    """sum of k // 2 over convs i.. of a network of conv sizes ks:
    csrc/sesr_common.cuh ring (at 5, 3, ..., 3, 5), group_ring and ks_ring."""
    return sum(k // 2 for k in ks[i:])


def _group_kind(j: int, n: int, flags: int) -> int:
    """0 the network's first conv, 2 its last, 1 a conv between
    (sesr_common.cuh group_kind)."""
    return 0 if j == 0 and flags & GROUP_FIRST else 2 if j == n - 1 and flags & GROUP_LAST \
        else 1


def _group_sizes(n: int, flags: int, ks=None) -> tuple:
    """The conv sizes of a group of n convs: ks, or (None) 5x5 the
    network's first and last conv, 3x3 the others (csrc/sesr_common.cuh
    group_ring)."""
    return tuple(ks) if ks is not None else \
        tuple(3 if _group_kind(j, n, flags) == 1 else 5 for j in range(n))


def _plane_stride(n: int) -> int:
    """csrc/sesr_net.cu plane_stride."""
    return ((n + 23) & ~31) + 8


def net_smem_bytes(datapath: str, L: int, in_ch: int, out_ch: int, tile, split, pe: int,
                   general: bool, width: int) -> int:
    """Shared memory of one block of K1 (``datapath`` "exact") or K2
    ("fast") at ``tile`` (csrc/sesr_net.cu smem_plan; chip_smoke.py checks
    the two agree): room for the head and records of the parameter block at
    MAX_LAYERS convs, two weight buffers of the largest layer's B fragments
    (every layer split for K1 at 4 PEs in the shipped instantiation, the
    layers of ``split`` in the general one; one for K1's general
    instantiation at width 32 where two do not fit a block at ``tile``, as
    the corrected kernel decides its B regions), two ping-pong buffers of
    width / 4 planes, and the shortcut: width / 4 planes of int8 (K1) or
    width / 2 of int16 pairs (K2)."""
    th, tw = tile
    exact = datapath == "exact"
    ks = shipped_sizes(L)
    w_words = 0
    for i in range(L):
        sp = bool(split[i]) if general else exact
        k, ic = ks[i], (in_ch if i == 0 else width)
        passes, chunks, _ = layer_geometry(k, ic, sp, pe)
        cols = out_columns(out_ch) if i == L - 1 else width
        w_words = max(w_words, passes * chunks * 32 * 2 * (cols // 8))
    ext = [(th + 2 * _ring(i, ks)) * (tw + 2 * _ring(i, ks)) for i in range(L)]
    bufs = [0, _round_up(ext[0], 4)]                 # layer i reads bufs[i % 2 == 0]
    for i in range(1, L):
        bufs[i % 2 == 0] = max(bufs[i % 2 == 0], width // 4 * _plane_stride(ext[i]))
    sc = (width // 4 if exact else width // 2) * _plane_stride(ext[L - 1])
    two = 4 * (net_words(MAX_LAYERS, width) + 2 * w_words + sum(bufs) + sc)
    return two - 4 * w_words if exact and general and width == 32 and two > SMEM_LIMIT else two


def net_group_smem_bytes(datapath: str, n: int, flags: int, in_ch: int, out_ch: int, tile,
                         split, pe: int, width: int, ks=None) -> int:
    """Shared memory of one block of a group of the layer-group form of K1
    ("exact") or K2 ("fast") (csrc/sesr_net_group.cu group_plan; chip_smoke.py
    checks the two agree): ``net_smem_bytes``' terms with the group's
    extents (``_ring`` of ``_group_sizes``) and split flags ``split`` (one per conv of the
    group), room for MAX_LAYERS + 1 records, the input of a group past conv
    0 and the output of one before the last conv as width / 4 planes, the
    shortcut where the group writes it (the tile) or reads it (the last
    conv's input extent), and a split last conv of K1 off 4 PEs staged one
    pass at a time (two pass buffers where they fit, else one). The
    two-conv group (``pair_group``) keeps no shortcut. ``ks``: the group's
    conv sizes in the forms of other conv sizes (csrc/sesr_net_ksize.cu),
    which stage every split conv past layer 0 off 4 PEs a pass at a time
    (K1) and keep one B buffer where two do not fit (K1 and K2); at width 64
    a split conv past layer 0 at any PE count (K1), each pass in pieces of
    at most PIECE_WORDS, and a one-pass conv whose B passes WHOLE_WORDS in
    such pieces; None: 5x5 / 3x3 / 5x5."""
    th, tw = tile
    exact = datapath == "exact"
    sizes = _group_sizes(n, flags, ks)
    w_words = 0
    for j in range(n):
        kind = _group_kind(j, n, flags)
        k, ic = sizes[j], (in_ch if kind == 0 else width)
        passes, chunks, _ = layer_geometry(k, ic, bool(split[j]), pe)
        cols = out_columns(out_ch) if kind == 2 else width
        words = passes * chunks * 32 * 2 * (cols // 8)
        staged = (kind == 2 or (ks is not None and kind == 1)) and split[j] and exact \
            and (pe != 4 or width == 64)
        if staged:
            words //= passes                # staged a pass at a time
        if width == 64 and kind != 0 and (staged or words > WHOLE_WORDS):
            fw = 2 * (cols // 8)            # in pieces of at most PIECE_WORDS
            words = min(words, PIECE_WORDS // (32 * fw) * 32 * fw)
        w_words = max(w_words, words)
    ext = [(th + 2 * _ring(j, sizes)) * (tw + 2 * _ring(j, sizes)) for j in range(n + 1)]
    bufs = [0, _round_up(ext[0], 4) if flags & GROUP_FIRST else 0]  # layer j reads bufs[j % 2 == 0]
    for j in range(1 if flags & GROUP_FIRST else 0, n + 1 - bool(flags & GROUP_LAST)):
        bufs[j % 2 == 0] = max(bufs[j % 2 == 0], width // 4 * _plane_stride(ext[j]))
    rs = sizes[-1] // 2 if flags & GROUP_LAST else 0
    sc = (width // 4 if exact else width // 2) * _plane_stride((th + 2 * rs) * (tw + 2 * rs)) \
        if flags and not pair_group(n, flags) else 0
    two = 4 * (net_words(MAX_LAYERS + 1, width) + 2 * w_words + sum(bufs) + sc)
    one = (exact and width == 32) or ks is not None
    return two - 4 * w_words if one and two > SMEM_LIMIT else two


def pair_group(n: int, flags: int) -> bool:
    """Whether a group is a two-conv network's one group (GROUP_FIRST |
    GROUP_LAST, n = 2), whose first conv also adds the shortcut: the group
    kernels' two-conv form (csrc/sesr_net_group.cu sesr_net_pair_kernel,
    csrc/sesr_corrected_group.cu's tail instantiations), which keeps no
    shortcut."""
    return n == 2 and flags == GROUP_FIRST | GROUP_LAST


def tail_group(n: int, flags: int, out_ch: int) -> bool:
    """Whether a group of the corrected kernel runs in its tail
    instantiations (csrc/sesr_corrected_group.cu tail_group): the last group
    of a last conv past 16 output channels, or the two-conv group."""
    return bool(flags & GROUP_LAST) and (out_columns(out_ch) > 16 or pair_group(n, flags))


def chunk_groups(groups: int, ocp: int) -> int:
    """PE groups of one chunk of a layer's columns in the corrected kernel
    (csrc/sesr_corrected.cu chunk_groups): all of them where they fit a
    wgmma (MAX_N columns), else MAX_N // ocp, a power of two that divides
    them."""
    return groups if groups * ocp <= MAX_N else MAX_N // ocp


def pieces(steps: int, cols: int) -> tuple:
    """(pieces, k32 steps of a piece) of a chunk of ``cols`` columns and
    ``steps`` steps staged in pieces of at most PIECE_MAX bytes: the whole
    chunk where it fits, else the largest divisor of the steps whose piece
    fits, so that the pieces divide the steps (csrc/sesr_corrected.cu
    piece_count and piece_steps, five at 25 steps, the only count past one
    piece of a 5x5 / 3x3 network; piece_span in the forms of other conv
    sizes: 7 of 49, 9 of 81, 1 of 41, the steps of a 9x9 conv at width 16)."""
    per = next(d for d in range(steps, 0, -1) if steps % d == 0 and d * cols * 32 <= PIECE_MAX)
    return steps // per, per


def layer_pieces(k: int, ic: int, oc: int, split: bool, last: bool, pe: int) -> tuple:
    """(pieces a round, bytes of the largest) of one layer of the corrected
    kernel where B is staged in pieces: a split hidden or last layer whose
    B passes WHOLE_MAX, or any at width 32 and 16 PE groups (it runs the
    kernel's conv_pieces: piece_form), its chunks (``chunk_groups``), each
    in ``pieces``; at width 64 a one-pass layer or a split layer 0 whose B
    passes WHOLE_MAX too (csrc/sesr_corrected_ksize.cu ks_whole_pieces,
    ks_first_pieces); any other layer one piece, its whole B."""
    steps, groups, n = wgmma_geometry(k, ic, oc, split, last, pe)
    if ic == 64 and not split and steps * n * 32 > WHOLE_MAX:
        count, per = pieces(steps, n)      # width 64: a one-pass layer in pieces
        return count, per * n * 32
    if ic <= 4 and oc == 64 and split and steps * n * 32 > WHOLE_MAX:
        nc = chunk_groups(groups, 64) * 64  # width 64: a split layer 0 in pieces
        count, per = pieces(steps, nc)
        return n // nc * count, per * nc * 32
    if not split or ic <= 4 or (steps * n * 32 <= WHOLE_MAX
                                and not (ic == 32 and groups == 16)):
        return 1, steps * n * 32
    nc = chunk_groups(groups, n // groups) * (n // groups)
    count, per = pieces(steps, nc)
    return n // nc * count, per * nc * 32


class CorrectedPlan(NamedTuple):
    bytes: int          # shared memory of one block
    regions: int        # B regions: 0 resident, else 1 or 2
    pieces: bool        # B staged in pieces (the general instantiation only)


def corrected_plan(L: int, in_ch: int, out_ch: int, tile, split, pe: int,
                   width: int = 16, general: bool = False) -> CorrectedPlan:
    """(shared memory bytes, B regions, pieces) of one block of the
    corrected kernel at ``tile``, ``pe`` PEs and hidden width ``width``, in
    the ``general`` instantiation or the shipped one (csrc/sesr_corrected.cu
    smem_plan; chip_smoke.py checks the two agree): the parameter block
    (``block_words``), B, two ping-pong buffers of ``width`` bytes a pixel (each
    holding the pixels its layers' GEMMs read, past the extent too; at
    width 32 a layer's input is two planes of 16 bytes a pixel, each
    rounded up to 128 bytes), the int16 shortcut of 2 ``width`` bytes a
    pixel and 16 bytes of scratch. B regions: 0 at width 16 up to eight
    PEs (up to four past 16 output channels), where every layer's B is
    resident; at width 32 and at 16 PE groups (and 8 past 16 output
    channels: staged_b), 2 (the even layers' and the odd layers', the next
    layer's B staged while a layer computes) where that fits a block, else
    1 (the largest layer's); where not even that fits, the general
    instantiations with piece forms (past 16 output channels, or at width
    32 and 16 PE groups with a split layer past layer 0: piece_kernel)
    stage each split layer's B in pieces (``layer_pieces``): 2 regions of
    the largest piece or layer, one piece staged while the one before
    computes, where they fit, else 1."""
    th, tw = tile
    ks = shipped_sizes(L)
    b_bytes, units = [], []
    bufs = [0, (th + 2 * _ring(0, ks)) * (tw + 2 * _ring(0, ks)) * 4]
    for i in range(L):
        last = i == L - 1
        k = ks[i]
        ic = in_ch if i == 0 else width
        oc = out_ch if last else width
        steps, _, n = wgmma_geometry(k, ic, oc, bool(split[i]), last, pe)
        b_bytes.append(steps * n * 32)
        units.append(layer_pieces(k, ic, oc, bool(split[i]), last, pe)[1])
        r = _ring(i, ks)
        ih, iw = th + 2 * r, tw + 2 * r
        if i == 0:                  # the widened pixels of the last step's second half
            reach = 4 * iw + 4
        elif width == 16:           # tap k * k - 1, and a pad tap one pixel on
            reach = (k - 1) * (iw + 1) + (k * k) % 2
        else:                       # tap k * k - 1, in each plane
            reach = (k - 1) * (iw + 1)
        cap = (_round_up((ih - k + 1) * iw, 64) + reach) * 16
        if i and width == 32:
            cap = 2 * _round_up(cap, 128)
        bufs[i % 2] = max(bufs[i % 2], cap)
    w_at = _round_up(block_words(pe, L, width, out_ch) * 4, 128)
    r_sc = _ring(L - 1, ks)
    rest = (_round_up(bufs[0], 128) + _round_up(bufs[1], 128)
            + (th + 2 * r_sc) * (tw + 2 * r_sc) * 2 * width + 16)     # + the scratch word

    def total(w_bytes):
        return _round_up(w_at + w_bytes, 128) + rest

    groups, wide_out = pe_groups(pe), out_columns(out_ch) > 16
    if not (width == 32 or groups == 16 or (wide_out and groups == 8)):       # staged_b
        return CorrectedPlan(total(sum(b_bytes)), 0, False)
    even, odd = max(b_bytes[0::2]), max(b_bytes[1::2])
    plans = [CorrectedPlan(total(_round_up(even, 128) + odd), 2, False),
             CorrectedPlan(total(max(even, odd)), 1, False)]
    if general and (wide_out or (groups == 16 and width == 32 and any(split[1:]))):
        # piece_kernel
        unit = max(units)
        plans += [CorrectedPlan(total(_round_up(unit, 128) + unit), 2, True),
                  CorrectedPlan(total(unit), 1, True)]
    return next((p for p in plans if p.bytes <= SMEM_LIMIT), plans[-1])


def corrected_group_plan(n: int, flags: int, in_ch: int, out_ch: int, tile, split, pe: int,
                         width: int, ks=None) -> CorrectedPlan:
    """(shared memory bytes, B regions, pieces) of one block of a group of
    the corrected kernel's layer-group form (csrc/sesr_corrected_group.cu
    group_plan; chip_smoke.py checks the two agree): ``corrected_plan``'s
    terms with the group's extents and records (``group_records``), split
    flags ``split`` (one per conv of the group), the input of a group past
    conv 0 and the output of one before the last conv as ``width``-byte
    pixels, and the shortcut where the group writes it (the tile) or reads
    it (the last conv's input extent); the instantiations at 16 PE groups
    and width 32 have the piece forms. A tail group (``tail_group``) runs
    in the tail instantiations: its block holds the last conv's own rows
    past ``width`` channels (``out_rows``), its B is staged at 8 PE groups
    too and may go in pieces at every PE group count, and the two-conv
    group keeps no shortcut. ``ks``: the group's conv sizes in the forms of
    other conv sizes (csrc/sesr_corrected_ksize.cu: every group in the tail
    instantiations' forms, B always staged); None: 5x5 / 3x3 / 5x5."""
    th, tw = tile
    sizes = _group_sizes(n, flags, ks)
    tail = tail_group(n, flags, out_ch) or ks is not None
    b_bytes, units = [], []
    bufs = [0, (th + 2 * _ring(0, sizes)) * (tw + 2 * _ring(0, sizes)) * 4
            if flags & GROUP_FIRST else 0]
    for j in range(n + 1 - bool(flags & GROUP_LAST)):
        kind = _group_kind(j, n, flags) if j < n else 1
        r = _ring(j, sizes)
        ih, iw = th + 2 * r, tw + 2 * r
        if j < n:
            k = sizes[j]
            ic = in_ch if kind == 0 else width
            oc = out_ch if kind == 2 else width
            steps, _, cols = wgmma_geometry(k, ic, oc, bool(split[j]), kind == 2, pe)
            b_bytes.append(steps * cols * 32)
            units.append(layer_pieces(k, ic, oc, bool(split[j]), kind == 2, pe)[1])
            if kind == 0:           # the widened pixels of the last step's second half
                reach = (k - 1) * iw + 8 * (-(-k // 8) - 1) + 4
            elif width == 16:       # tap k * k - 1, and a pad tap one pixel on
                reach = (k - 1) * (iw + 1) + (k * k) % 2
            else:                   # tap k * k - 1, in each plane
                reach = (k - 1) * (iw + 1)
            cap = (_round_up((ih - k + 1) * iw, 64) + reach) * 16
        else:                       # the group's output: the tile
            cap = th * tw * 16
        if kind != 0 and width > 16:  # width / 16 planes
            cap = width // 16 * _round_up(cap, 128)
        bufs[j % 2] = max(bufs[j % 2], cap)
    rows = tail and (ks is None or flags & GROUP_LAST)     # the last conv's own rows
    w_at = _round_up(block_words(pe, group_records(n, flags), width, out_ch if rows else 0) * 4,
                     128)
    rs = sizes[-1] // 2 if flags & GROUP_LAST else 0
    sc = (th + 2 * rs) * (tw + 2 * rs) * 2 * width if flags and not pair_group(n, flags) else 0
    rest = _round_up(bufs[0], 128) + _round_up(bufs[1], 128) + sc + 16

    def total(w_bytes):
        return _round_up(w_at + w_bytes, 128) + rest

    groups = pe_groups(pe)
    if ks is None and not (width == 32 or groups == 16 or (tail and groups == 8)):   # staged_b
        return CorrectedPlan(total(sum(b_bytes)), 0, False)
    even, odd = max(b_bytes[0::2]), max(b_bytes[1::2], default=0)
    plans = [CorrectedPlan(total(_round_up(even, 128) + odd), 2, False),
             CorrectedPlan(total(max(even, odd)), 1, False)]
    if tail or (groups == 16 and width == 32):                             # the piece forms
        unit = max(units)
        plans += [CorrectedPlan(total(_round_up(unit, 128) + unit), 2, True),
                  CorrectedPlan(total(unit), 1, True)]
    return next((p for p in plans if p.bytes <= SMEM_LIMIT), plans[-1])


def group_sizes(spec: SESRSpec, first: int, last: int):
    """The conv sizes of the group of convs first..last of ``spec``'s
    network where it runs in the forms of other conv sizes (its sizes not
    5x5 / 3x3 ... / 5x5, or its width 64), else None."""
    ks = spec.kernel_sizes
    if ks == shipped_sizes(spec.num_convs) and kernel_width(spec.num_channels) <= 32:
        return None
    return ks[first:last + 1]


def chain_form(kc) -> str:
    """The layer-group form's kernels a call with the constants kc
    launches: "group" (csrc/sesr_net_group.cu, csrc/sesr_corrected_group.cu),
    "ksize" (the forms of other conv sizes at widths 16 and 32) or "w64"
    (their width-64 instantiations)."""
    return "w64" if kc.width == 64 else "ksize" if kc.other_sizes else "group"


def corrected_smem_bytes(L: int, in_ch: int, out_ch: int, tile, split, pe: int,
                         width: int = 16, general: bool = False) -> int:
    """Shared memory of one block of the corrected kernel (``corrected_plan``)."""
    return corrected_plan(L, in_ch, out_ch, tile, split, pe, width, general).bytes


class NetKernel:
    """One entry point of a kernel library (``csrc/<library>.cu``) and its
    layer-group forms (``chain_entry``: the libraries and entry points
    named ``<prefix>_group``, ``<prefix>_ksize`` and ``<prefix>_w64``).
    ``launches`` counts the launches this wrapper made (each group's launch
    of a chain), ``split_launches`` the same launches by their per-layer
    split mask (the corrected kernel's modes; None for the other kernels).
    Its tile is the first of ``tiles`` whose shared memory (``smem_bytes``;
    a group's ``group_smem_bytes``) fits a block, and a tile that does not
    fit is refused before any launch."""

    tiles = NET_TILES

    def __init__(self, symbol: str, datapath: str, library: str = "sesr_net",
                 prefix: str = "sesr_net"):
        self.symbol = symbol
        self.datapath = datapath
        self.library = library
        self.prefix = prefix
        self.launches = 0
        self.split_launches = collections.Counter()
        self._plans = {}

    def smem_bytes(self, spec: SESRSpec, tile, split, pe: int, general: bool = False) -> int:
        """Shared memory of one block at ``tile`` (K1 and K2: ``net_smem_bytes``)."""
        return net_smem_bytes(self.datapath, spec.num_convs, spec.in_channels,
                              spec.conv_out_channels, tile, split, pe, general,
                              kernel_width(spec.num_channels))

    def group_smem_bytes(self, spec: SESRSpec, first: int, last: int, split, pe: int,
                         tile) -> int:
        """Shared memory of one block of the group of convs first..last at
        ``tile`` (``split``: the network's per-layer flags); K1 and K2:
        ``net_group_smem_bytes``."""
        flags = group_flags(first, last, spec.num_convs)
        return net_group_smem_bytes(self.datapath, last - first + 1, flags, spec.in_channels,
                                    spec.conv_out_channels, tile, split[first:last + 1], pe,
                                    kernel_width(spec.num_channels),
                                    group_sizes(spec, first, last))

    def tile(self, spec: SESRSpec, split, pe: int, general: bool = False) -> tuple:
        """The default output tile for ``spec``'s network at ``pe`` PEs in
        the ``general`` instantiation or the shipped one."""
        split = split or (False,) * spec.num_convs
        for tile in self.tiles:
            if self.smem_bytes(spec, tile, split, pe, general) <= SMEM_LIMIT:
                return tile
        raise ValueError(f"{self.symbol}: no tile of {self.tiles} fits {spec.name}")

    def group_tile(self, spec: SESRSpec, first: int, last: int, split, pe: int) -> tuple:
        """The default tile of the group of convs first..last."""
        for tile in self.tiles:
            if self.group_smem_bytes(spec, first, last, split, pe, tile) <= SMEM_LIMIT:
                return tile
        raise ValueError(f"{self.symbol}: no tile of {self.tiles} fits convs {first}-{last} of "
                         f"{spec.name}")

    def check_tile(self, spec: SESRSpec, tile, split, pe: int, general: bool = False,
                   group=None) -> int:
        """The tile's shared memory (``smem_bytes``, or for ``group`` =
        (first, last) ``group_smem_bytes``); raises ValueError for a tile
        the kernel does not take."""
        if not (1 <= tile[0] <= 1024 and 1 <= tile[1] <= 1024):
            raise ValueError(f"{self.symbol}: tile {tuple(tile)} outside 1..1024")
        need = self.smem_bytes(spec, tile, split, pe, general) if group is None else \
            self.group_smem_bytes(spec, *group, split, pe, tile)
        if need > SMEM_LIMIT:
            raise ValueError(f"{self.symbol}: tile {tuple(tile)} needs {need} B of shared "
                             f"memory for {spec.name}"
                             f"{'' if group is None else f' convs {group[0]}-{group[1]}'}, more "
                             f"than a block's {SMEM_LIMIT}")
        return need

    def plan(self, spec: SESRSpec, split, pe: int, general: bool = False, tile=None,
             group=None) -> tuple:
        """(tile, shared memory bytes) of a launch at ``tile``, or at the
        default tile (``self.tile``; ``group_tile`` for ``group`` = (first,
        last), a group of the layer-group form) when it is None; raises
        ValueError for a tile the kernel does not take. Kept per (spec,
        split, pe, general, tile, group), so that a call after the first
        costs a dict lookup."""
        key = (spec, tuple(split), pe, general, None if tile is None else tuple(tile), group)
        if key not in self._plans:
            if tile is None:
                tile = self.tile(spec, split, pe, general) if group is None else \
                    self.group_tile(spec, *group, split, pe)
            tile = tuple(tile)
            self._plans[key] = (tile, self.check_tile(spec, tile, split, pe, general, group))
        return self._plans[key]

    def launch_plans(self, spec: SESRSpec, kc, tile=None) -> list:
        """[(group, tile, shared memory bytes)] of a call with the constants
        kc: one launch (group None), or one per group (GroupConstants) of the
        layer-group form, each at its default tile or at ``tile``."""
        if not kc.groups:
            return [(None, *self.plan(spec, kc.pe_split, kc.pe, kc.general, tile))]
        return [(g, *self.plan(spec, kc.pe_split, kc.pe, kc.general, tile, (g.first, g.last)))
                for g in kc.groups]

    def extra_args(self, kc, group=None) -> tuple:
        """The entry point's arguments after the tile: the split mask (a
        group's own), the PE count, the instantiation (0 shipped, 1 general,
        2 the general one's wide form: KernelConstants.general and .wide)
        and the hidden width; K2's one-launch entry point takes the last two
        only."""
        gen = 2 if kc.wide else int(kc.general)
        if group is not None:
            return (group.split, kc.pe, gen, kc.width)
        if self.datapath == "fast":
            return (gen, kc.width)
        return (sum(1 << i for i, f in enumerate(kc.pe_split) if f), kc.pe, gen, kc.width)

    def chain_entry(self, kc, audit: bool = False) -> tuple:
        """(library, entry point) of the layer-group form's launches for the
        constants kc (``chain_form``); ``audit``: the counting form's, whose
        entry point in the forms of other conv sizes has a library of its
        own (csrc/sesr_corrected_ksize_audit.cu, sesr_corrected_w64_audit.cu)."""
        form = chain_form(kc)
        symbol = f"{self.prefix}_{form}{'_audit' if audit else ''}"
        return (f"{self.prefix}_group" if form == "group" else symbol), symbol

    def reset(self) -> None:
        self.launches = 0
        self.split_launches.clear()

    def __call__(self, spec: SESRSpec, qp: QuantParams, x_q: torch.Tensor,
                 tile=None, split=None) -> torch.Tensor:
        """x_q: int8 (N, H, W, C_in) contiguous on a CUDA device. Returns the
        int8 output (N, H, W, C_out) of the last conv. ``tile``: the output
        tile (rows, columns) of one thread block (default ``self.tile(spec,
        split, pe, general)``; in the layer-group form every group's, default
        each group's own). ``split`` (the corrected kernel only, and
        required there): one flag per layer, set where the layer runs one
        pass per PE (ops/corrected.py ``split_layers``)."""
        return self.run(spec, qp, x_q, tile, split)[0]

    def run(self, spec: SESRSpec, qp: QuantParams, x_q: torch.Tensor, tile=None,
            split=None) -> tuple:
        """``__call__``'s output and the layer-group form's boundaries:
        [(GroupConstants, its output, the shortcut tensor)] for each group
        before the last ([] for one launch)."""
        out, kc, trail = self._launch(spec, qp, x_q, tile, split)
        made = max(1, len(kc.groups))
        self.launches += made
        self.split_launches[None if split is None else tuple(kc.pe_split)] += made
        return out, trail

    def _check(self, spec: SESRSpec, x_q: torch.Tensor, split) -> None:
        if x_q.device.type != "cuda":
            raise ValueError(f"{self.symbol} runs on a CUDA tensor, got {x_q.device}")
        if x_q.dtype != torch.int8 or x_q.dim() != 4 \
                or x_q.shape[3] != spec.in_channels or not x_q.is_contiguous():
            raise ValueError(f"{self.symbol} takes a contiguous int8 (N, H, W, "
                             f"{spec.in_channels}) tensor, got {x_q.dtype} "
                             f"{tuple(x_q.shape)}")
        if (split is None) != (self.datapath != "corrected"):
            raise ValueError(f"{self.symbol}: a split mask is "
                             f"{'required' if split is None else 'not taken'}")

    def _launch(self, spec: SESRSpec, qp: QuantParams, x_q: torch.Tensor, tile, split,
                count=None):
        """One launch of the library's entry point, or the chain of the
        layer-group form, with the arguments of ``run``; ``count`` = (int64
        counts (L,), region) launches the counting form. Returns (int8
        output, KernelConstants, boundaries). Counts nothing."""
        self._check(spec, x_q, split)
        kc, weights, params = device_constants(spec, qp, self.datapath, x_q.device, split)
        n, h, w, _ = x_q.shape
        plans = self.launch_plans(spec, kc, tile)
        out = torch.empty((n, h, w, kc.out_channels), dtype=torch.int8, device=x_q.device)
        if out.numel() == 0:
            return out, kc, []
        if kc.groups:
            y, trail = self._chain(kc, weights, params, x_q, plans, count)
            return y, kc, trail
        lib = _build.load(self.library)
        symbol = self.symbol if count is None else self.audit_symbol
        more = () if count is None else (count[0].data_ptr(), *count[1])
        with torch.cuda.device(x_q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, symbol)(
                x_q.data_ptr(), out.data_ptr(), weights.data_ptr(),
                params.data_ptr(), n, h, w, kc.num_layers, kc.in_channels,
                kc.out_channels, *plans[0][1], *self.extra_args(kc), *more, stream)
        if err != 0:
            raise RuntimeError(f"{symbol} launch failed: "
                               f"{_build.error_string(self.library, err)} ({err})")
        return out, kc, []

    def _chain(self, kc, weights, params, x_q, plans, count):
        """The layer-group form: one launch per group, each group's output
        the next one's input; the shortcut written by the first group and
        read by the last. Returns (the network's int8 output, the
        boundaries: ``run``'s)."""
        n, h, w, _ = x_q.shape
        ksize = kc.ksize_form                # the forms of other conv sizes
        library, symbol = self.chain_entry(kc, count is not None)
        lib = _build.load(library)
        exact = self.datapath == "exact"
        sc = torch.empty((n, h, w, kc.width), dtype=torch.int8 if exact else torch.int16,
                         device=x_q.device) if len(kc.groups) > 1 else None
        lead = (int(exact),) if self.datapath != "corrected" else ()
        cur, trail = x_q, []
        with torch.cuda.device(x_q.device):
            stream = torch.cuda.current_stream().cuda_stream
            for (g, tile, _), prm in zip(plans, params):
                last = bool(g.flags & GROUP_LAST)
                out = torch.empty((n, h, w, kc.out_channels if last else kc.width),
                                  dtype=torch.int8, device=x_q.device)
                more = () if count is None else \
                    (count[0].data_ptr() + 8 * g.first, *count[1])
                sizes = (pack_sizes(kc.ksizes[g.first:g.last + 1]),) if ksize else ()
                err = getattr(lib, symbol)(
                    *lead, cur.data_ptr(), out.data_ptr(), weights.data_ptr(), prm.data_ptr(),
                    0 if sc is None else sc.data_ptr(), n, h, w, g.convs, g.flags,
                    kc.in_channels, kc.out_channels, *tile, *self.extra_args(kc, g), *sizes,
                    *more, stream)
                if err != 0:
                    raise RuntimeError(
                        f"{symbol} launch failed (convs {g.first}-{g.last}): "
                        f"{_build.error_string(library, err)} ({err})")
                if not last:
                    trail.append((g, out, sc))
                cur = out
        return cur, trail


class CorrectedKernel(NetKernel):
    """The corrected kernel: its tiles are CORRECTED_TILES, its shared
    memory ``corrected_smem_bytes`` (the same in every instantiation of a
    width, and in the counting form; a group's ``corrected_group_plan``).
    ``audit`` launches the counting form (``sesr_corrected_audit``, or
    ``sesr_corrected_group_audit`` a group), counted in ``audit_launches``
    and not in ``launches``."""

    tiles = CORRECTED_TILES
    audit_symbol = "sesr_corrected_audit"

    def __init__(self, symbol: str, datapath: str, library: str):
        super().__init__(symbol, datapath, library, "sesr_corrected")
        self.audit_launches = 0

    def reset(self) -> None:
        super().reset()
        self.audit_launches = 0

    def smem_bytes(self, spec: SESRSpec, tile, split, pe: int, general: bool = False) -> int:
        return corrected_smem_bytes(spec.num_convs, spec.in_channels, spec.conv_out_channels,
                                    tile, split, pe, kernel_width(spec.num_channels), general)

    def group_plan(self, spec: SESRSpec, first: int, last: int, split, pe: int,
                   tile) -> CorrectedPlan:
        return corrected_group_plan(last - first + 1, group_flags(first, last, spec.num_convs),
                                    spec.in_channels, spec.conv_out_channels, tile,
                                    split[first:last + 1], pe, kernel_width(spec.num_channels),
                                    group_sizes(spec, first, last))

    def group_smem_bytes(self, spec: SESRSpec, first: int, last: int, split, pe: int,
                         tile) -> int:
        return self.group_plan(spec, first, last, split, pe, tile).bytes

    def tile(self, spec: SESRSpec, split, pe: int, general: bool = False) -> tuple:
        """The first of ``tiles`` whose plan fits a block with every layer's
        B staged whole (or resident), else the first whose plan fits with B
        in pieces (``corrected_plan``): a smaller tile before pieces."""
        split = split or (False,) * spec.num_convs
        plans = {t: corrected_plan(spec.num_convs, spec.in_channels, spec.conv_out_channels, t,
                                   split, pe, kernel_width(spec.num_channels), general)
                 for t in self.tiles}
        return self._first_fit(plans, spec)

    def group_tile(self, spec: SESRSpec, first: int, last: int, split, pe: int) -> tuple:
        """``tile``'s rule for the group of convs first..last."""
        return self._first_fit({t: self.group_plan(spec, first, last, split, pe, t)
                                for t in self.tiles}, spec)

    def _first_fit(self, plans: dict, spec: SESRSpec) -> tuple:
        for pieces in (False, True):
            for t, plan in plans.items():
                if plan.bytes <= SMEM_LIMIT and plan.pieces == pieces:
                    return t
        raise ValueError(f"{self.symbol}: no tile of {self.tiles} fits {spec.name}")

    def audit(self, spec: SESRSpec, qp: QuantParams, x_q: torch.Tensor, split,
              region=None, tile=None) -> tuple:
        """The counting form on x_q as ``__call__`` takes it: (the int8
        output of ``__call__``, int64 counts (L,) on the card), counts[i]
        the PE partials that the 18-bit clamp changed on layer i if
        ``split`` flags it (0 elsewhere) at the outputs of ``region`` = (y0,
        y1, x0, x1) in input pixels of every frame (default: the whole
        frame). One launch, or one per group of the layer-group form, each
        counting its own convs."""
        n, h, w = x_q.shape[:3]
        y0, y1, x0, x1 = region or (0, h, 0, w)
        if not (0 <= y0 <= y1 <= h and 0 <= x0 <= x1 <= w):
            raise ValueError(f"{self.audit_symbol}: region {region} outside the {h}x{w} frame")
        counts = torch.zeros(spec.num_convs, dtype=torch.int64, device=x_q.device)
        out, kc, _ = self._launch(spec, qp, x_q, tile, split, (counts, (y0, y1, x0, x1)))
        self.audit_launches += max(1, len(kc.groups))
        return out, counts


pe_exact_net = NetKernel("sesr_pe_exact_net", "exact")
fast_net = NetKernel("sesr_fast_net", "fast")
corrected_net = CorrectedKernel("sesr_corrected_net", "corrected", "sesr_corrected")
NET_KERNELS = (pe_exact_net, fast_net, corrected_net)


def kernel_of(datapath: str) -> NetKernel:
    """The kernel that runs ``datapath`` (convert.DATAPATHS)."""
    return {k.datapath: k for k in NET_KERNELS}[datapath]


def reset_launch_counts() -> None:
    for k in NET_KERNELS:
        k.reset()


def run_net(kernel: NetKernel, spec: SESRSpec, qp: QuantParams,
            x: torch.Tensor, out_dtype: str = "f32", split=None,
            quantized: bool = False) -> torch.Tensor:
    """Quantize x (NHWC float on a CUDA device; with ``quantized`` x is the
    int8 input already), launch ``kernel`` (with ``split``, the corrected
    kernel's mask), and return the output in the ``out_dtype`` contract:
    dequantized float32 ("f32") or the raw int8 image ("int8"),
    pixel-shuffled."""
    x_q = x if quantized else quantize_input(x, qp).to(torch.int8)
    return output_of(kernel(spec, qp, x_q.contiguous(), split=split), spec, qp, out_dtype)


def output_of(y: torch.Tensor, spec: SESRSpec, qp: QuantParams, out_dtype: str) -> torch.Tensor:
    """A kernel's int8 output in the ``out_dtype`` contract, pixel-shuffled."""
    if out_dtype == "f32":
        y = dequantize_output(y, qp)
    if spec.has_pixel_shuffle:
        y = pixel_shuffle_nhwc(y, spec.scaling_factor)
    return y
