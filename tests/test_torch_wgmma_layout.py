"""A numpy model of the wgmma GEMM tile of csrc/wgmma_gemm.cuh, which the CPU
cannot compile: how TMA lays a stage into shared memory (the 128-byte
swizzle), how the wgmma descriptors read it back (K-major for A and int8 B,
MN-major for bf16 B), the int8 pass that turns a landed B stage into its
K-major copy (and reads probe_packed_dot's byte planes in place), and where
wgmma's accumulator fragment puts each result. Each piece is checked
against a plain ``a @ b``. The index maps, constants and ``__byte_perm``
selectors are read from the source, so the model and the kernel cannot
drift apart; the hardware's side (the swizzle on address bits, the
descriptor's addressing, the fragment layout) is written here from the PTX
ISA. The kernel itself is held against its plain version on the card by
chip_smoke.py phase 7.
"""

import re

import numpy as np
import pytest

from sesr_tpu_torch.ops import _build

SRC = (_build.CSRC / "wgmma_gemm.cuh").read_text()
CONST = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", SRC)}


def _expr(fn):
    """The return expression of the one-line device function ``fn``."""
    m = re.search(rf"int {fn}\(([^)]*)\) \{{\s*return (.*?);\s*\}}", SRC, re.S)
    assert m, fn
    args = [a.split()[-1] for a in m.group(1).split(",")]
    return eval(f"lambda {', '.join(args)}: {m.group(2)}")   # C and Python agree on these operators


swizzle128, b_row_dense, b_row_planes, item_kc, acc_row, acc_col = (
    _expr(f) for f in ("swizzle128", "b_row_dense", "b_row_planes", "item_kc", "acc_row",
                       "acc_col"))
STAGE_K = CONST["kStageK"]


def _hw_swizzle(addr):
    """The 128-byte swizzle as the hardware applies it to a shared-memory
    byte address: bits 4-6 ^= bits 7-9."""
    return addr ^ (((addr >> 7) & 7) << 4)


def _tma_swizzled(rows):
    """A (R, 128) byte box as TMA writes it with CU_TENSOR_MAP_SWIZZLE_128B,
    through the source's swizzle128; rows past the box stay zero."""
    smem = np.zeros(rows.shape[0] * 128, np.uint8)
    for r in range(rows.shape[0]):
        for c in range(8):
            smem[swizzle128(r, c):swizzle128(r, c) + 16] = rows[r, 16 * c:16 * c + 16]
    return smem


def _kmajor_read(smem, base, rows):
    """What a K-major descriptor (128-byte swizzle, SBO kSbo) at byte
    ``base`` reads: a (rows, kKStep) byte tile, row r at (r / 8) SBO + (r % 8)
    128 + byte."""
    step = CONST["kKStep"]
    out = np.empty((rows, step), np.uint8)
    for r in range(rows):
        for kb in range(step):
            out[r, kb] = smem[_hw_swizzle(base + (r // 8) * CONST["kSbo"] + (r % 8) * 128 + kb)]
    return out


def test_constants_and_swizzle():
    assert (STAGE_K, CONST["kSbo"], CONST["kKStep"]) == (128, 1024, 32)
    assert (CONST["kMnLbo"], CONST["kMnKStep"]) == (64 * 128, 16 * 128)
    seen = set()
    for row in range(64):
        for chunk in range(8):
            for b in range(16):
                off = swizzle128(row, chunk) + b
                assert off == _hw_swizzle(row * 128 + 16 * chunk + b)
                seen.add(off)
    assert seen == set(range(64 * 128))             # a permutation of the tile's bytes


@pytest.mark.parametrize("rows", [64, 128])
def test_kmajor_descriptor_reads_a_tma_stage(rows):
    """A (rows, 128 bytes of K) landed by TMA, read by the consumers' K-major
    descriptors at start + kKStep ks (warpgroup cw from row 64 cw): each
    read is A's bytes of that k step."""
    a = np.random.default_rng(rows).integers(0, 256, (rows, STAGE_K), dtype=np.uint8)
    smem = _tma_swizzled(a)
    for cw in range(rows // 64):
        for ks in range(STAGE_K // CONST["kKStep"]):
            got = _kmajor_read(smem, cw * 64 * STAGE_K + ks * CONST["kKStep"], 64)
            np.testing.assert_array_equal(got, a[64 * cw:64 * cw + 64, 32 * ks:32 * ks + 32])


def test_mn_major_descriptor_reads_bf16_b():
    """bf16 B (64 k rows, BN columns) landed as BN / 64 TMA boxes of (64
    columns, 64 k rows) at kMnLbo apart, read by the MN-major descriptor
    (LBO kMnLbo between 64-column groups, SBO kSbo between 8-row k groups,
    start + kMnKStep per k16 step): the product of the read operands is
    a @ b."""
    bn, kk = 256, 64
    rng = np.random.default_rng(1)
    b = rng.integers(-8, 8, (kk, bn)).astype(np.float32)
    a = rng.integers(-8, 8, (64, kk)).astype(np.float32)
    b16 = (b.view(np.uint32) >> 16).astype(np.uint16)        # exact: small integers
    smem = np.zeros(bn * kk * 2, np.uint8)
    for q in range(bn // 64):
        box = b16[:, 64 * q:64 * q + 64].copy().view(np.uint8)   # (64 k, 128 bytes)
        smem[q * CONST["kMnLbo"]:(q + 1) * CONST["kMnLbo"]] = _tma_swizzled(box)
    got = np.zeros((64, bn), np.float32)
    for ks in range(kk // 16):
        tile = np.empty((16, bn), np.uint16)
        for k in range(16):
            for n in range(bn):
                addr = (ks * CONST["kMnKStep"] + (n // 64) * CONST["kMnLbo"] +
                        (k // 8) * CONST["kSbo"] + (k % 8) * 128 + (n % 64) * 2)
                lo, hi = smem[_hw_swizzle(addr)], smem[_hw_swizzle(addr + 1)]
                tile[k, n] = int(lo) | int(hi) << 8
        bk = (tile.astype(np.uint32) << 16).view(np.float32)
        got += a[:, 16 * ks:16 * ks + 16] @ bk
    np.testing.assert_array_equal(got, a @ b)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of (y:x)."""
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _transpose_source():
    body = SRC[SRC.index("__device__ __forceinline__ void transpose_stage"):
               SRC.index("template <class TL, bool BF16, bool PLANES, int EPI>")]
    sels = [int(s, 16) for s in re.findall(r"__byte_perm\([^)]*?(0x[0-9a-f]{4})\)", body)]
    assert sels == [0x5140, 0x5140, 0x7362, 0x7362, 0x5410, 0x7632, 0x5410, 0x7632]
    assert "sts128(bt + swizzle128(8 * c2 + t, kc)" in body
    assert "const int c2 = it % PAIRS, kc = item_kc(it / PAIRS, c2);" in body
    return sels


def _transpose_stage(raw, bn, planes, sels):
    """transpose_stage on a landed int8 stage ``raw`` (128 rows of bn bytes,
    row b_row(k) holding k), every item of every thread: the K-major tile."""
    pairs = bn // 8
    words = raw.reshape(STAGE_K, bn // 4 * 4).view("<u4")            # (128, bn / 4)
    bt = np.zeros(bn * 128, np.uint8)
    row_of = b_row_planes if planes else b_row_dense
    for it in range(STAGE_K // 16 * pairs):
        c2, kc = it % pairs, item_kc(it // pairs, it % pairs)
        ow = np.zeros((8, 4), np.uint32)
        for g in range(4):
            w = [words[row_of(16 * kc + 4 * g + i), 2 * c2:2 * c2 + 2] for i in range(4)]
            for h in range(2):
                w0, w1, w2, w3 = (int(w[i][h]) for i in range(4))
                x01, x23 = _byte_perm(w0, w1, sels[0]), _byte_perm(w2, w3, sels[1])
                y01, y23 = _byte_perm(w0, w1, sels[2]), _byte_perm(w2, w3, sels[3])
                ow[4 * h:4 * h + 4, g] = [_byte_perm(x01, x23, sels[4]), _byte_perm(x01, x23, sels[5]),
                                          _byte_perm(y01, y23, sels[6]), _byte_perm(y01, y23, sels[7])]
        for t in range(8):
            off = swizzle128(8 * c2 + t, kc)
            bt[off:off + 16] = ow[t].astype("<u4").view(np.uint8)
    return bt


@pytest.mark.parametrize("bn", [64, 256])
@pytest.mark.parametrize("planes", [False, True], ids=["dense", "planes"])
def test_int8_transpose_and_kmajor_read_give_a_at_b(bn, planes):
    """int8 B (K, bn) landed stage by stage (dense rows, or the byte planes
    wb (4, K / 4, bn) through a 3-D box (bn, 32, 4)), turned K-major by the
    modelled transposing pass and read by the K-major descriptor; with A read
    the same way, the stages' exact sums are a @ b (K = 320 bytes: the last
    stage half past K, zero-filled by TMA)."""
    sels = _transpose_source()
    m, k = 64, 320
    rng = np.random.default_rng(bn + planes)
    a = rng.integers(-128, 128, (m, k)).astype(np.int8)
    b = rng.integers(-128, 128, (k, bn)).astype(np.int8)
    wb = np.stack([b[p::4] for p in range(4)])               # wb[p][j] = b[4 j + p]
    stages = -(-k // STAGE_K)
    acc = np.zeros((m, bn), np.int64)
    for st in range(stages):
        k0 = st * STAGE_K
        a_box = np.zeros((m, STAGE_K), np.int8)
        a_box[:, :min(STAGE_K, k - k0)] = a[:, k0:k0 + STAGE_K]
        raw = np.zeros((STAGE_K, bn), np.int8)               # TMA's landing, by b_row
        if planes:
            j0 = k0 // 4
            for p in range(4):
                rows = wb[p, j0:j0 + STAGE_K // 4]
                raw[p * 32:p * 32 + rows.shape[0]] = rows
        else:
            raw[:min(STAGE_K, k - k0)] = b[k0:k0 + STAGE_K]
        bt = _transpose_stage(raw.view(np.uint8), bn, planes, sels)
        smem_a = _tma_swizzled(a_box.view(np.uint8))
        for ks in range(STAGE_K // CONST["kKStep"]):
            at = _kmajor_read(smem_a, ks * CONST["kKStep"], m).view(np.int8)
            btt = _kmajor_read(bt, ks * CONST["kKStep"], bn).view(np.int8)   # (n, k)
            acc += at.astype(np.int64) @ btt.astype(np.int64).T
    np.testing.assert_array_equal(acc, a.astype(np.int64) @ b.astype(np.int64))


def test_transpose_stores_are_free_of_bank_conflicts():
    """Eight neighbouring lanes (one 128-byte phase of a 16-byte store)
    store column 8 c2 + t of chunk item_kc(kq, c2): eight distinct chunk
    positions, for every t and every start of the eight."""
    for kq in range(8):
        for t in range(8):
            for c0 in range(32):
                pos = {(swizzle128(8 * c2 + t, item_kc(kq, c2)) % 128) // 16
                       for c2 in range(c0, c0 + 8)}
                assert len(pos) == 8, (kq, t, c0)


@pytest.mark.parametrize("n", [64, 256])
def test_accumulator_fragment_map(n):
    """wgmma m64nN's accumulator as the PTX ISA lays it out (register r of
    thread t: row 16 (t / 32) + (t % 32) / 4 + 8 ((r % 4) / 2), column
    8 (r / 4) + 2 (t % 4) + r % 2), placed by the source's acc_row / acc_col
    into the staged C tile (rows of kCs words), gives back a @ b; and each
    half warp's 8-byte stores hit 32 distinct banks."""
    cs = n + 8
    assert "static constexpr int CS = BN + 8;" in SRC
    rng = np.random.default_rng(n)
    a = rng.integers(-128, 128, (64, 96))
    b = rng.integers(-128, 128, (96, n))
    c = a @ b
    staged = np.zeros((64, cs), np.int64)
    for t in range(128):
        warp, lane = t // 32, t % 32
        for r in range(n // 2):
            value = c[16 * warp + lane // 4 + 8 * ((r % 4) // 2), 8 * (r // 4) + 2 * (t % 4) + r % 2]
            j, i = r // 4, r % 4
            staged[acc_row(warp, lane, i), acc_col(j, lane, i)] = value
    np.testing.assert_array_equal(staged[:, :n], c)
    for warp in range(4):
        for j in range(n // 8):
            for i in (0, 2):
                for half in range(2):
                    banks = set()
                    for lane in range(16 * half, 16 * half + 16):
                        word = acc_row(warp, lane, i) * cs + acc_col(j, lane, i)
                        banks |= {word % 32, (word + 1) % 32}
                    assert len(banks) == 32
