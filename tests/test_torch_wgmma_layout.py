"""A numpy model of the wgmma GEMM tile of csrc/wgmma_gemm.cuh, which the CPU
cannot compile: how TMA lays a stage into shared memory (the 128-byte
swizzle), how the wgmma descriptors read it back (K-major for A and int8 B,
MN-major for bf16 B), the int8 pass that turns a landed B stage into its
K-major copy (and reads probe_packed_dot's byte planes in place), where
wgmma's accumulator fragment puts each result, and probe_bitcast_dot's
tile (words_tile): A's register fragments cut from landed words, its row
order, and B's rolled rows. Each piece is checked against a plain
``a @ b``. The index maps, constants and ``__byte_perm``
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
a_word_row, a_word_byte, a_sel, b_src_row = (
    _expr(f) for f in ("a_word_row", "a_word_byte", "a_sel", "b_src_row"))
words_out_row = _expr("words_out_row")      # calls a_word_row and a_word_byte
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


def _body(start, end):
    """The source text from ``start`` to the next ``end`` after it."""
    i = SRC.index(start)
    return SRC[i:SRC.index(end, i)]


def _transpose_source():
    body = _body("__device__ __forceinline__ void transpose_rows", "template <")
    sels = [int(s, 16) for s in re.findall(r"__byte_perm\([^)]*?(0x[0-9a-f]{4})\)", body)]
    assert sels == [0x5140, 0x5140, 0x7362, 0x7362, 0x5410, 0x7632, 0x5410, 0x7632]
    assert "sts128(bt + swizzle128(8 * c2 + t, kc)" in body
    assert "const int c2 = it % PAIRS, kc = item_kc(it / PAIRS, c2);" in body
    assert "w[i] = row(16 * kc + 4 * g + i, c2);" in body
    stage = _body("__device__ __forceinline__ void transpose_stage", "template <")
    assert "lds64(raw + (PLANES ? b_row_planes(k) : b_row_dense(k)) * BN + 8 * c2)" in stage
    return sels


def _transpose_stage(raw, bn, planes, sels):
    """transpose_stage on a landed int8 stage ``raw`` (128 rows of bn bytes,
    row b_row(k) holding k), every item of every thread: the K-major tile."""
    words = raw.reshape(STAGE_K, bn // 4 * 4).view("<u4")            # (128, bn / 4)
    row_of = b_row_planes if planes else b_row_dense
    return _transpose_rows(lambda k, c2: words[row_of(k), 2 * c2:2 * c2 + 2], bn, sels)


def _transpose_rows(row, bn, sels):
    """transpose_rows, every item of every thread, with ``row(k, c2)`` the
    two 32-bit words of k row k at 8-byte column group c2: the K-major tile."""
    pairs = bn // 8
    bt = np.zeros(bn * 128, np.uint8)
    for it in range(STAGE_K // 16 * pairs):
        c2, kc = it % pairs, item_kc(it // pairs, it % pairs)
        ow = np.zeros((8, 4), np.uint32)
        for g in range(4):
            w = [row(16 * kc + 4 * g + i, c2) for i in range(4)]
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


# probe_bitcast_dot (words_tile): the register fragment of A that wgmma
# m64nNk32 takes for 8-bit types, as the PTX ISA lays it out: register j
# (0-3) of lane l of warp w holds row 16 w + l / 4 + 8 (j % 2), bytes k =
# 4 (l % 4) + 16 (j / 2) .. + 3
def _frag_row(warp, lane, j):
    return 16 * warp + lane // 4 + 8 * (j % 2)


def _frag_k(lane, j):
    return 4 * (lane % 4) + 16 * (j // 2)


def _words_source():
    """load_a_words' selectors and chunks, and words_tile's use of the index
    maps, as the source has them."""
    load = _body("__device__ __forceinline__ void load_a_words", "template <")
    assert re.findall(r"__byte_perm\([^)]*?(0x[0-9a-f]{4}|sel)\)", load) == \
        ["sel", "sel", "0x5410", "0x7632"]
    assert "lds128(box + swizzle128(row, 4 * half + t))" in load
    assert "a[2 * half] = __byte_perm(xy, zw, 0x5410);" in load
    assert "a[2 * half + 1] = __byte_perm(xy, zw, 0x7632);" in load
    tile = _body("__device__ __forceinline__ void words_tile", "\n}\n")
    for text in (
            "constexpr int BOX = TL::BM / 4 * kStageK;",
            "tma_2d(st + q * BOX, tma_a, full + s, 4 * (kStageK * i + kKStep * q), m0 / 4);",
            "tma_2d(st + TL::A_BYTES, tma_b, full + s, n0, b_src_row(kStageK * i, p.roll, p.k));",
            "const int wrap = p.k - b_src_row(kStageK * i, p.roll, p.k);",
            "if (wrap >= kStageK) {",
            "transpose_rows<BN>([raw](int k, int c2) { return lds64(raw + k * BN + 8 * c2); }, bt,",
            "if (k < wrap) return lds64(raw + k * BN + 8 * c2);",
            "const int row = b_src_row(kStageK * i + k, p.roll, p.k);",
            "row = 16 * cw + a_word_row(warp, lane >> 2), t4 = lane & 3;",
            "const uint32_t sel = a_sel(warp);",
            "uint32_t(&ak)[4] = a[ks & 1];",
            "load_a_words(ak, words + ks * BOX, row, t4, sel);",
            "wgmma_rs<BN>(d, ak, db + ((ks * kKStep) >> 4));",
            "[](int r) { return words_out_row(r); }"):
        assert text in tile, text
    assert "const int m = m0 + cw * 64 + out_row(r);" in _body("void store_tile", "\n}\n")


def _words_dot(words, w, roll, nwg, bn):
    """One block of words_tile, modelled stage by stage: (4 M, bn) int64 from
    the words (M = 16 nwg word rows, K) and w (K, bn), with the A fragments
    each thread builds, B's rolled landing and transposing pass, the
    K-major B descriptor's read, and the epilogue's row order. Also checks
    that each fragment byte at A row 4 m + b, k = j is byte b of word (m,
    j) and pairs with w's row (j + roll) mod K."""
    sels = _transpose_source()
    rows, k = words.shape
    bm = 64 * nwg
    box = bm // 4 * STAGE_K
    wbytes = words.astype("<u4").view(np.uint8).reshape(rows, 4 * k)
    acc = np.zeros((nwg, 64, bn), np.int64)
    roll %= k
    for i in range(-(-k // STAGE_K)):
        steps = min(STAGE_K, k - STAGE_K * i) // CONST["kKStep"]
        # TMA: the stage's word boxes (32 words of every word row, swizzled)
        stage = np.zeros(4 * box, np.uint8)
        for q in range(steps):
            c0 = 4 * (STAGE_K * i + CONST["kKStep"] * q)
            stage[q * box:(q + 1) * box] = _tma_swizzled(wbytes[:, c0:c0 + 128])
        # TMA: w from row r0 on, rows past k zero-filled; the pass reads the
        # rows past the wrap from device memory
        r0 = b_src_row(STAGE_K * i, roll, k)
        wrap = k - r0
        landed = np.zeros((STAGE_K, bn), np.int8)
        landed[:min(STAGE_K, wrap)] = w[r0:r0 + STAGE_K]
        w_words = w.view("<u4")
        land_words = landed.view("<u4")

        def row(kk, c2):
            src = land_words[kk] if kk < wrap else w_words[b_src_row(STAGE_K * i + kk, roll, k)]
            return src[2 * c2:2 * c2 + 2]

        bt = _transpose_rows(row, bn, sels)
        for ks in range(steps):
            btt = _kmajor_read(bt, ks * CONST["kKStep"], bn).view(np.int8)    # (n, 32)
            for cw in range(nwg):
                a_tile = np.full((64, 32), 999, np.int64)
                for warp in range(4):
                    for lane in range(32):
                        wr = 16 * cw + a_word_row(warp, lane >> 2)
                        regs = []
                        for half in range(2):
                            chunk = 4 * half + (lane & 3)
                            off = ks * box + swizzle128(wr, chunk)
                            assert off == _hw_swizzle(ks * box + wr * 128 + 16 * chunk)
                            x, y, z, ww = (int(v) for v in stage[off:off + 16].view("<u4"))
                            xy = _byte_perm(x, y, a_sel(warp))
                            zw = _byte_perm(z, ww, a_sel(warp))
                            regs += [_byte_perm(xy, zw, 0x5410), _byte_perm(xy, zw, 0x7632)]
                        for j, reg in enumerate(regs):
                            r = _frag_row(warp, lane, j)
                            for e in range(4):
                                kk = _frag_k(lane, j) + e
                                a_tile[r, kk] = np.uint8((reg >> (8 * e)) & 0xFF).view(np.int8)
                                # A row r is output row 4 m + b with m, b from the index maps
                                m = 16 * cw + a_word_row(warp, lane >> 2)
                                b = a_word_byte(warp, j % 2)
                                assert words_out_row(r) == 4 * (m - 16 * cw) + b
                                jj = STAGE_K * i + CONST["kKStep"] * ks + kk
                                assert a_tile[r, kk] == np.int8(np.uint8(wbytes[m, 4 * jj + b]))
                                assert btt[:, kk].tolist() == \
                                    w[b_src_row(jj, roll, k)].tolist()
                assert (a_tile != 999).all()
                acc[cw] += a_tile @ btt.astype(np.int64).T
    out = np.zeros((4 * rows, bn), np.int64)
    for cw in range(nwg):
        for r in range(64):
            out[64 * cw + words_out_row(r)] = acc[cw, r]
    return out


def test_words_index_maps():
    """The A rows are a permutation (each warpgroup's 64 rows are its 16 word
    rows' four bytes, each once); a thread's two rows are two bytes of one
    word row; a_sel picks those two bytes; b_src_row is the roll; and a
    quarter warp's 16-byte loads of the swizzled words hit eight distinct
    chunk positions."""
    assert sorted(words_out_row(r) for r in range(64)) == list(range(64))
    for warp in range(4):
        for g in range(8):
            assert a_word_row(warp, g) in range(16)
            for h in range(2):
                assert words_out_row(acc_row(warp, 4 * g, 2 * h)) == \
                    4 * a_word_row(warp, g) + a_word_byte(warp, h)
        x, y = 0x44332211, 0x88776655          # byte b of x is 0x11 (b + 1), of y 0x11 (b + 5)
        b0, b1 = a_word_byte(warp, 0), a_word_byte(warp, 1)
        want = [0x11 * (b0 + 1), 0x11 * (b0 + 5), 0x11 * (b1 + 1), 0x11 * (b1 + 5)]
        assert _byte_perm(x, y, a_sel(warp)) == sum(v << (8 * i) for i, v in enumerate(want))
    assert [b_src_row(j, 5, 64) for j in (0, 58, 59, 63)] == [5, 63, 0, 4]
    for warp in range(4):
        for q in range(4):
            for half in range(2):
                pos = {(swizzle128(a_word_row(warp, lane >> 2), 4 * half + (lane & 3)) % 128) // 16
                       for lane in range(8 * q, 8 * q + 8)}
                assert len(pos) == 8, (warp, q, half)


@pytest.mark.parametrize("nwg, bn, k, roll", [
    (1, 64, 192, 1), (1, 64, 192, 0), (1, 64, 64, 63), (1, 64, 192, 191), (1, 64, 192, 197),
    (1, 64, 192, -3), (2, 256, 128, 100)])
def test_words_tile_gives_the_rolled_bitcast_dot(nwg, bn, k, roll):
    """words_tile modelled end to end on one block (M = 16 nwg word rows;
    the rolls of r3a (1), none, a wrap inside a stage, N - 1, N + 5 and a
    negative one, reduced mod N as the entry point does; N % 128 == 64 skips
    a half stage): out[4 m + b, p] = sum over n of byte b of words[m, (n -
    roll) mod N] w[n, p]."""
    _words_source()
    rng = np.random.default_rng(k + roll % k)
    rows = 16 * nwg
    words = rng.integers(-2 ** 31, 2 ** 31, (rows, k), dtype=np.int64).astype(np.int32)
    w = rng.integers(-128, 128, (k, bn)).astype(np.int8)
    got = _words_dot(words, w, roll % k, nwg, bn)
    a8 = np.roll(words, roll, axis=1).astype("<i4").view(np.int8).reshape(rows, k, 4)
    want = a8.transpose(0, 2, 1).reshape(4 * rows, k).astype(np.int64) @ w.astype(np.int64)
    np.testing.assert_array_equal(got, want)
