"""A numpy model of probe_conv_run (csrc/probes.cu), the conv probe's
persistent wgmma kernel, which the CPU cannot compile: the padded tile's
halo (the prologue and each step's epilogue), the tap boxes that TMA loads
from it, the resident int8 weights turned K-major, the grid barrier's word
and the ring's mbarrier phases across steps, and the wrapper's refusals.
The index maps are read from the source, so the model and the kernel cannot
drift apart. The kernel itself is held against its plain version on the
card by chip_smoke.py phase 7.
"""

import re

import numpy as np
import pytest
import torch

from sesr_tpu_torch.ops import _build
from sesr_tpu_torch.probes import kernels, plain
from tests.test_torch_wgmma_layout import _kmajor_read, _transpose_source, _transpose_stage

SRC = (_build.CSRC / "probes.cu").read_text()
CONV = SRC[SRC.index("namespace conv {"):SRC.index("}  // namespace conv")]
CONST = {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", CONV)}
STAGE_K = 128                       # wgmma_gemm.cuh kStageK: bytes of C a tap box holds
MASK = 0xFFFFFFFF


def _expr(fn):
    """The return expression of the one-line device function ``fn`` as a
    Python function (C's integer division and unsigned literals translated;
    every operand here is non-negative)."""
    m = re.search(rf"(?:int|unsigned) {fn}\(([^)]*)\) \{{\s*return (.*?);\s*\}}", CONV, re.S)
    assert m, fn
    args = [a.split()[-1] for a in m.group(1).split(",")]
    body = re.sub(r"(\d+)u\b", r"\1", m.group(2)).replace(" / ", " // ")
    return eval(f"lambda {', '.join(args)}: {body}")


pad_src, halo_copy, stage_tap, stage_chunk, barrier_target = (
    _expr(f) for f in ("pad_src", "halo_copy", "stage_tap", "stage_chunk", "barrier_target"))


def test_constants_match_the_wrapper():
    """The wrapper's tiling constants and shared-memory formula are the
    kernel's, and the bytes the source note states are what they give."""
    assert (CONST["kPatch"], CONST["kBn"], CONST["kRing"], CONST["kSmemLimit"]) == (
        kernels.CONV_PATCH, kernels.CONV_BN, kernels.CONV_RING, kernels.SMEM_LIMIT)
    assert CONST["kStageBytes"] == 64 * STAGE_K == 8192
    m = re.search(r"constexpr int smem_bytes\(int c, int es\) \{\s*return (.*?);", CONV, re.S)
    cs = CONST["kBn"] + 8
    env = {**CONST, "kCBytes": 64 * cs * 4}
    for c, es in ((64, 2), (128, 1), (128, 2), (256, 1)):
        assert eval(m.group(1), {}, {**env, "c": c, "es": es}) == kernels.conv_smem_bytes(c, es)
    assert (kernels.conv_smem_bytes(128, 1), kernels.conv_smem_bytes(128, 2)) == (126024, 199752)
    assert "126,024 B int8 and\n// 199,752 B bf16" in SRC
    assert kernels.conv_smem_bytes(256, 2) > kernels.SMEM_LIMIT >= kernels.conv_smem_bytes(256, 1)


@pytest.mark.parametrize("shape", [(8, 8, 64), (16, 24, 128), (48, 72, 128)])
def test_halo_map_gives_the_wrapped_tile(shape):
    """The prologue (padded position (hp, wp) <- pixel (pad_src(hp),
    pad_src(wp))) and each step's epilogue (pixel (h, w) -> padded rows
    {h + 1, halo_copy(h)} x columns {w + 1, halo_copy(w)}) both give
    np.pad(tile, 1, mode="wrap"); the epilogue writes every padded position
    exactly once."""
    eh, ew, c = shape
    rng = np.random.default_rng(eh + ew)
    x = rng.integers(-128, 128, shape).astype(np.int8)
    want = np.pad(x, ((1, 1), (1, 1), (0, 0)), mode="wrap")
    pro = np.array([[x[pad_src(hp, eh), pad_src(wp, ew)] for wp in range(ew + 2)]
                    for hp in range(eh + 2)])
    np.testing.assert_array_equal(pro, want)
    assert "pad_src(hp, p.eh)) * p.ew + pad_src(wp, p.ew)" in SRC

    y = rng.integers(-128, 128, shape).astype(np.int8)
    written = np.zeros((eh + 2, ew + 2), np.int64)
    buf = np.zeros_like(want)
    for h in range(eh):
        for w in range(ew):
            for hp in (h + 1, halo_copy(h, eh)):
                for wp in (w + 1, halo_copy(w, ew)):
                    if hp >= 0 and wp >= 0:
                        buf[hp, wp] = y[h, w]
                        written[hp, wp] += 1
    np.testing.assert_array_equal(buf, np.pad(y, ((1, 1), (1, 1), (0, 0)), mode="wrap"))
    assert (written == 1).all()
    assert "hs[2] = {h + 1, halo_copy(h, p.eh)}, ws[2] = {w + 1, halo_copy(w, p.ew)}" in SRC


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
def test_tap_boxes_are_the_circular_shifts(dtype):
    """Stage j of a step loads the 3-D box (128 bytes of C, 8, 8) at (c0,
    w0 + qx, h0 + qy) of the padded tile, tap 3 qy + qx = stage_tap(j) and
    c0 from stage_chunk(j): its 64 rows (8 dy + dx) are the plain conv's
    circular shift of the patch, and the stages' products with weight rows
    128 / es * j onwards sum to the conv of every patch of the tile."""
    es = 2 if dtype == torch.bfloat16 else 1
    eh, ew, c = 16, 24, 128
    cpt = c * es // STAGE_K
    per = STAGE_K // es                          # channels a box holds
    rng = np.random.default_rng(es)
    x = rng.integers(-3, 4, (eh, ew, c))
    w9 = rng.integers(-2, 3, (9 * c, c))
    padded = np.pad(x, ((1, 1), (1, 1), (0, 0)), mode="wrap")
    taps = [np.roll(x, (1 - qy, 1 - qx), axis=(0, 1)) for qy in range(3) for qx in range(3)]
    ref = np.concatenate(taps, axis=2).reshape(eh * ew, 9 * c) @ w9
    assert ("stage_chunk(j, cpt) * (kStageK / es),\n                 w0 + tap % 3, h0 + tap / 3)"
            in SRC)
    got = np.zeros((eh, ew, c), np.int64)
    for h0 in range(0, eh, 8):
        for w0 in range(0, ew, 8):
            for n0 in range(0, c, 64):
                acc = np.zeros((64, 64), np.int64)
                for j in range(9 * cpt):
                    tap, c0 = stage_tap(j, cpt), stage_chunk(j, cpt) * per
                    qy, qx = tap // 3, tap % 3
                    box = padded[h0 + qy:h0 + qy + 8, w0 + qx:w0 + qx + 8, c0:c0 + per]
                    rows = box.reshape(64, per)
                    shift = taps[tap][h0:h0 + 8, w0:w0 + 8, c0:c0 + per].reshape(64, per)
                    np.testing.assert_array_equal(rows, shift)
                    acc += rows @ w9[per * j:per * (j + 1), n0:n0 + 64]
                got[h0:h0 + 8, w0:w0 + 8, n0:n0 + 64] = acc.reshape(8, 8, 64)
    np.testing.assert_array_equal(got.reshape(eh * ew, c), ref)
    step = plain.conv_step(torch.from_numpy(x).to(torch.int8), torch.from_numpy(w9).to(torch.int8))
    np.testing.assert_array_equal(step.numpy(), np.clip(ref, -128, 127).reshape(eh, ew, c))


@pytest.mark.parametrize("c", [128, 256])
def test_resident_int8_weights_are_kmajor(c):
    """int8: raw tile j, the TMA box (64 columns, 128 k rows) at (n0, 128 j)
    of w9, turned K-major by transpose_stage, reads back through the K-major
    descriptor as w9[128 j:128 (j + 1), n0:n0 + 64].T: the nine (C = 128)
    or eighteen (C = 256) resident tiles together hold w9[:, n0:n0 + 64].T."""
    sels = _transpose_source()
    assert "tma_2d(ring + (j - j0) * kStageBytes, &map_w, wbar, n0, kStageK * j)" in SRC
    assert "transpose_stage<kBn, false>(smem_u32(ring + (j - r * S) * kStageBytes),\n" \
           "                                      smem_u32(bres + j * kStageBytes), tid)" in SRC
    rng = np.random.default_rng(c)
    w9 = rng.integers(-128, 128, (9 * c, c)).astype(np.int8)
    for n0 in (0, c - 64):
        cols = []
        for j in range(9 * c // STAGE_K):
            raw = np.ascontiguousarray(w9[STAGE_K * j:STAGE_K * (j + 1), n0:n0 + 64])
            tile = _transpose_stage(raw.view(np.uint8), 64, False, sels)
            for ks in range(STAGE_K // 32):
                cols.append(_kmajor_read(tile, 32 * ks, 64).view(np.int8))   # (64 n, 32 k)
        np.testing.assert_array_equal(np.concatenate(cols, axis=1), w9[:, n0:n0 + 64].T)


@pytest.mark.parametrize("nblocks", [108, 4])
def test_grid_barrier_word_over_calls(nblocks):
    """The grid barrier over launches of 1-50 steps (a prologue barrier and
    one between each two steps), the word starting near 2^32 so that it
    wraps: a wait (the int32 difference of word and target >= 0) holds
    exactly once the last block of its barrier has arrived, and after a
    launch the word is the base the wrapper passes to the next."""
    assert "static_cast<int>(ld_acquire(count) - target) >= 0" in SRC
    assert "grid_wait(p.count, barrier_target(p.base, s, nblocks));" in SRC

    def passed(word, target):
        return ((word - target) & MASK) < 2 ** 31

    base = word = (2 ** 32 - 7 * nblocks - 3) & MASK
    wrapped = False
    for iters in range(1, 51):
        for b in range(iters):
            target = barrier_target(base, b, nblocks) & MASK
            for _ in range(nblocks):
                assert not passed(word, target)
                word = (word + 1) & MASK
                wrapped |= word == 0
            assert passed(word, target) and word == target
            if b + 1 < iters:
                assert not passed(word, barrier_target(base, b + 1, nblocks) & MASK)
        base = kernels.barrier_base_after(base, nblocks, iters)
        assert word == base
    assert wrapped


@pytest.mark.parametrize("stages", [9, 18], ids=["int8_c128", "bf16_c128"])
def test_ring_phases_run_on_across_steps(stages):
    """The A ring over 1, 2, 3 and 50 steps of ``stages`` stages: the
    producer waits on empty (parity ((it / S) & 1) ^ 1), the consumer on
    full ((it / S) & 1), with ``it`` counting stages since the launch
    began; the consumer hands back stage it - 1 after issuing stage it, and
    the last stage of a step after the step. With mbarriers modelled by
    their phase count, any interleaving fills each slot only once it is
    free, reads each stage only once it has landed, and ends."""
    s_ring = CONST["kRing"]
    assert SRC.count("for (int j = 0; j < KT; ++j, ++it) {") == 2
    assert "if (j > 0) mbar_arrive(empty + (it - 1) % S);" in SRC
    assert "wgmma_wait<0>();\n    fence_acc(d);\n    mbar_arrive(empty + (it - 1) % S);" in SRC

    def try_wait(phases, parity):      # the phase of that parity has completed
        return (phases & 1) != parity

    rng = np.random.default_rng(stages)
    for iters in (1, 2, 3, 50):
        total = iters * stages
        full, empty = [0] * s_ring, [0] * s_ring
        slot_holds = [None] * s_ring
        pi = ci = 0
        pending = None                 # the stage the consumer hands back next
        while ci < total:
            moves = []
            if pi < total and try_wait(empty[pi % s_ring], ((pi // s_ring) & 1) ^ 1):
                moves.append("produce")
            if try_wait(full[ci % s_ring], (ci // s_ring) & 1):
                moves.append("consume")
            assert moves, (iters, pi, ci)
            if rng.choice(moves) == "produce":
                assert slot_holds[pi % s_ring] is None
                slot_holds[pi % s_ring] = pi
                full[pi % s_ring] += 1
                pi += 1
            else:
                assert slot_holds[ci % s_ring] == ci
                if pending is not None:            # j > 0: hand back stage it - 1
                    slot_holds[pending % s_ring] = None
                    empty[pending % s_ring] += 1
                pending = ci
                ci += 1
                if ci % stages == 0:               # the step's last stage, after wgmma_wait<0>
                    slot_holds[pending % s_ring] = None
                    empty[pending % s_ring] += 1
                    pending = None
        assert pi == total and all(h is None for h in slot_holds)


REFUSALS = {
    "cpu_tensor": ((8, 16, 128), torch.int8, 2, "CUDA"),
    "eh_not_a_multiple_of_8": ((9, 16, 128), torch.int8, 2, "multiples of 8"),
    "ew_not_a_multiple_of_8": ((8, 12, 128), torch.int8, 2, "multiples of 8"),
    "c_not_a_multiple_of_64": ((8, 8, 96), torch.bfloat16, 2, "multiple of 64"),
    "int8_c_not_a_multiple_of_128": ((8, 8, 64), torch.int8, 2, "element bytes of 128"),
    "bf16_weights_beyond_shared_memory": ((8, 8, 256), torch.bfloat16, 2, "shared memory"),
    "no_steps": ((8, 8, 128), torch.int8, 0, "iters >= 1"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_conv_run_refuses_before_any_build(monkeypatch, case):
    """The wrapper refuses, with ValueError and before anything is built or
    loaded, a CPU tensor and every shape the kernel does not take; no
    launch is counted."""
    def refuse(*_a, **_k):
        raise AssertionError("a refused call reached the kernel build")

    for fn in ("build", "load", "find_nvcc"):
        monkeypatch.setattr(_build, fn, refuse)
    shape, dtype, iters, msg = REFUSALS[case]
    x = torch.zeros(shape, dtype=dtype)
    w = torch.zeros((9 * shape[2], shape[2]), dtype=dtype)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match=msg):
        kernels.probe_conv_run(x, w, iters)
    assert all(k.launches == 0 for k in kernels.PROBE_KERNELS)
