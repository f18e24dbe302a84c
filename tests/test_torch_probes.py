"""The probes of the port (sesr_tpu_torch/probes) against the Pallas kernels
of the unmodified tools/ scripts, on the CPU.

Each tools/ probe calls ``pl.pallas_call`` inside its own function (the conv
and GEMM kernels are closures of ``main()``). The tests capture the kernels
by replacing ``pallas_call`` with a recorder (``monkeypatch``; nothing in
tools/ changes), then run them with the real ``pallas_call(...,
interpret=True)`` on numpy-seeded inputs, which the port's plain versions
get too. The kernels of csrc/probes.cu themselves are held against the
plain versions on the card by chip_smoke.py phase 7.
"""

import importlib
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sesr_tpu_torch.ops import _build
from sesr_tpu_torch.probes import bitcast, conv, int8_gemm, kernels, plain, tile_ab
from sesr_tpu_torch.probes.__main__ import main as probes_main
from tests.test_torch_params import one_torch_thread  # noqa: F401 (fixture)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
REAL_PALLAS_CALL = pl.pallas_call
SMALL_TILE = (9, 16, 8)            # (E_H, E_W, C) of the conv probe here
GEMM_SIZE, GEMM_BLOCK = 256, 128   # the GEMM probe re-gridded to 256^3 in 128-blocks


class Captured(Exception):
    """Raised by the recorder in place of a pallas_call it stops at."""


def _recorder(calls, forward=0):
    """A pallas_call that records (kernel, kwargs); it runs the first
    ``forward`` calls in interpret mode and raises Captured after that."""
    def record(kernel, **kw):
        calls.append((kernel, kw))
        if len(calls) <= forward:
            return REAL_PALLAS_CALL(kernel, interpret=True, **kw)
        raise Captured
    return record


def _interpret(kernel, kw, *args):
    return np.asarray(REAL_PALLAS_CALL(kernel, interpret=True, **kw)(*args))


@pytest.fixture(scope="module")
def conv_kernels():
    """{variant: (kernel, kwargs)} of tools/bench_probe_pallas_conv.py at
    SMALL_TILE. The kernels read the tool's module globals when they run, so
    those stay set to SMALL_TILE for as long as the tests use them."""
    tool = importlib.import_module("tools.bench_probe_pallas_conv")
    calls = []
    with pytest.MonkeyPatch.context() as tile:
        for name, value in zip(("E_H", "E_W", "C", "ITERS"), SMALL_TILE + (1,)):
            tile.setattr(tool, name, value)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(pl, "pallas_call", _recorder(calls))
            tool.main()      # each variant's pallas_call raises; main reports it
        assert len(calls) == len(conv.VARIANTS)
        yield dict(zip(conv.VARIANTS, calls))


@pytest.fixture(scope="module")
def gemm_kernels():
    """{variant: (kernel, kwargs)} of tools/bench_probe_pallas_int8.py."""
    tool = importlib.import_module("tools.bench_probe_pallas_int8")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", _recorder(calls))
        tool.main()
    assert len(calls) == len(int8_gemm.VARIANTS)
    return dict(zip(int8_gemm.VARIANTS, calls))


@pytest.fixture(scope="module")
def r3b_kernels():
    """(layout, byte-plane, timed byte-plane) calls of tools/bench_probe_r3b.py:
    the first two run in interpret mode, the timed form is captured."""
    tool = importlib.import_module("tools.bench_probe_r3b")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", _recorder(calls, forward=2))
        layout = tool.probe_bitcast_layout()
        with pytest.raises(Captured):
            tool.probe_byteplane_dot(layout)
    assert layout == "m*4+b" and len(calls) == 3
    return calls


@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("variant", list(conv.VARIANTS))
def test_conv_probe_matches_pallas(conv_kernels, variant, iters):
    """P1, tools/bench_probe_pallas_conv.py:122: int8 variants equal; bf16
    within 2^-7 max|JAX| (step 1 sums integers and is exact in any order)."""
    form, dtype = conv.VARIANTS[variant]
    x, w = conv.make_inputs(SMALL_TILE, seed=iters)[variant]
    kernel, kw = conv_kernels[variant]
    jdt = jnp.int8 if dtype == torch.int8 else jnp.bfloat16
    want = _interpret(kernel, {**kw, "grid": (iters,)}, jnp.asarray(x, jdt),
                      jnp.asarray(w, jdt))
    got = conv.conv_probe(torch.from_numpy(x), torch.from_numpy(w), variant, iters)
    assert got.dtype == torch.float32 and got.shape == SMALL_TILE
    if dtype == torch.int8 or iters == 1:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_array_less(np.abs(got.numpy() - want),
                                     2.0 ** -7 * np.abs(want).max() + 1e-30)
    assert np.abs(want).max() > 0


@pytest.mark.parametrize("variant", list(int8_gemm.VARIANTS))
def test_gemm_probe_matches_pallas(gemm_kernels, variant):
    """P2, tools/bench_probe_pallas_int8.py:65, re-gridded to 256^3 in
    128-blocks: all three variants equal (the sums are integers below 2^24)."""
    kernel, kw = gemm_kernels[variant]
    b = GEMM_BLOCK
    g = GEMM_SIZE // b
    kw = {**kw, "grid": (g, g, g),
          "in_specs": [pl.BlockSpec((b, b), lambda i, j, k: (i, k)),
                       pl.BlockSpec((b, b), lambda i, j, k: (k, j))],
          "out_specs": pl.BlockSpec((b, b), lambda i, j, k: (i, j)),
          "out_shape": kw["out_shape"].update(shape=(GEMM_SIZE, GEMM_SIZE)),
          "scratch_shapes": [pltpu.VMEM((b, b), kw["scratch_shapes"][0].dtype)]}
    a, bm = int8_gemm.make_inputs(GEMM_SIZE)[variant]
    dtype, out_dtype = int8_gemm.VARIANTS[variant]
    jdt = jnp.int8 if dtype == torch.int8 else jnp.bfloat16
    want = _interpret(kernel, kw, jnp.asarray(a, jdt), jnp.asarray(bm, jdt))
    got = int8_gemm.gemm_probe(torch.from_numpy(a), torch.from_numpy(bm), variant)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_r3a_bitcast_probe_fails_on_its_shapes_and_matches_when_consistent(capsys):
    """P3, tools/bench_probe_r3a.py:343: on r3a's shapes JAX's dot raises
    TypeError, and so does the port, before any launch; with w (128, 256)
    the captured kernel and the port agree."""
    tool = importlib.import_module("tools.bench_probe_r3a")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", _recorder(calls))
        assert tool.probe_mosaic_int8_bitcast() is False
    (kernel, kw), = calls
    words, w = bitcast.r3a_inputs()
    with pytest.raises(TypeError, match="contracting dimensions"):
        _interpret(kernel, kw, jnp.asarray(words), jnp.asarray(w))
    with pytest.raises(TypeError, match=r"got \(128,\) and \(512,\)"):
        bitcast.bitcast_dot(torch.from_numpy(words), torch.from_numpy(w))
    capsys.readouterr()
    assert bitcast.mosaic_int8_bitcast_probe(torch.device("cpu")) is False
    assert "FAILED TypeError" in capsys.readouterr().out
    w_ok = bitcast.r3a_inputs(bitcast.CONSISTENT_W_ROWS)[1]
    want = _interpret(kernel, {**kw, "out_shape": kw["out_shape"].update(shape=(1024, 256))},
                      jnp.asarray(words), jnp.asarray(w_ok))
    got = bitcast.bitcast_dot(torch.from_numpy(words), torch.from_numpy(w_ok))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert bitcast.mosaic_int8_bitcast_probe(torch.device("cpu"),
                                             bitcast.CONSISTENT_W_ROWS) is True


def _r3a_kernel():
    """(kernel, kwargs) of tools/bench_probe_r3a.py:343, captured."""
    tool = importlib.import_module("tools.bench_probe_r3a")
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", _recorder(calls))
        assert tool.probe_mosaic_int8_bitcast() is False
    (kernel, kw), = calls
    return kernel, kw


def test_plain_bitcast_dot_matches_pallas():
    """plain.bitcast_dot (probe_bitcast_dot's plain version) against the
    captured r3a kernel at its own roll, 1, on seeded words and weights of
    the consistent shape."""
    kernel, kw = _r3a_kernel()
    rng = np.random.default_rng(5)
    words = rng.integers(-2 ** 31, 2 ** 31, (256, 128), dtype=np.int64).astype(np.int32)
    w = rng.integers(-128, 128, (128, 256)).astype(np.int8)
    want = _interpret(kernel, {**kw, "out_shape": kw["out_shape"].update(shape=(1024, 256))},
                      jnp.asarray(words), jnp.asarray(w))
    got = plain.bitcast_dot(torch.from_numpy(words), torch.from_numpy(w), 1)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _bitcast_dot_spec(words, w, roll):
    """out[4 m + b, p] = sum over n of byte b of words[m, (n - roll) mod N] w[n, p]."""
    m, n = words.shape
    out = np.zeros((4 * m, w.shape[1]), np.int64)
    u = words.astype(np.int64) & 0xFFFFFFFF
    for b in range(4):
        plane = ((u >> (8 * b)) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64)
        rolled = plane[:, (np.arange(n) - roll) % n]
        out[b::4] = rolled @ w.astype(np.int64)
    return out


@pytest.mark.parametrize("m, n, p", [(100, 64, 64), (7, 192, 128)])
@pytest.mark.parametrize("roll", [0, 1, 63, "N-1", "N+5", -3])
def test_plain_bitcast_dot_byte_spec(m, n, p, roll):
    roll = {"N-1": n - 1, "N+5": n + 5}.get(roll, roll)
    rng = np.random.default_rng(m + n)
    words = rng.integers(-2 ** 31, 2 ** 31, (m, n), dtype=np.int64).astype(np.int32)
    w = rng.integers(-128, 128, (n, p)).astype(np.int8)
    got = plain.bitcast_dot(torch.from_numpy(words), torch.from_numpy(w), roll)
    np.testing.assert_array_equal(got.numpy(), _bitcast_dot_spec(words, w, roll))
    got = bitcast.bitcast_dot(torch.from_numpy(words), torch.from_numpy(w), roll)
    np.testing.assert_array_equal(got.numpy(), _bitcast_dot_spec(words, w, roll))


PROBES_SRC = (_build.CSRC / "probes.cu").read_text()


def _src_fn(name):
    """The one-line function ``name`` of csrc/probes.cu as a Python lambda."""
    m = re.search(rf"int {name}\(([^)]*)\) \{{\s*return (.*?);\s*\}}", PROBES_SRC, re.S)
    args = [a.split()[-1] for a in m.group(1).split(",")]
    body = re.sub(r"(\S+) >= (\S+) \? (.*) : (.*)", r"(\3) if \1 >= \2 else (\4)", m.group(2))
    return eval(f"lambda {', '.join(args)}: {body}")


def _byte_perm(x, y, sel):
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(src[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


@pytest.mark.parametrize("m, n", [(3, 16), (2, 48), (5, 64)])
@pytest.mark.parametrize("roll", [0, 1, 2, 3, 5, -3, 130])
def test_unpack_runs_kernel_model(m, n, roll):
    """probe_unpack_words' run kernel (n % 16 == 0) modelled thread by
    thread from csrc/probes.cu (src_col, the groups each run loads and their
    wrap, byte_rows' selectors, the 16-byte stores) equals plain.unpack_words
    for every D = (-roll) mod 4."""
    src_col = _src_fn("src_col")
    body = PROBES_SRC[PROBES_SRC.index("void byte_rows"):PROBES_SRC.index("template <int D>")]
    sels = [int(v, 16) for v in re.findall(r"(0x[0-9a-f]{4})\)", body)]
    assert sels == [0x5140, 0x5140, 0x7362, 0x7362, 0x5410, 0x7632, 0x5410, 0x7632]
    kern = PROBES_SRC[PROBES_SRC.index("template <int D>"):PROBES_SRC.index("// Any n:")]
    for text in ("constexpr int G = D ? 5 : 4;",
                 "const int q = src_col(c0, roll, n) / 4;",
                 "__ldg(row + (q + g < groups ? q + g : q + g - groups))",
                 "byte_rows(v[D + 4 * j], v[D + 4 * j + 1], v[D + 4 * j + 2], v[D + 4 * j + 3], o[j]);",
                 "make_uint4(o[0][b], o[1][b], o[2][b], o[3][b])"):
        assert text in kern, text
    assert "by_d[(n - roll) % 4]<<<" in PROBES_SRC
    rng = np.random.default_rng(n)
    words = rng.integers(-2 ** 31, 2 ** 31, (m, n), dtype=np.int64).astype(np.int32)
    u = words.astype(np.int64) & 0xFFFFFFFF
    r_ = roll % n
    d = (n - r_) % 4
    groups, out = n // 4, np.zeros((4 * m, n), np.uint8)
    for unit in range(m * (n // 16)):
        r, c0 = unit // (n // 16), unit % (n // 16) * 16
        q = src_col(c0, r_, n) // 4
        v = []
        for g in range(5 if d else 4):
            gi = q + g if q + g < groups else q + g - groups
            v += [int(x) for x in u[r, 4 * gi:4 * gi + 4]]
        for j in range(4):
            x, y, z, ww = v[d + 4 * j:d + 4 * j + 4]
            xy01, zw01 = _byte_perm(x, y, sels[0]), _byte_perm(z, ww, sels[1])
            xy23, zw23 = _byte_perm(x, y, sels[2]), _byte_perm(z, ww, sels[3])
            rows = [_byte_perm(xy01, zw01, sels[4]), _byte_perm(xy01, zw01, sels[5]),
                    _byte_perm(xy23, zw23, sels[6]), _byte_perm(xy23, zw23, sels[7])]
            for b in range(4):
                out[4 * r + b, c0 + 4 * j:c0 + 4 * j + 4] = [(rows[b] >> (8 * e)) & 0xFF
                                                             for e in range(4)]
    want = plain.unpack_words(torch.from_numpy(words), roll).numpy()
    np.testing.assert_array_equal(out.view(np.int8), want)


@pytest.mark.parametrize("shapes, what", [
    (((4, 96), (96, 64)), "N not a multiple of 64"), (((4, 64), (64, 96)), "P not a multiple of 64"),
    (((4, 64), (128, 64)), "w's rows differ from N")], ids=["N", "P", "rows"])
def test_bitcast_dot_wrapper_refuses_shapes_without_launch(monkeypatch, shapes, what):
    def refuse(*_a, **_k):
        raise AssertionError("a refused shape reached the kernel build")

    for fn in ("build", "load", "find_nvcc"):
        monkeypatch.setattr(_build, fn, refuse)
    (m, n), (k, p) = shapes
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="multiples of 64" if what[0] in "NP" else "takes int32"):
        kernels.probe_bitcast_dot(torch.zeros((m, n), dtype=torch.int32),
                                  torch.zeros((k, p), dtype=torch.int8))
    assert all(kern.launches == 0 for kern in kernels.PROBE_KERNELS)


def test_r3b_bitcast_layout_matches_pallas(r3b_kernels, capsys):
    """P4, tools/bench_probe_r3b.py:82: the unpack equals the TPU bitcast,
    and the port's layout probe answers m*4+b."""
    kernel, kw = r3b_kernels[0]
    x8, words = bitcast.layout_inputs()
    want = _interpret(kernel, kw, jnp.asarray(words))
    np.testing.assert_array_equal(bitcast.unpack_words(torch.from_numpy(words)).numpy(), want)
    assert bitcast.bitcast_layout_probe(torch.device("cpu")) == "m*4+b"
    assert "m*4+b: MATCH" in capsys.readouterr().out


@pytest.mark.parametrize("timed", [False, True], ids=["r3b_147", "r3b_164_f32"])
def test_r3b_byteplane_dot_matches_pallas(r3b_kernels, timed):
    """P5 and P6, tools/bench_probe_r3b.py:147 and :164: the port's exact
    dot equals a8 @ w8 and the captured byte-plane kernel (the timed form
    casts to f32)."""
    kernel, kw = r3b_kernels[2 if timed else 1]
    a8, w8, words, wb = bitcast.byteplane_inputs()
    want = _interpret(kernel, kw, jnp.asarray(words), jnp.asarray(wb))
    out_dtype = torch.float32 if timed else torch.int32
    got = bitcast.byteplane_dot(torch.from_numpy(words), torch.from_numpy(wb), out_dtype)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32) if timed else want)
    np.testing.assert_array_equal(want, a8.astype(np.int32) @ w8.astype(np.int32))
    assert bitcast.byteplane_dot_probe(torch.device("cpu"))


def test_plain_write_back_rounds_as_jax():
    """The bf16 write-back is bf16(acc * f32(1e-3)), nearest-even, as
    ``(acc * 1e-3).astype(bfloat16)`` in JAX; the int8 one a clip."""
    rng = np.random.default_rng(3)
    acc = np.concatenate([rng.normal(0, 1e3, 20000), rng.integers(-2 ** 20, 2 ** 20, 20000),
                          rng.normal(0, 1e-30, 2000)]).astype(np.float32)
    want = np.asarray((jnp.asarray(acc) * 1e-3).astype(jnp.bfloat16).astype(jnp.float32))
    got = plain.write_back(torch.from_numpy(acc), torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
    ints = rng.integers(-300, 300, 1000).astype(np.int32)
    np.testing.assert_array_equal(plain.write_back(torch.from_numpy(ints), torch.int8).numpy(),
                                  np.clip(ints, -128, 127).astype(np.int8))


@pytest.mark.parametrize("roll", [0, 1, -3, 130])
def test_plain_unpack_words_extracts_bytes(roll):
    words = np.random.default_rng(roll % 7).integers(-2 ** 31, 2 ** 31, (5, 12), dtype=np.int64)
    words = words.astype(np.int32)
    got = plain.unpack_words(torch.from_numpy(words), roll).numpy()
    m, n = words.shape
    for r in range(m):
        for c in range(n):
            w = int(words[r, (c - roll) % n]) & 0xFFFFFFFF
            for b in range(4):
                assert got[4 * r + b, c] == np.int8(np.uint8((w >> (8 * b)) & 0xFF).view(np.int8))


def test_byteplane_weights_rows():
    """The byte-plane weights are w8's rows 4j + b (wb[b][j] = w8[4j + b]),
    the words pack a8's bytes, and the plain byte-plane dot sums the four
    plane dots to a8 @ w8 on a shape of its own."""
    a8, w8, words, wb = bitcast.byteplane_inputs((6, 24, 5), seed=1)
    for j in range(6):
        for b in range(4):
            np.testing.assert_array_equal(wb[b, j], w8[4 * j + b])
    for i in range(6):
        for j in range(6):
            word = int(words[i, j]) & 0xFFFFFFFF
            assert [np.uint8(word >> (8 * b) & 0xFF).view(np.int8) for b in range(4)] == \
                list(a8[i, 4 * j:4 * j + 4])
    got = plain.packed_dot(torch.from_numpy(words), torch.from_numpy(wb))
    np.testing.assert_array_equal(got.numpy(), a8.astype(np.int32) @ w8.astype(np.int32))


@pytest.mark.parametrize("call", ["gemm", "gemm_write_back", "conv_step", "unpack", "packed_dot",
                                  "bitcast_dot"])
def test_wrappers_refuse_cpu_tensors_without_building(monkeypatch, call):
    def refuse(*_a, **_k):
        raise AssertionError("a CPU call reached the kernel build")

    for fn in ("build", "load", "find_nvcc"):
        monkeypatch.setattr(_build, fn, refuse)
    a8 = torch.zeros((64, 64), dtype=torch.int8)
    x = torch.zeros((8, 16, 128), dtype=torch.int8)
    calls = {"gemm": lambda: kernels.probe_gemm(a8, a8),
             "gemm_write_back": lambda: kernels.probe_gemm.write_back(a8, a8, 9),
             "conv_step": lambda: kernels.probe_conv_run(x, torch.zeros((1152, 128),
                                                                        dtype=torch.int8), 2),
             "unpack": lambda: kernels.probe_unpack_words(torch.zeros((4, 64), dtype=torch.int32)),
             "packed_dot": lambda: kernels.probe_packed_dot(
                 torch.zeros((64, 16), dtype=torch.int32), torch.zeros((4, 16, 64),
                                                                       dtype=torch.int8)),
             "bitcast_dot": lambda: kernels.probe_bitcast_dot(
                 torch.zeros((4, 64), dtype=torch.int32), a8)}
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        calls[call]()
    assert all(k.launches == 0 for k in kernels.PROBE_KERNELS)


def test_probe_cli_on_cpu(capsys):
    dev = ["--device", "cpu", "--reps", "1"]
    res = probes_main(["conv", *dev, "--shape", "9", "16", "64", "--iters", "2"])
    assert set(res) == set(conv.VARIANTS) and all(isinstance(v, float) for v in res.values())
    res = probes_main(["gemm", *dev, "--size", "128"])
    assert set(res) == set(int8_gemm.VARIANTS) and all(isinstance(v, float) for v in res.values())
    res = probes_main(["bitcast", *dev])
    assert (res["layout"], res["byteplane_correct"], res["r3a_shapes_run"],
            res["consistent_shapes_run"]) == ("m*4+b", True, False, True)
    out = capsys.readouterr().out
    assert out.count('"device": "cpu"') == 3
    if torch.cuda.is_available():
        return
    with pytest.raises(SystemExit):           # the default device is the card
        probes_main(["gemm", "--size", "128"])


def test_build_is_keyed_by_library(monkeypatch, tmp_path):
    """One library per csrc/<name>.cu: its file name hashes its own source
    and the csrc/ headers it includes, so editing one source, or a header
    only it includes, renames only its library; build() reuses a library it
    finds and build_all() builds every one."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for src in list(_build.CSRC.glob("*.cu")) + list(_build.CSRC.glob("*.cuh")):
        (csrc / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\necho "ptxas info"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    paths = {name: _build.library_path(name) for name in _build.SIGNATURES}
    assert set(paths) == {"sesr_net", "sesr_corrected", "sesr_net_group",
                          "sesr_corrected_group", "sesr_net_ksize", "sesr_corrected_ksize",
                          "sesr_corrected_ksize_audit", "sesr_net_w64", "sesr_corrected_w64",
                          "sesr_corrected_w64_audit", "probes"}
    for name, path in paths.items():
        assert path.parent == tmp_path / "kernels" and path.name.startswith(f"lib{name}-")
    assert _build.sources("probes") == [csrc / "probes.cu", csrc / "wgmma_gemm.cuh"]
    assert _build.sources("sesr_net") == [csrc / "sesr_net.cu", csrc / "sesr_common.cuh"]
    assert _build.sources("sesr_corrected") == [csrc / "sesr_corrected.cu",
                                                csrc / "sesr_common.cuh"]
    # the layer-group libraries build on the network kernels' sources
    assert _build.sources("sesr_net_group") == [csrc / "sesr_net_group.cu", csrc / "sesr_net.cu",
                                                csrc / "sesr_common.cuh"]
    assert _build.sources("sesr_corrected_group") == [
        csrc / "sesr_corrected_group.cu", csrc / "sesr_corrected.cu", csrc / "sesr_common.cuh"]
    # and the libraries of other conv sizes on the layer-group sources
    assert _build.sources("sesr_net_ksize") == [csrc / "sesr_net_ksize.cu",
                                                *_build.sources("sesr_net_group")]
    assert _build.sources("sesr_corrected_ksize") == [csrc / "sesr_corrected_ksize.cu",
                                                      *_build.sources("sesr_corrected_group")]
    # the counting form's and the width-64 libraries on the ksize sources
    for name, base in (("sesr_corrected_ksize_audit", "sesr_corrected_ksize"),
                       ("sesr_net_w64", "sesr_net_ksize"),
                       ("sesr_corrected_w64", "sesr_corrected_ksize"),
                       ("sesr_corrected_w64_audit", "sesr_corrected_ksize")):
        assert _build.sources(name) == [csrc / f"{name}.cu", *_build.sources(base)]
    with (csrc / "wgmma_gemm.cuh").open("a") as f:
        f.write("// edited\n")
    edited_header = _build.library_path("probes")
    assert edited_header != paths["probes"]
    assert _build.library_path("sesr_net") == paths["sesr_net"]
    with (csrc / "probes.cu").open("a") as f:
        f.write("// edited\n")
    assert _build.library_path("probes") not in (paths["probes"], edited_header)
    assert _build.library_path("sesr_net") == paths["sesr_net"]
    # the header both network kernels include renames both of their libraries
    probes = _build.library_path("probes")
    with (csrc / "sesr_common.cuh").open("a") as f:
        f.write("// edited\n")
    assert _build.library_path("sesr_net") != paths["sesr_net"]
    assert _build.library_path("sesr_corrected") != paths["sesr_corrected"]
    assert _build.library_path("sesr_net_group") != paths["sesr_net_group"]
    assert _build.library_path("sesr_corrected_ksize") != paths["sesr_corrected_ksize"]
    assert _build.library_path("sesr_corrected_w64_audit") != paths["sesr_corrected_w64_audit"]
    assert _build.library_path("probes") == probes
    builds = _build.build_all()
    assert {n: b.path for n, b in builds.items()} == {
        n: _build.library_path(n) for n in _build.SIGNATURES}
    assert all(b.path.exists() and "ptxas" in b.log for b in builds.values())
    again = _build.build("probes")
    assert again.seconds == 0.0 and again.path == builds["probes"].path
    with pytest.raises(ValueError, match="no kernel library"):
        _build.library_path("nope")


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN44_GLOBAL__N__b1e08967_11_sesr_net_cu_9aa2969415\
sesr_net_kernelILi1ELi16ELb0ELi32EEEvPKaPaPKiS5_iiiiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN44_GLOBAL__N__b1e08967_11_sesr_net_cu_9aa2969415\
sesr_net_kernelILi1ELi16ELb0ELi32EEEvPKaPaPKiS5_iiiiiiii
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size
ptxas info    : Compile time = 15.207 ms
ptxas info    : Compiling entry function '_Z21sesr_corrected_kernelILi4ELb0EEvPKaPaPKiS3_iiiiiii' \
for 'sm_90a'
ptxas info    : Function properties for _Z21sesr_corrected_kernelILi4ELb0EEvPKaPaPKiS3_iiiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 90 registers, used 1 barriers
"""


def test_ptxas_report_reads_each_instantiation():
    """``_build.ptxas_report`` reads registers and spill stores per
    instantiation of one kernel family from an -Xptxas -v log."""
    assert _build.ptxas_report(PTXAS_LOG, "sesr_net_kernel") == {"Li1ELi16ELb0ELi32": (128, 4)}
    assert _build.ptxas_report(PTXAS_LOG, "sesr_corrected_kernel") == {"Li4ELb0": (90, 0)}
    assert _build.ptxas_report(PTXAS_LOG, "probe_gemm_kernel") == {}


def test_importing_the_probes_builds_and_loads_nothing():
    code = ("from sesr_tpu_torch.ops import _build\n"
            "def refuse(*a, **k):\n"
            "    raise AssertionError('built or loaded at import')\n"
            "_build.build = _build.load = _build.find_nvcc = refuse\n"
            "import sesr_tpu_torch.probes, sesr_tpu_torch.probes.kernels, "
            "sesr_tpu_torch.probes.plain, sesr_tpu_torch.probes.conv, "
            "sesr_tpu_torch.probes.int8_gemm, sesr_tpu_torch.probes.bitcast, "
            "sesr_tpu_torch.probes.__main__, sesr_tpu_torch.probes.tile_ab, "
            "sesr_tpu_torch.ops.kernels, "
            "sesr_tpu_torch.timing\n"
            "print('ok')")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stdout + res.stderr


@pytest.mark.parametrize("variant", list(tile_ab.VARIANTS))
def test_tile_ab_variants_apply_to_the_source(variant):
    """Each A/B variant of the GEMM tile is csrc/ with its edits, and each
    edit still finds its text (python -m sesr_tpu_torch.probes.tile_ab)."""
    files = tile_ab.variant_sources(variant)
    assert set(files) == {"probes.cu", "wgmma_gemm.cuh"}
    changed = {f for f, text in files.items() if text != (_build.CSRC / f).read_text()}
    assert changed == {f for f, _, _ in tile_ab.VARIANTS[variant]}
    assert len(changed) == (variant != "base")
