"""python -m sesr_tpu_torch.probes.tile_ab [--tile gemm|conv|bitcast] [--size N] [--reps R] [--rounds K]

An A/B of the probes' wgmma kernels on the card: ``csrc/`` as it is
("base") and variants, each a copy of ``csrc/`` with one text edit, built
side by side (one nvcc each, all started together) into
``build/variants/<name>/`` and timed in turns, ``--rounds`` times over,
device time (CUDA events, the device kept busy while the host enqueues).
Each line says whether the output equals the plain version.

``--tile gemm`` (the default): the GEMM tile (``csrc/wgmma_gemm.cuh``) at
N^3 through ``probe_gemm``'s C entry point, int8 -> int32 and bf16 ->
float32. Variants:
  no_transpose    the int8 transposing pass removed: wgmma reads whatever
                  the K-major ring holds, so the int8 product is wrong, and
                  the time says what the pass costs
  bf16_3_stages   the bf16 128 x 256 tile with 3 stages in flight, not 4

``--tile conv``: the conv probe's persistent kernel (``probe_conv_run``) on
the probe's (48, 72, 128) tile, int8 and bf16, calls of 1 and 50 steps and
their K-difference, the time of one step. Variants (each but ring_6 gives
a wrong result, timed):
  conv_ring_6          6 tap boxes in flight, not 4
  conv_no_grid_wait    the producer does not wait for the grid barrier: the
                       time without the barriers between steps
  conv_no_mma          no wgmma: the time of the loads, barriers and
                       epilogues alone

``--tile bitcast``: P3 whole (``probe_bitcast_dot``, wgmma_gemm.cuh
``words_tile``) at words (N, N) x w (N, N / 4), roll 1 (the 128 x 256
tile), and at the probe's words (256, 128) x w (128, 256) (the 64 x 64
one). Variants:
  bitcast_setmaxnreg     the 128 x 256 tile with setmaxnreg: 208 registers
                         a consumer thread, 88 a producer thread
  bitcast_branchy        the transposing pass tests every row for the wrap
                         in every stage, not only in the stage that wraps
  bitcast_one_set        one A register set: each k32 step waits for the
                         previous wgmma to finish before it loads
  bitcast_bn128          128 x 128 tiles (64 accumulators a thread) where
                         the kernel takes 128 x 256

Needs the card and nvcc; prints one JSON line per measurement.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from sesr_tpu_torch.ops import _build
from sesr_tpu_torch.probes import conv, kernels, plain
from sesr_tpu_torch.timing import median_ms

VARIANT_DIR = _build.BUILD_DIR.parent / "variants"
# name: [(file in csrc/, text, replacement)]
VARIANTS = {
    "base": [],
    "no_transpose": [(
        "wgmma_gemm.cuh",
        "        transpose_stage<BN, PLANES>(smem_u32(smem + s * TL::STAGE_BYTES + TL::A_BYTES),\n"
        "                                    smem_u32(bt_ring + t * TL::B_BYTES), tt);\n",
        "")],
    "bf16_3_stages": [(
        "probes.cu", "using BigTileBf16 = wg::Tile<2, 256, 4>;",
        "using BigTileBf16 = wg::Tile<2, 256, 3>;")],
    "conv_ring_6": [(
        "probes.cu", "constexpr int kRing = 4;", "constexpr int kRing = 6;")],
    "conv_no_grid_wait": [(
        "probes.cu", "        grid_wait(p.count, barrier_target(p.base, s, nblocks));\n", "")],
    "conv_no_mma": [(
        "probes.cu",
        "        wgmma<kBn, BF16>(d, da + ((ks * kKStep) >> 4),\n"
        "                         db + (((BF16 ? kMnKStep : kKStep) * ks) >> 4));\n", "")],
    "bitcast_setmaxnreg": [(
        "wgmma_gemm.cuh", "  const int KT = (p.k + kStageK - 1) / kStageK;\n",
        "  const int KT = (p.k + kStageK - 1) / kStageK;\n  if constexpr (TL::NWG == 2) {\n"
        "    if (wgi == 0)\n"
        "      asm volatile(\"setmaxnreg.dec.sync.aligned.u32 88;\\n\" ::: \"memory\");\n"
        "    else\n"
        "      asm volatile(\"setmaxnreg.inc.sync.aligned.u32 208;\\n\" ::: \"memory\");\n  }\n")],
    "bitcast_bn128": [("probes.cu", "use_big(a) ? wg::launch_bitcast_dot<BigTile>(a, s)",
                       "use_big(a) ? wg::launch_bitcast_dot<wg::Tile<2, 128, 4>>(a, s)")],
    "bitcast_branchy": [("wgmma_gemm.cuh", "        if (wrap >= kStageK) {\n",
                         "        if (false) {\n")],
    "bitcast_one_set": [
        ("wgmma_gemm.cuh", "        wgmma_wait<1>();  // step ks - 1 is done\n",
         "        wgmma_wait<0>();\n"),
        ("wgmma_gemm.cuh", "uint32_t(&ak)[4] = a[ks & 1];", "uint32_t(&ak)[4] = a[0];")],
}
CONV_VARIANTS = ("conv_ring_6", "conv_no_grid_wait", "conv_no_mma")
BITCAST_VARIANTS = ("bitcast_setmaxnreg", "bitcast_branchy", "bitcast_one_set", "bitcast_bn128")


def variant_sources(name: str) -> dict[str, str]:
    """{file name: text} of csrc/ with the variant's edits; raises if an edit
    no longer applies to the source."""
    files = {p.name: p.read_text() for p in _build.sources("probes")}
    for fname, old, new in VARIANTS[name]:
        if files[fname].count(old) != 1:
            raise ValueError(f"variant {name}: the edit of {fname} does not apply")
        files[fname] = files[fname].replace(old, new)
    return files


def build_variant(name: str) -> Path:
    out = VARIANT_DIR / name
    out.mkdir(parents=True, exist_ok=True)
    for fname, text in variant_sources(name).items():
        (out / fname).write_text(text)
    lib = out / "libprobes.so"
    res = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(out / "probes.cu")], capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{res.stdout}{res.stderr}")
    return lib


def _entry_points(names, symbol: str) -> dict:
    """{variant: its library's C entry point ``symbol``}, every library built
    together."""
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build_variant, names)))
    fns = {}
    for name, path in libs.items():
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = _build.SIGNATURES["probes"][symbol]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def conv_ab(reps: int, rounds: int) -> list:
    """The conv probe's kernel and its variants, in turns: device ms of 1-
    and 50-step calls, and one step (T(50) - T(1)) / 49."""
    fns = _entry_points(("base",) + CONV_VARIANTS, "probe_conv_run")
    dev = torch.device("cuda", 0)
    eh, ew, c = conv.E_H, conv.E_W, conv.C
    nblocks = (c // kernels.CONV_BN) * (ew // kernels.CONV_PATCH) * (eh // kernels.CONV_PATCH)
    word = torch.zeros(1, dtype=torch.int32, device=dev)
    base = [0]
    gen = torch.Generator(device=dev).manual_seed(0)
    results = []
    for rnd in range(rounds):
        for name, fn in fns.items():
            for dtype in (torch.int8, torch.bfloat16):
                x = torch.randint(-3, 4, (eh, ew, c), device=dev, generator=gen).to(dtype)
                w9 = torch.randint(-2, 3, (9 * c, c), device=dev, generator=gen).to(dtype)
                bufs = torch.empty((2, eh + 2, ew + 2, c), dtype=dtype, device=dev)
                out = torch.empty((eh, ew, c), dtype=torch.float32, device=dev)

                def call(iters):
                    err = fn(x.data_ptr(), w9.data_ptr(), bufs.data_ptr(), out.data_ptr(),
                             word.data_ptr(), base[0], eh, ew, c, iters,
                             int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant {name} launch failed ({err})")
                    base[0] = kernels.barrier_base_after(base[0], nblocks, iters)

                ms = {it: median_ms(lambda: call(it), dev, reps, lead_ms=2.0)
                      for it in (1, conv.ITERS)}
                call(conv.ITERS)
                equal = torch.equal(out, conv.plain_probe(x, w9, "dot9", conv.ITERS))
                res = {"device": torch.cuda.get_device_name(dev), "round": rnd, "variant": name,
                       "type": str(dtype)[6:], "shape": [eh, ew, c], "ms_1_step": ms[1],
                       f"ms_{conv.ITERS}_steps": ms[conv.ITERS],
                       "us_per_step": (ms[conv.ITERS] - ms[1]) / (conv.ITERS - 1) * 1e3,
                       "equal_to_plain": bool(equal)}
                print(json.dumps(res), flush=True)
                results.append(res)
    return results


def bitcast_ab(size: int, reps: int, rounds: int) -> list:
    """probe_bitcast_dot and its variants, in turns: device ms at words
    (size, size) x w (size, size / 4) and at the probe's shape, roll 1, each
    output against the plain version."""
    fns = _entry_points(("base",) + BITCAST_VARIANTS, "probe_bitcast_dot")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = {"sized": (size, size, size // 4), "probe": (256, 128, 256)}
    operands = {}
    for key, (m, n, p) in shapes.items():
        words = torch.randint(-2 ** 31, 2 ** 31 - 1, (m, n), device=dev, generator=gen,
                              dtype=torch.int32)
        w = torch.randint(-128, 128, (n, p), device=dev, generator=gen).to(torch.int8)
        operands[key] = (words, w, plain.bitcast_dot(words, w, 1))
    results = []
    for rnd in range(rounds):
        for name, fn in fns.items():
            for key, (words, w, want) in operands.items():
                (m, n), p = words.shape, w.shape[1]
                out = torch.empty((4 * m, p), dtype=torch.int32, device=dev)

                def call():
                    err = fn(words.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, p, 1,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant {name} launch failed ({err})")

                ms = median_ms(call, dev, reps, lead_ms=1.0)
                res = {"device": torch.cuda.get_device_name(dev), "round": rnd, "variant": name,
                       "shape": key, "words": [m, n], "w": [n, p], "ms": ms,
                       "TOP/s": 2 * 4 * m * n * p / (ms * 1e-3) / 1e12,
                       "equal_to_plain": bool(torch.equal(out, want))}
                print(json.dumps(res), flush=True)
                results.append(res)
    return results


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="python -m sesr_tpu_torch.probes.tile_ab")
    ap.add_argument("--tile", default="gemm", choices=["gemm", "conv", "bitcast"])
    ap.add_argument("--size", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        ap.error("no CUDA device: the A/B runs on the card")
    if args.tile == "conv":
        return conv_ab(args.reps, args.rounds)
    if args.tile == "bitcast":
        return bitcast_ab(args.size, args.reps, args.rounds)
    fns = _entry_points([v for v in VARIANTS if v not in CONV_VARIANTS + BITCAST_VARIANTS],
                        "probe_gemm")
    dev = torch.device("cuda", 0)
    n = args.size
    gen = torch.Generator(device=dev).manual_seed(0)
    a8 = torch.randint(-8, 8, (n, n), device=dev, generator=gen).to(torch.int8)
    b8 = torch.randint(-8, 8, (n, n), device=dev, generator=gen).to(torch.int8)
    operands = {"int8": (a8, b8, torch.int32), "bf16": (a8.bfloat16(), b8.bfloat16(),
                                                         torch.float32)}
    wants = {k: plain.gemm(a, b, out) for k, (a, b, out) in operands.items()}
    results = []
    for rnd in range(args.rounds):
        for name, fn in fns.items():
            for kind, (a, b, out_dtype) in operands.items():
                out = torch.empty((n, n), dtype=out_dtype, device=dev)

                def call():
                    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), None, None, n, n, n,
                             int(kind == "bf16"), int(kind == "bf16"), 1,
                             torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"variant {name} launch failed ({err})")

                ms = median_ms(call, dev, args.reps, lead_ms=1.0)
                res = {"device": torch.cuda.get_device_name(dev), "round": rnd,
                       "variant": name, "type": kind, "size": n, "ms": ms,
                       "TOP/s": 2 * n ** 3 / (ms * 1e-3) / 1e12,
                       "equal_to_plain": bool(torch.equal(out, wants[kind]))}
                print(json.dumps(res), flush=True)
                results.append(res)
    return results


if __name__ == "__main__":
    main()
