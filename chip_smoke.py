#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (sesr_tpu_torch): sr_x2, nr
and nrdm_6 served and simulated, every task's infer, the probes, and the
artifact toolchain (eval-float, calibrate, certify, infer --audit).

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository around this file; fails
(non-zero exit, no "ok" line) without them. Phases:

1. the card: nvidia-smi's name and power limit, torch's device name;
2. build every kernel library from csrc/ (one nvcc per source, all started
   together), with the -Xptxas -v report;
3. each kernel against its plain PyTorch version on numpy-seeded inputs
   (the int8 outputs must be equal): K1 (sesr_pe_exact_net) and K2
   (sesr_fast_net) on sr_x2 at 540x960, 27x45 and a ragged 37x53 at batch
   2, K2 at batch 4, both at 27x45 with zero points off the shipped -128,
   both with two convs' weights at +-127 so that the clamps fire (K1's
   18-bit per-PE clamp; K2's 20-bit clamp); the corrected kernel
   (sesr_corrected_net, csrc/sesr_corrected.cu, on wgmma) on nr and nrdm_6
   in their hybrid mode at 27x45 and 37x53, on every artifact in the
   PE-exact mode (stamps removed), on nr with odd zero points and ragged at
   batch 2, on nr with convs 0 and 4 at +127 (hybrid: the 20-bit clamp
   fires on one-pass conv 0 and the 18-bit clamp on split conv 4; pe-exact:
   the 18-bit clamp on split conv 0), and on the edges of its wide rows
   (frames 1, 7, 63, 65 and 1921 columns wide, a frame smaller than one
   tile, a batch whose last tile is ragged) in both modes; every kernel on
   the sr_x4, nrdm_3, nrdm_6, dm and nr artifacts at 27x45; each wrapper on
   the card against the plain version on the CPU; ``infer --n-images 2`` on
   every task, cuda against cpu; and the SASS of the network libraries
   (cuobjdump): the corrected kernel on IGMMA with no IMMA, K1 and K2 on
   IMMA;
4. the main paths, each with the launch counters set to 0 before it and
   read after it. sr_x2: ``serve`` (behind ``infer``) on four synthetic
   540x960 -> 1080x1920 frames at batch 1 and batch 4 (K2), then
   ``simulate`` (behind ``sim``) on one 540x960 frame (K1). The Bayer
   tasks: nr and nrdm_6 served (hybrid mode, the corrected kernel) on four
   1080x1920 Bayer-sparse frames at batch 1 and 4, and nr simulated (K1)
   and simulated ``--corrected`` (the corrected kernel); then the served
   frames, batch 1 and 4, and the simulations against the plain version;
5. CUDA-event device timings, batch 1, of each kernel (K1 and K2 on sr_x2
   at 540x960, the corrected kernel on nr and nrdm_6 at 1080x1920, hybrid,
   and on nr pe-exact) at every tile of its sweep (each tile's output
   equal to the default tile's) and of its plain version, against the
   least time the card could take (int8 operations at 1,979 TOP/s over the
   network's MACs, or bytes at 3.35 TB/s, whichever is larger); each tile's
   registers and shared memory as CUPTI reports them (torch.profiler; the
   corrected kernel's also against its plan in the wrapper and in the
   library), and its tensor-core instructions per frame as computed from
   the tile geometry (mma.sync for K1 / K2, wgmma for the corrected
   kernel);
6. where a served frame's time goes, sr_x2 (540x960) and nr (1080x1920),
   at batch 1 and 4: the forward on an input already on the card, and the
   round trip from a numpy input to a numpy output; wall ms/frame by CUDA
   events, device ms/frame of every kernel and copy by torch.profiler,
   and the idle share 1 - busy / wall;
7. the probes (csrc/probes.cu, the counterparts of the TPU-compiler probes
   in tools/): ``python -m sesr_tpu_torch.probes`` conv, gemm and bitcast
   with the probe kernels' launch counters at 0, every kernel at the
   probes' full sizes against its plain version (int8 and int32 outputs
   torch.equal, bf16 conv probes after 1-3 steps within 2^-7 max|plain|,
   r3a's own shapes refused with no launch); the conv probe's persistent
   kernel (probe_conv_run) at 1, 2, 3 and 50 steps, its int8 50-step
   check five times over (a missing proxy fence shows as a stale read only
   sometimes), on edge shapes, one launch per probe call, and the shapes
   it does not take refused with no launch; the wgmma GEMM tile on its
   edges (ragged M, N off the big tile, K of one stage or less, write-back
   rep > 1; torch.equal) and a 16-byte misaligned view refused with no
   launch; the SASS of each probe kernel (cuobjdump: probe_gemm,
   probe_packed_dot and probe_conv_run on HGMMA / IGMMA with UTMALDG and
   no HMMA / IMMA); and each kernel's device time (CUDA events, the
   device kept busy while the host enqueues) beside its plain version's,
   its library call's (torch._int_mm timed with B row-major and
   column-major, the faster reported; for bf16 torch.mm with a float32
   output, torch.matmul's bf16 output beside it; F.pad + F.conv2d for a
   bf16 conv step) and its bound; a conv step's time is the K-difference
   (T(50) - T(1)) / 49 of 50- and 1-step probe calls; registers and
   shared memory from CUPTI;
8. the artifact toolchain from float weights (the sr_x2 and nr golden
   bundles' collapsed weights, written to a collapsed .npz), with TF32 on
   around it (the float paths turn it off for their own convs):
   ``eval-float`` on sr_x2 at 540x960 cuda against cpu; ``calibrate``
   (minmax) of sr_x2 at 540x960 and nr at 1080x1920, twice on the card
   (equal artifacts) and once on the CPU (scales within rel 3e-3, zeros
   within 2), and KL on nr at 272x480 (the same guardrail decision); ``certify`` of
   the two fresh and the shipped sr_x2, nr and nrdm_6 artifacts on four
   full-size frames on the card (sr_x2 fully certified through K2, one
   launch a frame; nr and nrdm_6 hybrid with the last conv ``x``, through
   the corrected kernel, one launch a frame), their stamps on 96x128 crops
   equal on cuda and cpu, and the seconds of the interpreter, strict and
   kernel-equality parts; the strict interpreter on nr's 1080x1920 frame;
   ``infer --audit 1`` on nr at 1080x1920: four synthetic frames (no
   violation, outputs equal to the plain version) and the adversarial
   frame then a synthetic one (layer 0 flagged, the stream degraded to
   pe-exact with its launches counted by split mask, both outputs equal to
   the CPU interpreter's), with the audit's shadow cost per frame. Each
   time is printed with the card's name and power limit.

The line before the last is the ``kernels`` JSON; the last is
{"ok": true, "device": {...}}.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TASK = "sr_x2"
FRAME = (540, 960)                 # deployment input; 1080x1920 output
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor-core peak
BYTES_PER_S = 3.35e12              # H100 SXM HBM3
BAYER_FRAME = (1080, 1920)         # nr / nrdm_6: the sr_x2 output frame, Bayer-sparse
KL_FRAME = (272, 480)              # phase 8's KL guardrail check, cuda against cpu
REPLACES = {"sesr_pe_exact_net": "sesr_tpu/ops/pallas_pipeline.py:143",
            "sesr_fast_net": "sesr_tpu/ops/pallas_packed.py:238",
            # XLA with no Pallas kernel, reached from :723 packed_exact_forward
            # (corrected) and :749 packed_hybrid_forward
            "sesr_corrected_net": "sesr_tpu/ops/packed.py:562"}
SOURCES = {"sesr_pe_exact_net": "sesr_tpu_torch/csrc/sesr_net.cu",
           "sesr_fast_net": "sesr_tpu_torch/csrc/sesr_net.cu",
           "sesr_corrected_net": "sesr_tpu_torch/csrc/sesr_corrected.cu"}
TILE_SWEEP = ((16, 32), (24, 32), (32, 32), (16, 64), (24, 48), (32, 64))
# the corrected kernel's (one block an SM, persistent): tiles past a
# block's shared memory are reported and skipped
CORRECTED_SWEEP = ((16, 64), (24, 64), (32, 32), (32, 48), (48, 48), (32, 64))
# the corrected kernel's wide-row edges: (n, h, w), in both modes
CORRECTED_EDGES = ((1, 33, 1), (1, 33, 7), (1, 33, 63), (1, 33, 65), (1, 9, 1921),
                   (1, 5, 9), (3, 40, 70))
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core peak
PROBE_SOURCE = "sesr_tpu_torch/csrc/probes.cu"
PROBE_REPLACES = {
    "probe_gemm": "tools/bench_probe_pallas_int8.py:65; the dots of "
                  "tools/bench_probe_pallas_conv.py:122 (mm variants) and "
                  "tools/bench_probe_r3a.py:343",
    "probe_conv_run": "tools/bench_probe_pallas_conv.py:122",
    "probe_unpack_words": "tools/bench_probe_r3b.py:82; the bitcast of "
                          "tools/bench_probe_r3a.py:343",
    "probe_packed_dot": "tools/bench_probe_r3b.py:147; tools/bench_probe_r3b.py:164",
}
BF16_ITERS = 3                     # bf16 conv probes are compared after 3 steps,
BF16_TOL = 2.0 ** -7               # within 2^-7 max|plain| elementwise


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line():
    res = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi: {res.returncode} {res.stderr.strip()}")
    return res.stdout.strip()


def bound(ops, nbytes, ops_per_s):
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = ops / ops_per_s * 1e3, nbytes / BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _short(name):
    """A device event's name without its template arguments' bodies."""
    m = re.search(r"sesr_net_kernel<\(?[a-z ]*\)?(\d)", name)
    if m:
        return {"0": "K1 sesr_pe_exact_net", "1": "K2 sesr_fast_net"}.get(m.group(1), name[:80])
    if "sesr_corrected_kernel" in name:
        return "sesr_corrected_net"
    if name.startswith("Memcpy"):
        return name
    for functor in ("DivFunctor", "MulFunctor", "CUDAFunctorOnSelf_add", "round_kernel",
                    "clamp", "direct_copy"):
        if functor in name:
            src = (" from int8" if "(signed char)" in name
                   else " from f32" if "(float)" in name else "")
            return f"aten {functor}{src}"
    return name[:80]


def mma_count(spec, pe_split, n, h, w, tile):
    """mma.sync instructions (m16n8k32) one launch issues over an (n, h, w)
    input, computed from the tile geometry of conv_layer in
    sesr_tpu_torch/csrc/sesr_net.cu (the card does not count them): per
    block and layer, the layer's output extent (the tile and the halo of
    the convs after it) cut into sixteens, times the passes and k32 chunks
    of its implicit GEMM and its n-tiles of 8 output channels.
    ``pe_split``: per layer, one pass per PE (KernelConstants.pe_split)."""
    from sesr_tpu_torch.convert import layer_geometry

    th, tw = tile
    L = spec.num_convs
    per_block = 0
    for i, k in enumerate(spec.kernel_sizes):
        ic = spec.in_channels if i == 0 else spec.num_channels
        oc = spec.conv_out_channels if i == L - 1 else spec.num_channels
        passes, chunks, _ = layer_geometry(k, ic, pe_split[i])
        r = sum(kk // 2 for kk in spec.kernel_sizes[i + 1:])
        rows = -(-(th + 2 * r) * (tw + 2 * r) // 16)
        per_block += rows * passes * chunks * -(-oc // 8)
    return per_block * n * -(-h // th) * -(-w // tw)


def wgmma_count(spec, pe_split, n, h, w, tile):
    """(wgmma instructions, tensor-core MACs) one launch of the corrected
    kernel (csrc/sesr_corrected.cu) issues over an (n, h, w) input, computed
    from its tile geometry (the card does not count them): per tile and
    layer, the wide GEMM's rows (the output extent's height times the input
    extent's width) cut into m-tiles of 64, times the layer's k32 steps;
    each wgmma is 64 x N x 32 MACs, N the layer's columns (convert.py
    wgmma_geometry; x4 on a split layer)."""
    from sesr_tpu_torch.convert import wgmma_geometry

    th, tw = tile
    L = spec.num_convs
    count = macs = 0
    for i, k in enumerate(spec.kernel_sizes):
        ic = spec.in_channels if i == 0 else spec.num_channels
        oc = spec.conv_out_channels if i == L - 1 else spec.num_channels
        steps, _, n_cols = wgmma_geometry(k, ic, oc, pe_split[i], i == L - 1)
        r = sum(kk // 2 for kk in spec.kernel_sizes[i:])
        rows = (th + 2 * r - k + 1) * (tw + 2 * r)
        count += -(-rows // 64) * steps
        macs += -(-rows // 64) * steps * 64 * n_cols * 32
    tiles = n * -(-h // th) * -(-w // tw)
    return count * tiles, macs * tiles


def launch_attrs(torch, launches, pattern="sesr_net_kernel"):
    """{key: (registers per thread, shared memory bytes per block)} of the
    launch of a kernel whose name holds ``pattern`` that each fn of
    ``launches`` ({key: fn}) makes, as CUPTI reports them in torch.profiler's
    trace; (None, None) where the trace does not hold them. Each fn is
    traced on its own and its last such kernel read: a trace may carry
    kernels of an earlier trace, or miss one."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    path = os.path.join(REPO, "build", "chip_smoke_trace.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    attrs = {}
    for key, fn in launches.items():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        kernels = sorted((e for e in events if e.get("cat") == "kernel"
                          and pattern in e.get("name", "")), key=lambda e: e["ts"])
        args = kernels[-1].get("args", {}) if kernels else {}
        attrs[key] = (args.get("registers per thread"), args.get("shared memory"))
    os.unlink(path)
    return attrs


def plain_kwargs(kern, qp, mode=None):
    """integer_forward's arguments for the plain version of ``kern`` (the
    corrected kernel in ``mode``, "hybrid" or "pe-exact")."""
    if kern.datapath == "exact":
        return dict(corrected=False, compute="exact")
    if kern.datapath == "fast":
        return dict(corrected=True, compute="fast")
    return dict(corrected=True, fast_layers=tuple(qp.fast_cert_layers)
                if mode == "hybrid" else None)


def tensor_count(kern, spec, split, n, h, w, tile):
    """(tensor-core instructions, their MACs, the instruction's name) of one
    launch of ``kern``, computed from its tile geometry."""
    if kern.datapath == "corrected":
        return (*wgmma_count(spec, split, n, h, w, tile), "wgmma")
    mmas = mma_count(spec, split, n, h, w, tile)
    return mmas, mmas * 16 * 8 * 32, "mma.sync"


def time_kernel(torch, dev, kern, spec, qp, x, mode, sweep):
    """Phase 5 for one kernel on one network and batch-1 frame x: with
    ``sweep``, every tile of its sweep (TILE_SWEEP; the corrected kernel's
    CORRECTED_SWEEP, skipping tiles past a block's shared memory) with its
    output equal to the default tile's, its registers and shared memory
    from CUPTI (the corrected kernel's also against the plan of the wrapper
    and of the library) and its tensor-core instructions computed from the
    tile geometry; then the default tile's time, the plain version's and the
    bound. A kernel's time is device time (the card kept busy while the host
    enqueues the launch: the wrapper's Python, about as long as K2 itself,
    stays out). Returns (ms, plain ms, (bound ms, bound by))."""
    from sesr_tpu_torch.convert import kernel_constants
    from sesr_tpu_torch.ops import _build
    from sesr_tpu_torch.ops.corrected import split_layers
    from sesr_tpu_torch.ops.kernels import SMEM_LIMIT
    from sesr_tpu_torch.quant.integer import integer_forward, quantize_input
    from sesr_tpu_torch.timing import median_ms

    corrected = kern.datapath == "corrected"
    split_arg = split_layers(qp, mode) if corrected else None
    split = kernel_constants(spec, qp, kern.datapath, split_arg).pe_split
    x_q = quantize_input(x, qp).to(torch.int8).contiguous()
    n, h, w = x_q.shape[:3]
    label = f"{kern.symbol} {spec.name}{f' {mode}' if mode else ''} {h}x{w}"
    tile0 = kern.tile(spec, split)
    ref = kern(spec, qp, x_q, split=split_arg)
    if sweep:
        tiles = TILE_SWEEP
        if corrected:
            lib = _build.load(kern.library)
            mask = sum(1 << i for i, f in enumerate(split) if f)
            tiles = []
            for tile in CORRECTED_SWEEP:
                plan = kern.smem_bytes(spec, tile, split)
                built = lib.sesr_corrected_smem(spec.num_convs, spec.in_channels,
                                                spec.conv_out_channels, *tile, mask)
                if plan != (built or plan) or (plan <= SMEM_LIMIT) != (built > 0):
                    fail(f"{label} tile {tile}: the wrapper plans {plan} B of shared memory, "
                         f"the library {built}")
                if plan > SMEM_LIMIT:
                    print(f"[5] {label} tile {tile[0]}x{tile[1]}: needs {plan} B of shared "
                          f"memory, more than a block's {SMEM_LIMIT}: not taken", flush=True)
                else:
                    tiles.append(tile)
        attrs = launch_attrs(torch, {tile: (lambda t=tile: kern(spec, qp, x_q, tile=t,
                                                                split=split_arg))
                                     for tile in tiles},
                             "sesr_corrected_kernel" if corrected else "sesr_net_kernel")
        for tile in tiles:
            if not torch.equal(kern(spec, qp, x_q, tile=tile, split=split_arg), ref):
                fail(f"{label} at tile {tile} differs from tile {tile0}")
            tile_ms = median_ms(lambda: kern(spec, qp, x_q, tile=tile, split=split_arg), dev,
                                30, warmup=3, lead_ms=1.0)
            regs, smem = attrs[tile]
            count, _, instr = tensor_count(kern, spec, split, n, h, w, tile)
            if corrected and smem is not None and smem != kern.smem_bytes(spec, tile, split):
                fail(f"{label} tile {tile}: CUPTI reports {smem} B of shared memory, the plan "
                     f"{kern.smem_bytes(spec, tile, split)}")
            print(f"[5] {label} tile {tile[0]}x{tile[1]}: {tile_ms:.4f} ms/frame; CUPTI: "
                  f"{regs if regs is not None else 'not measured'} registers per thread, "
                  f"{smem if smem is not None else 'not measured'} B shared memory per "
                  f"block; {count} {instr} per frame (computed from the tile geometry)",
                  flush=True)
    ms = median_ms(lambda: kern(spec, qp, x_q, split=split_arg), dev, 30, warmup=3, lead_ms=1.0)
    kw = plain_kwargs(kern, qp, mode)
    plain_ms = median_ms(lambda: integer_forward(spec, qp, x, **kw), dev, 5)
    weights = sum(int(np.prod(np.shape(wl))) for wl in qp.w_int)
    macs = weights * n * h * w
    moved = x_q.numel() + n * h * w * spec.conv_out_channels + weights
    bnd = bound(2 * macs, moved, INT8_OPS_PER_S)
    count, tc_macs, instr = tensor_count(kern, spec, split, n, h, w, tile0)
    print(f"[5] {label}: {ms:.4f} ms/frame at tile {tile0[0]}x{tile0[1]}, per-PE passes on "
          f"convs {[i for i in range(spec.num_convs) if split[i]]} (plain {plain_ms:.3f} ms); "
          f"computed from the tile geometry: {count} {instr} ({tc_macs:.4g} tensor-core MACs, "
          f"{tc_macs / macs:.3f}x the network's); bound {bnd[0] * 1e3:.3f} us ({bnd[1]}) = "
          f"{2 * macs:.4g} int8 ops vs {moved} bytes, share of bound {bnd[0] / ms:.4f}",
          flush=True)
    return ms, plain_ms, bnd


def breakdown(torch, fn, frames, iters=20):
    """(wall ms/frame, busy ms/frame, {event: device ms/frame}) of fn()."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / (iters * frames)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = _short(e.name)
            per[k] = per.get(k, 0.0) + e.device_time_total / 1e3 / (iters * frames)
    return wall, sum(per.values()), dict(sorted(per.items(), key=lambda kv: -kv[1]))


SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "HMMA", "IMMA")


def sass_counts(lib):
    """{kernel function (mangled): {opcode: count}} of the kernels in the
    library, from ``cuobjdump -sass`` (the toolkit's, beside nvcc)."""
    from sesr_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                         timeout=300)
    if res.returncode != 0:
        fail(f"cuobjdump -sass {lib}: {res.returncode} {res.stderr.strip()[:400]}")
    counts, current = {}, None
    op = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    for line in res.stdout.splitlines():
        if "Function :" in line:
            current = line.split("Function :", 1)[1].strip()
            counts[current] = dict.fromkeys(SASS_OPS, 0)
        elif current is not None and "/*" in line:
            for hit in op.findall(line.split(";")[0]):
                counts[current][hit] += 1
    return counts


def net_sass_check(build):
    """The network kernels' tensor-core instructions, from ``cuobjdump -sass``
    of their libraries: the corrected kernel (sesr_corrected_kernel) on
    wgmma (IGMMA) and no mma.sync (IMMA); K1 and K2 (sesr_net_kernel) on
    mma.sync. Prints each kernel's counts; fails otherwise."""
    want = {"sesr_corrected": ("sesr_corrected_kernel", "IGMMA", "IMMA", 1),
            "sesr_net": ("sesr_net_kernel", "IMMA", "IGMMA", 6)}
    for name, (family, has, lacks, instances) in want.items():
        seen = 0
        for fn, c in sorted(sass_counts(build.library_path(name)).items()):
            if family not in fn:
                continue
            seen += 1
            print(f"[3] SASS {family} {fn[fn.index(family) + len(family):][:40]}: "
                  f"{ {k: v for k, v in c.items() if v} }", flush=True)
            if not c[has] or c[lacks]:
                fail(f"{fn}: {has} expected and no {lacks}, got {c}")
        if seen != instances:
            fail(f"{name}: {seen} {family} instantiations in the library, {instances} expected")


def sass_check(lib):
    """probe_gemm, probe_packed_dot and probe_conv_run on wgmma (HGMMA /
    IGMMA) with TMA loads (UTMALDG) and no mma.sync (HMMA / IMMA). Prints
    each kernel's counts; fails on a missing opcode."""
    counts = sass_counts(lib)
    seen = dict.fromkeys(("probe_gemm_kernel", "probe_packed_dot_kernel",
                          "probe_conv_run_kernel"), 0)
    for fn, c in sorted(counts.items()):
        family = next((k for k in seen if k in fn), None)
        if family is None:
            continue
        seen[family] += 1
        print(f"[7] SASS {family} {fn[fn.index(family) + len(family):][:48]}: "
              f"{ {k: v for k, v in c.items() if v} }", flush=True)
        if not (c["HGMMA"] + c["IGMMA"]) or not c["UTMALDG"] or c["HMMA"] + c["IMMA"]:
            fail(f"{fn} is not on wgmma with TMA loads alone: {c}")
    print(f"[7] SASS kernels per family: {seen}", flush=True)
    if min(seen.values()) < 1:
        fail(f"a probe kernel is missing from the library: {seen}")


# the GEMM tile's edges: (M, K bytes, N). 4352 = 17 x 256 columns give the
# 128 x 256 tile >= 132 blocks at M = 1000; 192 columns take the 64 x 64
# tile; M 100 and 1000 are no multiple of 64 or 128; K of 64 bytes is half
# a stage and 128 one stage
EDGE_SHAPES = ((1000, 256, 4352), (100, 512, 192), (1000, 64, 4352), (100, 64, 192),
               (1000, 128, 4352), (1000, 1152, 192))
EDGE_REP = 3


def gemm_edge_checks(torch, dev, compare):
    """probe_gemm (every epilogue, both types) and probe_packed_dot on the
    tile's edges, each torch.equal with its plain version; then a 16-byte
    misaligned view refused with no launch."""
    from sesr_tpu_torch.probes import bitcast, plain
    from sesr_tpu_torch.probes import kernels as pk

    rng = np.random.default_rng(7)
    for m, kb, n in EDGE_SHAPES:
        for dtype in (torch.int8, torch.bfloat16):
            k = kb // (2 if dtype == torch.bfloat16 else 1)
            a = torch.from_numpy(rng.integers(-8, 8, (m, k)).astype(np.float32)).to(dev, dtype)
            b = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.float32)).to(dev, dtype)
            outs = [torch.float32] + ([torch.int32] if dtype == torch.int8 else [])
            for out_dtype in outs:
                got, want = pk.probe_gemm(a, b, out_dtype), plain.gemm(a, b, out_dtype)
                compare("probe_gemm", got, want)
                if not torch.equal(got, want):
                    fail(f"probe_gemm {dtype} -> {out_dtype} at (M, K, N) {(m, k, n)} "
                         f"disagrees with its plain version")
            x, f = pk.probe_gemm.write_back(a, b, EDGE_REP, f32=True)
            want = plain.gemm_write_back(a, b, EDGE_REP)
            compare("probe_gemm", x, want)
            if not (torch.equal(x, want) and torch.equal(f, want.float())):
                fail(f"probe_gemm {dtype} write-back rep {EDGE_REP} at {(m, k, n)} disagrees")
        _, _, words, wb = bitcast.byteplane_inputs((m, kb, n), seed=kb)
        words, wb = torch.from_numpy(words).to(dev), torch.from_numpy(wb).to(dev)
        for out_dtype in (torch.int32, torch.float32):
            got = pk.probe_packed_dot(words, wb, out_dtype)
            want = plain.packed_dot(words, wb, out_dtype)
            compare("probe_packed_dot", got, want)
            if not torch.equal(got, want):
                fail(f"probe_packed_dot -> {out_dtype} at (M, K, N) {(m, kb, n)} disagrees")
    print(f"[7] edge cases {EDGE_SHAPES} (M, K bytes, N), both types, every epilogue "
          f"(write-back rep {EDGE_REP}), and probe_packed_dot: torch.equal with plain",
          flush=True)
    before = {k.symbol: k.launches for k in pk.PROBE_KERNELS}
    a = torch.zeros(128 * 256 + 16, dtype=torch.int8, device=dev)[1:1 + 128 * 256].view(128, 256)
    words = torch.zeros(128 * 64 + 4, dtype=torch.int32, device=dev)[1:1 + 128 * 64].view(128, 64)
    b = torch.zeros((256, 128), dtype=torch.int8, device=dev)
    for label, call in (("probe_gemm", lambda: pk.probe_gemm(a, b)),
                        ("probe_packed_dot", lambda: pk.probe_packed_dot(
                            words, torch.zeros((4, 64, 128), dtype=torch.int8, device=dev)))):
        try:
            call()
            fail(f"{label} took a view that is not 16-byte aligned")
        except ValueError as e:
            print(f"[7] {label} refuses a misaligned view: {e}", flush=True)
    after = {k.symbol: k.launches for k in pk.PROBE_KERNELS}
    if after != before:
        fail(f"a refused misaligned view launched: {before} -> {after}")


# probe_conv_run off the probe's own shape: (shape, type, steps)
CONV_EDGES = (((16, 24, 128), "int8", (1, 3, 50)), ((16, 24, 128), "bfloat16", (1, 3)),
              ((16, 24, 64), "bfloat16", (1, 3)), ((8, 8, 256), "int8", (1, 3, 50)))
# shapes it refuses: (shape, type, what)
CONV_REFUSED = (((9, 16, 128), "int8", "E_H not a multiple of 8"),
                ((8, 12, 128), "int8", "E_W not a multiple of 8"),
                ((8, 8, 96), "bfloat16", "C not a multiple of 64"),
                ((8, 8, 64), "int8", "int8 C not a multiple of 128"),
                ((8, 8, 256), "bfloat16", "bf16 weights beyond shared memory"),
                ((96, 96, 128), "int8", "288 blocks, more than the SMs"))
CONV_REPEATS = 5


def conv_run_checks(torch, dev, compare, counts, p1):
    """probe_conv_run beyond the probe calls: the int8 50-step calls
    CONV_REPEATS times over each (a missing proxy fence would show as a
    stale read only sometimes), the edge shapes against the plain version,
    and the refused shapes, with no launch."""
    from sesr_tpu_torch.probes import conv
    from sesr_tpu_torch.probes import kernels as pk

    c = conv.C
    for rep in range(CONV_REPEATS):
        for name in ("v2_int8_concat3", "v3_int8_dot9"):
            xt, wt = p1[name]
            got = conv.conv_probe(xt, wt, name)
            want = conv.plain_probe(xt, wt.reshape(9 * c, c), conv.VARIANTS[name][0], conv.ITERS)
            compare("probe_conv_run", got, want)
            if not torch.equal(got, want):
                fail(f"{name}, {conv.ITERS} steps, repeat {rep}: not equal to its plain version")
    print(f"[7] int8 {conv.ITERS}-step probe calls, v2 and v3, {CONV_REPEATS} times each: all "
          f"torch.equal with plain", flush=True)
    rng = np.random.default_rng(11)
    for shape, tname, steps in CONV_EDGES:
        dtype = getattr(torch, tname)
        x = torch.from_numpy(rng.integers(-3, 4, shape).astype(np.float32)).to(dev, dtype)
        w9 = torch.from_numpy(rng.integers(-2, 3, (9 * shape[2], shape[2])).astype(np.float32)
                              ).to(dev, dtype)
        for iters in steps:
            xn, got = pk.probe_conv_run(x, w9, iters)
            want = conv.plain_probe(x, w9, "dot9", iters)
            diff = compare("probe_conv_run", got, want)
            top = float(want.abs().max())
            exact = dtype == torch.int8 or iters == 1
            ok = torch.equal(got, want) if exact else diff <= BF16_TOL * top
            ok = ok and torch.equal(xn.float(), got)
            print(f"[7] probe_conv_run edge {shape} {tname}, {iters} steps: "
                  f"{'torch.equal' if exact else f'max |diff| {diff} <= 2^-7 * {top}'} with "
                  f"plain = {ok}", flush=True)
            if not ok:
                fail(f"probe_conv_run at {shape} {tname}, {iters} steps, disagrees")
    before = counts()
    for shape, tname, what in CONV_REFUSED:
        dtype = getattr(torch, tname)
        x = torch.zeros(shape, dtype=dtype, device=dev)
        try:
            pk.probe_conv_run(x, torch.zeros((9 * shape[2], shape[2]), dtype=dtype, device=dev), 2)
            fail(f"probe_conv_run took {shape} {tname} ({what})")
        except ValueError as e:
            print(f"[7] probe_conv_run refuses {shape} {tname} ({what}): {e}", flush=True)
    if counts() != before:
        fail(f"a refused probe_conv_run shape launched: {before} -> {counts()}")


def probes_phase(torch, dev):
    """Phase 7, the probes: the probe path with the launch counters at 0,
    each kernel of csrc/probes.cu against its plain version, and the times.
    Returns the four kernels' entries of the ``kernels`` line; an entry's
    max_abs_err is the largest difference over every comparison of that
    kernel with its plain version in this phase."""
    import torch.nn.functional as F

    from sesr_tpu_torch.ops import _build
    from sesr_tpu_torch.probes import bitcast, conv, int8_gemm, plain
    from sesr_tpu_torch.probes import kernels as pk
    from sesr_tpu_torch.probes.__main__ import main as probes_main
    from sesr_tpu_torch.timing import median_ms

    # 7a. the probe path a user runs, with the launch counters at 0
    pk.reset_launch_counts()
    for probe in ("conv", "gemm", "bitcast"):
        print(f"[7] python -m sesr_tpu_torch.probes {probe} --reps 2:", flush=True)
        probes_main([probe, "--reps", "2"])
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in pk.PROBE_KERNELS}
    print(f"[7] launches over the probe path (warm-up + 2 timed calls of each variant): "
          f"{launches}", flush=True)
    if min(launches.values()) < 1:
        fail(f"the probe path did not go through every probe kernel: {launches}")

    def counts():
        return {k.symbol: k.launches for k in pk.PROBE_KERNELS}

    def on_card(arr, dtype=None):
        t = torch.from_numpy(arr).to(dev)
        return t if dtype is None else t.to(dtype)

    def device_ms(fn, reps=20, lead_ms=1.0):
        return median_ms(fn, dev, reps, lead_ms=lead_ms)

    # 7b. every kernel against its plain version
    err = {k.symbol: 0.0 for k in pk.PROBE_KERNELS}

    def compare(sym, got, want):
        """max |got - want|, kept as the kernel's max_abs_err if larger."""
        diff = float((got.double() - want.double()).abs().max())
        err[sym] = max(err[sym], diff)
        return diff

    c = conv.C
    p1 = {}

    def conv_check(label, sym, got, want, dtype, iters):
        """int8: torch.equal; bf16: within 2^-7 max|plain|."""
        diff = compare(sym, got, want)
        top = float(want.abs().max())
        ok = torch.equal(got, want) if dtype == torch.int8 else diff <= BF16_TOL * top
        print(f"[7] {label} ({sym}), {iters} steps: "
              f"{'torch.equal' if dtype == torch.int8 else f'max |diff| {diff} <= 2^-7 * {top}'}"
              f" with plain (cuda) = {ok}; max|plain| {top}", flush=True)
        if not ok:
            fail(f"{label} disagrees with its plain version after {iters} steps")

    for name, (x, w) in conv.make_inputs().items():
        form, dtype = conv.VARIANTS[name]
        xt, wt = on_card(x, dtype), on_card(w, dtype)
        p1[name] = (xt, wt)
        w9 = wt.reshape(9 * c, c)
        if form == "mm":
            iters = conv.ITERS if dtype == torch.int8 else BF16_ITERS
            conv_check(f"P1 {name}", "probe_gemm", conv.conv_probe(xt, wt, name, iters),
                       conv.plain_probe(xt, w9, form, iters), dtype, iters)
            continue
        for iters in (1, 2, 3, conv.ITERS) if dtype == torch.int8 else (1, 2, BF16_ITERS):
            before = counts()
            got = conv.conv_probe(xt, wt, name, iters)
            launched = {k: counts()[k] - before[k] for k in before}
            if launched != {**dict.fromkeys(before, 0), "probe_conv_run": 1}:
                fail(f"a {name} probe call of {iters} steps launched {launched}, not one "
                     f"probe_conv_run")
            conv_check(f"P1 {name}", "probe_conv_run", got,
                       conv.plain_probe(xt, w9, form, iters), dtype, iters)
    print("[7] every v1-v4 probe call above was one probe_conv_run launch", flush=True)
    conv_run_checks(torch, dev, compare, counts, p1)
    p2 = {}
    for name, (a, b) in int8_gemm.make_inputs().items():
        dtype, out_dtype = int8_gemm.VARIANTS[name]
        at, bt = on_card(a, dtype), on_card(b, dtype)
        p2[name] = (at, bt)
        got = int8_gemm.gemm_probe(at, bt, name)
        want = plain.gemm(at, bt, out_dtype)
        diff = compare("probe_gemm", got, want)
        equal = torch.equal(got, want)
        print(f"[7] P2 {name} at {int8_gemm.SIZE}^3: torch.equal with plain (cuda) = {equal}, "
              f"max |diff| {diff}", flush=True)
        if not equal:
            fail(f"probe_gemm {name} disagrees with its plain version")
    words, w_r3a = (on_card(t) for t in bitcast.r3a_inputs())
    before = counts()
    try:
        bitcast.bitcast_dot(words, w_r3a)
        fail("r3a's own shapes (words (256, 128), w (512, 256)) did not raise")
    except TypeError as e:
        print(f"[7] P3 on r3a's shapes raises before any launch: {e}", flush=True)
    if counts() != before:
        fail(f"P3 on r3a's shapes launched: {before} -> {counts()}")
    w_ok = on_card(bitcast.r3a_inputs(bitcast.CONSISTENT_W_ROWS)[1])
    a8_r3a = plain.unpack_words(words, 1)
    words_l = on_card(bitcast.layout_inputs()[1])
    layout = bitcast.bitcast_layout_probe(dev)
    a8, w8, packed, wb = bitcast.byteplane_inputs()
    packed, wb, w8t = on_card(packed), on_card(wb), on_card(w8)
    got = bitcast.byteplane_dot(packed, wb)
    checks = {
        "P3 unpack (256, 128) roll 1": ("probe_unpack_words", bitcast.unpack_words(words, 1),
                                        a8_r3a),
        "P3 dot, w (128, 256)": ("probe_gemm", bitcast.bitcast_dot(words, w_ok),
                                 plain.gemm(a8_r3a, w_ok, torch.int32)),
        "P4 unpack (8, 128)": ("probe_unpack_words", bitcast.unpack_words(words_l),
                               plain.unpack_words(words_l)),
        "P5 byte-plane dot": ("probe_packed_dot", got, plain.packed_dot(packed, wb)),
        "P5 byte-plane dot against numpy a8 @ w8": (
            "probe_packed_dot", got.cpu(),
            torch.from_numpy(a8.astype(np.int32) @ w8.astype(np.int32))),
        "P6 byte-plane dot, f32": ("probe_packed_dot",
                                   bitcast.byteplane_dot(packed, wb, torch.float32),
                                   plain.packed_dot(packed, wb, torch.float32))}
    for label, (sym, g, want) in checks.items():
        diff = compare(sym, g, want)
        equal = torch.equal(g, want)
        print(f"[7] {label} ({sym}): torch.equal = {equal}, max |diff| {diff}", flush=True)
        if not equal:
            fail(f"{label} disagrees with its plain version")
    print(f"[7] P4 bitcast layout probe: {layout}", flush=True)
    if layout != "m*4+b":
        fail(f"the unpack's row layout is {layout}, not m*4+b")
    gemm_edge_checks(torch, dev, compare)
    sass_check(_build.library_path("probes"))
    print(f"[7] max_abs_err over every comparison, per kernel: {err}", flush=True)

    # 7c. times: kernel, plain version and library call, each against its bound
    entries = []

    def entry(sym, work, ms, plain_ms, bnd, library_ms):
        entries.append(dict(
            name=sym, route="cuda", source=PROBE_SOURCE, replaces=PROBE_REPLACES[sym],
            launches=launches[sym], max_abs_err=err[sym], ms=ms, plain_ms=plain_ms,
            bound_ms=bnd[0], bound_by=bnd[1], library_ms=library_ms, work=work))

    def report(label, ms, bnd, plain_ms=None, library_ms=None, library=""):
        lib = f"{library_ms:.5f} ms ({library})" if library_ms is not None else "none"
        pl_ = f"{plain_ms:.5f} ms" if plain_ms is not None else "-"
        print(f"[7] {label}: {ms:.5f} ms, bound {bnd[0] * 1e3:.4f} us ({bnd[1]}), share "
              f"{bnd[0] / ms:.4f}; plain {pl_}; library {lib}", flush=True)

    def int_mm(a, b, f32=False):
        """(device ms, label) of the faster of torch._int_mm(a, b) with b
        row-major and column-major (transposed outside the timed region)."""
        b_cm = b.t().contiguous().t()
        want = torch._int_mm(a, b)
        if not torch.equal(torch._int_mm(a, b_cm), want):
            fail("torch._int_mm with a column-major B computes another product")
        times = {}
        for layout, bb in (("B row-major", b), ("B column-major", b_cm)):
            times[layout] = device_ms((lambda: torch._int_mm(a, bb).float()) if f32 else
                                      (lambda: torch._int_mm(a, bb)))
        best = min(times, key=times.get)
        print(f"[7]     torch._int_mm{'(..).float()' if f32 else ''} {tuple(a.shape)} x "
              f"{tuple(b.shape)}: {times} ms", flush=True)
        return times[best], f"torch._int_mm{'(..).float()' if f32 else ''}, {best}"

    def mm_f32(a, b):
        """(device ms, label) of torch.mm(a, b, out_dtype=torch.float32), the
        bf16 -> f32 product the kernel computes (it must equal the plain
        version); torch.matmul's bf16 output, half the bytes, is printed
        beside it."""
        try:
            same = torch.equal(torch.mm(a, b, out_dtype=torch.float32),
                               plain.gemm(a, b, torch.float32))
        except (TypeError, RuntimeError) as e:
            fail(f"torch.mm(..., out_dtype=torch.float32) is not available: {e}")
        if not same:
            fail("torch.mm(..., out_dtype=torch.float32) computes another product")
        ms = device_ms(lambda: torch.mm(a, b, out_dtype=torch.float32))
        bf16_ms = device_ms(lambda: torch.matmul(a, b))
        print(f"[7]     bf16 {tuple(a.shape)} x {tuple(b.shape)}: torch.mm(.., out_dtype=f32) "
              f"{ms:.5f} ms (equal to plain); torch.matmul, bf16 output, {bf16_ms:.5f} ms",
              flush=True)
        return ms, "torch.mm(.., out_dtype=torch.float32)"

    n = int8_gemm.SIZE
    for name, (at, bt) in p2.items():
        dtype, out_dtype = int8_gemm.VARIANTS[name]
        ms = device_ms(lambda: pk.probe_gemm(at, bt, out_dtype))
        plain_ms = device_ms(lambda: plain.gemm(at, bt, out_dtype), reps=5)
        if dtype == torch.bfloat16:
            lib_ms, lib_name = mm_f32(at, bt)
        else:
            lib_ms, lib_name = int_mm(at, bt, f32=out_dtype == torch.float32)
        bnd = bound(2 * n ** 3, 2 * n * n * at.element_size() + 4 * n * n,
                    BF16_OPS_PER_S if dtype == torch.bfloat16 else INT8_OPS_PER_S)
        report(f"P2 probe_gemm {name} {n}^3 (device time)", ms, bnd, plain_ms, lib_ms,
               lib_name)
        if name == "pallas_mm_int8":
            entry("probe_gemm", f"int8 {n}^3 -> int32 (P2 pallas_mm_int8)", ms, plain_ms, bnd,
                  lib_ms)

    eh, ew = conv.E_H, conv.E_W
    m = eh * ew

    def ops_per_s(dtype):
        return INT8_OPS_PER_S if dtype == torch.int8 else BF16_OPS_PER_S

    step_ms = {}
    for name, (xt, wt) in p1.items():
        form, dtype = conv.VARIANTS[name]
        w9 = wt.reshape(9 * c, c)
        call_ms = median_ms(lambda: conv.conv_probe(xt, wt, name), dev, 10, warmup=2)
        dev_ms = device_ms(lambda: conv.conv_probe(xt, wt, name), reps=10, lead_ms=5.0)
        plain_ms = median_ms(lambda: conv.plain_probe(xt, w9, form, conv.ITERS), dev, 3)
        es = xt.element_size()
        bnd = bound(conv.step_ops((eh, ew, c), form) * conv.ITERS,
                    m * c * es + 9 * c * c * es + m * c * 4, ops_per_s(dtype))
        sym = "probe_gemm" if form == "mm" else "probe_conv_run"
        n_launch = conv.ITERS if form == "mm" else 1
        line = ""
        if form != "mm":
            # one step: the K-difference of 50- and 1-step calls, which takes
            # the prologue and the weight load out
            one_ms = device_ms(lambda: conv.conv_probe(xt, wt, name, 1), reps=20)
            step_ms[name] = (dev_ms - one_ms) / (conv.ITERS - 1)
            sb = bound(conv.step_ops((eh, ew, c)), 2 * m * c * es + 9 * c * c * es,
                       ops_per_s(dtype))
            line = (f"; 1-step call {one_ms:.5f} ms, one step (T({conv.ITERS}) - T(1)) / "
                    f"{conv.ITERS - 1} = {step_ms[name] * 1e3:.4f} us, share of its "
                    f"{sb[0] * 1e3:.4f} us bound {sb[0] / step_ms[name]:.4f}")
        print(f"[7] P1 {name}, one probe call ({n_launch} {sym} launch"
              f"{'es' if n_launch > 1 else ''}): {call_ms:.5f} ms as the host issues it, "
              f"{dev_ms:.5f} ms of device time (launches queued); bound "
              f"{bnd[0] * 1e3:.4f} us ({bnd[1]}), share {bnd[0] / dev_ms:.4f} of the device "
              f"time; plain {plain_ms:.5f} ms{line}", flush=True)
    # one step of each type beside its plain version and the library's conv
    for dtype in (torch.int8, torch.bfloat16):
        name = "v2_int8_concat3" if dtype == torch.int8 else "v1_bf16_concat3"
        xt, wt = p1[name]
        w9 = wt.reshape(9 * c, c)
        step = plain.conv_step(xt, w9)
        plain_ms = device_ms(lambda: plain.conv_step(xt, w9), reps=10)
        es = xt.element_size()
        bnd = bound(conv.step_ops((eh, ew, c)), 2 * m * c * es + 9 * c * c * es, ops_per_s(dtype))
        lib_ms, lib_name = None, "none: PyTorch has no int8 conv on CUDA"
        if dtype == torch.bfloat16:
            x_nchw = xt.permute(2, 0, 1)[None].contiguous()
            w_oihw = wt.reshape(3, 3, c, c).permute(3, 2, 0, 1).contiguous()

            def lib():
                return F.conv2d(F.pad(x_nchw, (1, 1, 1, 1), mode="circular"), w_oihw)

            # the library call computes the same conv: in f32 on these
            # integer inputs its sums are exact, so its write-back is the plain step's
            same = plain.write_back(F.conv2d(F.pad(x_nchw.float(), (1, 1, 1, 1), mode="circular"),
                                             w_oihw.float())[0].permute(1, 2, 0), torch.bfloat16)
            if not torch.equal(same, step):
                fail("F.conv2d on the circularly padded tile is not the probe's conv")
            lib_ms, lib_name = device_ms(lib), \
                "F.pad circular + F.conv2d, bf16 NCHW, no write-back"
        report(f"P1 probe_conv_run, one {str(dtype)[6:]} step of {name} "
               f"((T({conv.ITERS}) - T(1)) / {conv.ITERS - 1}, device time)",
               step_ms[name], bnd, plain_ms, lib_ms, lib_name)
        if dtype == torch.bfloat16:
            entry("probe_conv_run", f"one bf16 step of P1 on ({eh}, {ew}, {c}): the "
                  f"K-difference (T({conv.ITERS}) - T(1)) / {conv.ITERS - 1} of v1 probe calls",
                  step_ms[name], plain_ms, bnd, lib_ms)
    for name in ("v5_int8_mm", "v6_bf16_mm"):
        xt, wt = p1[name]
        a = xt.reshape(m // 9, 9 * c)
        buf = torch.empty_like(xt).view(m, c)
        ms = device_ms(lambda: pk.probe_gemm.write_back(a, wt, 9, out_x=buf), reps=30)
        plain_ms = device_ms(lambda: plain.gemm_write_back(a, wt, 9), reps=10)
        if xt.dtype == torch.int8:
            lib_ms, lib_name = int_mm(a, wt)
        else:
            lib_ms, lib_name = mm_f32(a, wt)
        es = xt.element_size()
        bnd = bound(conv.step_ops((eh, ew, c), "mm"), 2 * m * c * es + 9 * c * c * es,
                    INT8_OPS_PER_S if xt.dtype == torch.int8 else BF16_OPS_PER_S)
        report(f"P1 probe_gemm write-back, one {name} step (device time)", ms, bnd, plain_ms,
               lib_ms, lib_name)

    for label, wds, roll in (("P3 (256, 128) roll 1", words, 1), ("P4 (8, 128)", words_l, 0)):
        ms = device_ms(lambda: pk.probe_unpack_words(wds, roll), reps=30)
        plain_ms = device_ms(lambda: plain.unpack_words(wds, roll))
        bnd = bound(0, 2 * wds.numel() * 4, INT8_OPS_PER_S)
        report(f"{label} probe_unpack_words (device time)", ms, bnd, plain_ms)
        if roll:
            entry("probe_unpack_words", "P3's unpack: (256, 128) int32 words, roll 1", ms,
                  plain_ms, bnd, None)
    ms = device_ms(lambda: bitcast.bitcast_dot(words, w_ok), reps=30)
    plain_ms = device_ms(lambda: plain.gemm(plain.unpack_words(words, 1), w_ok, torch.int32))
    lib_ms, lib_name = int_mm(a8_r3a, w_ok)
    bnd = bound(2 * a8_r3a.shape[0] * a8_r3a.shape[1] * w_ok.shape[1],
                words.numel() * 4 + w_ok.numel() + a8_r3a.shape[0] * w_ok.shape[1] * 4,
                INT8_OPS_PER_S)
    report("P3 bitcast_dot on consistent shapes (unpack + probe_gemm, device time)", ms, bnd,
           plain_ms, lib_ms, f"{lib_name}, on the unpacked operand")
    mb, kb, nb = bitcast.BYTEPLANE_SHAPES
    lib_a8 = packed.view(torch.int8).reshape(mb, kb)
    for out_dtype in (torch.int32, torch.float32):
        ms = device_ms(lambda: pk.probe_packed_dot(packed, wb, out_dtype), reps=30)
        plain_ms = device_ms(lambda: plain.packed_dot(packed, wb, out_dtype))
        lib_ms, lib_name = int_mm(lib_a8, w8t, f32=out_dtype == torch.float32)
        bnd = bound(2 * mb * kb * nb, packed.numel() * 4 + wb.numel() + mb * nb * 4,
                    INT8_OPS_PER_S)
        label = "P5" if out_dtype == torch.int32 else "P6 (f32 output)"
        report(f"{label} probe_packed_dot (device time)", ms, bnd, plain_ms, lib_ms,
               f"{lib_name}, words viewed int8 (1024, 512) x w8")
        if out_dtype == torch.int32:
            entry("probe_packed_dot", "P5: words (1024, 128) int32 x wb (4, 128, 128) -> int32",
                  ms, plain_ms, bnd, lib_ms)

    # registers and shared memory per block, as CUPTI reports them
    x_i8, w_i8 = p1["v2_int8_concat3"]
    x_bf, w_bf = p1["v1_bf16_concat3"]
    a_p2, b_p2 = p2["pallas_mm_int8"]
    a_bf, b_bf = p2["pallas_mm_bf16"]
    attrs = launch_attrs(torch, {
        "probe_gemm int8 128x256 tiles (P2)": lambda: pk.probe_gemm(a_p2, b_p2),
        "probe_gemm bf16 128x256 tiles (P2)": lambda: pk.probe_gemm(a_bf, b_bf, torch.float32),
        "probe_gemm int8 64x64 tiles (P3 dot)": lambda: pk.probe_gemm(a8_r3a, w_ok),
        "probe_gemm bf16 64x64 tiles (P1 mm step)": lambda: pk.probe_gemm.write_back(
            x_bf.reshape(-1, 9 * c), w_bf.reshape(9 * c, c), 9),
        "probe_conv_run int8, 50 steps": lambda: pk.probe_conv_run(
            x_i8, w_i8.reshape(9 * c, c), conv.ITERS),
        "probe_conv_run bf16, 50 steps": lambda: pk.probe_conv_run(
            x_bf, w_bf.reshape(9 * c, c), conv.ITERS),
        "probe_unpack_words": lambda: pk.probe_unpack_words(words, 1),
        "probe_packed_dot": lambda: pk.probe_packed_dot(packed, wb)}, pattern="probe_")
    for key, (regs, smem) in attrs.items():
        print(f"[7] CUPTI {key}: {regs if regs is not None else 'not measured'} registers "
              f"per thread, {smem if smem is not None else 'not measured'} B shared memory "
              f"per block", flush=True)
    return entries


def same_artifact(a, b):
    """Field-for-field equality of two QuantParams."""
    for f in dataclasses.fields(a):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if f.name in ("w_int", "bias_f", "bias_int"):
            if len(va) != len(vb) or not all(np.array_equal(x, y) for x, y in zip(va, vb)):
                return False
        elif va != vb:
            return False
    return True


def stamps(qp):
    return (qp.fast_cert_ok, qp.fast_cert_images, qp.fast_cert_layers, qp.fast_cert_static,
            qp.shortcut_static, qp.cert_grade, qp.cert_stamps)


def toolchain_phase(torch, dev, card):
    """Phase 8, the artifact toolchain from float weights: eval-float,
    calibrate and certify, and infer --audit, each on the card against the
    port's CPU run. TF32 is left on (PyTorch's default) around the phase:
    the float paths must turn it off for their own convs. Returns, per
    network kernel and path, (launches, frames served)."""
    import tempfile
    import warnings

    from sesr_tpu_torch.cli import evaluate_float, serve
    from sesr_tpu_torch.config import spec_for_task
    from sesr_tpu_torch.data import SyntheticDataset
    from sesr_tpu_torch.io.torch_import import load_reference_checkpoint
    from sesr_tpu_torch.ops.corrected import split_layers
    from sesr_tpu_torch.ops.kernels import corrected_net, fast_net, reset_launch_counts
    from sesr_tpu_torch.quant.calibrate import (ObserverRegressionWarning, calibrate,
                                                guarded_calibrate)
    from sesr_tpu_torch.quant.certify import adversarial_image, certify_fast
    from sesr_tpu_torch.quant.integer import integer_forward
    from sesr_tpu_torch.quant.params import QuantParams
    from sesr_tpu_torch.quant.strict import strict_integer_forward

    torch.backends.cudnn.allow_tf32 = True
    tag = f"({card})"

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def tf32_left_on(what):
        if not torch.backends.cudnn.allow_tf32:
            fail(f"{what} left the caller's TF32 setting changed")

    def frames_of(task, hw, n=4):
        data = list(SyntheticDataset(task, n=n, hw=hw))
        return data, [d[0] for d in data]

    with tempfile.TemporaryDirectory() as tmp:
        params = {}
        for task in ("sr_x2", "nr"):
            with np.load(os.path.join(REPO, "tests", "goldens", f"{task}.npz")) as g:
                L = int(g["num_convs"])
                path = os.path.join(tmp, f"{task}_collapsed.npz")
                np.savez(path, **{f"w_{i}": np.transpose(g[f"w_collapsed_{i}"], (2, 3, 1, 0))
                                  for i in range(L)},
                         **{f"b_{i}": g[f"b_collapsed_{i}"] for i in range(L)})
            params[task] = load_reference_checkpoint(task, path=path)

    # 8a. eval-float: sr_x2 on four 540x960 -> 1080x1920 frames
    sr_spec, nr_spec = spec_for_task("sr_x2"), spec_for_task("nr")
    sr_data, sr_x = frames_of("sr_x2", (2 * FRAME[0], 2 * FRAME[1]))
    ev_gpu, t_gpu = timed(lambda: evaluate_float(sr_spec, params["sr_x2"], sr_data, "cuda",
                                                 keep_outputs=True))
    tf32_left_on("evaluate_float")
    ev_cpu, t_cpu = timed(lambda: evaluate_float(sr_spec, params["sr_x2"], sr_data, "cpu",
                                                 keep_outputs=True))
    diff = max(float(np.abs(a - b).max()) for a, b in zip(ev_gpu.outputs, ev_cpu.outputs))
    dpsnr = max(abs(a - b) for a, b in zip(ev_gpu.psnr, ev_cpu.psnr))
    print(f"[8] eval-float sr_x2, 4 frames {sr_x[0].shape[1:3]} -> {ev_gpu.outputs[0].shape}: "
          f"mean psnr cuda {ev_gpu.mean_psnr:.4f} cpu {ev_cpu.mean_psnr:.4f} (largest per-frame "
          f"difference {dpsnr:.2e} dB), max abs output difference {diff:.3e}; {t_gpu:.3f} s "
          f"cuda, {t_cpu:.3f} s cpu {tag}", flush=True)
    if not (diff <= 1e-4 and dpsnr <= 0.01):
        fail(f"eval-float cuda vs cpu: max abs {diff} (bound 1e-4), psnr {dpsnr} dB (bound 0.01)")

    # 8b. calibrate (minmax): sr_x2 at 540x960, nr at 1080x1920; two card
    # runs and the CPU run
    nr_data, nr_x = frames_of("nr", BAYER_FRAME)
    fresh = {}
    for task, spec, images in (("sr_x2", sr_spec, sr_x), ("nr", nr_spec, nr_x)):
        q1, t1 = timed(lambda: calibrate(spec, params[task], images, device="cuda"))
        tf32_left_on("calibrate")
        q2, _ = timed(lambda: calibrate(spec, params[task], images, device="cuda"))
        qc, tc = timed(lambda: calibrate(spec, params[task], images, device="cpu"))
        rel = max(abs(a / b - 1) for a, b in zip(q1.a_scale, qc.a_scale))
        dz = max(abs(a - b) for a, b in zip(q1.a_zero, qc.a_zero))
        print(f"[8] calibrate {task} minmax, 4 frames {images[0].shape[1:3]}: {t1:.3f} s cuda, "
              f"{tc:.3f} s cpu {tag}; cuda vs cpu: scales within rel {rel:.2e}, zeros within "
              f"{dz}; two cuda runs equal: {same_artifact(q1, q2)}; zeros {q1.a_zero}", flush=True)
        if not (rel <= 3e-3 and dz <= 2):
            fail(f"calibrate {task}: cuda vs cpu scales rel {rel} (3e-3), zeros {dz} (2)")
        if not same_artifact(q1, q2):
            fail(f"calibrate {task}: two card runs wrote different artifacts")
        fresh[task] = q1
    # the KL guardrail on nr (four 272x480 frames; the CPU run scores both
    # observers' artifacts through the interpreter): the same decision
    kl_data = list(SyntheticDataset("nr", n=4, hw=KL_FRAME))
    decisions = {}
    for device in ("cuda", "cpu"):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always", ObserverRegressionWarning)
            _, t = timed(lambda: guarded_calibrate(nr_spec, params["nr"], kl_data, "nr",
                                                   observer="kl", device=device))
        msgs = [str(w.message) for w in caught if w.category is ObserverRegressionWarning]
        decisions[device] = bool(msgs)
        print(f"[8] calibrate nr --observer kl, 4 frames {KL_FRAME} on {device}: {t:.3f} s {tag}; "
              f"guardrail {'fires: ' + msgs[0][:90] if msgs else 'silent'}", flush=True)
    if decisions["cuda"] != decisions["cpu"]:
        fail(f"the KL guardrail decides differently on cuda and cpu: {decisions}")
    tf32_left_on("guarded_calibrate")

    # 8c. certify at full size on the card (launch counters at 0 around each
    # run), and on 96x128 crops on the card and the CPU
    nrdm6_spec = spec_for_task("nrdm_6")
    _, nrdm6_x = frames_of("nrdm_6", BAYER_FRAME)
    shipped = {t: QuantParams.load(os.path.join(REPO, "artifacts", f"qparams_{t}.npz"))
               for t in ("sr_x2", "nr", "nrdm_6")}
    runs = [("fresh sr_x2", sr_spec, fresh["sr_x2"], sr_x),
            ("fresh nr", nr_spec, fresh["nr"], nr_x),
            ("shipped sr_x2", sr_spec, shipped["sr_x2"], sr_x),
            ("shipped nr", nr_spec, shipped["nr"], nr_x),
            ("shipped nrdm_6", nrdm6_spec, shipped["nrdm_6"], nrdm6_x)]
    launches = {"sesr_fast_net": {}, "sesr_corrected_net": {}}
    for label, spec, qp, images in runs:
        seconds = {}
        reset_launch_counts()
        cert, t = timed(lambda: certify_fast(spec, qp, images, device="cuda", seconds=seconds))
        k2, kc = fast_net.launches, corrected_net.launches
        crops = [x[:, :96, :128] for x in images]
        small_gpu = certify_fast(spec, qp, crops, device="cuda")
        small_cpu = certify_fast(spec, qp, crops, device="cpu")
        print(f"[8] certify {label}, 4 frames {images[0].shape[1:3]}: grade {cert.cert_grade} "
              f"layers {cert.cert_stamps}; {t:.3f} s (interpreter {seconds['interpreter']:.3f}, "
              f"strict {seconds['strict']:.3f}, kernel equality {seconds['equality']:.3f}) {tag}; "
              f"launches K2 {k2}, sesr_corrected_net {kc}; at 96x128 cuda {small_gpu.cert_stamps} "
              f"cpu {small_cpu.cert_stamps}", flush=True)
        if stamps(small_gpu) != stamps(small_cpu):
            fail(f"certify {label} at 96x128: cuda {stamps(small_gpu)} != cpu {stamps(small_cpu)}")
        n = len(images)
        if spec is sr_spec:
            if not (cert.fast_cert_ok and k2 == n and kc == 0):
                fail(f"certify {label}: fully certified {cert.fast_cert_ok}, K2 launches {k2} "
                     f"and corrected {kc} for {n} images")
            launches["sesr_fast_net"][f"certify_{label.replace(' ', '_')}"] = (k2, n)
        else:
            if not (cert.cert_grade == "partial" and cert.cert_stamps.endswith("x")
                    and all(cert.fast_cert_layers[:-1]) and kc == n and k2 == 0):
                fail(f"certify {label}: {cert.cert_grade} {cert.cert_stamps}, corrected "
                     f"launches {kc} and K2 {k2} for {n} images (want hybrid, last conv x)")
            launches["sesr_corrected_net"][f"certify_{label.replace(' ', '_')}"] = (kc, n)

    # the strict interpreter alone on nr's 1080x1920 frame
    x0 = torch.from_numpy(nr_x[0]).to(dev)
    y_strict, t = timed(lambda: strict_integer_forward(nr_spec, shipped["nr"], x0))
    print(f"[8] strict_integer_forward nr {BAYER_FRAME}: {t:.3f} s {tag}", flush=True)
    del y_strict

    # 8d. infer --audit 1 on nr at 1080x1920 (launch counters at 0 around
    # each stream): four synthetic frames, then the adversarial frame and
    # one synthetic frame
    qp = shipped["nr"]
    reset_launch_counts()
    clean = serve(nr_spec, qp, nr_data, device="cuda", audit_every=1, keep_outputs=True)
    torch.cuda.synchronize()
    kc_clean = corrected_net.launches
    for (x, _), y in zip(nr_data, clean.outputs):
        want = integer_forward(nr_spec, qp, torch.from_numpy(x).to(dev), corrected=True,
                               fast_layers=tuple(qp.fast_cert_layers))[0]
        if not torch.equal(torch.from_numpy(y).to(dev), want[0]):
            fail("infer --audit 1 on nr: a served frame differs from the plain version")
    shadow = clean.audit_seconds / clean.audited
    print(f"[8] infer --audit 1 nr, 4 frames {BAYER_FRAME}: mode {clean.mode}, "
          f"{clean.audited} audited, violations {clean.violations}; sesr_corrected_net launches "
          f"{kc_clean}; forward {clean.forward_seconds / clean.n * 1e3:.3f} ms/frame, audit "
          f"shadow {shadow * 1e3:.3f} ms/frame {tag}", flush=True)
    if clean.violations or clean.mode != "hybrid" or clean.audited != 4 or kc_clean != 4:
        fail(f"infer --audit 1 on in-distribution nr frames: {clean.violations}, {clean.mode}, "
             f"{clean.audited} audited, {kc_clean} launches")
    adv = adversarial_image(qp, hw=BAYER_FRAME)
    stream = [(adv, np.zeros_like(adv)), nr_data[0]]
    reset_launch_counts()
    res = serve(nr_spec, qp, stream, device="cuda", audit_every=1, keep_outputs=True)
    torch.cuda.synchronize()
    pe_split = split_layers(qp, "pe-exact")
    kc_adv, kc_pe = corrected_net.launches, corrected_net.split_launches[pe_split]
    print(f"[8] infer --audit 1 nr, adversarial frame then a synthetic one: violations "
          f"{res.violations}, served {res.mode} from then on; "
          f"sesr_corrected_net launches {kc_adv}, of them pe-exact (split {pe_split}) {kc_pe}",
          flush=True)
    if not (res.violations == [(0, (0,))] and res.mode == "pe-exact" and kc_adv == 3
            and kc_pe == 2):
        fail(f"the adversarial stream: violations {res.violations}, mode {res.mode}, "
             f"{kc_adv} launches, {kc_pe} pe-exact")
    for (x, _), y in zip(stream, res.outputs):
        want = integer_forward(nr_spec, qp, x, corrected=True, device="cpu")[0][0]
        if not torch.equal(torch.from_numpy(y), want):
            fail("the degraded stream's output differs from the CPU interpreter's")
    print("[8] both frames of the degraded stream: torch.equal with integer_forward(corrected) "
          "on the CPU", flush=True)
    launches["sesr_corrected_net"]["infer_audit_nr"] = (kc_clean, clean.n)
    launches["sesr_corrected_net"]["infer_audit_nr_adversarial"] = (kc_adv, res.n)
    torch.backends.cudnn.allow_tf32 = False
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this run needs the card "
             "and has no CPU fallback")
    sys.path.insert(0, REPO)
    try:
        from sesr_tpu_torch.cli import main as cli_main
        from sesr_tpu_torch.cli import serve, simulate
        from sesr_tpu_torch.config import spec_for_task
        from sesr_tpu_torch.convert import kernel_constants
        from sesr_tpu_torch.data import SyntheticDataset
        from sesr_tpu_torch.ops import _build
        from sesr_tpu_torch.ops.corrected import hybrid_forward, split_layers
        from sesr_tpu_torch.ops.fast import fast_forward
        from sesr_tpu_torch.ops.kernels import (NET_KERNELS, corrected_net, fast_net,
                                                pe_exact_net, reset_launch_counts)
        from sesr_tpu_torch.ops.pe_exact import pe_exact_forward
        from sesr_tpu_torch.quant.integer import (dequantize_output,
                                                  integer_forward,
                                                  integer_forward_int8,
                                                  quantize_input)
        from sesr_tpu_torch.quant.params import QuantParams
        from sesr_tpu_torch.timing import median_ms
    except ImportError as e:
        fail(f"the port is not next to this script ({e})")

    # 1. the card
    card = card_line()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch: {name} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False       # the plain version's convs
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build every library, one nvcc per source, all started together
    t0 = time.perf_counter()
    for build in _build.build_all().values():
        print(f"[2] built {os.path.relpath(build.path, REPO)}: nvcc {build.seconds:.1f} s "
              f"\n{build.log.strip()}", flush=True)
    print(f"[2] the builds took {time.perf_counter() - t0:.1f} s", flush=True)

    spec = spec_for_task(TASK)
    qp = QuantParams.load(os.path.join(REPO, "artifacts", f"qparams_{TASK}.npz"))
    rng = np.random.default_rng(0)

    def artifact(task):
        return spec_for_task(task), QuantParams.load(
            os.path.join(REPO, "artifacts", f"qparams_{task}.npz"))

    # 3. kernels against their plain versions
    max_err = {k.symbol: 0.0 for k in NET_KERNELS}

    def check(kern, kspec, cqp, x, label, mode=None):
        """``kern`` (in the corrected kernel's ``mode``) on x against its
        plain version on the card; returns the plain dumps."""
        x_q = quantize_input(x, cqp).to(torch.int8).contiguous()
        split = split_layers(cqp, mode) if kern is corrected_net else None
        out = kern(kspec, cqp, x_q, split=split)
        torch.cuda.synchronize()
        _, dumps = integer_forward(kspec, cqp, x, collect_dumps=True,
                                   **plain_kwargs(kern, cqp, mode))
        ref = dumps[f"input.{kspec.num_convs}"].to(torch.int8)
        err = float((dequantize_output(out, cqp) - dequantize_output(ref, cqp)).abs().max())
        max_err[kern.symbol] = max(max_err[kern.symbol], err)
        equal = torch.equal(out, ref)
        how = f" {mode}, split {[i for i, f in enumerate(split) if f]}" if split else ""
        print(f"[3] {kern.symbol} {kspec.name}{how} {label}: array_equal with plain (cuda) = "
              f"{equal}, max_abs_err {err}", flush=True)
        if not equal:
            fail(f"{kern.symbol} disagrees with its plain version on {kspec.name} {label}: "
                 f"{int((out != ref).sum())} values differ")
        return dumps

    def frames(shape, channels):
        return torch.from_numpy(rng.random(shape + (channels,), dtype=np.float32)).to(dev)

    # zero points off the shipped -128: a floored one (restoration and pads
    # use -128, the fused bias the raw zero), odd and positive ones
    odd_zeros = [-120, -131, -100, 5, -127, -128]
    odd = dataclasses.replace(qp, a_zero=odd_zeros)
    # convs 1 and 4 with weights at +-127: K1's 18-bit per-PE clamp fires (its
    # 20-bit clamp cannot: 4 x (2^17 - 1) < 2^19 - 1), and so does K2's 20-bit
    # one; both kernels then run those convs in their clamping form
    w_sat = list(qp.w_int)
    for i in (1, 4):
        w_sat[i] = np.where(np.asarray(w_sat[i]) >= 0, 127, -127).astype(np.asarray(w_sat[i]).dtype)
    sat = dataclasses.replace(qp, w_int=w_sat)
    ragged = (2, 37, 53)                     # no multiple of 16 or of a tile
    cases = [(pe_exact_net, (1,) + FRAME, qp), (pe_exact_net, (1, 27, 45), qp),
             (pe_exact_net, ragged, qp), (pe_exact_net, (2, 27, 45), odd),
             (pe_exact_net, (1, 27, 45), sat), (fast_net, (1,) + FRAME, qp),
             (fast_net, (1, 27, 45), qp), (fast_net, ragged, qp),
             (fast_net, (2, 27, 45), odd), (fast_net, (1, 27, 45), sat),
             (fast_net, (4,) + FRAME, qp)]
    for kern, shape, cqp in cases:
        label = f"{shape}{' odd zeros' if cqp is odd else ' saturating' if cqp is sat else ''}"
        xt = frames(shape, spec.in_channels)
        dumps = check(kern, spec, cqp, xt, label)
        if cqp is sat:
            add_hi = 2 ** (qp.hw.pe_add_bits - 1) - 1
            at_20 = int(((dumps["pe_add.1"] == add_hi) | (dumps["pe_add.1"] == -add_hi - 1)).sum())
            ovf18, ovf20 = dumps["overflow_18"].tolist(), dumps["overflow_20"].tolist()
            print(f"[3]     plain dumps: overflow_18 {ovf18}, overflow_20 {ovf20}, "
                  f"layer-1 sums at the 20-bit clamp {at_20}", flush=True)
            if kern is pe_exact_net and not ovf18[1] > 0:
                fail("the saturating case did not fire K1's 18-bit clamp")
            if kern is fast_net and not at_20 > 0:
                fail("the saturating case did not fire K2's 20-bit clamp")
        if shape == (1, 27, 45) and cqp is qp:
            # the whole wrapper on the card against the plain version on the CPU
            x = xt.cpu().numpy()
            if kern is pe_exact_net:
                got = pe_exact_forward(spec, qp, xt).cpu()
                want = integer_forward(spec, qp, x, device="cpu")[0]
            else:
                got = fast_forward(spec, qp, xt, out_dtype="int8").cpu()
                want = integer_forward_int8(spec, qp, x, corrected=True,
                                            compute="fast", device="cpu")
            if not torch.equal(got, want):
                fail(f"{kern.symbol} wrapper on cuda != plain version on cpu at {shape}")
            print(f"[3] {kern.symbol} wrapper (cuda) == plain (cpu) at {shape}", flush=True)

    # the corrected kernel: nr and nrdm_6 in their hybrid mode (the last
    # conv per PE), every artifact in the PE-exact mode (stamps removed: the
    # split layers are those its proof cannot clear), odd zero points,
    # ragged shapes, batch 2, and a saturating nr whose plain dumps show the
    # 18-bit clamp firing on a split conv and the 20-bit clamp on a one-pass
    # conv
    nr_spec, nr_qp = artifact("nr")
    for task in ("nr", "nrdm_6"):
        tspec, tqp = artifact(task)
        for shape in ((2, 27, 45), (1, 37, 53)):
            check(corrected_net, tspec, tqp, frames(shape, 3), str(shape), "hybrid")
    for task in ("nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2"):
        tspec, tqp = artifact(task)
        unstamped = dataclasses.replace(tqp, fast_cert_layers=None, fast_cert_ok=False)
        check(corrected_net, tspec, unstamped, frames((2, 27, 45), tspec.in_channels),
              "(2, 27, 45) stamps removed", "pe-exact")
    nr_odd = dataclasses.replace(nr_qp, a_zero=odd_zeros)
    for mode in ("hybrid", "pe-exact"):
        check(corrected_net, nr_spec, nr_odd, frames(ragged, 3), f"{ragged} odd zeros", mode)
    nr_sat = dataclasses.replace(nr_qp, w_int=[
        np.full_like(np.asarray(w), 127) if i in (0, nr_spec.num_convs - 1) else np.asarray(w)
        for i, w in enumerate(nr_qp.w_int)])
    last = nr_spec.num_convs - 1
    for mode in ("hybrid", "pe-exact"):
        dumps = check(corrected_net, nr_spec, nr_sat, frames((1, 27, 45), 3),
                      "(1, 27, 45) saturating: convs 0 and 4 at +127", mode)
        kc = kernel_constants(nr_spec, nr_sat, "corrected", split_layers(nr_sat, mode))
        add_hi = 2 ** (nr_qp.hw.pe_add_bits - 1) - 1
        at_20 = int(((dumps["pe_add.0"] == add_hi) | (dumps["pe_add.0"] == -add_hi - 1)).sum())
        ovf18 = dumps["overflow_18"].tolist()
        print(f"[3]     plain dumps: overflow_18 {ovf18}; conv-0 sums at the 20-bit clamp "
              f"{at_20}; split {kc.pe_split}, 20-bit clamp {kc.clamp20}", flush=True)
        if mode == "hybrid" and not (kc.clamp20[0] and kc.pe_split[last] and at_20 > 0
                                     and ovf18[last] > 0):
            fail("the saturating hybrid case did not fire the 20-bit clamp on one-pass conv 0 "
                 "and the 18-bit clamp on split conv 4")
        if mode == "pe-exact" and not (kc.pe_split[0] and ovf18[0] > 0):
            fail("the saturating pe-exact case did not fire the 18-bit clamp on split conv 0")
    # the edges of the wide rows: a frame 1 column wide (narrower than a
    # tile's halo), 7, one short of and one past 64, 1921 (30 tiles and a
    # ragged one), a frame smaller than one tile, and a batch of 3 whose
    # last tile is ragged; nr in both modes, nrdm_6 hybrid
    nr_pe = dataclasses.replace(nr_qp, fast_cert_layers=None)
    nrdm6_spec, nrdm6_qp = artifact("nrdm_6")
    for shape in CORRECTED_EDGES:
        xt = frames(shape, 3)
        check(corrected_net, nr_spec, nr_qp, xt, f"{shape} edge", "hybrid")
        check(corrected_net, nr_spec, nr_pe, xt, f"{shape} edge", "pe-exact")
        check(corrected_net, nrdm6_spec, nrdm6_qp, xt, f"{shape} edge", "hybrid")
    xt = frames((1, 27, 45), 3)
    x = xt.cpu().numpy()
    for out_dtype in ("int8", "f32"):
        got = hybrid_forward(nr_spec, nr_qp, xt, out_dtype=out_dtype).cpu()
        want = hybrid_forward(nr_spec, nr_qp, x, out_dtype=out_dtype, device="cpu")
        if not torch.equal(got, want):
            fail(f"sesr_corrected_net wrapper on cuda != plain version on cpu ({out_dtype})")
    print("[3] sesr_corrected_net wrapper (cuda) == plain (cpu) on nr (1, 27, 45), int8 and "
          "f32", flush=True)

    # the other instantiations (1 input channel, 3 or 16 output channels,
    # 8 convs) and forms (dm, nrdm_6 and nr: K1 per PE on conv 0 or the last;
    # dm: K2's 20-bit clamp on its last conv) on the other shipped artifacts
    for task in ("sr_x4", "nrdm_3", "nrdm_6", "dm", "nr"):
        tspec, tqp = artifact(task)
        x = frames((2, 27, 45), tspec.in_channels)
        for kern in NET_KERNELS:
            if kern is fast_net and not tqp.fast_cert_ok:
                continue
            check(kern, tspec, tqp, x, "(2, 27, 45)",
                  "hybrid" if kern is corrected_net else None)
    # infer on every task through the command a user runs: the same mode
    # and scores on the card as on the CPU
    for task in ("nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2"):
        args = ["infer", "--task", task, "--qparams",
                os.path.join(REPO, "artifacts", f"qparams_{task}.npz"), "--n-images", "2"]
        r_gpu = cli_main(args)
        r_cpu = cli_main(args + ["--device", "cpu"])
        if (r_gpu.mode, r_gpu.psnr, r_gpu.ssim) != (r_cpu.mode, r_cpu.psnr, r_cpu.ssim):
            fail(f"infer --task {task}: cuda {r_gpu.mode} {r_gpu.psnr} != cpu {r_cpu.mode} "
                 f"{r_cpu.psnr}")
    print("[3] infer --n-images 2 on every task: the same mode and scores on cuda as on cpu",
          flush=True)
    net_sass_check(_build)

    # 4. the main path, with the launch counters at 0: sr_x2 (infer through
    # K2, sim through K1)
    reset_launch_counts()
    sr_frames = SyntheticDataset(TASK, n=4, hw=(2 * FRAME[0], 2 * FRAME[1]))
    r1 = serve(spec, qp, sr_frames, batch=1, device="cuda")
    k2_b1 = fast_net.launches
    r4 = serve(spec, qp, sr_frames, batch=4, device="cuda")
    k2_b4 = fast_net.launches - k2_b1
    sim = simulate(spec, qp, sr_frames[0][0], device="cuda")
    torch.cuda.synchronize()
    launches = {k.symbol: k.launches for k in NET_KERNELS}
    sim_frames = int(sim.y.shape[0])
    per_frame = {"sesr_pe_exact_net": {"sim": launches["sesr_pe_exact_net"] / sim_frames},
                 "sesr_fast_net": {"infer_batch1": k2_b1 / r1.n, "infer_batch4": k2_b4 / r4.n}}
    print(f"[4] infer {r1.mode} batch 1: {r1.n} frames, mean psnr {r1.mean_psnr:.4f} "
          f"ssim {r1.mean_ssim:.4f}, outputs {r1.out_shapes[0]}, forward "
          f"{r1.forward_seconds / r1.n * 1e3:.3f} ms/frame; K2 launches {k2_b1}", flush=True)
    print(f"[4] infer {r4.mode} batch 4: {r4.n} frames, mean psnr {r4.mean_psnr:.4f} "
          f"ssim {r4.mean_ssim:.4f}, outputs {r4.out_shapes[0]}, forward "
          f"{r4.forward_seconds / r4.n * 1e3:.3f} ms/frame; K2 launches {k2_b4}", flush=True)
    print(f"[4] sim: output {tuple(sim.y.shape)} from {sim.source}; "
          f"launches over the sr_x2 path {launches}; per frame {per_frame}", flush=True)
    if r1.mode != "fast":
        fail(f"sr_x2 should serve the certified fast mode, got {r1.mode}")
    if k2_b1 < 1 or k2_b4 < 1 or launches["sesr_pe_exact_net"] < 1:
        fail(f"the sr_x2 path did not go through both of its kernels: {launches}")
    out_hw = (2 * FRAME[0], 2 * FRAME[1], 3)
    if r1.out_shapes != [(1,) + out_hw] * 4 or r4.out_shapes != [(4,) + out_hw]:
        fail(f"unexpected output shapes {r1.out_shapes} {r4.out_shapes}")
    if not (r1.finite and r4.finite and bool(torch.isfinite(sim.y).all())):
        fail("non-finite output")
    if r1.psnr != r4.psnr:
        fail(f"batch 4 scores {r4.psnr} differ from batch 1 {r1.psnr}")
    if not r1.mean_psnr > 20.0:
        fail(f"implausible sr_x2 psnr {r1.mean_psnr}")

    # the Bayer path, with the launch counters at 0 again: nr and nrdm_6
    # served (hybrid, sesr_corrected_net) on 1080x1920 Bayer-sparse frames
    # (the sr_x2 output frame of the same camera pipeline) at batch 1 and 4,
    # nr simulated (sim through K1, sim --corrected through the corrected
    # kernel)
    reset_launch_counts()
    bayer = {}
    for task in ("nr", "nrdm_6"):
        tspec, tqp = artifact(task)
        data = list(SyntheticDataset(task, n=4, hw=BAYER_FRAME))
        c0 = corrected_net.launches
        b1 = serve(tspec, tqp, data, batch=1, device="cuda")
        c1 = corrected_net.launches - c0
        b4 = serve(tspec, tqp, data, batch=4, device="cuda")
        c4 = corrected_net.launches - c0 - c1
        bayer[task] = (tspec, tqp, data, b1, b4, c1, c4)
    nr_frame = bayer["nr"][2][0][0]
    nr_sim = simulate(nr_spec, nr_qp, nr_frame, device="cuda")
    nr_sim_c = simulate(nr_spec, nr_qp, nr_frame, device="cuda", corrected=True)
    torch.cuda.synchronize()
    bayer_launches = {k.symbol: k.launches for k in NET_KERNELS}
    print(f"[4] launches over the Bayer path: {bayer_launches}", flush=True)
    for task, (tspec, tqp, data, b1, b4, c1, c4) in bayer.items():
        per_frame.setdefault("sesr_corrected_net", {}).update(
            {f"{task}_infer_batch1": c1 / b1.n, f"{task}_infer_batch4": c4 / b4.n})
        for b, n_launch, batch in ((b1, c1, 1), (b4, c4, 4)):
            print(f"[4] infer {task} {b.mode} batch {batch}: {b.n} frames, mean psnr "
                  f"{b.mean_psnr:.4f} ssim {b.mean_ssim:.4f}, outputs {b.out_shapes[0]}, "
                  f"forward {b.forward_seconds / b.n * 1e3:.3f} ms/frame; sesr_corrected_net "
                  f"launches {n_launch}", flush=True)
        if b1.mode != "hybrid" or b4.mode != "hybrid":
            fail(f"{task} should serve the hybrid mode, got {b1.mode}")
        if c1 != 4 or c4 != 1:
            fail(f"{task}: {c1} / {c4} sesr_corrected_net launches for 4 dispatches at batch 1 "
                 f"and 1 at batch 4")
        if b1.out_shapes != [(1,) + BAYER_FRAME + (3,)] * 4 or \
                b4.out_shapes != [(4,) + BAYER_FRAME + (3,)]:
            fail(f"{task}: unexpected output shapes {b1.out_shapes} {b4.out_shapes}")
        # (the synthetic Bayer sets score 17-18 dB, on the CPU and in JAX alike)
        if not (b1.finite and b4.finite) or b1.psnr != b4.psnr or not b1.mean_psnr > 10.0:
            fail(f"{task}: batch 1 {b1.psnr} / batch 4 {b4.psnr} scores (finite "
                 f"{b1.finite} {b4.finite})")
    print(f"[4] sim nr: {tuple(nr_sim.y.shape)} from {nr_sim.source}; sim --corrected nr: "
          f"{tuple(nr_sim_c.y.shape)} from {nr_sim_c.source}", flush=True)
    if bayer_launches["sesr_corrected_net"] < 9 or bayer_launches["sesr_pe_exact_net"] < 1:
        fail(f"the Bayer path did not go through its kernels: {bayer_launches}")
    if not (bool(torch.isfinite(nr_sim.y).all()) and bool(torch.isfinite(nr_sim_c.y).all())):
        fail("non-finite nr simulation")
    # the served frames against the plain version (these launches are not
    # counted): batch 1 and 4, int8 outputs equal
    for task, (tspec, tqp, data, *_) in bayer.items():
        x4 = torch.from_numpy(np.concatenate([d[0] for d in data])).to(dev)
        for xb in (x4[:1], x4):
            got = hybrid_forward(tspec, tqp, xb, out_dtype="int8")
            want = integer_forward_int8(tspec, tqp, xb, corrected=True, compute="exact",
                                        fast_layers=tuple(tqp.fast_cert_layers))
            if not torch.equal(got, want):
                fail(f"{task} at {tuple(xb.shape)}: sesr_corrected_net != plain")
            del got, want
        print(f"[4] {task} served frames {tuple(x4.shape)}, batch 1 and 4: array_equal "
              f"with plain (cuda)", flush=True)
    want = integer_forward(nr_spec, nr_qp, torch.from_numpy(nr_frame).to(dev), corrected=True)[0]
    if not torch.equal(nr_sim_c.y, want):
        fail("sim --corrected on nr != the plain corrected interpreter")
    want = integer_forward(nr_spec, nr_qp, torch.from_numpy(nr_frame).to(dev))[0]
    if not torch.equal(nr_sim.y, want):
        fail("sim on nr != the plain reference interpreter")
    del want
    print("[4] sim nr and sim --corrected nr at 1080x1920: array_equal with plain (cuda)",
          flush=True)

    # 5. timing: K1 and K2 at sr_x2 540x960, the corrected kernel on nr's
    # and nrdm_6's 1080x1920 frame in their hybrid mode; batch 1
    entries = []
    x = frames((1,) + FRAME, spec.in_channels)
    x_q = quantize_input(x, qp).to(torch.int8).contiguous()
    xb = torch.from_numpy(bayer["nr"][2][0][0]).to(dev)
    timed = {"sesr_pe_exact_net": (spec, qp, x, None), "sesr_fast_net": (spec, qp, x, None),
             "sesr_corrected_net": (nr_spec, nr_qp, xb, "hybrid")}
    total = {k: launches[k] + bayer_launches[k] for k in launches}
    for kern in NET_KERNELS:
        kspec, kqp, kx, mode = timed[kern.symbol]
        ms, plain_ms, bnd = time_kernel(torch, dev, kern, kspec, kqp, kx, mode, sweep=True)
        entries.append(dict(
            name=kern.symbol, route="cuda", source=SOURCES[kern.symbol],
            replaces=REPLACES[kern.symbol], launches=total[kern.symbol],
            launches_per_frame=per_frame[kern.symbol], max_abs_err=max_err[kern.symbol],
            ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
            work=f"{kspec.name}, {tuple(kx.shape[1:3])} frame, batch 1"
                 f"{f', {mode} mode' if mode else ''}"))
    # the corrected kernel's other network (nrdm_6: 8 convs, the 24x32
    # tile) and its PE-exact mode on nr
    nrdm6_spec, nrdm6_qp = bayer["nrdm_6"][:2]
    time_kernel(torch, dev, corrected_net, nrdm6_spec, nrdm6_qp, xb, "hybrid", sweep=True)
    time_kernel(torch, dev, corrected_net, nr_spec,
                dataclasses.replace(nr_qp, fast_cert_layers=None), xb, "pe-exact", sweep=False)
    fwd_ms = median_ms(lambda: fast_forward(spec, qp, x), dev, 20, warmup=3)
    print(f"[5] fast_forward end to end (quantize, K2, dequantize, shuffle): "
          f"{fwd_ms:.4f} ms/frame", flush=True)
    fwd_ms = median_ms(lambda: hybrid_forward(nr_spec, nr_qp, xb), dev, 20, warmup=3)
    print(f"[5] hybrid_forward on nr 1080x1920 end to end (quantize, sesr_corrected_net, "
          f"dequantize): {fwd_ms:.4f} ms/frame", flush=True)

    # 6. where a served frame's time goes
    for task, tspec, tqp, fwd, frame in (
            (TASK, spec, qp, fast_forward, FRAME),
            ("nr", nr_spec, nr_qp, hybrid_forward, BAYER_FRAME)):
        for batch in (1, 4):
            x_np = rng.random((batch,) + frame + (tspec.in_channels,), dtype=np.float32)
            x = torch.from_numpy(x_np).to(dev)
            windows = {"forward": lambda: fwd(tspec, tqp, x),
                       "round trip": lambda: fwd(
                           tspec, tqp, torch.from_numpy(x_np).to(dev)).cpu().numpy()}
            for window, fn in windows.items():
                wall, busy, per = breakdown(torch, fn, batch)
                idle = f"{1.0 - busy / wall}" if busy else "not measured (no device events)"
                print(f"[6] {task} {window}, batch {batch}: wall {wall} ms/frame, device busy "
                      f"{busy} ms/frame, idle share {idle}", flush=True)
                for k, t in per.items():
                    print(f"[6]     {t:.4f} ms  {k}", flush=True)

    # 7. the probes
    entries += probes_phase(torch, dev)

    # 8. the artifact toolchain: its launches join the network kernels'
    t0 = time.perf_counter()
    toolchain_launches = toolchain_phase(torch, dev, card)
    print(f"[8] the toolchain phase took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    for e in entries:
        for path, (count, n_frames) in toolchain_launches.get(e["name"], {}).items():
            e["launches"] += count
            e["launches_per_frame"][path] = count / n_frames

    print(card_line(), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    main()
