#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (sesr_tpu_torch): sr_x2, nr
and nrdm_6 served and simulated, every task's infer, the probes, the
artifact toolchain (eval-float, calibrate, certify, infer --audit),
training, QAT, AdaRound and make_qparams, the RTL vector export, hist and
the experimental models, sharded execution, the HardwareConfig family,
the benchmark and cost analysis (``bench``, ``profile``), and the SESR
family's deep, wide, RGB, two-conv and other-conv-size networks.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and the repository around this file; fails
(non-zero exit, no "ok" line) without them. Phases:

1. the card: nvidia-smi's name and power limit, torch's device name;
2. build every kernel library from csrc/ (one nvcc per source, all started
   together; beside them the float parts of phases 8 and 9 (no kernel),
   then phases 10, 3, the rest of 9 and 4, then the checks and main paths
   of phases 8, 12 and 15 (8, 9, 12 and 15 are generators that yield
   between their parts), all waited for before phase 5, the libraries
   those phases use at full priority and the others at the lowest; phase
   7 and every time in the kernels line after them), with the -Xptxas -v
   report;
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
   tile, a batch whose last tile is ragged) in both modes, and its counting
   form (sesr_corrected_audit, the runtime audit) on the same edges with
   nr's adversarial frame first in each batch, its counts array_equal with
   the plain interpreter's overflow_18 and two W blocks as count regions
   adding up to the whole frame's; every kernel on
   the sr_x4, nrdm_3, nrdm_6, dm and nr artifacts at 27x45; each wrapper on
   the card against the plain version on the CPU; ``infer --n-images 2`` on
   every task, cuda against cpu; and the SASS of the network libraries
   (cuobjdump): the corrected kernel and its counting form on IGMMA with
   no IMMA, K1 and K2 on IMMA;
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
   launch; P3 whole (probe_bitcast_dot: the roll, bitcast and dot in one
   launch, one per bitcast_dot call) on its edges at six rolls and at the
   sized shape (words (4096, 4096) x w (4096, 1024)), P4's unpack
   (probe_unpack_words) at (8, 128), (256, 128) and (4096, 4096) at rolls
   0, 1 and 5 and on its edges, all torch.equal; the SASS of each probe
   kernel (cuobjdump: probe_gemm, probe_packed_dot, probe_bitcast_dot and
   probe_conv_run on HGMMA / IGMMA with UTMALDG and no HMMA / IMMA) and
   ptxas's registers; and each kernel's device time (CUDA events, the
   device kept busy while the host enqueues) beside its plain version's,
   its library call's (torch._int_mm timed with B row-major and
   column-major, the faster reported; for bf16 torch.mm with a float32
   output, torch.matmul's bf16 output beside it; F.pad + F.conv2d for a
   bf16 conv step; for P3 torch.roll + the unpacked view's copy +
   torch._int_mm, for P4 the same without the product) and its bound,
   P3 and P4 at the probes' shapes beside a launch floor (a one-element
   fill_) and sized; a conv step's time is the K-difference (T(50) -
   T(1)) / 49 of 50- and 1-step probe calls; registers and shared memory
   from CUPTI;
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
   the CPU interpreter's); each audit one launch of the counting form
   (quant/audit.py's plain interpreter fails on a CUDA tensor while the
   streams run; 4 + 1 counting launches beside 4 + 3 served), its counts
   and sound output held against the plain interpreter's on the card; the
   audit's device ms per frame beside the served PE-exact kernel's and its
   shadow ms per frame as the host issues it;
9. (beside the builds, after 3) training and make_qparams, with TF32 on
   around them: the STE
   round and fake-quant on the card against the CPU (values and
   gradients torch.equal, clip ties at 0.5); float training of the
   expanded sr_x4 through ``train`` (the first step's loss and gradients
   within rel 1e-4 of the CPU's, the loss falling, two card runs and a
   run saved and resumed torch.equal, steps per second); the QAT recipe
   from those weights (fine-tune, fake-quant-delta collapse, percentile
   calibration, certify through the kernel the certificate selects, one
   launch a frame) and ``infer`` of the result on four 270x480 frames;
   ``make_qparams`` on sr_x4 (AdaRound, 800 steps a layer, percentile:
   fully certified, K2) and nr (nearest, minmax: partial, the corrected
   kernel) from the golden bundles' float weights, per layer the
   seconds, the share moved and the calibration error, both artifacts
   served with every output equal to the plain version; ``calibrate
   --weight-rounding adaround`` on sr_x4 (every weight within a
   neighbour of nearest); one layer of AdaRound at 120 steps on the card
   against the CPU (at most 1 % of its weights differ); where the time
   of a float, a QAT and an AdaRound step goes (torch.profiler: wall,
   device busy, idle share, device events a step). Each time is printed
   with the card's name and power limit;
10. the RTL vector export, ``hist`` and the experimental models: the
   fixture of each of the ten golden bundles exported on the card in its
   residual mode (the plain interpreter's dumps), every reference-generated
   text file byte-equal (sr_x2_qat: the golden prefix, then ``1f``); the
   six shipped artifacts exported through ``export_vectors`` (behind
   ``export``) at 80x960, the reference fixture's size (the fixture itself
   when SESR_REFERENCE_ROOT holds it, else a seeded uniform frame): K1's
   output equal to the interpreter's, the card's dumps array_equal with
   the CPU's, nrdm_6's whole tree sha256-equal cuda vs cpu, and per task
   the interpreter's time with dumps (CUDA events and torch.profiler's
   device busy), K1's device time, the host formatting's seconds and MB/s;
   ``export`` from the command line on nr; ``hist`` from the sr_x2 and nr
   golden float weights on four full-size frames on the card, and at
   272x480 on the card against the CPU (weight histograms equal, counts
   equal, activation histograms within 1 % of each domain's count in L1,
   the input domain's equal; each PNG decodes); the experimental forwards
   (inception, one inception path, split, anchor; sr_x4 base, 64x64 in) on
   the card within 1e-5 of the CPU. K1's export launches join its entry;
11. sharded execution (``sesr_tpu_torch/parallel``): on NCCL at world size
   1 (a FileStore; NCCL takes one rank per device) the sharded integer
   forwards (1D, 2D, multihost, tail) array_equal with integer_forward, the
   float forwards within rtol / atol 1e-5 of forward_float, sharded_calibrate
   within rel 3e-3 / 2 zero steps of the CPU's calibrate, every sharded
   deployment forward (1D, 2D, pinned, multihost, forced pe-exact, tail;
   f32 and int8) array_equal with the monolithic one in one launch, a CUDA
   tensor on a gloo group refused, and stream_frames on five nr frames with
   the adversarial frame third, audited every batch (hybrid until it, then
   pe-exact: 3 + 3 launches; three counting launches, each over the rank's
   window with its block as the count region, the plain interpreter barred
   on the card, each audit equal to the plain sharded audit); then every
   rank's window of sp = 4 and 2 x 2
   grids in turn on the card (virtual ranks: nr and nrdm_6 hybrid and nr
   pe-exact at 1080x1920, sr_x2 through K2 at 540x960, f32 and int8) and
   slabs (nr and nrdm_6 at 1080x1920 in pick_slab_h's four, sr_x2 at
   540x960 in four of 136 rows), each array_equal with the monolithic
   kernel, one launch a window or slab, each window's and slab's device
   time against the monolithic frame's; and the sharded QAT step with the
   percentile observer, its observers' state torch.equal with the
   unsharded step's;
12. the HardwareConfig family (tests/test_hwconfig_sweep.py's four
   configs, copied here): the sr_x2 and nr golden float weights and the
   sweep's sparse 8-channel net calibrated, certified, saved and reloaded
   on the card at each config and at the reference point; with the
   counters at 0 before and read after, each served at a 540x960 output
   (``CUT_SIZE``) at batch 1 and 4 in the mode its certificate selects, simulated (K1)
   and simulated --corrected; every output array_equal with the plain
   interpreter, slabs and 2 x 2 virtual ranks equal to the served frame,
   ``infer --qparams`` cuda against cpu; the corrected kernel with every
   layer split and a saturating nr through K1 and the corrected kernel
   (the accumulator clamp firing, and at 8 PEs the adder clamp), K2's
   general instantiation where sr_x2's conv 0 can reach the adder clamp,
   its activations are not int8 or its sums may pass 2^22; nr's ``infer
   --audit 1`` and one counting launch; then each kernel's device time per
   frame at each config, its registers (ptxas; CUPTI for the new configs,
   in phase 14's process) and its ratio to the same kernel on the same
   network at 4 PEs. One ``kernels`` entry per (kernel, config), and one
   for the counting form at each new config. Since PR 18 the configs are
   eight: the sweep's four, 16 PEs, 16 PEs with a 24-bit adder (sums past
   2^22: the wide kernels), and 6- and 4-bit activations.
13. ``bench`` and ``profile`` (``sesr_tpu_torch/bench.py``, ``costs.py``):
   ``run_bench`` with the default rows, ``--per-task`` and ``--all-paths``
   at full size (fewer repeats and calls than the command), with the plain
   interpreters barred from the forwards it times; each row launched one of
   its mode's kernel per call and nothing else, and each row's output on
   its own input array_equal with the plain version on the card; then
   ``profile`` of sr_x2 at 540x960 (deployment, interpreter and float, the
   golden collapsed weights) and of nr at 1080x1920 (deployment) through
   the command: FLOPs equal to 2 x the convs' MACs and peak memory measured.
   The bench's launches stay out of the ``kernels`` line, which counts the
   main paths.
14. the SESR paper's deepest and widest members, SESR-M11 x2 (13 convs, 16
   channels) and SESR-XL x2 (13 convs, 32 channels), from seeded weights:
   each calibrated and certified on the card (both certify fast), an M11
   and an XL with two convs at +127 that the certificate leaves unstamped,
   XL calibrated at phase 12's four configs and XL at 8 PEs with 12-bit
   accumulators; with the counters at 0 before and read after each call,
   at 540x960: K2 (the mode select_forward picks) and K1 (sim) on both,
   the corrected kernel in the hybrid and PE-exact modes on the unstamped
   two, at batch 1 and 4; K1 and the corrected PE-exact mode (sim
   --corrected) on XL at each config and at 8 PEs, at batch 1; every
   output torch.equal with the plain interpreter on the card, one launch a
   call; the runtime audit's counting form on the unstamped XL at 4 and 8
   PEs (counts array_equal with the plain interpreter's overflow_18, one
   counting launch a call), its device time beside the served PE-exact
   kernel's and its ptxas and CUPTI lines; M11 and XL at 16 PEs and the
   wide M11 (``family_phase``); then each kernel's device time
   at its default tile (K1 and K2 also
   at every tile of ops/kernels.py NET_TILES that fits a block), its bound
   and share, MACs computed over MACs needed, registers and shared memory
   (ptxas, the wrapper's plan and the library's, and CUPTI, read at the
   default tile in a process of its own, ``chip_smoke.py --cupti``, whose
   shared memory must be the plan's; the process of phases 12 and 15-17's
   jobs runs beside this phase's main path and ends before its first
   time is taken). One ``kernels`` entry per (kernel,
   network, mode, config), with its own launches; the counting form has an
   entry of its own for nr (phases 8 and 11) and for XL at 4 and 8 PEs.
15. last convs of 1 to 48 output channels (``out_channels_phase``): the
   SESR paper's Y-channel x2, RGB x3 and x4 networks through every kernel
   at 4 PEs and 16, plain and with the last conv at +127, every output
   540x960 (``CUT_SIZE``; K1 takes SESR-XL x4 RGB at 16 PEs as one layer group, its
   split last conv staged a PE pass at a time), then a sweep of every
   padded and past-16 instantiation on a small batch;
16. networks deeper than one launch runs (``deep_phase``): sesr_m16_x2 (18
   convs) and sesr_xl22_x2 (24) from seeded weights, calibrated and
   certified on the card at 4 PEs, 16 and a sweep config and saturated at
   +127 in each group, through K1, K2, both corrected modes and the
   counting form at 270x480 as chains of layer groups (one launch a group,
   every output and count equal to the plain interpreter), ``infer --audit
   1``, two virtual ranks, then every layer-group instantiation launched
   on a small batch by 33-conv networks (three groups or more: first,
   middle and last; the corrected kernel's tail instantiations by the last
   group past 16 outputs) and two-conv networks (one group) with its
   boundary tensors held to the plain interpreter's; each chain's device
   time, bound, groups' tiles and plans (the library's; CUPTI's in phase
   14's process, for every group of the main path and a middle, tail or
   two-conv group of every instantiation), MACs computed over needed
   beside one launch's, and the bytes crossing the boundaries;
17. the layer-group form's corners (``corner_phase``, phase 16's
   ``chain_phase``): sesr_m16_x4_rgb (18 convs, 48 outputs) and
   sesr_xl22_x3_rgb (24, width 32, 27 outputs), whose corrected last group
   runs the tail instantiations, and the two-conv sesr_m0_x2 and
   sesr_xl0_x4_rgb (one group, its first conv adding the shortcut), from
   seeded weights, calibrated and certified on the card at 4 PEs, 16 and
   a sweep config and saturated at +127 in the last group; every mode at
   batch 1 and 4 at every config, at the input whose output is 540x960,
   torch.equal with the plain interpreter, one launch a group; ``infer
   --audit 1``, sesr_m0_x2 at two virtual ranks; each chain's time, plans,
   MACs computed over needed and ptxas;
18. networks of other conv sizes (``ksize_phase``, ``chain_phase``):
   sesr_m5_k3_x2 (7 convs, all 3x3), sesr_m5_k717_x2 (7x7 / 1x1 / 7x7),
   sesr_xl_k5_x2 (13 convs of width 32, all 5x5) and sesr_m5_k939_x4_rgb
   (9x9 / 3x3 / 9x9, 48 outputs), each in the forms of other conv sizes
   (sesr_net_ksize.cu, sesr_corrected_ksize.cu), as phase 17 runs its
   networks; then a sweep on a small batch (``ksize_sweep``) that puts each
   of 1, 3, 5, 7 and 9 in each position at widths 16 and 32 and launches
   every instantiation of the two libraries;
19. networks of hidden width 33 to 64 (``width_phase``, ``chain_phase``):
   sesr_w64_m5_x2 (SESR-M5's 7 convs at width 64), sesr_w48_xl_x2 (SESR-XL's
   13 convs at width 48, run padded to 64), sesr_w64_m5_x4_rgb (48 outputs)
   and the two-conv sesr_w64_m0_x2, each in the width-64 instantiations of
   the forms of other conv sizes (sesr_net_w64.cu, sesr_corrected_w64.cu,
   sesr_corrected_w64_audit.cu), as phase 18 runs its networks but at the
   input whose output is 1080x1920 (out_frame); then a sweep
   on a small batch (``width_sweep``) that launches every width-64
   instantiation. Phases 15-19 run before 14, beside whose main path a
   CUPTI process reads their launches.

The line before the last is the ``kernels`` JSON; the last is
{"ok": true, "device": {...}}.
"""

import collections
import contextlib
import dataclasses
import functools
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TASK = "sr_x2"
# each library's nvcc priority (nice; LATE_NICE where not listed): the
# libraries phases 10, 3, 9 and 4 use at full priority, K1's layer-group
# one (phase 15's checks) next, the rest last; all are built before phase
# 5. (Phase 10 waits for sesr_net's build and phase 3 for sesr_corrected's
# whatever the priorities: a library's nvcc takes its own time.)
BUILD_NICE, LATE_NICE = {"sesr_net": 0, "sesr_corrected": 0, "sesr_net_group": 10}, 19
FRAME = (540, 960)                 # deployment input; 1080x1920 output
INT8_OPS_PER_S = 1979e12           # H100 SXM dense int8 tensor-core peak
BYTES_PER_S = 3.35e12              # H100 SXM HBM3
BAYER_FRAME = (1080, 1920)         # nr / nrdm_6: the sr_x2 output frame, Bayer-sparse
KL_FRAME = (272, 480)              # phase 8's KL check and phase 10's hist, cuda against cpu
SR4_FRAME = (270, 480)             # phase 9: sr_x4 served, 1080x1920 out
TRAIN_STEPS, RESUME_AT = 200, 80   # phase 9's float training runs
QAT_STEPS = 300                    # the QAT recipe's fine-tune
ADAROUND_CHECK_STEPS = 120         # one layer, card against CPU
BENCH_REPEATS, BENCH_CALLS = 2, 20  # phase 13's run_bench (the command: 5 and 50)
REPLACES = {"sesr_pe_exact_net": "sesr_tpu/ops/pallas_pipeline.py:143",
            "sesr_fast_net": "sesr_tpu/ops/pallas_packed.py:238",
            # XLA with no Pallas kernel, reached from :723 packed_exact_forward
            # (corrected) and :749 packed_hybrid_forward
            "sesr_corrected_net": "sesr_tpu/ops/packed.py:562"}
# the counting form of the corrected kernel (sesr_corrected_audit): the
# runtime audit's shadow run, which the JAX package runs as the jitted
# integer_forward(corrected=True, collect_dumps=True) (XLA, no Pallas kernel)
AUDIT_REPLACES = "sesr_tpu/quant/integer.py:233 (from sesr_tpu/quant/audit.py:96)"
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
                  "tools/bench_probe_pallas_conv.py:122 (mm variants)",
    "probe_conv_run": "tools/bench_probe_pallas_conv.py:122",
    "probe_bitcast_dot": "tools/bench_probe_r3a.py:343",
    "probe_unpack_words": "tools/bench_probe_r3b.py:82",
    "probe_packed_dot": "tools/bench_probe_r3b.py:147; tools/bench_probe_r3b.py:164",
}
# the sized rows of P3 and P4, where the work and not a launch sets the
# time: words (M, N) int32, w (N, P) int8
P3_SIZED = (4096, 4096, 1024)
BF16_ITERS = 3                     # bf16 conv probes are compared after 3 steps,
BF16_TOL = 2.0 ** -7               # within 2^-7 max|plain| elementwise


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def finish(phase):
    """Resume a phase that yielded (phases 8, 9, 12 and 15) for its last
    part; returns what the phase returns."""
    try:
        next(phase)
    except StopIteration as done:
        return done.value
    fail("a phase yielded twice")


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


def mma_count(spec, pe_split, n, h, w, tile, pe):
    """mma.sync instructions (m16n8k32) one launch issues over an (n, h, w)
    input, computed from the tile geometry of conv_layer in
    sesr_tpu_torch/csrc/sesr_net.cu (the card does not count them): per
    block and layer, the layer's output extent (the tile and the halo of
    the convs after it) cut into sixteens, times the passes and k32 chunks
    of its implicit GEMM and its n-tiles of 8 output channels (the last
    conv's out_columns). ``pe_split``: per layer, one pass per PE
    (KernelConstants.pe_split) of ``pe``; a network runs padded to its
    kernel width (16 or 32)."""
    from sesr_tpu_torch.convert import kernel_width, layer_geometry, out_columns

    th, tw = tile
    L = spec.num_convs
    width = kernel_width(spec.num_channels)
    per_block = 0
    for i, k in enumerate(spec.kernel_sizes):
        ic = spec.in_channels if i == 0 else width
        oc = out_columns(spec.conv_out_channels) if i == L - 1 else width
        passes, chunks, _ = layer_geometry(k, ic, pe_split[i], pe)
        r = sum(kk // 2 for kk in spec.kernel_sizes[i + 1:])
        rows = -(-(th + 2 * r) * (tw + 2 * r) // 16)
        per_block += rows * passes * chunks * (oc // 8)
    return per_block * n * -(-h // th) * -(-w // tw)


def wgmma_count(spec, pe_split, n, h, w, tile, pe):
    """(wgmma instructions, tensor-core MACs) one launch of the corrected
    kernel (csrc/sesr_corrected.cu) issues over an (n, h, w) input, computed
    from its tile geometry (the card does not count them): per tile and
    layer, the wide GEMM's rows (the output extent's height times the input
    extent's width) cut into m-tiles of 64, times the layer's k32 steps
    (width 16: two taps a step, width 32: one) and its chunks of whole PE
    groups (ops/kernels.py chunk_groups, at most 128 columns); together 64
    x N x 32 MACs a step, N the layer's columns (convert.py wgmma_geometry
    at ``pe`` PEs; x4 on a split layer at 4). B staged in pieces runs the
    same wgmmas."""
    from sesr_tpu_torch.convert import kernel_width, wgmma_geometry
    from sesr_tpu_torch.ops.kernels import chunk_groups

    th, tw = tile
    L = spec.num_convs
    width = kernel_width(spec.num_channels)
    count = macs = 0
    for i, k in enumerate(spec.kernel_sizes):
        ic = spec.in_channels if i == 0 else width
        oc = spec.conv_out_channels if i == L - 1 else width
        steps, groups, n_cols = wgmma_geometry(k, ic, oc, pe_split[i], i == L - 1, pe)
        r = sum(kk // 2 for kk in spec.kernel_sizes[i:])
        rows = (th + 2 * r - k + 1) * (tw + 2 * r)
        count += -(-rows // 64) * steps * (groups // chunk_groups(groups, n_cols // groups))
        macs += -(-rows // 64) * steps * 64 * n_cols * 32
    tiles = n * -(-h // th) * -(-w // tw)
    return count * tiles, macs * tiles


def launch_attrs(torch, launches, pattern="sesr_net_kernel", tries=1, index=-1, need=1):
    """{key: (registers per thread, shared memory bytes per block)} of the
    launch of a kernel whose name holds ``pattern`` that each fn of
    ``launches`` ({key: fn}) makes, as CUPTI reports them in torch.profiler's
    trace; (None, None) where the trace does not hold them. Each fn is
    traced on its own and its last such kernel read. A trace may carry
    kernels of an earlier trace, or miss one: only a kernel whose
    correlation id is that of a launch call in the same trace is read, and
    a trace that holds none is taken again, up to ``tries`` times. ``index``
    / ``need``: read the kernel at ``index`` of the trace's, in launch order,
    from a trace that holds at least ``need`` of them (a chain of layer
    groups: one kernel a group)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    path = os.path.join(REPO, "build", f"chip_smoke_trace_{os.getpid()}.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    attrs = {}
    for key, fn in launches.items():
        attrs[key] = (None, None)
        for trace in range(1, tries + 1):
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                fn()
                torch.cuda.synchronize()
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
            os.unlink(path)
            calls = {e.get("args", {}).get("correlation") for e in events
                     if e.get("cat") in ("cuda_runtime", "cuda_driver")} - {None}
            named = [e for e in events if e.get("cat") == "kernel"
                     and pattern in e.get("name", "")]
            kernels = sorted((e for e in named
                              if not calls or e.get("args", {}).get("correlation") in calls),
                             key=lambda e: e["ts"])
            if len(kernels) < len(named):
                print(f"[cupti] {key}: trace {trace} skipped {len(named) - len(kernels)} "
                      f"kernel(s) of an earlier trace", flush=True)
            if len(kernels) >= need:
                args = kernels[index].get("args", {})
                attrs[key] = (args.get("registers per thread"), args.get("shared memory"))
                break
            if trace < tries:
                print(f"[cupti] {key}: trace {trace} holds no launch of its own; tracing "
                      f"again", flush=True)
    return attrs


def kernel_family(kern, kc, audit=False, group=None):
    """The name of the CUDA kernel ``kern`` launches for the constants kc:
    the served one or (``audit``) the counting form, and the general
    instantiation's wide form where kc.wide; the corrected kernel's
    instantiations of a last conv past 16 channels and those with piece
    forms at width 32 and 16 PE groups (wide form or not). In the
    layer-group form the kernel of ``group`` (the two-conv group's and the
    corrected kernel's tail instantiations: ops/kernels.py pair_group,
    tail_group), or for ``group`` None the prefix every group's kernel
    shares (a chain's launches, read from a trace in launch order). A
    network of other conv sizes, or of width 64, runs every group in the
    forms of other conv sizes (sesr_net_ksize.cu, sesr_corrected_ksize.cu;
    at width 64 their instantiations in sesr_net_w64.cu,
    sesr_corrected_w64.cu and sesr_corrected_w64_audit.cu)."""
    from sesr_tpu_torch.ops.kernels import pair_group, tail_group

    wide = "_wide" if kc.wide else ""
    if kc.groups:                       # the layer-group form's kernels
        corrected = kern.datapath == "corrected"
        if group is None:
            return "sesr_corrected_" if corrected else "sesr_net_"
        if kc.ksize_form:
            if corrected:
                return f"sesr_corrected_ksize{'_audit' if audit else ''}_kernel"
            return "sesr_net_ksize_pair_kernel" if pair_group(group.convs, group.flags) \
                else "sesr_net_ksize_kernel"
        if corrected:
            form = "tail" if tail_group(group.convs, group.flags, kc.out_channels) else "group"
            return f"sesr_corrected_{form}{'_audit' if audit else ''}_kernel"
        return "sesr_net_pair_kernel" if pair_group(group.convs, group.flags) \
            else "sesr_net_group_kernel"
    if kern.datapath == "corrected":
        if kc.out_channels > 16:
            return f"sesr_corrected{'_audit' if audit else ''}_wideout_kernel"
        if piece_forms(kc):
            return f"sesr_corrected{'_audit' if audit else ''}_pieces_kernel"
        return f"sesr_corrected{'_audit' if audit else ''}{wide}_kernel"
    return f"sesr_net{wide}_kernel"


def piece_forms(kc):
    """Whether the corrected kernel's launch for kc takes its instantiation
    with piece forms at width 32 and 16 PE groups (a split layer past layer
    0; csrc/sesr_corrected.cu piece_kernel)."""
    from sesr_tpu_torch.convert import pe_groups

    return kc.general and kc.width == 32 and pe_groups(kc.pe) == 16 and any(kc.pe_split[1:])


def ptxas_line(kern, spec, kc, audit=False, group=None):
    """("family<template arguments>", (registers, spill store bytes)) of the
    instantiation ``kern`` launches for kc (in the layer-group form, for
    ``group``, by default the first), from ptxas's build log."""
    from sesr_tpu_torch.convert import out_columns, pe_groups

    if kc.groups:
        group = group or kc.groups[0]
    family = kernel_family(kern, kc, audit, group)
    gen = "" if kc.wide else f"ELb{int(kc.general)}"
    if kc.groups:
        # sesr_net_group_kernel<DP, OCL, C, WIDE>, sesr_corrected_group(_audit)_kernel<G, C, WS>;
        # the two-conv and tail groups' sesr_net_pair_kernel<DP, OCL, C> and
        # sesr_corrected_tail(_audit)_kernel<G, C>, each the wide form; other
        # conv sizes: sesr_net_ksize(_pair)_kernel<DP, OCL, C> and
        # sesr_corrected_ksize(_audit)_kernel<G, C>, each the wide form, in
        # the library of the chain's form (ops/kernels.py chain_entry)
        ws = "" if "_group_" not in family else f"ELb{int(kc.wide)}"
        lib = kern.chain_entry(kc, audit)[0]
        key = f"Li{pe_groups(kc.pe)}ELi{kc.width}{ws}" if kern.datapath == "corrected" else \
            f"Li{int(kern.datapath == 'fast')}ELin{out_columns(kc.out_channels)}ELi{kc.width}{ws}"
    elif kern.datapath == "corrected":
        lib, key = "sesr_corrected", (f"Li{pe_groups(kc.pe) if kc.general else 4}{gen}"
                                      f"ELi{kc.width}")
        if kc.out_channels > 16:
            key = f"Li{pe_groups(kc.pe)}ELi{kc.width}ELb{int(kc.wide)}"
        elif piece_forms(kc):
            key = f"Lb{int(kc.wide)}"
    else:
        # the shipped instantiations: the count; the general ones: the
        # padded count, negated
        ocl = f"n{out_columns(kc.out_channels)}" if kc.general else kc.out_channels
        lib, key = "sesr_net", (f"Li{int(kern.datapath == 'fast')}ELi{ocl}"
                                f"{gen}ELi{kc.width}")
    return f"{family}<{key}>", ptxas_report(lib, family).get(key, (None, None))


@functools.lru_cache(maxsize=None)
def ptxas_report(lib, family):
    """ptxas's report of the kernel ``family`` in library ``lib``'s build log
    (read once: a library does not change within a run)."""
    from sesr_tpu_torch.ops import _build

    return _build.ptxas_report(_build.build(lib).log, family)


def chain_lines(kern, spec, kc, audit=False):
    """{"family<template arguments>": (registers, spill store bytes)} of every
    instantiation a call with kc launches (``ptxas_line``): one, or in the
    layer-group form each group's (a chain's last group may run in the
    corrected kernel's tail instantiations, the others in its group ones)."""
    return dict(ptxas_line(kern, spec, kc, audit, g) for g in (kc.groups or (None,)))


def group_source(kern, kc, audit=False):
    """The source of the layer-group kernels ``kern`` launches for kc (the
    counting form's with ``audit``)."""
    return f"sesr_tpu_torch/csrc/{kern.chain_entry(kc, audit)[0]}.cu"


def chain_plans(kern, spec, kc, phase, tile=None):
    """[(group, tile, shared memory bytes)] of a call with the constants kc
    (``launch_plans``: one launch, or one per layer group), each plan held
    to the library's own (sesr_net_smem, sesr_corrected_smem, and the
    layer-group libraries' sesr_net_group_smem, sesr_corrected_group_smem,
    and for other conv sizes sesr_net_ksize_smem, sesr_corrected_ksize_smem,
    at width 64 sesr_net_w64_smem, sesr_corrected_w64_smem): the run fails
    where they differ."""
    from sesr_tpu_torch.convert import pack_sizes
    from sesr_tpu_torch.ops import _build

    plans = kern.launch_plans(spec, kc, tile)
    mask = sum(1 << i for i, f in enumerate(kc.pe_split) if f)
    exact = int(kern.datapath == "exact")
    for g, t, need in plans:
        if g is None and kern.datapath == "corrected":
            built = _build.load("sesr_corrected").sesr_corrected_smem(
                spec.num_convs, spec.in_channels, spec.conv_out_channels, *t, mask, kc.pe,
                int(kc.general), kc.width)
        elif g is None:
            built = _build.load("sesr_net").sesr_net_smem(
                exact, spec.num_convs, spec.in_channels, spec.conv_out_channels, *t, mask, kc.pe,
                int(kc.general), kc.width)
        elif kc.ksize_form:
            ks = pack_sizes(kc.ksizes[g.first:g.last + 1])
            lib, symbol = kern.chain_entry(kc)
            smem = getattr(_build.load(lib), f"{symbol}_smem")
            lead = () if kern.datapath == "corrected" else (exact,)
            built = smem(*lead, g.convs, g.flags, spec.in_channels, spec.conv_out_channels, *t,
                         g.split, kc.pe, kc.width, ks)
        elif kern.datapath == "corrected":
            built = _build.load("sesr_corrected_group").sesr_corrected_group_smem(
                g.convs, g.flags, spec.in_channels, spec.conv_out_channels, *t, g.split, kc.pe,
                kc.width)
        else:
            built = _build.load("sesr_net_group").sesr_net_group_smem(
                exact, g.convs, g.flags, spec.in_channels, spec.conv_out_channels, *t, g.split,
                kc.pe, kc.width)
        if built != need:
            fail(f"[{phase}] {kern.symbol} {spec.name}"
                 f"{'' if g is None else f' convs {g.first}-{g.last}'} tile {t}: the wrapper "
                 f"plans {need} B of shared memory, the library {built}")
    return plans


def first_in_pieces(spec, kc, plans):
    """The groups of a corrected-kernel chain in the old group kernels
    (csrc/sesr_corrected_group.cu) whose first conv goes in pieces (its
    ``in_pieces(0)``: the plan's piece form and the conv's B in more than
    one piece), which stage no whole layer 0 before a tile: [(index, first
    conv)] of ``plans`` (``chain_plans``)."""
    from sesr_tpu_torch.convert import GROUP_FIRST
    from sesr_tpu_torch.ops.kernels import corrected_group_plan, layer_pieces

    if kc.ksize_form or not kc.groups:
        return []
    out = []
    for gi, (g, tile, _) in enumerate(plans):
        split = [bool(g.split >> j & 1) for j in range(g.convs)]
        first = bool(g.flags & GROUP_FIRST)
        plan = corrected_group_plan(g.convs, g.flags, spec.in_channels, spec.conv_out_channels,
                                    tile, split, kc.pe, kc.width)
        ic = spec.in_channels if first else kc.width
        if plan.pieces and layer_pieces(kc.ksizes[g.first], ic, kc.width, split[0], False,
                                        kc.pe)[0] > 1:
            out.append((gi, g.first))
    return out


def plain_kwargs(kern, qp, mode=None):
    """integer_forward's arguments for the plain version of ``kern`` (the
    corrected kernel in ``mode``, "hybrid" or "pe-exact")."""
    if kern.datapath == "exact":
        return dict(corrected=False, compute="exact")
    if kern.datapath == "fast":
        return dict(corrected=True, compute="fast")
    return dict(corrected=True, fast_layers=tuple(qp.fast_cert_layers)
                if mode == "hybrid" else None)


def audit_check(torch, spec, qp, x, label, phase, region=None):
    """The corrected kernel's counting form (``audit_forward``, one launch
    of sesr_corrected_audit, counted in ``corrected_net.audit_launches``)
    on the CUDA tensor x against the plain interpreter on the card
    (``integer_forward(corrected=True, collect_dumps=True)``): counts
    array_equal with its overflow_18 (with ``region``: the counts of the
    region, compared by the caller), output torch.equal. Returns the
    counts as numpy."""
    from sesr_tpu_torch.ops.corrected import audit_forward, split_layers
    from sesr_tpu_torch.ops.kernels import corrected_net
    from sesr_tpu_torch.quant.integer import integer_forward

    before = (corrected_net.launches, corrected_net.audit_launches)
    y, counts = audit_forward(spec, qp, x, region=region)
    torch.cuda.synchronize()
    if (corrected_net.launches, corrected_net.audit_launches) != (before[0], before[1] + 1):
        fail(f"[{phase}] audit {label}: not one counting launch")
    if region is not None:
        return counts.cpu().numpy()
    want_y, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True)
    want = dumps["overflow_18"].cpu().numpy()
    got = counts.cpu().numpy()
    split = [i for i, f in enumerate(split_layers(qp, "pe-exact")) if f]
    print(f"[{phase}] sesr_corrected_audit {spec.name} {label} {tuple(x.shape)}, split {split}: "
          f"counts {got.tolist()}, plain overflow_18 {want.tolist()}, array_equal "
          f"{np.array_equal(got, want)}; output torch.equal {torch.equal(y, want_y)}", flush=True)
    if not np.array_equal(got, want) or not torch.equal(y, want_y):
        fail(f"[{phase}] the counting form differs from the plain interpreter on {spec.name} "
             f"{label}")
    return got


@contextlib.contextmanager
def audit_on_the_kernel(torch):
    """Within: quant/audit.py's plain interpreter fails on a CUDA tensor, so
    an audit on the card must take the counting kernel; every
    ``audit_frame`` call of ``cli.serve`` and ``multihost.stream_frames``
    is recorded as (x, halo_group, AuditResult) in the list it yields."""
    from sesr_tpu_torch import cli
    from sesr_tpu_torch.parallel import multihost
    from sesr_tpu_torch.quant import audit
    from sesr_tpu_torch.quant.integer import resolve_device

    plain, real = audit.integer_forward, audit.audit_frame
    made = []

    def barred(spec, qp, x, *a, **k):
        if resolve_device(x, k.get("device")).type == "cuda":
            fail("quant/audit.py ran the plain interpreter on the card")
        return plain(spec, qp, x, *a, **k)

    def recorded(spec, qp, x, *a, **k):
        res = real(spec, qp, x, *a, **k)
        made.append((x, k.get("halo_group"), res))
        return res

    audit.integer_forward, cli.audit_frame, multihost.audit_frame = barred, recorded, recorded
    try:
        yield made
    finally:
        audit.integer_forward, cli.audit_frame, multihost.audit_frame = plain, real, real


def check_audits(torch, spec, qp, audits, phase):
    """Each recorded (x, halo_group, AuditResult) against the plain
    interpreter on the card (the rank's block with its halo group): counts
    array_equal with its overflow_18, the sound output torch.equal. Returns
    the counts."""
    from sesr_tpu_torch.quant.integer import integer_forward

    held = []
    for x, halo_group, res in audits:
        with torch.inference_mode():
            y, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True,
                                       halo_group=halo_group)
        want = dumps["overflow_18"].cpu().numpy()
        if not np.array_equal(res.ovf18, want) or not torch.equal(res.y_exact, y):
            fail(f"[{phase}] an audit on the card differs from the plain interpreter: counts "
                 f"{res.ovf18.tolist()} against {want.tolist()}, outputs equal "
                 f"{torch.equal(res.y_exact, y)}")
        held.append(res.ovf18.tolist())
    return held


def audit_entry(torch, dev, spec, qp, x, name, card, phase, launches):
    """The ``kernels``-line entry of the counting form on x (batch 1, on the
    card): its largest output difference from the plain interpreter's (its
    counts must be the plain overflow_18), device ms (CUDA events, the card
    led) beside the served PE-exact kernel's in the same turn, the plain
    interpreter's ms with its counters, the bound of the PE-exact mode's
    operations (the network's int8 MACs) against its bytes, and ptxas's
    registers and spill stores of its instantiation."""
    from sesr_tpu_torch.convert import kernel_constants
    from sesr_tpu_torch.ops.corrected import audit_forward, split_layers
    from sesr_tpu_torch.ops.kernels import corrected_net
    from sesr_tpu_torch.quant.integer import integer_forward, quantize_input
    from sesr_tpu_torch.timing import median_ms

    y, counts = audit_forward(spec, qp, x)
    want_y, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True)
    if not torch.equal(counts, dumps["overflow_18"]):
        fail(f"[{phase}] {name}: counts {counts.tolist()} against the plain "
             f"{dumps['overflow_18'].tolist()}")
    err = float((y - want_y).abs().max())
    del want_y, dumps
    split = split_layers(qp, "pe-exact")
    kc = kernel_constants(spec, qp, "corrected", split)
    x_q = quantize_input(x, qp).to(torch.int8).contiguous()
    tile = corrected_net.tile(spec, kc.pe_split, kc.pe, kc.general)
    times = {}
    for turn in ("audit", "served", "served", "audit"):
        fn = (lambda: corrected_net.audit(spec, qp, x_q, split)) if turn == "audit" else \
            (lambda: corrected_net(spec, qp, x_q, split=split))
        times.setdefault(turn, []).append(median_ms(fn, dev, 20, warmup=3, lead_ms=1.0))
    ms, served_ms = min(times["audit"]), min(times["served"])
    plain_ms = median_ms(lambda: integer_forward(spec, qp, x, collect_dumps=True,
                                                 corrected=True), dev, 3)
    weights = sum(int(np.prod(np.shape(w))) for w in qp.w_int)
    n, h, w = x_q.shape[:3]
    macs = weights * n * h * w
    moved = x_q.numel() + n * h * w * spec.conv_out_channels + weights + 8 * spec.num_convs
    bnd = bound(2 * macs, moved, INT8_OPS_PER_S)
    key, (regs, spill) = ptxas_line(corrected_net, spec, kc, audit=True)
    print(f"[{phase}] sesr_corrected_audit {spec.name} {h}x{w}, {kc.pe} PEs: {ms:.4f} ms/frame "
          f"device ({times['audit']}), the served PE-exact kernel {served_ms:.4f} "
          f"({times['served']}), ratio {ms / served_ms:.4f}; tile {tile[0]}x{tile[1]}; "
          f"{key} ptxas {regs} registers, {spill} B spill stores; bound "
          f"{bnd[0] * 1e3:.3f} us ({bnd[1]}: {2 * macs:.4g} int8 ops, {moved} bytes), share "
          f"{bnd[0] / ms:.4f}; plain interpreter with its counters {plain_ms:.3f} ms {card}",
          flush=True)
    n_launch, n_frames = launches
    return dict(name=name, route="cuda", source=SOURCES["sesr_corrected_net"],
                replaces=AUDIT_REPLACES, launches=n_launch,
                launches_per_frame={"main path": n_launch / n_frames},
                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bnd[0], bound_by=bnd[1], library_ms=None, tile=list(tile),
                served_pe_exact_ms=served_ms, ptxas=[regs, spill],
                work=f"{spec.name}, {h}x{w} frame, batch 1, the PE-exact mode with its "
                     f"18-bit counters, {kc.pe} PEs")


def tensor_count(kern, spec, split, n, h, w, tile, pe):
    """(tensor-core instructions, their MACs, the instruction's name) of one
    launch of ``kern`` at ``pe`` PEs, computed from its tile geometry."""
    if kern.datapath == "corrected":
        return (*wgmma_count(spec, split, n, h, w, tile, pe), "wgmma")
    mmas = mma_count(spec, split, n, h, w, tile, pe)
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
    from sesr_tpu_torch.convert import kernel_constants, kernel_width
    from sesr_tpu_torch.ops import _build
    from sesr_tpu_torch.ops.corrected import split_layers
    from sesr_tpu_torch.ops.kernels import SMEM_LIMIT
    from sesr_tpu_torch.quant.integer import integer_forward, quantize_input
    from sesr_tpu_torch.timing import median_ms

    corrected = kern.datapath == "corrected"
    split_arg = split_layers(qp, mode) if corrected else None
    kc = kernel_constants(spec, qp, kern.datapath, split_arg)
    split = kc.pe_split
    x_q = quantize_input(x, qp).to(torch.int8).contiguous()
    n, h, w = x_q.shape[:3]
    label = f"{kern.symbol} {spec.name}{f' {mode}' if mode else ''} {h}x{w}"
    pe = qp.hw.pe
    tile0 = kern.tile(spec, split, pe)
    ref = kern(spec, qp, x_q, split=split_arg)
    if sweep:
        tiles = TILE_SWEEP
        if corrected:
            lib = _build.load(kern.library)
            mask = sum(1 << i for i, f in enumerate(split) if f)
            tiles = []
            for tile in CORRECTED_SWEEP:
                plan = kern.smem_bytes(spec, tile, split, pe, kc.general)
                built = lib.sesr_corrected_smem(spec.num_convs, spec.in_channels,
                                                spec.conv_out_channels, *tile, mask, pe,
                                                int(kc.general), kernel_width(spec.num_channels))
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
            count, _, instr = tensor_count(kern, spec, split, n, h, w, tile, pe)
            if corrected and smem is not None and smem != kern.smem_bytes(spec, tile, split, pe):
                fail(f"{label} tile {tile}: CUPTI reports {smem} B of shared memory, the plan "
                     f"{kern.smem_bytes(spec, tile, split, pe)}")
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
    count, tc_macs, instr = tensor_count(kern, spec, split, n, h, w, tile0, pe)
    print(f"[5] {label}: {ms:.4f} ms/frame at tile {tile0[0]}x{tile0[1]}, per-PE passes on "
          f"convs {[i for i in range(spec.num_convs) if split[i]]} (plain {plain_ms:.3f} ms); "
          f"computed from the tile geometry: {count} {instr} ({tc_macs:.4g} tensor-core MACs, "
          f"{tc_macs / macs:.3f}x the network's); bound {bnd[0] * 1e3:.3f} us ({bnd[1]}) = "
          f"{2 * macs:.4g} int8 ops vs {moved} bytes, share of bound {bnd[0] / ms:.4f}",
          flush=True)
    return ms, plain_ms, bnd


def breakdown(torch, fn, frames, iters=20):
    """(wall ms/frame, busy ms/frame, {event: device ms/frame}, device
    events per frame) of fn()."""
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
    per, events = {}, 0
    for e in prof.events():
        # a user annotation (the optimizer's "Optimizer.step#Adam.step")
        # spans the kernels it launched on the device timeline: not work
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            k = _short(e.name)
            per[k] = per.get(k, 0.0) + e.device_time_total / 1e3 / (iters * frames)
            events += 1
    return (wall, sum(per.values()), dict(sorted(per.items(), key=lambda kv: -kv[1])),
            events / (iters * frames))


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
    of their libraries: the corrected kernel (sesr_corrected_kernel: the
    shipped instantiation and the general ones of 4, 8 and 16 PE groups,
    at hidden widths 16 and 32) and its counting form (sesr_corrected_
    audit_kernel, the same eight), and the general ones' wide forms (the
    six sesr_corrected_wide_kernel and sesr_corrected_audit_wide_kernel,
    and the twelve of a last conv past 16 channels, served and
    counting, sesr_corrected_wideout_kernel and
    sesr_corrected_audit_wideout_kernel, and the two with piece forms at
    width 32 and 16 PE groups, sesr_corrected_pieces_kernel and
    sesr_corrected_audit_pieces_kernel) on wgmma (IGMMA) and no mma.sync
    (IMMA); K1 and K2 (sesr_net_kernel, three output counts shipped and
    four padded output widths general, at hidden widths 16 and 32; and
    sesr_net_wide_kernel, the general ones' wide forms) on mma.sync. Prints each kernel's counts; fails otherwise."""
    want = (("sesr_corrected", "sesr_corrected_kernel", "IGMMA", "IMMA", 8),
            ("sesr_corrected", "sesr_corrected_audit_kernel", "IGMMA", "IMMA", 8),
            ("sesr_corrected", "sesr_corrected_wide_kernel", "IGMMA", "IMMA", 6),
            ("sesr_corrected", "sesr_corrected_audit_wide_kernel", "IGMMA", "IMMA", 6),
            ("sesr_corrected", "sesr_corrected_wideout_kernel", "IGMMA", "IMMA", 12),
            ("sesr_corrected", "sesr_corrected_audit_wideout_kernel", "IGMMA", "IMMA", 12),
            ("sesr_corrected", "sesr_corrected_pieces_kernel", "IGMMA", "IMMA", 2),
            ("sesr_corrected", "sesr_corrected_audit_pieces_kernel", "IGMMA", "IMMA", 2),
            ("sesr_net", "sesr_net_kernel", "IMMA", "IGMMA", 28),
            ("sesr_net", "sesr_net_wide_kernel", "IMMA", "IGMMA", 16))
    dumps = {name: sass_counts(build.library_path(name)) for name in ("sesr_corrected", "sesr_net")}
    for name, family, has, lacks, instances in want:
        seen = 0
        for fn, c in sorted(dumps[name].items()):
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
    """probe_gemm, probe_packed_dot, probe_bitcast_dot and probe_conv_run on
    wgmma (HGMMA / IGMMA) with TMA loads (UTMALDG) and no mma.sync (HMMA /
    IMMA). Prints each kernel's counts; fails on a missing opcode."""
    counts = sass_counts(lib)
    seen = dict.fromkeys(("probe_gemm_kernel", "probe_packed_dot_kernel",
                          "probe_bitcast_dot_kernel", "probe_conv_run_kernel"), 0)
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
                            words, torch.zeros((4, 64, 128), dtype=torch.int8, device=dev))),
                        ("probe_bitcast_dot", lambda: pk.probe_bitcast_dot(
                            words, torch.zeros((64, 64), dtype=torch.int8, device=dev))),
                        ("probe_unpack_words", lambda: pk.probe_unpack_words(words))):
        try:
            call()
            fail(f"{label} took a view that is not 16-byte aligned")
        except ValueError as e:
            print(f"[7] {label} refuses a misaligned view: {e}", flush=True)
    after = {k.symbol: k.launches for k in pk.PROBE_KERNELS}
    if after != before:
        fail(f"a refused misaligned view launched: {before} -> {after}")


# probe_bitcast_dot off the probe's shape: words (M, N), w (N, P). 4M =
# 1000 rows by P = 4352 columns take the 128 x 256 tile (8 x 17 = 136
# blocks), P = 192 the 64 x 64 one; M 25 and 250 are no multiple of a
# tile's 16 or 32 word rows; N = 64 is half a stage, 128 one, 1152 nine;
# M = 1 is four output rows. At each roll (N - 1 and N + 5 by N).
BITCAST_EDGES = ((250, 256, 4352), (25, 512, 192), (250, 64, 4352), (25, 64, 192),
                 (250, 128, 4352), (250, 1152, 192), (1, 192, 64))
BITCAST_ROLLS = (0, 1, 63, "N-1", "N+5", -3)
# probe_unpack_words: the probes' shapes and the sized one at these rolls
# (5: the 16-byte groups start 3 words before a run, as at roll 1), and
# edges: (shape, rolls), the runs kernel at every (-roll) mod 4, and widths
# no multiple of 16 (a word a thread)
UNPACK_ROLLS = (0, 1, 5)
UNPACK_EDGES = (((33, 48), (2, 3, -3, 130)), ((5, 12), (0, 1, 7)), ((3, 100), (0, 5)),
                ((1, 1), (0, 1)), ((2, 16), (0, 6, 15)))


def bitcast_checks(torch, dev, compare, counts):
    """probe_bitcast_dot against its plain version (torch.equal) on its edges
    at every roll of BITCAST_ROLLS and at the sized shape, each through
    bitcast.bitcast_dot with exactly one probe_bitcast_dot launch and no other;
    probe_unpack_words against its plain version at the probes' shapes and
    the sized one at UNPACK_ROLLS and on UNPACK_EDGES. Returns the sized
    operands (words, w)."""
    from sesr_tpu_torch.probes import bitcast, plain
    from sesr_tpu_torch.probes import kernels as pk

    rng = np.random.default_rng(13)

    def seeded_words(m, n):
        words = rng.integers(-2 ** 31, 2 ** 31, (m, n), dtype=np.int64).astype(np.int32)
        return torch.from_numpy(words).to(dev)

    def seeded(m, n, p):
        return (seeded_words(m, n),
                torch.from_numpy(rng.integers(-128, 128, (n, p)).astype(np.int8)).to(dev))

    def one_launch(label, wds, w, roll):
        before = counts()
        got = bitcast.bitcast_dot(wds, w, roll)
        launched = {k: counts()[k] - before[k] for k in before}
        if launched != {**dict.fromkeys(before, 0), "probe_bitcast_dot": 1}:
            fail(f"bitcast_dot {label} launched {launched}, not one probe_bitcast_dot")
        want = plain.bitcast_dot(wds, w, roll)
        compare("probe_bitcast_dot", got, want)
        if not torch.equal(got, want):
            fail(f"probe_bitcast_dot {label} disagrees with its plain version")

    for m, n, p in BITCAST_EDGES:
        wds, w = seeded(m, n, p)
        for roll in BITCAST_ROLLS:
            roll = {"N-1": n - 1, "N+5": n + 5}.get(roll, roll)
            one_launch(f"words {(m, n)} w {(n, p)} roll {roll}", wds, w, roll)
    print(f"[7] probe_bitcast_dot edges {BITCAST_EDGES} (M, N, P) at rolls {BITCAST_ROLLS}: "
          f"torch.equal with plain, one launch a bitcast_dot", flush=True)
    big_words, big_w = seeded(*P3_SIZED)
    one_launch(f"sized words {P3_SIZED[:2]} w {P3_SIZED[1:]} roll 1", big_words, big_w, 1)
    print(f"[7] probe_bitcast_dot sized, words {P3_SIZED[:2]} x w {P3_SIZED[1:]} roll 1: "
          f"torch.equal with plain, one launch", flush=True)
    cases = [(shape, UNPACK_ROLLS) for shape in ((8, 128), (256, 128), P3_SIZED[:2])]
    for shape, rolls in cases + list(UNPACK_EDGES):
        wds = big_words if shape == P3_SIZED[:2] else seeded_words(*shape)
        for roll in rolls:
            got, want = pk.probe_unpack_words(wds, roll), plain.unpack_words(wds, roll)
            compare("probe_unpack_words", got, want)
            if not torch.equal(got, want):
                fail(f"probe_unpack_words {shape} roll {roll} disagrees with its plain version")
    print(f"[7] probe_unpack_words at {[c[0] for c in cases]} x rolls {UNPACK_ROLLS} and edges "
          f"{UNPACK_EDGES}: torch.equal with plain", flush=True)
    return big_words, big_w


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
        "P3 whole, w (128, 256)": ("probe_bitcast_dot", bitcast.bitcast_dot(words, w_ok),
                                   plain.bitcast_dot(words, w_ok, 1)),
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
    big_words, big_w = bitcast_checks(torch, dev, compare, counts)
    sass_check(_build.library_path("probes"))
    log = _build.build("probes").log
    for family in ("probe_bitcast_dot_kernel", "probe_unpack_runs_kernel", "probe_gemm_kernel"):
        print(f"[7] ptxas {family} (template arguments: registers, spill store bytes): "
              f"{_build.ptxas_report(log, family)}", flush=True)
    print(f"[7] ptxas lines on wgmma: {[ln.strip() for ln in log.splitlines() if 'wgmma' in ln]}",
          flush=True)
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

    # P3 and P4 at the probes' shapes, where a launch sets the time (beside
    # the launch floor), and sized, where the work does
    one = torch.zeros(1, device=dev)
    floor_ms = device_ms(lambda: one.fill_(0), reps=30)
    print(f"[7] launch floor: one launch of a one-element fill_, {floor_ms:.5f} ms (device "
          f"time)", flush=True)

    def unpack_lib(wds, roll):
        """The function of probe_unpack_words in PyTorch: torch.roll (roll !=
        0), then the int8 view's permute made contiguous, one copy."""
        m_, n_ = wds.shape
        rolled = torch.roll(wds, roll, 1) if roll else wds
        return rolled.view(torch.int8).reshape(m_, n_, 4).permute(0, 2, 1).contiguous() \
            .view(4 * m_, n_)

    for label, wds, roll in (("P4 (8, 128) roll 0", words_l, 0),
                             ("P3's unpack (256, 128) roll 1", words, 1),
                             (f"P4 sized {P3_SIZED[:2]} roll 0", big_words, 0),
                             (f"P4 sized {P3_SIZED[:2]} roll 1", big_words, 1)):
        if not torch.equal(unpack_lib(wds, roll), plain.unpack_words(wds, roll)):
            fail(f"the library unpack computes another function at {label}")
        ms = device_ms(lambda: pk.probe_unpack_words(wds, roll), reps=30)
        plain_ms = device_ms(lambda: plain.unpack_words(wds, roll))
        lib_ms = device_ms(lambda: unpack_lib(wds, roll), reps=30)
        bnd = bound(0, 2 * wds.numel() * 4, INT8_OPS_PER_S)
        report(f"{label} probe_unpack_words (device time)", ms, bnd, plain_ms, lib_ms,
               f"{'torch.roll + ' if roll else ''}view / permute / contiguous")
        if label.startswith("P4") and roll == 0:
            entry("probe_unpack_words", f"P4: {tuple(wds.shape)} int32 words, roll 0", ms,
                  plain_ms, bnd, lib_ms)

    for label, wds, w_, roll in (("P3 words (256, 128) x w (128, 256) roll 1", words, w_ok, 1),
                                 (f"P3 sized words {P3_SIZED[:2]} x w {P3_SIZED[1:]} roll 1",
                                  big_words, big_w, 1)):
        a8 = plain.unpack_words(wds, roll)
        w_cm = w_.t().contiguous().t()
        if not torch.equal(torch._int_mm(unpack_lib(wds, roll), w_cm),
                           plain.bitcast_dot(wds, w_, roll)):
            fail(f"the library composition computes another function at {label}")
        ms = device_ms(lambda: bitcast.bitcast_dot(wds, w_, roll), reps=30)
        two_ms = device_ms(lambda: pk.probe_gemm(pk.probe_unpack_words(wds, roll), w_), reps=30)
        gemm_ms = device_ms(lambda: pk.probe_gemm(a8, w_), reps=30)
        plain_ms = device_ms(lambda: plain.bitcast_dot(wds, w_, roll), reps=5)
        libs = {layout: device_ms(lambda: torch._int_mm(unpack_lib(wds, roll), b), reps=30)
                for layout, b in (("w row-major", w_), ("w column-major", w_cm))}
        lib_name = min(libs, key=libs.get)
        int_mm_ms, _ = int_mm(a8, w_)
        rows, p_ = a8.shape[0], w_.shape[1]
        bnd = bound(2 * rows * wds.shape[1] * p_, wds.numel() * 4 + w_.numel() + rows * p_ * 4,
                    INT8_OPS_PER_S)
        report(f"{label} probe_bitcast_dot, one launch (device time)", ms, bnd, plain_ms,
               libs[lib_name], f"torch.roll + view / permute / contiguous + torch._int_mm, "
               f"{lib_name}")
        print(f"[7]     {label}: the earlier two-launch form (probe_unpack_words, then "
              f"probe_gemm) {two_ms:.5f} ms; probe_gemm on the unpacked operand {gemm_ms:.5f} "
              f"ms; torch._int_mm on it {int_mm_ms:.5f} ms; library composition {libs} ms",
              flush=True)
        entry("probe_bitcast_dot", f"{label}: the roll, bitcast and int8 dot in one launch", ms,
              plain_ms, bnd, libs[lib_name])
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
        "probe_bitcast_dot 64x64 tiles (P3)": lambda: pk.probe_bitcast_dot(words, w_ok),
        "probe_bitcast_dot 128x256 tiles (P3 sized)": lambda: pk.probe_bitcast_dot(big_words,
                                                                                   big_w),
        "probe_unpack_words, sized, roll 1": lambda: pk.probe_unpack_words(big_words, 1),
        "probe_gemm bf16 64x64 tiles (P1 mm step)": lambda: pk.probe_gemm.write_back(
            x_bf.reshape(-1, 9 * c), w_bf.reshape(9 * c, c), 9),
        "probe_conv_run int8, 50 steps": lambda: pk.probe_conv_run(
            x_i8, w_i8.reshape(9 * c, c), conv.ITERS),
        "probe_conv_run bf16, 50 steps": lambda: pk.probe_conv_run(
            x_bf, w_bf.reshape(9 * c, c), conv.ITERS),
        "probe_unpack_words (8, 128)": lambda: pk.probe_unpack_words(words_l),
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
    the float paths must turn it off for their own convs. A generator: it
    yields after its float part (eval-float, calibrate, the KL guardrail:
    no kernel) and after its checks, and ``finish`` runs the audit's time
    and returns, per network kernel and path, (launches, frames served), and
    the audit's kernels-line entry."""
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
    # the kernels' part after K2's and the corrected kernel's builds, with
    # TF32 as the caller has it meanwhile
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = True

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
    # one synthetic frame. On the card the audit is one launch of the
    # corrected kernel's counting form: quant/audit.py's plain interpreter
    # fails on a CUDA tensor while the streams run, and every audit the
    # streams made is held against the plain interpreter after them
    qp = shipped["nr"]
    with audit_on_the_kernel(torch) as audits:
        reset_launch_counts()
        clean = serve(nr_spec, qp, nr_data, device="cuda", audit_every=1, keep_outputs=True)
        torch.cuda.synchronize()
        kc_clean, ka_clean = corrected_net.launches, corrected_net.audit_launches
    for (x, _), y in zip(nr_data, clean.outputs):
        want = integer_forward(nr_spec, qp, torch.from_numpy(x).to(dev), corrected=True,
                               fast_layers=tuple(qp.fast_cert_layers))[0]
        if not torch.equal(torch.from_numpy(y).to(dev), want[0]):
            fail("infer --audit 1 on nr: a served frame differs from the plain version")
    held = check_audits(torch, nr_spec, qp, audits, 8)
    shadow = clean.audit_seconds / clean.audited
    print(f"[8] infer --audit 1 nr, 4 frames {BAYER_FRAME}: mode {clean.mode}, "
          f"{clean.audited} audited, violations {clean.violations}; sesr_corrected_net launches "
          f"{kc_clean}, sesr_corrected_audit launches {ka_clean}; every audit's counts "
          f"{held} array_equal with the plain interpreter's (cuda); forward "
          f"{clean.forward_seconds / clean.n * 1e3:.3f} ms/frame, audit shadow "
          f"{shadow * 1e3:.3f} ms/frame as the host issues it {tag}", flush=True)
    if clean.violations or clean.mode != "hybrid" or clean.audited != 4 or kc_clean != 4 \
            or ka_clean != 4 or len(audits) != 4:
        fail(f"infer --audit 1 on in-distribution nr frames: {clean.violations}, {clean.mode}, "
             f"{clean.audited} audited, {kc_clean} served and {ka_clean} counting launches")
    adv = adversarial_image(qp, hw=BAYER_FRAME)
    stream = [(adv, np.zeros_like(adv)), nr_data[0]]
    with audit_on_the_kernel(torch) as audits:
        reset_launch_counts()
        res = serve(nr_spec, qp, stream, device="cuda", audit_every=1, keep_outputs=True)
        torch.cuda.synchronize()
        pe_split = split_layers(qp, "pe-exact")
        kc_adv, kc_pe = corrected_net.launches, corrected_net.split_launches[pe_split]
        ka_adv = corrected_net.audit_launches
    held = check_audits(torch, nr_spec, qp, audits, 8)
    print(f"[8] infer --audit 1 nr, adversarial frame then a synthetic one: violations "
          f"{res.violations}, served {res.mode} from then on; "
          f"sesr_corrected_net launches {kc_adv}, of them pe-exact (split {pe_split}) {kc_pe}; "
          f"sesr_corrected_audit launches {ka_adv}, counts {held} (plain's on cuda)",
          flush=True)
    if not (res.violations == [(0, (0,))] and res.mode == "pe-exact" and kc_adv == 3
            and kc_pe == 2 and ka_adv == 1 and len(audits) == 1 and held[0][0] > 0):
        fail(f"the adversarial stream: violations {res.violations}, mode {res.mode}, "
             f"{kc_adv} launches, {kc_pe} pe-exact, {ka_adv} counting, counts {held}")
    for (x, _), y in zip(stream, res.outputs):
        want = integer_forward(nr_spec, qp, x, corrected=True, device="cpu")[0][0]
        if not torch.equal(torch.from_numpy(y), want):
            fail("the degraded stream's output differs from the CPU interpreter's")
    print("[8] both frames of the degraded stream: torch.equal with integer_forward(corrected) "
          "on the CPU", flush=True)
    # the times after the builds (``finish``), with TF32 as the caller has it
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = True
    # the audit's time on one frame: the counting launch against the served
    # PE-exact kernel, and the plain interpreter with its counters
    audit_e = audit_entry(torch, dev, nr_spec, qp, torch.from_numpy(adv).to(dev),
                          "sesr_corrected_audit", tag, 8, (ka_clean + ka_adv, clean.n + res.n))
    audit_e["launches_per_frame"] = {"infer_audit_nr": ka_clean / clean.n,
                                     "infer_audit_nr_adversarial": ka_adv / res.n}
    print(f"[8] the audit per nr frame: {audit_e['ms']:.4f} ms device, {shadow * 1e3:.3f} ms "
          f"shadow as the host issues it (plain interpreter {audit_e['plain_ms']:.3f} ms) {tag}",
          flush=True)
    launches["sesr_corrected_net"]["infer_audit_nr"] = (kc_clean, clean.n)
    launches["sesr_corrected_net"]["infer_audit_nr_adversarial"] = (kc_adv, res.n)
    torch.backends.cudnn.allow_tf32 = False
    return launches, audit_e


def expect_launches(what, mode, k2, kc, n):
    """One launch a frame of the kernel the certificate's ``mode`` selects
    (K2 for "fast", the corrected kernel otherwise), none of the other."""
    want = (n, 0) if mode == "fast" else (0, n)
    if (k2, kc) != want:
        fail(f"{what}: {mode} mode launched K2 {k2} and sesr_corrected_net {kc} times "
             f"for {n} frames (want {want})")


def training_phase(torch, dev, card):
    """Phase 9, training and make_qparams on the card: the STE and
    fake-quant against the CPU, float training of the expanded sr_x4 (cuda
    against cpu, determinism, save and resume), the QAT recipe from those
    weights, AdaRound and make_qparams from golden weights, each fresh
    artifact certified and served through the kernel its certificate
    selects. TF32 is left on around the phase. A generator: it yields
    after its float part (9a and 9b: no kernel), and ``finish`` runs the
    rest and returns, per network kernel and path, (launches, frames)."""
    import tempfile

    from sesr_tpu_torch import make_qparams
    from sesr_tpu_torch.cli import main as cli_main
    from sesr_tpu_torch.cli import serve, training_set
    from sesr_tpu_torch.config import spec_for_task
    from sesr_tpu_torch.data import SyntheticDataset
    from sesr_tpu_torch.deploy import select_forward
    from sesr_tpu_torch.io.checkpoint import tensor_leaves
    from sesr_tpu_torch.io.torch_import import load_reference_checkpoint
    from sesr_tpu_torch.models.expanded import ExpandedBlock, ExpandedParams, init_expanded
    from sesr_tpu_torch.ops.conv import float_exact
    from sesr_tpu_torch.ops.kernels import corrected_net, fast_net, reset_launch_counts
    from sesr_tpu_torch.quant import qat
    from sesr_tpu_torch.quant.adaround import layer_inputs, optimize_layer_rounding
    from sesr_tpu_torch.quant.calibrate import calibrate
    from sesr_tpu_torch.quant.integer import integer_forward, layer_step
    from sesr_tpu_torch.quant.params import quantize_weights

    torch.backends.cudnn.allow_tf32 = True
    tag = f"({card})"
    launches = {"sesr_fast_net": {}, "sesr_corrected_net": {}}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def counted(fn):
        reset_launch_counts()
        out, t = timed(fn)
        return out, t, fast_net.launches, corrected_net.launches

    def served(label, spec, qp, data):
        """serve() on the card, one launch a frame of the selected kernel,
        every output equal to its plain version's on the card."""
        res, t, k2, kc = counted(lambda: serve(spec, qp, data, device="cuda",
                                               keep_outputs=True))
        expect_launches(f"infer {label}", res.mode, k2, kc, len(data))
        kw = {"fast": dict(compute="fast"), "hybrid": dict(
            fast_layers=tuple(qp.fast_cert_layers)), "pe-exact": {}}[res.mode]
        for (x, _), y in zip(data, res.outputs):
            want = integer_forward(spec, qp, torch.from_numpy(x).to(dev), corrected=True,
                                   **kw)[0]
            if not torch.equal(torch.from_numpy(y).to(dev), want[0]):
                fail(f"infer {label}: a served frame differs from the plain version")
        print(f"[9] infer {label}, {len(data)} frames {data[0][0].shape[1:3]} -> "
              f"{res.outputs[0].shape}: mode {res.mode}, K2 launches {k2}, sesr_corrected_net "
              f"{kc}, every output equal to the plain version; mean psnr {res.mean_psnr:.4f}; "
              f"forward {res.forward_seconds / res.n * 1e3:.3f} ms/frame {tag}", flush=True)
        launches["sesr_fast_net" if res.mode == "fast" else "sesr_corrected_net"][
            f"infer_{label.replace(' ', '_')}"] = (k2 + kc, len(data))

    def certified(label, qp, k2, kc, n, seconds):
        mode = select_forward(qp)[0]
        expect_launches(f"certify {label}", mode, k2, kc, n)
        launches["sesr_fast_net" if mode == "fast" else "sesr_corrected_net"][
            f"certify_{label.replace(' ', '_')}"] = (k2 + kc, n)
        print(f"[9] {label}: grade {qp.cert_grade} layers {qp.cert_stamps} (mode {mode}) over "
              f"{qp.fast_cert_images} images; certify's launches K2 {k2}, "
              f"sesr_corrected_net {kc}; {seconds:.3f} s {tag}", flush=True)
        return mode

    # 9a. the STE round and fake-quant, values and gradients, card against
    # CPU; values on the clip bounds included
    rng = np.random.default_rng(90)
    ties = 0
    for q_type, is_weight, lo, hi in ((0, True, -1.0, 1.0), (0, False, -0.7, 1.3),
                                      (1, False, -0.7, 1.3), (1, True, -0.7, 1.3)):
        x = rng.uniform(2 * lo, 2 * hi, 1 << 16).astype(np.float32)
        x[:3] = [lo, hi, 0.5]
        cot = rng.standard_normal(x.shape).astype(np.float32)
        got = {}
        for d in ("cuda", "cpu"):
            st = qat.QuantizerState(torch.tensor([lo], device=d), torch.tensor([hi], device=d),
                                    torch.ones((), dtype=torch.int32, device=d))
            xt = torch.tensor(x, device=d, requires_grad=True)
            y = qat.fake_quant(xt, st, 8, q_type, is_weight)
            y.backward(torch.tensor(cot, device=d))
            got[d] = (y.detach().cpu(), xt.grad.cpu())
        if not (torch.equal(got["cuda"][0], got["cpu"][0])
                and torch.equal(got["cuda"][1], got["cpu"][1])):
            fail(f"fake_quant q_type {q_type} weight {is_weight}: card and CPU differ")
        half = int((got["cuda"][1] == 0.5 * torch.from_numpy(cot)).sum())
        ties += half
        print(f"[9] fake_quant q_type {q_type} weight {is_weight}, {x.size} values: values and "
              f"STE gradients torch.equal card vs CPU; {half} clip-tie gradients at 0.5",
              flush=True)
    if ties == 0:
        fail("no clip-tie gradient of 0.5 (trap: torch.clamp gives 1)")

    # 9b. float training of the expanded sr_x4 at full width
    spec = spec_for_task("sr_x4")
    data = training_set("sr_x4", None, 4)
    x0, gt0 = data[0][:2]
    first = {}
    for d in ("cuda", "cpu"):
        p = init_expanded(spec, torch.Generator().manual_seed(0))
        p = ExpandedParams([ExpandedBlock(*(v.to(d).requires_grad_() for v in blk))
                            for blk in p.blocks])
        with float_exact():
            loss, _ = qat.train_loss(spec, None, p, None, torch.from_numpy(x0).to(d),
                                     torch.from_numpy(gt0).to(d))
            loss.backward()
        first[d] = (float(loss), [v.grad.cpu() for v in tensor_leaves(p)])
    rel_loss = abs(first["cuda"][0] / first["cpu"][0] - 1)
    rel_grad = max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(first["cuda"][1], first["cpu"][1]))
    print(f"[9] first train step of sr_x4 (expanded, {spec.num_channels} channels, "
          f"{spec.tmp_channels} expanded), input {x0.shape[1:3]}: loss cuda {first['cuda'][0]:.7f} "
          f"cpu {first['cpu'][0]:.7f} (rel {rel_loss:.2e}); gradients within rel {rel_grad:.2e} "
          f"of the largest", flush=True)
    if not (rel_loss <= 1e-4 and rel_grad <= 1e-4):
        fail(f"first train step card vs CPU: loss rel {rel_loss}, gradients rel {rel_grad} "
             f"(bound 1e-4)")
    train = ["train", "--task", "sr_x4", "--lr", "1e-3", "--seed", "0", "--n-images", "4"]
    with tempfile.TemporaryDirectory() as tmp:
        a, ta = timed(lambda: cli_main(train + ["--steps", str(TRAIN_STEPS)]))
        b = cli_main(train + ["--steps", str(TRAIN_STEPS)])
        state = os.path.join(tmp, "state.pt")
        cli_main(train + ["--steps", str(RESUME_AT), "--resume", state,
                          "--save-every", str(RESUME_AT)])
        c = cli_main(train + ["--steps", str(TRAIN_STEPS - RESUME_AT), "--resume", state])
    same = all(torch.equal(u, v)
               for u, v in zip(tensor_leaves(a.params), tensor_leaves(b.params)))
    resumed = c.start == RESUME_AT and all(
        torch.equal(u, v) for u, v in zip(tensor_leaves(a.params), tensor_leaves(c.params)))
    head, tail = float(np.mean(a.losses[:4])), float(np.mean(a.losses[-4:]))
    print(f"[9] train sr_x4 float, {TRAIN_STEPS} steps of Adam(1e-3) on the CLI's synthetic "
          f"pairs: {a.steps_per_second:.2f} steps/s ({ta:.3f} s with set-up) {tag}; loss "
          f"{head:.6f} -> {tail:.6f} (mean of the first and last 4 steps); two card runs "
          f"torch.equal: {same}; saved at {RESUME_AT} and resumed: torch.equal {resumed}",
          flush=True)
    if not (tail < head and same and resumed):
        fail(f"float training: loss {head} -> {tail}, deterministic {same}, resume {resumed}")
    if not torch.backends.cudnn.allow_tf32:
        fail("training left the caller's TF32 setting changed")

    # where a training step's time goes: the float and the QAT step on the
    # first training pair, and AdaRound's step (50 a call) on layer 1
    p = ExpandedParams([ExpandedBlock(*(v.detach().clone().requires_grad_() for v in blk))
                        for blk in a.params.blocks])
    batch = (torch.from_numpy(x0).to(dev), torch.from_numpy(gt0).to(dev))
    steps_of = {}
    for label, cfg in (("float", None), ("QAT", qat.QATConfig())):
        step = qat.make_train_step(spec, cfg, p, qat.adam(p, 1e-6))
        qs = qat.prepare(spec, qat.QATConfig(), dev)
        steps_of[f"train step, {label}"] = (lambda step=step, qs=qs: step(qs, batch), 1)

    def step_breakdown(what, fn, n, iters):
        wall, busy, per, events = breakdown(torch, fn, n, iters=iters)
        top = "; ".join(f"{k} {t:.4f}" for k, t in list(per.items())[:4])
        print(f"[9] where the time goes, {what}: wall {wall:.4f} ms, device busy {busy:.4f} "
              f"ms, idle share {1.0 - busy / wall:.3f}, {events:.0f} device events a step; "
              f"largest (device ms a step): {top} {tag}", flush=True)

    for what, (fn, n) in steps_of.items():
        step_breakdown(what, fn, n, 10)

    # the kernels' part after K2's and the corrected kernel's builds (its
    # float part runs first, while they build), TF32 as the caller has it
    # meanwhile
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = True
    # 9c. the QAT recipe from those weights: fine-tune, fake-quant-delta
    # collapse, calibrate (percentile, safe_zero_floor), certify, serve
    expanded = ExpandedParams([ExpandedBlock(*(v.detach().cpu() for v in blk))
                               for blk in a.params.blocks])
    held_out = list(SyntheticDataset("sr_x4", n=6, hw=(96, 128), seed=77))
    calib = make_qparams.calibration_images("sr_x4", 8)
    q, tq, k2, kc = counted(lambda: make_qparams.build_qat_artifact(
        "sr_x4", expanded, data, held_out, calib, steps=QAT_STEPS, lr=1e-4, device="cuda"))
    print(f"[9] QAT fine-tune sr_x4, {QAT_STEPS} steps of Adam(1e-4): "
          f"{QAT_STEPS / q.train_seconds:.2f} steps/s {tag}; loss {q.losses[0]:.6f} -> "
          f"{q.losses[-1]:.6f}; held-out own-float {q.float_psnr:.3f} dB, int8 "
          f"{q.int8_psnr:.3f} dB (gap {q.gap:+.3f}); recipe {tq:.3f} s", flush=True)
    certified("QAT sr_x4", q.built.qp, k2, kc, len(calib), q.built.seconds)
    sr_frames = list(SyntheticDataset("sr_x4", n=4, hw=(4 * SR4_FRAME[0], 4 * SR4_FRAME[1])))
    served("QAT sr_x4", spec, q.built.qp, sr_frames)

    # 9d. AdaRound and make_qparams from the golden bundles' float weights
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for task in ("sr_x4", "nr"):
            with np.load(os.path.join(REPO, "tests", "goldens", f"{task}.npz")) as g:
                L = int(g["num_convs"])
                paths[task] = os.path.join(tmp, f"{task}_collapsed.npz")
                np.savez(paths[task],
                         **{f"w_{i}": np.transpose(g[f"w_collapsed_{i}"], (2, 3, 1, 0))
                            for i in range(L)},
                         **{f"b_{i}": g[f"b_collapsed_{i}"] for i in range(L)})
        out = os.path.join(tmp, "built")
        built = {}
        for task in ("sr_x4", "nr"):
            res, t, k2, kc = counted(lambda: make_qparams.main(
                ["--out-dir", out, "--tasks", task, "--checkpoint", paths[task]]))
            art = res[task]
            print(f"[9] make_qparams {task} ({art.rounding}, {art.observer}), {art.images} "
                  f"calibration images: {t:.3f} s {tag}", flush=True)
            for i, layer in enumerate(art.layers):
                print(f"[9]   adaround layer {i}: {layer.seconds:.3f} s, "
                      f"{layer.moved * 100:.2f}% off nearest, calibration rounding mse "
                      f"{layer.mse_nearest:.6g} -> {layer.mse_final:.6g} {tag}", flush=True)
                if layer.mse_final > layer.mse_nearest:
                    fail(f"adaround {task} layer {i}: mse_final above mse_nearest")
            mode = certified(f"built {task}", art.qp, k2, kc, art.images, art.seconds)
            want = "fast" if task == "sr_x4" else "hybrid"
            if mode != want:
                fail(f"the built {task} artifact serves {mode}, expected {want}")
            built[task] = art
        params_sr = load_reference_checkpoint("sr_x4", path=paths["sr_x4"])
        # the calibrate command with AdaRound, on the card by default
        qp_cli, t = timed(lambda: cli_main(
            ["calibrate", "--task", "sr_x4", "--checkpoint", paths["sr_x4"], "--out",
             os.path.join(tmp, "qp_cli.npz"), "--weight-rounding", "adaround",
             "--adaround-steps", "200", "--observer", "percentile", "--no-eval"]))
    nearest, _ = quantize_weights(params_sr.weights)
    moved = [float(np.mean(q != n)) for q, n in zip(qp_cli.w_int, nearest)]
    if not all(np.abs(q.astype(np.int64) - n).max() <= 1
               for q, n in zip(qp_cli.w_int, nearest)):
        fail("calibrate --weight-rounding adaround moved a weight beyond a neighbour")
    print(f"[9] calibrate sr_x4 --weight-rounding adaround --adaround-steps 200 (percentile, "
          f"4 synthetic images): {t:.3f} s {tag}; share off nearest per layer "
          f"{[round(m, 4) for m in moved]}", flush=True)
    if len(built["sr_x4"].layers) != spec.num_convs:
        fail("the sr_x4 recipe did not run AdaRound on every layer")
    if not torch.backends.cudnn.allow_tf32:
        fail("make_qparams left the caller's TF32 setting changed")
    served("built sr_x4", spec, built["sr_x4"].qp, sr_frames)
    served("built nr", spec_for_task("nr"), built["nr"].qp,
           list(SyntheticDataset("nr", n=4, hw=BAYER_FRAME)))

    # 9e. one layer of AdaRound, card against CPU, on the same inputs
    qp0 = calibrate(spec, params_sr, calib, safe_zero_floor=True, observer="percentile",
                    device="cuda")
    states = [(torch.from_numpy(img).to(dev), None) for img in calib]
    x_in = layer_inputs(qp0, states, 0)
    states = [layer_step(xs, 0, spec.num_convs, qp0, None, True, False)[2:4] for xs in x_in]
    xs1 = torch.cat(layer_inputs(qp0, states, 1))
    r_gpu, t_gpu = timed(lambda: optimize_layer_rounding(
        params_sr.weights[1], qp0.w_scale[1], xs1, steps=ADAROUND_CHECK_STEPS))
    r_cpu = optimize_layer_rounding(params_sr.weights[1], qp0.w_scale[1], xs1.cpu(),
                                    steps=ADAROUND_CHECK_STEPS)
    differ = float(np.mean(r_gpu.w_int != r_cpu.w_int))
    print(f"[9] adaround sr_x4 layer 1 ({r_gpu.w_int.size} weights, inputs "
          f"{tuple(xs1.shape)}), {ADAROUND_CHECK_STEPS} steps: card {t_gpu:.3f} s, "
          f"{r_gpu.moved * 100:.2f}% moved, cpu {r_cpu.moved * 100:.2f}% moved; w_int differs "
          f"card vs CPU on {differ * 100:.3f}% of the weights; mse_nearest card "
          f"{r_gpu.mse_nearest:.6g} cpu {r_cpu.mse_nearest:.6g} {tag}", flush=True)
    if differ > 0.01:
        fail(f"adaround card vs CPU: {differ * 100:.2f}% of layer 1's w_int differ (bound 1%)")
    step_breakdown("AdaRound step (layer 1, 50 steps a call)", lambda: optimize_layer_rounding(
        params_sr.weights[1], qp0.w_scale[1], xs1, steps=50), 50, 2)
    torch.backends.cudnn.allow_tf32 = False
    return launches


# phase 10: the golden bundles, their model spec and residual mode
GOLDENS = ("nrdm_3", "sr_x4", "sr_x2", "nr", "dm", "nr_qat", "dm_qat", "nrdm_3_qat",
           "sr_x4_qat", "sr_x2_qat")
GOLDEN_RESIDUAL = {"nr": "graph_add", "dm": "graph_add", "nr_qat": "graph_add_qat",
                   "dm_qat": "graph_add_qat"}
EXPORT_FRAME = (80, 960)           # the reference's own sim fixture's size
HIST_BOUND = 1e-2                  # card vs CPU activation histograms, L1 / count


def golden_qparams(g, spec):
    """The port's QuantParams from a golden bundle's collapsed float
    weights and recorded min / max."""
    from sesr_tpu_torch.quant.params import CalibState, finalize, quantize_weights

    L = int(g["num_convs"])
    w_int, w_scale = quantize_weights(
        [np.transpose(g[f"w_collapsed_{i}"], (2, 3, 1, 0)) for i in range(L)])
    calib = CalibState.fresh(L + 1)
    for d in range(L + 1):
        calib.update(d, float(g[f"min_val_{d}"]), float(g[f"max_val_{d}"]))
    return finalize(spec, w_int, w_scale, [g[f"b_collapsed_{i}"] for i in range(L)], calib)


def export_phase(torch, dev, card):
    """Phase 10, the RTL vector export, ``hist`` and the experimental
    models, on the card against the CPU. Returns, per network kernel and
    path, (launches, frames)."""
    import hashlib
    import shutil
    import tempfile

    from sesr_tpu_torch.cli import export_vectors, main as cli_main, simulate
    from sesr_tpu_torch.config import spec_for_task
    from sesr_tpu_torch.data import SyntheticDataset
    from sesr_tpu_torch.data.datasets import load_reference_fixture, reference_fixture_path
    from sesr_tpu_torch.export.vectors import export_tree
    from sesr_tpu_torch.io.torch_import import load_reference_checkpoint
    from sesr_tpu_torch.models import experimental as exp
    from sesr_tpu_torch.models.sesr import CollapsedParams, init_params
    from sesr_tpu_torch.ops.kernels import pe_exact_net, reset_launch_counts
    from sesr_tpu_torch.png import read_png
    from sesr_tpu_torch.quant.integer import integer_forward, quantize_input
    from sesr_tpu_torch.quant.observers import CHART_HEIGHT, dump_histograms
    from sesr_tpu_torch.quant.params import QuantParams
    from sesr_tpu_torch.timing import median_ms

    tag = f"({card})"
    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        # 10a. every golden bundle's fixture on the card, in its residual
        # mode: every reference-generated text file, byte for byte
        compared = 0
        for name in GOLDENS:
            with np.load(os.path.join(REPO, "tests", "goldens", f"{name}.npz")) as g:
                g = dict(g)
            spec = spec_for_task(name.replace("_qat", ""))
            qp = golden_qparams(g, spec)
            bounds = ((float(g["qat_add_lo"]), float(g["qat_add_hi"]))
                      if "qat_add_lo" in g else None)
            _, dumps = integer_forward(spec, qp, g["fixture"].transpose(0, 2, 3, 1),
                                       collect_dumps=True, device=dev,
                                       residual_mode=GOLDEN_RESIDUAL.get(name, "sim"),
                                       qat_add_bounds=bounds)
            tree = export_tree(qp, {k: v.cpu().numpy() for k, v in dumps.items()},
                               list(spec.kernel_sizes))
            n = 0
            for sub, files in tree.items():
                for fname, text in files.items():
                    key = (f"e2e_txt:output_txt/input/{fname}" if sub == "end2end"
                           else f"txt:output_txt/{sub}/{fname}")
                    if key not in g:
                        fail(f"golden {name} has no {key}")
                    want = bytes(g[key])
                    if "upstream_output_crash" in g and sub == "requan_shift_n":
                        # upstream crashed writing the negative res_requant_n:
                        # the golden holds the prefix, the value is -1 at 5 bits
                        want += b"1f"
                    if text != want:
                        fail(f"export of golden {name} on the card: {sub}/{fname} differs "
                             f"({len(text)} bytes, golden {len(want)})")
                    n += 1
            compared += n
        print(f"[10] golden parity on the card: {compared} files of {len(GOLDENS)} bundles "
              f"byte-equal to the reference's", flush=True)

        # 10b. the six shipped artifacts at the reference fixture's size
        fixture = {}
        reset_launch_counts()
        k1_exports = 0
        for task in ("nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2"):
            spec, qp = spec_for_task(task), QuantParams.load(
                os.path.join(REPO, "artifacts", f"qparams_{task}.npz"))
            if os.path.exists(reference_fixture_path(task)):
                x, src = load_reference_fixture(task), reference_fixture_path(task)
            else:
                x = np.random.default_rng(10).random((1,) + EXPORT_FRAME + (spec.in_channels,),
                                                     dtype=np.float32)
                src = "seeded uniform (the reference's .pt is absent)"
            fixture[task] = x
            out = os.path.join(tmp, task)
            k0 = pe_exact_net.launches
            res = export_vectors(spec, qp, x, out, device="cuda")
            k1_exports += pe_exact_net.launches - k0
            mb = res.nbytes / 1e6
            # the card's dumps against the CPU's (the launch is not counted)
            on_card = simulate(spec, qp, x, device="cuda", keep_dumps=True).dumps
            _, on_cpu = integer_forward(spec, qp, x, collect_dumps=True, device="cpu")
            for k, v in on_cpu.items():
                if not np.array_equal(on_card[k], v.numpy()):
                    fail(f"export {task}: the interpreter's {k} on the card != the CPU's")
            xt = torch.from_numpy(x).to(dev)
            x_q = quantize_input(xt, qp).to(torch.int8).contiguous()
            k1_ms = median_ms(lambda: pe_exact_net(spec, qp, x_q), dev, 30, warmup=3,
                              lead_ms=1.0)
            wall, busy, _, events = breakdown(
                torch, lambda: integer_forward(spec, qp, xt, collect_dumps=True), 1, iters=5)
            print(f"[10] export {task} {x.shape[1:3]} ({src}): {len(res.files)} files, "
                  f"{mb:.1f} MB; K1 == interpreter; dumps array_equal with the CPU's; "
                  f"interpreter with dumps {wall:.3f} ms wall, {busy:.3f} ms device busy "
                  f"({events:.0f} device events), with the copy to the host "
                  f"{res.interpreter_seconds * 1e3:.1f} ms; K1 {k1_ms:.4f} ms device; "
                  f"formatting and writing {res.format_seconds:.3f} s, "
                  f"{mb / res.format_seconds:.1f} MB/s {tag}", flush=True)
            if task != "nrdm_6":
                shutil.rmtree(out)
        if k1_exports != 6:
            fail(f"six exports launched K1 {k1_exports} times")
        # nrdm_6, the largest tree: the CUDA export against the CPU's
        spec6, qp6 = spec_for_task("nrdm_6"), QuantParams.load(
            os.path.join(REPO, "artifacts", "qparams_nrdm_6.npz"))
        res_cpu = export_vectors(spec6, qp6, fixture["nrdm_6"], os.path.join(tmp, "cpu"),
                                 device="cpu")

        def digests(root):
            out = {}
            for d, _, names in os.walk(root):
                for n in names:
                    with open(os.path.join(d, n), "rb") as f:
                        out[os.path.relpath(os.path.join(d, n), root)] = \
                            hashlib.sha256(f.read()).hexdigest()
            return out

        on_card, on_cpu = digests(os.path.join(tmp, "nrdm_6")), digests(os.path.join(tmp, "cpu"))
        if on_card != on_cpu or len(on_card) != 61:
            fail(f"nrdm_6's export: {len(on_card)} files on the card, {len(on_cpu)} on the "
                 f"CPU, {sum(on_card.get(k) != v for k, v in on_cpu.items())} differ")
        print(f"[10] nrdm_6's tree, {len(on_card)} files: sha256 equal cuda vs cpu; the CPU "
              f"interpreter {res_cpu.interpreter_seconds:.3f} s, formatting "
              f"{res_cpu.format_seconds:.3f} s {tag}", flush=True)
        shutil.rmtree(os.path.join(tmp, "nrdm_6"))
        shutil.rmtree(os.path.join(tmp, "cpu"))
        # the command a user runs, with --fixture
        np.save(os.path.join(tmp, "x.npy"), fixture["nr"])
        reset_launch_counts()
        r = cli_main(["export", "--task", "nr", "--qparams",
                      os.path.join(REPO, "artifacts", "qparams_nr.npz"), "--fixture",
                      os.path.join(tmp, "x.npy"), "--out-dir", os.path.join(tmp, "cli")])
        if pe_exact_net.launches != 1 or len(r.files) != 40:
            fail(f"export --task nr: {pe_exact_net.launches} K1 launches, {len(r.files)} files")
        k1_exports += 1
        shutil.rmtree(os.path.join(tmp, "cli"))

        # 10c. hist from the sr_x2 and nr golden float weights: four
        # full-size frames on the card, then 272x480 on the card and the CPU
        for task, frame in (("sr_x2", (2 * FRAME[0], 2 * FRAME[1])), ("nr", BAYER_FRAME)):
            spec = spec_for_task(task)
            with np.load(os.path.join(REPO, "tests", "goldens", f"{task}.npz")) as g:
                L = int(g["num_convs"])
                params = CollapsedParams(
                    [np.transpose(g[f"w_collapsed_{i}"], (2, 3, 1, 0)) for i in range(L)],
                    [np.array(g[f"b_collapsed_{i}"]) for i in range(L)])
            images = [d[0] for d in SyntheticDataset(task, n=4, hw=frame)]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = dump_histograms(spec, params, images, os.path.join(tmp, "hist_full"),
                                   device="cuda")
            t_full = time.perf_counter() - t0
            small = [x[:, :KL_FRAME[0], :KL_FRAME[1]] for x in images]
            t0 = time.perf_counter()
            gpu = dump_histograms(spec, params, small, os.path.join(tmp, "hist_gpu"),
                                  device="cuda")
            t_gpu = time.perf_counter() - t0
            t0 = time.perf_counter()
            cpu = dump_histograms(spec, params, small, os.path.join(tmp, "hist_cpu"),
                                  device="cpu")
            t_cpu = time.perf_counter() - t0
            if not all(np.array_equal(a, b) for a, b in zip(gpu.weight + gpu.weight_quan,
                                                            cpu.weight + cpu.weight_quan)):
                fail(f"hist {task}: the weight histograms differ cuda vs cpu")
            l1 = []
            for d in range(L + 1):
                n = int(cpu.activation[d].sum())
                if int(gpu.activation[d].sum()) != n:
                    fail(f"hist {task} domain {d}: {int(gpu.activation[d].sum())} values on "
                         f"the card, {n} on the CPU")
                l1.append(float(np.abs(gpu.activation[d] - cpu.activation[d]).sum()) / n)
            rel = max(abs(a - b) / max(abs(b), 1e-30)
                      for a, b in zip(gpu.lo + gpu.hi, cpu.lo + cpu.hi))
            for path in full.files + gpu.files:
                if read_png(path).shape[0] != CHART_HEIGHT:
                    fail(f"hist {task}: {path} does not decode to a {CHART_HEIGHT}-row chart")
            print(f"[10] hist {task}: 4 frames {images[0].shape[1:3]} on the card "
                  f"{t_full:.3f} s, {len(full.files)} PNGs (each decodes); at {KL_FRAME} "
                  f"card {t_gpu:.3f} s, cpu {t_cpu:.3f} s: weight histograms equal, bounds "
                  f"within rel {rel:.2e}, activation L1 / count per domain "
                  f"{[f'{v:.2e}' for v in l1]} {tag}", flush=True)
            if max(l1) > HIST_BOUND or l1[0] != 0.0:
                fail(f"hist {task}: activation histograms cuda vs cpu L1 {l1} (input domain "
                     f"0, others {HIST_BOUND})")
            for sub in ("hist_full", "hist_gpu", "hist_cpu"):
                shutil.rmtree(os.path.join(tmp, sub))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # 10d. the experimental models on the card against the CPU (sr_x4 base)
    base = spec_for_task("sr_x4")
    gen = torch.Generator().manual_seed(3)
    paths = []
    for s in exp.inception_path_spec(base):
        pre = dataclasses.replace(s, out_channels=s.out_channels * s.scaling_factor ** 2,
                                  scaling_factor=1)
        paths.append(init_params(pre, gen))
    inception = exp.InceptionSESRParams(paths)
    rng = np.random.default_rng(11)

    def conv_p(ic, oc, k, scale=0.1):
        return CollapsedParams([rng.standard_normal((k, k, ic, oc)).astype(np.float32) * scale],
                               [rng.standard_normal(oc).astype(np.float32) * 0.01])

    t = 8
    trunk = CollapsedParams(
        [rng.standard_normal((3, 3, 2 * t, 2 * t)).astype(np.float32) * 0.05 for _ in range(3)],
        [np.zeros(2 * t, np.float32) for _ in range(3)])
    split = exp.SplitSESRParams([conv_p(1, t, 5), conv_p(1, t // 2, 5), conv_p(1, t // 2, 5)],
                                trunk, [conv_p(t, 16, 5), conv_p(t // 2, 16, 5),
                                        conv_p(t // 2, 16, 5)])
    x = rng.random((1, 64, 64, 1), dtype=np.float32)
    runs = {"inception": lambda d: exp.forward_inception(base, inception, x, device=d),
            "inception path 2": lambda d: exp.forward_inception(
                base, inception, x, single_path=True, conv_scale=2, device=d),
            "split": lambda d: exp.forward_split(base, split, x, tiny_channels=t, device=d),
            "anchor": lambda d: exp.anchor_upsample(x, 4, device=d)}
    for label, fn in runs.items():
        y_gpu, y_cpu = fn("cuda").cpu(), fn("cpu")
        err = float((y_gpu - y_cpu).abs().max())
        print(f"[10] experimental {label}: {tuple(y_gpu.shape)}, max abs cuda vs cpu {err:.3e}",
              flush=True)
        if y_gpu.shape != (1, 256, 256, 1) or not err <= 1e-5:
            fail(f"experimental {label}: shape {tuple(y_gpu.shape)}, max abs {err} (1e-5)")
    return {"sesr_pe_exact_net": {"export": (k1_exports, k1_exports)}}


SLAB_SR = 136                      # phase 11: sr_x2's slab height at 540x960, four slabs
VIRTUAL_GRIDS = ((1, 4), (2, 2))   # phase 11: sp = 4 and a 2 x 2 grid of virtual ranks


def sharding_phase(torch, dev, card):
    """Phase 11, sharded execution on the card: the sharded forwards on
    NCCL at world size 1 (NCCL takes one rank per device), every rank's
    window of a 4-card deployment in turn on this card (virtual ranks),
    slabs, and an audited stream_frames. Returns, per network kernel and
    path, (launches, frames served)."""
    import tempfile
    import warnings

    import torch.distributed as dist

    from sesr_tpu_torch.config import spec_for_task
    from sesr_tpu_torch.data import SyntheticDataset
    from sesr_tpu_torch.deploy import select_forward
    from sesr_tpu_torch.io.torch_import import load_reference_checkpoint
    from sesr_tpu_torch.models.sesr import forward_float, init_params
    from sesr_tpu_torch.ops.corrected import pe_exact_corrected_forward, split_layers
    from sesr_tpu_torch.ops.halo import halo_exchange
    from sesr_tpu_torch.ops.kernels import corrected_net, fast_net, reset_launch_counts
    from sesr_tpu_torch.ops.slab import blocks, pick_slab_h, slab_forward, window
    from sesr_tpu_torch.parallel import multihost as mh
    from sesr_tpu_torch.parallel import tiling
    from sesr_tpu_torch.parallel.launch import process_group
    from sesr_tpu_torch.quant.audit import OODSaturationWarning
    from sesr_tpu_torch.quant.calibrate import calibrate
    from sesr_tpu_torch.quant.certify import adversarial_image
    from sesr_tpu_torch.quant.integer import integer_forward, quantize_input
    from sesr_tpu_torch.quant.params import QuantParams
    from sesr_tpu_torch.timing import median_ms

    tag = f"({card})"
    kernel_of = {"fast": fast_net, "hybrid": corrected_net, "pe-exact": corrected_net}
    arts = {t: (spec_for_task(t), QuantParams.load(
        os.path.join(REPO, "artifacts", f"qparams_{t}.npz"))) for t in ("sr_x2", "nr", "nrdm_6")}
    sr_data = list(SyntheticDataset("sr_x2", n=4, hw=(2 * FRAME[0], 2 * FRAME[1])))
    nr_data = list(SyntheticDataset("nr", n=4, hw=BAYER_FRAME))
    frame = {"sr_x2": torch.from_numpy(sr_data[0][0]).to(dev),
             "nr": torch.from_numpy(nr_data[0][0]).to(dev)}
    frame["nrdm_6"] = frame["nr"]
    launches = {"sesr_fast_net": {}, "sesr_corrected_net": {}}

    def counted(fn, want, what, path, frames=1):
        """fn() with the counters at 0 before it: ``want`` launches of the
        kernels (K2, corrected); the count joins the phase's launches."""
        reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        got = (fast_net.launches, corrected_net.launches)
        if got != want:
            fail(f"[11] {what}: launches K2 / sesr_corrected_net {got}, want {want}")
        for kern, n in zip((fast_net, corrected_net), got):
            if n:
                n0, f0 = launches[kern.symbol].get(path, (0, 0))
                launches[kern.symbol][path] = (n0 + n, f0 + frames)
        return out

    def equal(got, want, what):
        if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
            fail(f"[11] {what}: differs from the monolithic forward")

    # 11a. NCCL at world size 1, through a FileStore
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as store, process_group("nccl", 0, 1, store):
        m2, m3 = tiling.make_mesh(1, 1), tiling.make_mesh_2d(1, 1, 1)
        mh3 = mh.make_mesh_multihost(n_hosts=1, dp=1, sp=1)
        mh4 = mh.make_mesh_multihost_2d(n_hosts=1, dp=1, sp_h=1, sp_w=1)
        print(f"[11] NCCL world of {dist.get_world_size()}: meshes {m2.mesh.shape} "
              f"{m3.mesh.shape} {mh3.mesh.shape} {mh4.mesh.shape} on {m2.device_type}",
              flush=True)
        for task, build, mesh in (("sr_x2", tiling.sharded_integer_forward, m2),
                                  ("nr", tiling.sharded_integer_forward_2d, m3),
                                  ("sr_x2", mh.multihost_integer_forward, mh3)):
            spec, qp = arts[task]
            want = integer_forward(spec, qp, frame[task])[0]
            equal(build(spec, qp, mesh)(frame[task]), want, f"{build.__name__} {task}")
        spec, qp = arts["nr"]
        equal(mh.multihost_tail_forward(spec, qp, mh3)(frame["nr"]),
              integer_forward(spec, qp, frame["nr"])[0], "multihost_tail_forward nr")
        print("[11] sharded_integer_forward (sr_x2), _2d (nr), multihost_integer_forward "
              "(sr_x2), multihost_tail_forward (nr): array_equal with integer_forward",
              flush=True)
        spec = arts["sr_x2"][0]
        params = init_params(spec, torch.Generator().manual_seed(0))
        got = tiling.sharded_float_forward(spec, params, m2)(frame["sr_x2"])
        got_2d = tiling.sharded_float_forward_2d(spec, params, m3)(frame["sr_x2"])
        want = forward_float(spec, params, frame["sr_x2"])
        err = max(float((g - want).abs().max()) for g in (got, got_2d))
        print(f"[11] sharded_float_forward and _2d sr_x2 {FRAME}: max abs difference from "
              f"forward_float {err:.3e}", flush=True)
        if not all(torch.allclose(g, want, rtol=1e-5, atol=1e-5) for g in (got, got_2d)):
            fail(f"[11] sharded_float_forward: {err} past rtol / atol 1e-5")
        with np.load(os.path.join(REPO, "tests", "goldens", "sr_x2.npz")) as g, \
                tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "sr_x2_collapsed.npz")
            L = int(g["num_convs"])
            np.savez(path, **{f"w_{i}": np.transpose(g[f"w_collapsed_{i}"], (2, 3, 1, 0))
                              for i in range(L)},
                     **{f"b_{i}": g[f"b_collapsed_{i}"] for i in range(L)})
            golden = load_reference_checkpoint("sr_x2", path=path)
        images = [d[0] for d in sr_data[:2]]
        tc = time.perf_counter()
        q_shard = tiling.sharded_calibrate(spec, golden, images, m2)
        tc = time.perf_counter() - tc
        q_cpu = calibrate(spec, golden, images, device="cpu")
        rel = max(abs(a / b - 1) for a, b in zip(q_shard.a_scale, q_cpu.a_scale))
        dz = max(abs(a - b) for a, b in zip(q_shard.a_zero, q_cpu.a_zero))
        print(f"[11] sharded_calibrate sr_x2, 2 frames {FRAME}: {tc:.3f} s {tag}; against the "
              f"CPU's calibrate: scales within rel {rel:.2e}, zeros within {dz}", flush=True)
        if not (rel <= 3e-3 and dz <= 2):
            fail(f"[11] sharded_calibrate: scales rel {rel} (3e-3), zeros {dz} (2) of the CPU")
        # the sharded QAT step with the percentile observer (its order
        # statistic a radix select whose counts reduce over the group): every
        # observer's state after one step equal to the unsharded step's
        from sesr_tpu_torch.models.expanded import ExpandedBlock, ExpandedParams, init_expanded
        from sesr_tpu_torch.quant import qat

        qat_blocks = init_expanded(spec, torch.Generator().manual_seed(4)).blocks
        xq = torch.from_numpy(sr_data[0][0][:, :128, :192]).to(dev)
        gq = torch.from_numpy(sr_data[0][1][:, :256, :384]).to(dev)
        states = []
        for step_of in (lambda p, o: tiling.sharded_train_step(spec, qat.QATConfig(ptq=True), p,
                                                               o, m2),
                        lambda p, o: qat.make_train_step(spec, qat.QATConfig(ptq=True), p, o)):
            p = ExpandedParams([ExpandedBlock(*(v.to(dev).requires_grad_() for v in blk))
                                for blk in qat_blocks])
            qs, loss = step_of(p, qat.adam(p, 1e-5))(qat.prepare(spec, qat.QATConfig(), dev),
                                                    (xq, gq))
            states.append([t for c in qs.convs for o in (c.act, c.weight)
                           for t in (o.min_val, o.max_val)])
        same = all(torch.equal(a, b) for a, b in zip(*states))
        print(f"[11] sharded QAT step, percentile observer (ptq=True), sr_x2 "
              f"{tuple(xq.shape[1:3])}: every observer's state torch.equal with the unsharded "
              f"step's: {same}", flush=True)
        if not same:
            fail("[11] the sharded percentile observer differs from the unsharded one")
        deploy = (
            ("sharded_deployment_forward", tiling.sharded_deployment_forward, m2, {}),
            ("sharded_deployment_forward_2d", tiling.sharded_deployment_forward_2d, m3, {}),
            ("multihost_packed_forward", mh.multihost_packed_forward, mh3, {}),
            ("multihost_packed_forward_2d", mh.multihost_packed_forward_2d, mh4, {}),
            ("multihost_tail_forward", mh.multihost_tail_forward, mh3,
             {"lowering": "deployment"}))
        for task in ("sr_x2", "nr"):
            spec, qp = arts[task]
            mode, fwd = select_forward(qp)
            want = fwd(spec, qp, frame[task])
            want8 = fwd(spec, qp, frame[task], out_dtype="int8")
            k2_kc = (1, 0) if mode == "fast" else (0, 1)
            pinned = (("sharded_packed_forward", tiling.sharded_packed_forward, m2, {}),) \
                if mode == "fast" else \
                (("sharded_hybrid_forward", tiling.sharded_hybrid_forward, m2, {}),)
            for name, build, mesh, kw in deploy + pinned:
                got = counted(lambda: build(spec, qp, mesh, **kw)(frame[task]), k2_kc,
                              f"{name} {task}", f"nccl_world1_{task}")
                equal(got, want, f"{name} {task}")
            got = counted(lambda: tiling.sharded_deployment_forward(
                spec, qp, m2, out_dtype="int8")(frame[task]), k2_kc, f"int8 {task}",
                f"nccl_world1_{task}")
            equal(got, want8, f"sharded_deployment_forward int8 {task}")
            print(f"[11] {task} ({mode}): every sharded deployment forward at world size 1 "
                  f"array_equal with the monolithic one, one launch each, f32 and int8",
                  flush=True)
        spec, qp = arts["nr"]
        want = pe_exact_corrected_forward(spec, qp, frame["nr"])
        got = counted(lambda: mh.multihost_packed_forward(spec, qp, mh3, force_mode="pe-exact")(
            frame["nr"]), (0, 1), "multihost_packed_forward pe-exact nr", "nccl_world1_nr")
        equal(got, want, "multihost_packed_forward pe-exact nr")
        if corrected_net.split_launches[split_layers(qp, "pe-exact")] != 1:
            fail("[11] forced pe-exact did not launch the pe-exact split")
        print("[11] multihost_packed_forward(force_mode='pe-exact') nr: array_equal, one "
              "pe-exact launch", flush=True)
        gloo = dist.new_group(backend="gloo")
        try:
            halo_exchange(frame["nr"], 2, gloo)
            fail("[11] a CUDA tensor on a gloo group was not refused")
        except ValueError as e:
            print(f"[11] a CUDA tensor on a gloo group raises: {e}", flush=True)

        # 11d. stream_frames at world size 1: five nr frames, the adversarial
        # frame third, audited every batch: each audit one counting launch
        # over the rank's window (its block the count region), the plain
        # interpreter barred from quant/audit.py on the card while it runs,
        # and each audit's counts and output the plain sharded audit's
        spec, qp = arts["nr"]
        adv = adversarial_image(qp, hw=BAYER_FRAME).astype(np.float32)
        stream = [d[0] for d in nr_data[:2]] + [adv] + [d[0] for d in nr_data[2:]]
        log = []
        with warnings.catch_warnings(record=True) as caught, \
                audit_on_the_kernel(torch) as audits:
            warnings.simplefilter("always", OODSaturationWarning)
            ts = time.perf_counter()
            outs = counted(lambda: [b.y for b in mh.stream_frames(
                spec, qp, mh3, stream, lowering="deployment", audit_every=1, audit_log=log)],
                (0, 6), "stream_frames nr audited", "stream_frames_nr_audited", len(stream))
            ts = time.perf_counter() - ts
        n_audit = corrected_net.audit_launches
        by_split = {m: corrected_net.split_launches[split_layers(qp, m)]
                    for m in ("hybrid", "pe-exact")}
        summary = [(i, m, None if r is None else r.ok) for i, m, r in log]
        held = check_audits(torch, spec, qp, audits, 11)
        print(f"[11] stream_frames nr, 5 frames {BAYER_FRAME}, adversarial third, audit_every=1: "
              f"log {summary}; sesr_corrected_net launches by mode {by_split}, "
              f"sesr_corrected_audit launches {n_audit} (one a window, the rank's block its "
              f"count region), each audit's counts {held} array_equal with the plain sharded "
              f"audit's (cuda); {len(caught)} OODSaturationWarning; {ts:.3f} s {tag}",
              flush=True)
        if summary != [(0, "hybrid", True), (1, "hybrid", True), (2, "hybrid", False),
                       (3, "pe-exact", None), (4, "pe-exact", None)] \
                or by_split != {"hybrid": 3, "pe-exact": 3} or len(caught) != 1 \
                or n_audit != 3 or len(audits) != 3 or not held[2][0] \
                or any(a[1] is None for a in audits):
            fail("[11] the audited stream did not degrade to pe-exact at the adversarial frame "
                 "through three windowed counting launches")
        launches["sesr_corrected_audit"] = {"stream_frames_nr_audited": (n_audit, len(stream))}
        for x, y in zip(stream, outs):
            equal(y, integer_forward(spec, qp, torch.from_numpy(x).to(dev), corrected=True)[0],
                  "stream_frames against the corrected interpreter")
        print("[11] every streamed frame array_equal with integer_forward(corrected)", flush=True)
    print(f"[11] NCCL world-size-1 part: {time.perf_counter() - t0:.1f} s", flush=True)

    # 11b. virtual ranks at full width: every rank's window in turn
    def windows_ms(kern, spec, qp, x, split, h_blocks, w_blocks):
        """Device ms of the kernel on each window, and on the whole frame."""
        x_q = quantize_input(x, qp).to(torch.int8).contiguous()
        R = spec.halo_width()
        H, W = x_q.shape[1:3]
        per = []
        for ha, hb in h_blocks:
            for wa, wb in w_blocks:
                (h0, h1), (w0, w1) = window(ha, hb, H, R), window(wa, wb, W, R)
                win = x_q[:, h0:h1, w0:w1].contiguous()
                per.append(median_ms(lambda: kern(spec, qp, win, split=split), dev, 20,
                                     warmup=2, lead_ms=1.0))
        mono = median_ms(lambda: kern(spec, qp, x_q, split=split), dev, 20, warmup=2,
                         lead_ms=1.0)
        return per, mono

    t0 = time.perf_counter()
    runs = [("nr", None, g, "f32") for g in VIRTUAL_GRIDS] + \
        [("nrdm_6", None, g, "f32") for g in VIRTUAL_GRIDS] + \
        [("nr", "pe-exact", (1, 4), "f32")] + \
        [("sr_x2", None, g, dt) for g in VIRTUAL_GRIDS for dt in ("f32", "int8")]
    for task, force, grid, out_dtype in runs:
        spec, qp = arts[task]
        mode, fwd = ("pe-exact", pe_exact_corrected_forward) if force else select_forward(qp)
        kern = kernel_of[mode]
        split = split_layers(qp, mode) if kern is corrected_net else None
        x = frame[task]
        want = fwd(spec, qp, x, out_dtype=out_dtype)
        n_win = grid[0] * grid[1]
        got = counted(lambda: tiling.virtual_rank_forward(spec, qp, x, grid, fwd, out_dtype),
                      (n_win, 0) if kern is fast_net else (0, n_win),
                      f"virtual ranks {task} {grid}", f"virtual_ranks_{task}_{mode}")
        equal(got, want, f"virtual ranks {task} {mode} {grid} {out_dtype}")
        H, W = x.shape[1:3]
        per, mono = windows_ms(kern, spec, qp, x, split, blocks(H, grid[0]), blocks(W, grid[1]))
        e2e = median_ms(lambda: tiling.virtual_rank_forward(spec, qp, x, grid, fwd, out_dtype),
                        dev, 10, warmup=2)
        e2e_mono = median_ms(lambda: fwd(spec, qp, x, out_dtype=out_dtype), dev, 10, warmup=2)
        print(f"[11] virtual ranks {task} {mode} {H}x{W} grid {grid[0]}x{grid[1]} {out_dtype}: "
              f"array_equal, {n_win} launches; {kern.symbol} device ms per window "
              f"{[round(t, 4) for t in per]}, largest / monolithic {max(per) / mono:.3f}, "
              f"sum {sum(per):.4f} vs monolithic {mono:.4f} ms ({sum(per) / mono:.3f}x); "
              f"end to end as the host issues them {e2e:.4f} vs {e2e_mono:.4f} ms {tag}",
              flush=True)

    # 11c. slabs
    for task, slab_h in (("nr", None), ("nrdm_6", None), ("sr_x2", SLAB_SR)):
        spec, qp = arts[task]
        mode, fwd = select_forward(qp)
        kern = kernel_of[mode]
        split = split_layers(qp, mode) if kern is corrected_net else None
        x = frame[task]
        H, W = x.shape[1:3]
        slab_h = slab_h or pick_slab_h(spec, H)
        h_blocks = [(a, min(a + slab_h, H)) for a in range(0, H, slab_h)]
        want = fwd(spec, qp, x)
        got = counted(lambda: slab_forward(spec, qp, x, slab_h),
                      (len(h_blocks), 0) if kern is fast_net else (0, len(h_blocks)),
                      f"slabs {task}", f"slabs_{task}")
        equal(got, want, f"slab_forward {task}")
        per, mono = windows_ms(kern, spec, qp, x, split, h_blocks, [(0, W)])
        e2e = median_ms(lambda: slab_forward(spec, qp, x, slab_h), dev, 10, warmup=2)
        e2e_mono = median_ms(lambda: fwd(spec, qp, x), dev, 10, warmup=2)
        print(f"[11] slab_forward {task} {mode} {H}x{W}, slab_h {slab_h}: array_equal, "
              f"{len(h_blocks)} launches; {kern.symbol} device ms per slab "
              f"{[round(t, 4) for t in per]}, sum {sum(per):.4f} vs monolithic {mono:.4f} ms "
              f"({sum(per) / mono:.3f}x); end to end as the host issues them {e2e:.4f} vs "
              f"{e2e_mono:.4f} ms {tag}", flush=True)
    print(f"[11] virtual ranks and slabs: {time.perf_counter() - t0:.1f} s", flush=True)
    return launches


# phase 12: tests/test_hwconfig_sweep.py's four HardwareConfigs (copied:
# this script imports no JAX) and its 8-channel sweep net, whose sparse
# weights certify fully (K2) where the golden networks do not; then the
# rest of the family (tests/test_torch_hwconfig_family.py): 16 PEs, 16 PEs
# whose 24-bit adder lets |pe_add + bias| pass 2^22 (every kernel's wide
# form), and 6- and 4-bit activations
HW_CONFIGS = {"pe2_narrow": dict(pe=2, pe_acc_bits=16, pe_add_bits=18, bias_bits=12,
                                 requant_bits=12, requant_n_max=24),
              "pe8_wide": dict(pe=8, pe_acc_bits=20, pe_add_bits=22),
              "pe3_nondivisible": dict(pe=3),
              "pe2_servable": dict(pe=2, bias_bits=12, requant_bits=12, requant_n_max=24),
              "pe16": dict(pe=16),
              "pe16_wide": dict(pe=16, pe_acc_bits=20, pe_add_bits=24),
              "q6": dict(quan_bits=6),
              "q4": dict(quan_bits=4)}
NEW_CONFIGS = ("pe16", "pe16_wide", "q6", "q4")
SWEEP_NET = dict(name="sweep", in_channels=3, out_channels=3, num_channels=8, num_lblocks=2)
CERT_FRAME = (96, 128)             # phase 12's certification frames


def hwconfig_phase(torch, dev, card):
    """Phase 12, the HardwareConfig family on the card: at each of the four
    configs, the sr_x2 and nr golden float weights and the sparse sweep net
    calibrated on the card (the goldens on their calibration images),
    certified on two 96x128 frames, saved and reloaded; then, with the
    launch counters at 0 before and read after, served at CUT_SIZE (sr_x2
    270x480 in, nr and the sweep net 540x960) at batch 1 and 4
    through the mode the certificate selects, simulated (K1) and simulated
    --corrected; every output array_equal with the plain interpreter on the
    card, and ``infer --qparams`` on the goldens cuda against cpu; nr
    served with ``--audit 1`` (its audits on the counting kernel, held to
    the plain interpreter) and one launch of the counting form on its
    first frame. Then each kernel's device time per frame at each config
    (K1 on sr_x2, the corrected kernel on nr, K2 on a network the config
    certifies fully), ptxas's registers and spills and its ratio to the
    same kernel on the same network calibrated at the reference point (4
    PEs). A generator: it yields after its checks, and ``finish`` runs the
    times and returns the kernels-line entries of every (kernel, config)
    pair and, for CUPTI's registers and shared memory in phase 14's
    process of its own, the new configs' timed launches as jobs."""
    import tempfile

    from sesr_tpu_torch.cli import main as cli_main
    from sesr_tpu_torch.cli import serve, simulate
    from sesr_tpu_torch.config import HardwareConfig, SESRSpec, spec_for_task
    from sesr_tpu_torch.convert import clamp20_layers, kernel_constants
    from sesr_tpu_torch.data import SyntheticDataset
    from sesr_tpu_torch.deploy import select_forward
    from sesr_tpu_torch.io.torch_import import load_reference_checkpoint
    from sesr_tpu_torch.models.sesr import CollapsedParams, init_params
    from sesr_tpu_torch.ops.corrected import split_layers
    from sesr_tpu_torch.ops.kernels import (NET_KERNELS, corrected_net, fast_net, pe_exact_net,
                                            reset_launch_counts)
    from sesr_tpu_torch.ops.slab import slab_forward
    from sesr_tpu_torch.parallel.tiling import virtual_rank_forward
    from sesr_tpu_torch.quant.calibrate import calibrate
    from sesr_tpu_torch.quant.certify import certify_fast
    from sesr_tpu_torch.quant.integer import integer_forward, quantize_input
    from sesr_tpu_torch.quant.params import QuantParams
    from sesr_tpu_torch.timing import median_ms

    tag = f"({card})"
    t_phase = time.perf_counter()
    configs = {k: HardwareConfig(**v) for k, v in HW_CONFIGS.items()}
    nets = {}
    with tempfile.TemporaryDirectory() as tmp:
        for task in ("sr_x2", "nr"):
            with np.load(os.path.join(REPO, "tests", "goldens", f"{task}.npz")) as g:
                L = int(g["num_convs"])
                path = os.path.join(tmp, f"{task}_collapsed.npz")
                np.savez(path, **{f"w_{i}": np.transpose(g[f"w_collapsed_{i}"], (2, 3, 1, 0))
                                  for i in range(L)},
                         **{f"b_{i}": g[f"b_collapsed_{i}"] for i in range(L)})
                calib = [g[f"calib_img_{j}"].transpose(0, 2, 3, 1)
                         for j in range(int(g["n_calib"]))]
            out_hw = CUT_SIZE                # sr_x2's output and nr's frame
            nets[task] = (spec_for_task(task), load_reference_checkpoint(task, path=path),
                          calib, False, list(SyntheticDataset(task, n=4, hw=out_hw)))
    # the sweep net (tests/test_hwconfig_sweep.py _params_sparse's recipe: the
    # largest tenth of each tensor's weights kept) on the nr frames
    sweep = SESRSpec(**SWEEP_NET)
    base = init_params(sweep, torch.Generator().manual_seed(0))
    sparse = []
    for w in base.weights:
        a = w.numpy()
        sparse.append(a * (np.abs(a) >= np.quantile(np.abs(a), 0.9)))
    rng = np.random.default_rng(12)
    nets["sweep"] = (sweep, CollapsedParams(sparse, [b.numpy() for b in base.biases]),
                     [rng.random((1, 24, 32, 3), dtype=np.float32) for _ in range(2)], True,
                     nets["nr"][4])
    plain_of = {"fast": lambda q: dict(corrected=True, compute="fast"),
                "hybrid": lambda q: dict(corrected=True, fast_layers=tuple(q.fast_cert_layers)),
                "pe-exact": lambda q: dict(corrected=True)}

    def artifact(task, cname, hw, tmp):
        """calibrate, certify, save and reload: the artifact a user builds."""
        spec, params, calib, floor, _ = nets[task]
        qp = calibrate(spec, params, calib, hw=hw, safe_zero_floor=floor, device="cuda")
        cert = [d[0] for d in SyntheticDataset("nr" if task == "sweep" else task, n=2,
                                               hw=CERT_FRAME)]
        qp = certify_fast(spec, qp, cert, device="cuda")
        path = os.path.join(tmp, f"qparams_{task}_{cname}.npz")
        qp.save(path)
        back = QuantParams.load(path)
        if back.hw != hw or back.cert_stamps != qp.cert_stamps:
            fail(f"[12] {task}: the saved artifact reloads as {back.hw} {back.cert_stamps}")
        return back, path

    def equal(got, want, what):
        if got.shape != want.shape or not np.array_equal(got, want):
            fail(f"[12] {what}: differs from the plain interpreter")

    def audited_nr(spec, qp, data, mode, x0, cname):
        """nr served with ``--audit 1`` (``serve(audit_every=1)``, the
        launch counters at 0 before it): every audit on the counting
        kernel, held to the plain interpreter after the stream, one
        counting launch an audited frame, each frame the plain version's of
        the mode it was served in (pe-exact from a violation on); then one
        launch of the counting form on the first frame (``audit_check``),
        which runs even where the certificate trusts no layer empirically
        and the stream audits nothing. Returns the line's summary."""
        with audit_on_the_kernel(torch) as audits:
            reset_launch_counts()
            res = serve(spec, qp, data, batch=1, device="cuda", audit_every=1,
                        keep_outputs=True)
            torch.cuda.synchronize()
            ka = corrected_net.audit_launches
        held = check_audits(torch, spec, qp, audits, 12)
        first = res.violations[0][0] if res.violations else len(data)
        for k, ((x, _), y) in enumerate(zip(data, res.outputs)):
            kw = plain_of[mode](qp) if k < first else dict(corrected=True)
            want_y = integer_forward(spec, qp, torch.from_numpy(x).to(dev), **kw)[0]
            equal(y, want_y[0].cpu().numpy(), f"nr {cname} --audit 1 frame {k}")
        if ka != res.audited or len(audits) != ka:
            fail(f"[12] nr {cname} --audit 1: {res.audited} audited, {ka} counting launches, "
                 f"{len(audits)} audits recorded")
        got = audit_check(torch, spec, qp, x0, f"{cname}, frame 0", 12)
        audit_launches[cname] = (ka + 1, len(data) + 1)
        return (f"; --audit 1: {res.audited} audited ({ka} counting launches, counts {held}), "
                f"violations {res.violations}, served {res.mode} at the end; the counting form "
                f"on frame 0: counts {got.tolist()}")

    launches = {k.symbol: {} for k in NET_KERNELS}
    audit_launches = {}
    arts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for cname, hw in {"pe4": HardwareConfig(), **configs}.items():
            t_art = time.perf_counter()
            for task in ("sr_x2", "nr", "sweep"):
                arts[cname, task] = artifact(task, cname, hw, tmp)
            print(f"[12] {cname}: three artifacts built in {time.perf_counter() - t_art:.1f} s",
                  flush=True)
            if cname == "pe4":
                continue
            for task in ("sr_x2", "nr", "sweep"):
                t_task, st = time.perf_counter(), Steps()
                spec, _, _, _, data = nets[task]
                qp, path = arts[cname, task]
                # the main path at this config, counters at 0 before it
                reset_launch_counts()
                r1 = serve(spec, qp, data, batch=1, device="cuda", keep_outputs=True)
                r4 = serve(spec, qp, data, batch=4, device="cuda", keep_outputs=True)
                sim = simulate(spec, qp, data[0][0], device="cuda")
                sim_c = simulate(spec, qp, data[0][0], device="cuda", corrected=True)
                torch.cuda.synchronize()
                st("serve and sim")
                got = {k.symbol: k.launches for k in NET_KERNELS}
                mode = r1.mode
                want = {"sesr_pe_exact_net": 1, "sesr_fast_net": 5 * (mode == "fast"),
                        "sesr_corrected_net": 1 + 5 * (mode != "fast")}
                if got != want or r4.mode != mode:
                    fail(f"[12] {task} {cname}: mode {mode} / {r4.mode}, launches {got}, "
                         f"want {want}")
                for sym, n in got.items():
                    if n:
                        n0, f0 = launches[sym].get(cname, (0, 0))
                        frames = 1 if sym == "sesr_pe_exact_net" else \
                            (8 if sym == "sesr_fast_net" else 8 * (mode != "fast") + 1)
                        launches[sym][cname] = (n0 + n, f0 + frames)
                # the same outputs from the plain interpreter on the card
                x4 = torch.from_numpy(np.concatenate([d[0] for d in data])).to(dev)
                want_y = integer_forward(spec, qp, x4, **plain_of[mode](qp))[0].cpu().numpy()
                equal(np.stack(r1.outputs), want_y, f"{task} {cname} {mode} batch 1")
                equal(np.stack(r4.outputs), want_y, f"{task} {cname} {mode} batch 4")
                del want_y
                x0 = x4[:1]
                equal(sim.y.cpu().numpy(), integer_forward(spec, qp, x0)[0].cpu().numpy(),
                      f"{task} {cname} sim")
                equal(sim_c.y.cpu().numpy(),
                      integer_forward(spec, qp, x0, corrected=True)[0].cpu().numpy(),
                      f"{task} {cname} sim --corrected")
                st("plain")
                # the same frame as four slabs and as a 2 x 2 grid of virtual
                # ranks (each window R = spec.halo_width() past its cuts)
                mono = select_forward(qp)[1](spec, qp, x0).cpu().numpy()
                slab_h = -(-x0.shape[1] // 8) * 2
                equal(slab_forward(spec, qp, x0, slab_h=slab_h).cpu().numpy(), mono,
                      f"{task} {cname} {mode} slabs of {slab_h} rows")
                equal(virtual_rank_forward(spec, qp, x0, (2, 2)).cpu().numpy(), mono,
                      f"{task} {cname} {mode} 2 x 2 virtual ranks")
                st("slabs and ranks")
                cli = ""
                if task != "sweep":
                    args = ["infer", "--task", task, "--qparams", path, "--n-images", "2"]
                    a_gpu, a_cpu = cli_main(args), cli_main(args + ["--device", "cpu"])
                    if (a_gpu.mode, a_gpu.psnr) != (a_cpu.mode, a_cpu.psnr) or \
                            a_gpu.mode != mode:
                        fail(f"[12] infer --qparams {task} {cname}: cuda {a_gpu.mode} "
                             f"{a_gpu.psnr}, cpu {a_cpu.mode} {a_cpu.psnr}, served {mode}")
                    cli = f"; infer --qparams cuda == cpu ({mode}, psnr {a_gpu.mean_psnr:.4f})"
                    st("infer cuda and cpu")
                if task == "nr":
                    cli += audited_nr(spec, qp, data, mode, x0, cname)
                    st("--audit 1")
                kc1 = kernel_constants(spec, qp, "exact")
                print(f"[12] {task} {cname} {qp.hw}: certificate {qp.cert_grade} "
                      f"{qp.cert_stamps}, mode {mode}; served 4 frames "
                      f"{tuple(x4.shape[1:3])} at batch 1 and 4, sim and sim --corrected: "
                      f"array_equal with plain (cuda); slabs of {slab_h} rows and 2 x 2 "
                      f"virtual ranks equal the served frame; launches {got}; K1 split "
                      f"{kc1.pe_split}, general {kc1.general}{cli}; "
                      f"{time.perf_counter() - t_task:.1f} s ({st})", flush=True)
                del x4
        # the forms the served paths may not reach at a config: the corrected
        # kernel with every layer split (its pe_groups column groups), and a
        # saturating nr (convs 0, 1 and the last at +127: the accumulator
        # clamp fires on split layers, and at 8 PEs the adder clamp) through
        # K1 and the corrected kernel, each against its plain version (at the
        # new configs the clamps' events are printed: at 16 PEs with 20-bit
        # accumulators a one-channel PE's sum cannot reach them, and 4- and
        # 6-bit activations keep the sums small)
        nr_spec = nets["nr"][0]
        L = nr_spec.num_convs
        for cname in configs:
            qp = arts[cname, "nr"][0]
            sat = dataclasses.replace(qp, w_int=[
                np.full_like(np.asarray(w), 127) if i in (0, 1, L - 1) else np.asarray(w)
                for i, w in enumerate(qp.w_int)])
            for shape in ((2, 27, 45), (1, 37, 53)):
                x = torch.from_numpy(rng.random(shape + (3,), dtype=np.float32)).to(dev)
                for what, cqp, kern, split in (
                        ("all split", qp, corrected_net, (True,) * L),
                        ("saturating", sat, pe_exact_net, None),
                        ("saturating, all split", sat, corrected_net, (True,) * L),
                        ("saturating pe-exact", sat, corrected_net,
                         split_layers(sat, "pe-exact"))):
                    x_q = quantize_input(x, cqp).to(torch.int8).contiguous()
                    out = kern(nr_spec, cqp, x_q, split=split)
                    kw = dict(corrected=False) if split is None else \
                        dict(corrected=True, fast_layers=tuple(not f for f in split))
                    _, dumps = integer_forward(nr_spec, cqp, x, collect_dumps=True, **kw)
                    if not torch.equal(out, dumps[f"input.{L}"].to(torch.int8)):
                        fail(f"[12] {kern.symbol} nr {cname} {what} {shape}: differs from plain")
                    kc = kernel_constants(nr_spec, cqp, kern.datapath, split)
                    ovf18, ovf20 = dumps["overflow_18"].tolist(), dumps["overflow_20"].tolist()
                    if cname not in NEW_CONFIGS and (
                            what.startswith("saturating") and not any(ovf18) or
                            (what.startswith("saturating") and cqp.hw.pe == 8 and not any(ovf20))):
                        fail(f"[12] nr {cname} {what}: the clamps did not fire ({ovf18}, {ovf20})")
                    print(f"[12] {kern.symbol} nr {cname} {what} {shape}: array_equal with "
                          f"plain (cuda); split {kc.pe_split}, overflow_18 {ovf18}, "
                          f"overflow_20 {ovf20}", flush=True)
        # K2's general instantiation (a conv 0 that can reach the adder
        # clamp, as at pe2_narrow's 18 bits; activations off int8; sums that
        # may pass 2^22): sr_x2 at each config where it is so, held to the
        # fast datapath's plain version (the certificate is set here only so
        # that the plain version runs; the kernel does not read it)
        k2_general = []
        for cname in configs:
            spec, qp = nets["sr_x2"][0], arts[cname, "sr_x2"][0]
            cqp = dataclasses.replace(qp, fast_cert_ok=True)
            kc = kernel_constants(spec, cqp, "fast")
            if not kc.general:
                continue
            x = torch.from_numpy(rng.random((2, 37, 53, 3), dtype=np.float32)).to(dev)
            out = fast_net(spec, cqp, quantize_input(x, cqp).to(torch.int8).contiguous())
            _, dumps = integer_forward(spec, cqp, x, collect_dumps=True, corrected=True,
                                       compute="fast")
            if not (kc.general and torch.equal(out, dumps[f"input.{spec.num_convs}"]
                                               .to(torch.int8))):
                fail(f"[12] sesr_fast_net sr_x2 {cname}, general {kc.general}: differs from "
                     f"plain")
            k2_general.append(cname)
            print(f"[12] sesr_fast_net sr_x2 {cname} (2, 37, 53), conv 0 can reach the adder "
                  f"clamp {clamp20_layers(qp)[0]}, quan_bits {qp.hw.quan_bits}, wide sums "
                  f"{kc.wide}: general instantiation, array_equal with "
                  f"plain (cuda); overflow_20 {dumps['overflow_20'].tolist()}", flush=True)
        if not k2_general or not set(k2_general) & set(NEW_CONFIGS):
            fail(f"[12] K2's general instantiation ran at {k2_general}, at no new config")
    fast_at = {c: [t for t in ("sr_x2", "sweep") if arts[c, t][0].fast_cert_ok]
               for c in ["pe4", *configs]}
    print(f"[12] fully certified (K2): {fast_at}", flush=True)
    for sym in launches:
        if not launches[sym]:
            fail(f"[12] {sym} launched at no alternate config")
    checks = time.perf_counter() - t_phase
    yield                            # the times after the builds (``finish``)
    t_phase = time.perf_counter()

    # timing: each kernel at each config, against the same kernel on the same
    # network at the reference point
    def timed(kern, cname, task, mode=None):
        """(device ms per frame, tile, constants, frame) of kern on the
        network of ``task`` at config ``cname``. (CUPTI's registers and
        shared memory of the new configs' launches: phase 14's process; a
        trace this late in the run misses them.)"""
        spec, _, _, _, data = nets[task]
        qp = arts[cname, task][0]
        x = torch.from_numpy(data[0][0]).to(dev)
        split = split_layers(qp, mode) if kern is corrected_net else None
        kc = kernel_constants(spec, qp, kern.datapath, split)
        x_q = quantize_input(x, qp).to(torch.int8).contiguous()
        fn = (lambda: kern(spec, qp, x_q, split=split))
        ms = median_ms(fn, dev, 30, warmup=3, lead_ms=1.0)
        return ms, kern.tile(spec, kc.pe_split, kc.pe, kc.general), kc, x

    entries, jobs = [], []
    cupti_dir = os.path.join(REPO, "build", "chip_smoke_cupti")
    os.makedirs(cupti_dir, exist_ok=True)
    cases = [(pe_exact_net, "sr_x2", None), (corrected_net, "nr", "pe-exact"),
             (corrected_net, "nr", "hybrid")]
    at_pe4 = {}                      # each kernel's 4-PE time, taken once
    for cname in configs:
        for kern, task, mode in cases + [(fast_net, t, None) for t in fast_at[cname][:1]]:
            spec = nets[task][0]
            qp = arts[cname, task][0]
            if mode == "hybrid" and not any(qp.fast_cert_layers or ()):
                continue
            ms, tile, kc, x = timed(kern, cname, task, mode)
            ref = "not measured (the reference point does not certify it)"
            if kern is not fast_net or task in fast_at["pe4"]:
                if mode != "hybrid" or any(arts["pe4", task][0].fast_cert_layers or ()):
                    if (kern.symbol, task, mode) not in at_pe4:
                        at_pe4[kern.symbol, task, mode] = timed(kern, "pe4", task, mode)[0]
                    ms4 = at_pe4[kern.symbol, task, mode]
                    ref = f"{ms / ms4:.4f} (at 4 PEs {ms4:.4f} ms)"
            kw = plain_kwargs(kern, qp, mode)
            # one timed call of the plain version, warm from the main path
            plain_ms = median_ms(lambda: integer_forward(spec, qp, x, **kw), dev, 1, warmup=0)
            weights = sum(int(np.prod(np.shape(w))) for w in qp.w_int)
            n, h, w = x.shape[:3]
            macs = weights * n * h * w
            moved = n * h * w * (spec.in_channels + spec.conv_out_channels) + weights
            bnd = bound(2 * macs, moved, INT8_OPS_PER_S)
            count, tc_macs, instr = tensor_count(kern, spec, kc.pe_split, n, h, w, tile, kc.pe)
            n_launch, n_frames = launches[kern.symbol].get(cname, (0, 0))
            key_p, (p_regs, p_spill) = ptxas_line(kern, spec, kc)
            label = f"{kern.symbol} {task}{f' {mode}' if mode else ''} {cname}"
            key = f"{cname}, {mode}" if mode else cname
            print(f"[12] {label}: {ms:.4f} ms/frame at {h}x{w}, tile {tile[0]}x{tile[1]}, "
                  f"{'general' if kc.general else 'shipped'} instantiation, per-PE passes on "
                  f"convs {[i for i in range(spec.num_convs) if kc.pe_split[i]]}; "
                  f"ptxas {key_p}: {p_regs} registers, {p_spill} B spill stores; "
                  f"{count} {instr} per frame ({tc_macs / macs:.3f}x the network's MACs, "
                  f"computed from the tile geometry); ratio to the same kernel at 4 PEs {ref}; "
                  f"plain {plain_ms:.3f} ms; launches on the phase's path {n_launch} "
                  f"{tag}", flush=True)
            entries.append(dict(
                name=f"{kern.symbol}[{key}]", route="cuda", source=SOURCES[kern.symbol],
                replaces=REPLACES[kern.symbol], launches=n_launch,
                launches_per_frame={cname: n_launch / n_frames if n_frames else 0.0},
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=None, config=cname,
                work=f"{spec.name}, {(h, w)} frame, batch 1{f', {mode} mode' if mode else ''}, "
                     f"{HW_CONFIGS[cname]}"))
            if cname in NEW_CONFIGS:
                qp_path = os.path.join(cupti_dir, f"hw_{cname}_{task}.npz")
                qp.save(qp_path)
                jobs.append(dict(label=label, spec=dataclasses.asdict(spec), qparams=qp_path,
                                 symbol=kern.symbol, mode=mode, tile=list(tile),
                                 pattern=kernel_family(kern, kc),
                                 plan=kern.smem_bytes(spec, tile, kc.pe_split, kc.pe,
                                                      kc.general)))
        # the counting form at each new config, on nr's first frame: its
        # time beside the served PE-exact kernel's, and its registers and
        # shared memory (CUPTI in phase 14's process)
        if cname in NEW_CONFIGS:
            spec, qp = nets["nr"][0], arts[cname, "nr"][0]
            entries.append(audit_entry(
                torch, dev, spec, qp, torch.from_numpy(nets["nr"][4][0][0]).to(dev),
                f"sesr_corrected_audit[nr, {cname}]", tag, 12, audit_launches[cname]))
            kc = kernel_constants(spec, qp, "corrected", split_layers(qp, "pe-exact"))
            tile = corrected_net.tile(spec, kc.pe_split, kc.pe, kc.general)
            qp_path = os.path.join(cupti_dir, f"hw_{cname}_nr_audit.npz")
            qp.save(qp_path)
            jobs.append(dict(label=f"sesr_corrected_audit nr {cname}",
                             spec=dataclasses.asdict(spec), qparams=qp_path,
                             symbol=corrected_net.symbol, mode="pe-exact", audit=True,
                             pattern=kernel_family(corrected_net, kc, audit=True),
                             tile=list(tile),
                             plan=corrected_net.smem_bytes(spec, tile, kc.pe_split, kc.pe,
                                                           kc.general)))
    print(f"[12] the hwconfig phase took {checks:.1f} s for its checks and "
          f"{time.perf_counter() - t_phase:.1f} s for its times {tag}", flush=True)
    return entries, jobs


# phase 14: the SESR paper's deepest and widest members (Bhardwaj et al.,
# "Collapsible Linear Blocks for Super-Efficient Super Resolution", MLSys
# 2022): SESR-M11 x2 (13 convs, 16 channels) and SESR-XL x2 (13 convs, 32
# channels), from seeded weights (the published checkpoints are not in the
# repository), at the sr_x2 frame
FAMILY_NETS = {"m11": dict(name="sesr_m11_x2", in_channels=3, out_channels=3, num_channels=16,
                           num_lblocks=11, scaling_factor=2),
               "xl": dict(name="sesr_xl_x2", in_channels=3, out_channels=3, num_channels=32,
                          num_lblocks=11, scaling_factor=2)}
# the unstamped M11 and XL: these convs' weights at +127, so that the 18-bit
# clamp fires on data there and the certificate leaves them unstamped
SATURATED = (3, 9)
# XL at 8 PEs with 12-bit accumulators: every conv split in K1 and in the
# corrected kernel (a split hidden layer's 256 columns in two chunks)
XL_PE8 = dict(pe=8, pe_acc_bits=12)
# M11 at pe16_wide with these convs at +127: conv 2 drives every channel of
# conv 3's input, and conv 11 the last conv's, to the top of its range, so
# that conv 3's corrected sum (144 x 127 x 255 = 4.66e6) and the last conv's
# (400 x 127 x 127 on the reference datapath) pass 2^22 (the wide form)
WIDE_SATURATED = (2, 3, 11, 12)
# phase 15: the SESR paper's Y-channel networks (x2: the Y channel in, 4
# outputs before the shuffle, at SESR-M5's and SESR-XL's widths and depths),
# and RGB networks at x3 (27 outputs) and x4 (48, the widest output of an
# RGB SESR up to x4) at SESR-M5's, and at x4 at SESR-XL's, from seeded
# weights, each at the input size whose output is 1080x1920 (out_frame)
OUT_NETS = {"sesr_m5_x2_y": dict(name="sesr_m5_x2_y", in_channels=1, out_channels=1,
                                 num_channels=16, num_lblocks=5, scaling_factor=2),
            "sesr_xl_x2_y": dict(name="sesr_xl_x2_y", in_channels=1, out_channels=1,
                                 num_channels=32, num_lblocks=11, scaling_factor=2),
            "sesr_m5_x3_rgb": dict(name="sesr_m5_x3_rgb", in_channels=3, out_channels=3,
                                   num_channels=16, num_lblocks=5, scaling_factor=3),
            "sesr_m5_x4_rgb": dict(name="sesr_m5_x4_rgb", in_channels=3, out_channels=3,
                                   num_channels=16, num_lblocks=5, scaling_factor=4),
            "sesr_xl_x4_rgb": dict(name="sesr_xl_x4_rgb", in_channels=3, out_channels=3,
                                   num_channels=32, num_lblocks=11, scaling_factor=4)}
OUT_SIZE = (1080, 1920)
# phase 15's sweep of the instantiations of a last conv past the shipped
# counts that the main path leaves unlaunched, on a small batch: K1 and K2
# at each padded count (out_cols 8, 16, 32, 48), width and form (general
# and wide), the corrected kernel's served and counting forms past 16
# outputs at each PE group count, width and form; OUT_NETS and the Y
# channel at x3 (9 outputs) at both widths and RGB at x3 at SESR-XL's, each
# calibrated at 4 PEs on the card and run at the configs of SWEEP_HW
SWEEP_NETS = {"sesr_m5_x3_y": dict(name="sesr_m5_x3_y", in_channels=1, out_channels=1,
                                   num_channels=16, num_lblocks=5, scaling_factor=3),
              "sesr_xl_x3_y": dict(name="sesr_xl_x3_y", in_channels=1, out_channels=1,
                                   num_channels=32, num_lblocks=11, scaling_factor=3),
              "sesr_xl_x3_rgb": dict(name="sesr_xl_x3_rgb", in_channels=3, out_channels=3,
                                     num_channels=32, num_lblocks=11, scaling_factor=3)}
WIDE_SUMS = dict(pe_acc_bits=20, pe_add_bits=24)
SWEEP_HW = {"pe4": {}, "pe4_wide": WIDE_SUMS, "pe8": dict(pe=8),
            "pe8_wide": dict(pe=8, **WIDE_SUMS), "pe16": dict(pe=16),
            "pe16_wide": dict(pe=16, **WIDE_SUMS)}
SWEEP_BATCH = (2, 27, 45)


# phase 16: networks deeper than one launch of any kernel runs (Bhardwaj
# et al., MLSys 2022: SESR-M11's width 16 at m = 16 linear blocks, and
# SESR-XL's width 32 at m = 22), x2 RGB at cut_frame's 270x480, from seeded
# weights, each run as a chain of layer groups
DEEP_NETS = {"m16": dict(name="sesr_m16_x2", in_channels=3, out_channels=3, num_channels=16,
                         num_lblocks=16, scaling_factor=2),
             "xl22": dict(name="sesr_xl22_x2", in_channels=3, out_channels=3, num_channels=32,
                          num_lblocks=22, scaling_factor=2)}


def out_frame(spec):
    """The input frame whose output is OUT_SIZE."""
    return OUT_SIZE[0] // spec.scaling_factor, OUT_SIZE[1] // spec.scaling_factor


# the output frame of phases 12 and 15-18 (half OUT_SIZE's height and
# width), cut to keep the script within its time: their checks hold at any
# frame, and phases 4-11, 13, 14 and 19 run the full one
CUT_SIZE = (540, 960)


def cut_frame(spec):
    """The input frame whose output is CUT_SIZE."""
    return CUT_SIZE[0] // spec.scaling_factor, CUT_SIZE[1] // spec.scaling_factor


# phase 14's networks at the new configs: each network's config (their
# labels and kernels-line names say "saturated", apart from XL's at pe16)
NEW_FAMILY = {"m11u_pe16": "pe16", "xlu_pe16": "pe16", "m11w": "pe16_wide"}


def halo_ratio(spec, tile):
    """MACs K1 and K2 compute over the MACs the network needs in one launch
    at ``tile`` (``chain_halo``)."""
    return chain_halo(spec, [(None, tile, 0)])


def family_phase(torch, dev, card, handed):
    """Phase 14, SESR-M11 x2 and SESR-XL x2 on the card: each calibrated
    from seeded collapsed weights and certified with the port's own
    ``calibrate`` and ``certify_fast``, an M11 and an XL whose convs
    SATURATED are at +127 (their certificates leave them unstamped), XL
    calibrated at each of phase 12's HW_CONFIGS, and XL at 8 PEs with
    12-bit accumulators (XL_PE8, every conv split); then, with the launch
    counters at 0 before and read after each call, the main path at
    540x960: the mode ``select_forward`` picks (K2 for the certified two,
    hybrid for the unstamped two), K1 (``pe_exact_forward``, behind
    ``sim``) and the unstamped networks' corrected PE-exact mode, each at
    batch 1 and 4; XL's corrected PE-exact mode (``sim --corrected``'s
    path) and K1 at each config and at XL_PE8, at batch 1; every output
    torch.equal with the plain interpreter on the card, one launch a call.
    Since PR 18 also the saturated M11 and XL calibrated at pe16 (K1 and
    the corrected PE-exact mode; XL's corrected kernel is refused there,
    its refusal naming its plan's bytes) and M11 at pe16_wide with
    WIDE_SATURATED (K1, K2, both corrected modes and the counting form, in
    the wide kernels), whose largest |pe_add + bias| must pass 2^22 on both
    datapaths. Then each kernel's device time (CUDA
    events) at its default tile and, for K1 and K2, at each tile of
    NET_TILES that fits a block: its bound and share, MACs computed over
    MACs needed (``halo_ratio``), the tensor-core MACs over the network's,
    registers and shared memory (CUPTI, the wrapper's plan and the
    library's, which must agree; the corrected kernel's B regions; CUPTI
    again at the default tile in ``cupti_process``, which must give the
    plan) and ptxas's registers and spills of the instantiation. The CUPTI
    process ``handed`` (``cupti_start`` of the earlier phases' jobs) runs
    beside the main path and is waited for before the first time is taken.
    Returns the kernels-line entries."""
    from sesr_tpu_torch.config import HardwareConfig, SESRSpec, spec_for_task
    from sesr_tpu_torch.convert import kernel_constants
    from sesr_tpu_torch.deploy import select_forward
    from sesr_tpu_torch.models.sesr import init_params
    from sesr_tpu_torch.ops import _build
    from sesr_tpu_torch.ops.corrected import (hybrid_forward, pe_exact_corrected_forward,
                                              split_layers)
    from sesr_tpu_torch.ops.fast import fast_forward
    from sesr_tpu_torch.ops.kernels import (NET_KERNELS, NET_TILES, SMEM_LIMIT, corrected_net,
                                            corrected_plan, fast_net, pe_exact_net,
                                            reset_launch_counts)
    from sesr_tpu_torch.ops.pe_exact import pe_exact_forward
    from sesr_tpu_torch.quant.calibrate import calibrate
    from sesr_tpu_torch.quant.certify import certify_fast
    from sesr_tpu_torch.quant.integer import (integer_forward, integer_forward_int8,
                                              quantize_input)
    from sesr_tpu_torch.quant.params import QuantParams
    from sesr_tpu_torch.timing import median_ms

    tag = f"({card})"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(14)
    nets, made = {}, {}
    for key, kw in FAMILY_NETS.items():
        spec = SESRSpec(**kw)
        params = init_params(spec, torch.Generator().manual_seed(len(nets)))
        calib = [rng.random((1, 96, 128, 3), dtype=np.float32) for _ in range(2)]
        made[key] = (params, calib)
        cert = [rng.random((1,) + CERT_FRAME + (3,), dtype=np.float32) for _ in range(2)]
        t0 = time.perf_counter()
        qp = calibrate(spec, params, calib, safe_zero_floor=True, device="cuda")
        t1 = time.perf_counter()
        qp = certify_fast(spec, qp, cert, device="cuda")
        t2 = time.perf_counter()
        print(f"[14] {spec.name}: {spec.num_convs} convs of {spec.num_channels} channels; "
              f"calibrate {t1 - t0:.2f} s, certify_fast {t2 - t1:.2f} s on the card: "
              f"{qp.cert_grade} {qp.cert_stamps}", flush=True)
        if not qp.fast_cert_ok:
            fail(f"[14] {spec.name} did not certify fast: {qp.cert_stamps}")
        nets[key] = (spec, qp, cert)
    for key, base in (("m11u", "m11"), ("xlu", "xl")):
        spec, qp, cert = nets[base]
        sat = dataclasses.replace(qp, w_int=[
            np.full_like(np.asarray(w), 127) if i in SATURATED else np.asarray(w)
            for i, w in enumerate(qp.w_int)])
        t0 = time.perf_counter()
        sat = certify_fast(spec, sat, cert, device="cuda")
        stamped = tuple(sat.fast_cert_layers or ())
        print(f"[14] {spec.name} with convs {SATURATED} at +127: {sat.cert_grade} "
              f"{sat.cert_stamps}; certify_fast {time.perf_counter() - t0:.2f} s on the card; "
              f"split hybrid {[i for i, f in enumerate(split_layers(sat, 'hybrid')) if f]}, "
              f"pe-exact {[i for i, f in enumerate(split_layers(sat, 'pe-exact')) if f]}",
              flush=True)
        if select_forward(sat)[0] != "hybrid" or any(stamped[i] for i in SATURATED):
            fail(f"[14] the saturated {spec.name} should serve hybrid with convs {SATURATED} "
                 f"unstamped, got {select_forward(sat)[0]} {stamped}")
        nets[key] = (spec, sat, cert)
    # XL at phase 12's configs (calibrated on the card) and at XL_PE8
    spec, qp, _ = nets["xl"]
    for cname, kw in HW_CONFIGS.items():
        t0 = time.perf_counter()
        cqp = calibrate(spec, *made["xl"], hw=HardwareConfig(**kw), safe_zero_floor=True,
                        device="cuda")
        split = split_layers(cqp, "pe-exact")
        print(f"[14] {spec.name} at {cname} {kw}: calibrate {time.perf_counter() - t0:.2f} s on "
              f"the card; corrected PE-exact split {[i for i, f in enumerate(split) if f]}",
              flush=True)
        nets[f"xl_{cname}"] = (spec, cqp, None)
    nets["xl_pe8_acc12"] = (
        spec, dataclasses.replace(qp, hw=dataclasses.replace(qp.hw, **XL_PE8)), None)
    # the saturated M11 and XL calibrated at pe16, and the M11 at pe16_wide
    # with WIDE_SATURATED, each certified on the card (the corrected
    # kernel takes XL at 16 PEs with split convs, its split
    # layers' B staged in pieces, so XL's certificate checks its hybrid
    # mode on the card too)
    for key, net, cname, sats in (("m11u_pe16", "m11", "pe16", SATURATED),
                                  ("xlu_pe16", "xl", "pe16", SATURATED),
                                  ("m11w", "m11", "pe16_wide", WIDE_SATURATED)):
        spec, _, cert = nets[net]
        t0 = time.perf_counter()
        cqp = calibrate(spec, *made[net], hw=HardwareConfig(**HW_CONFIGS[cname]),
                        safe_zero_floor=True, device="cuda")
        cqp = dataclasses.replace(cqp, w_int=[
            np.full_like(np.asarray(w), 127) if i in sats else np.asarray(w)
            for i, w in enumerate(cqp.w_int)])
        cqp = certify_fast(spec, cqp, cert, device="cuda")
        print(f"[14] {spec.name} at {cname} with convs {sats} at +127 ({key}): "
              f"{cqp.cert_grade} {cqp.cert_stamps}, serves {select_forward(cqp)[0]}; calibrate "
              f"and certify_fast {time.perf_counter() - t0:.2f} s on the card; split pe-exact "
              f"{[i for i, f in enumerate(split_layers(cqp, 'pe-exact')) if f]}", flush=True)
        nets[key] = (spec, cqp, cert)

    x4 = torch.from_numpy(rng.random((4,) + FRAME + (3,), dtype=np.float32)).to(dev)
    x1 = x4[:1].contiguous()
    # the main path: per served network the mode it serves (int8 out), K1
    # and the unstamped networks' corrected PE-exact mode, each at batch 1
    # and 4; at the configs the corrected PE-exact mode (sim --corrected's
    # path, "sim-c"), at XL_PE8 that and K1, at batch 1
    served = {"m11": (("fast", "fast"), ("sim", "exact")),
              "xl": (("fast", "fast"), ("sim", "exact")),
              "m11u": (("hybrid", "hybrid"), ("pe-exact", "pe-exact")),
              "xlu": (("hybrid", "hybrid"), ("pe-exact", "pe-exact"))}
    calls = {**served, **{f"xl_{c}": (("sim-c", "pe-exact"), ("sim", "exact"))
                          for c in HW_CONFIGS},
             "xl_pe8_acc12": (("sim", "exact"), ("sim-c", "pe-exact")),
             "m11u_pe16": (("sim", "exact"), ("sim-c", "pe-exact")),
             "xlu_pe16": (("hybrid", "hybrid"), ("sim", "exact"), ("sim-c", "pe-exact")),
             "m11w": (("sim", "exact"), ("pe-exact", "pe-exact"), ("hybrid", "hybrid"),
                      *((("fast", "fast"),) if nets["m11w"][1].fast_cert_ok else ()))}
    # every (network, mode) runs: no kernel refuses one of them (SESR-XL's
    # corrected kernel at 16 PEs stages its split layers' B in pieces)
    refused = {}
    datapath_of = {"fast": "fast", "sim": "exact", "hybrid": "corrected",
                   "pe-exact": "corrected", "sim-c": "corrected"}
    for key, modes in list(calls.items()):
        spec, qp, _ = nets[key]
        kept = []
        for mode, split_mode in modes:
            dp = datapath_of[mode]
            split = split_layers(qp, split_mode) if dp == "corrected" else None
            try:
                kernel_constants(spec, qp, dp, split)
                kept.append((mode, split_mode))
            except NotImplementedError as e:
                refused[key, mode] = str(e)
                print(f"[14] {spec.name} ({key}) {mode}: refused, {e}", flush=True)
        calls[key] = tuple(kept)
    if refused:
        fail(f"[14] a kernel refused a network: {sorted(refused)}")
    fwd = {"fast": lambda s, q, x: fast_forward(s, q, x, out_dtype="int8"),
           "hybrid": lambda s, q, x: hybrid_forward(s, q, x, out_dtype="int8"),
           "pe-exact": lambda s, q, x: pe_exact_corrected_forward(s, q, x, out_dtype="int8"),
           "sim": lambda s, q, x: pe_exact_forward(s, q, x),
           "sim-c": lambda s, q, x: pe_exact_corrected_forward(s, q, x)}
    kernel_of = {"fast": fast_net, "hybrid": corrected_net, "pe-exact": corrected_net,
                 "sim": pe_exact_net, "sim-c": corrected_net}

    def counts():
        return {k.symbol: k.launches for k in NET_KERNELS}

    # each (network, mode)'s own launches and frames, read from the
    # counters around each of its calls
    own = {(key, mode): [0, 0] for key, modes in calls.items() for mode, _ in modes}
    launches = dict.fromkeys(counts(), 0)
    outs = {}
    for key, modes in calls.items():
        spec, qp, _ = nets[key]
        if key in served and select_forward(qp)[0] != modes[0][0]:
            fail(f"[14] {key}: select_forward picks {select_forward(qp)[0]}, not {modes[0][0]}")
        for mode, _ in modes:
            for x in ((x1, x4) if key in served else (x1,)):
                reset_launch_counts()
                outs[key, mode, x.shape[0]] = fwd[mode](spec, qp, x)
                made = {k: v for k, v in counts().items() if v}
                if made != {kernel_of[mode].symbol: 1}:
                    fail(f"[14] {key} {mode} batch {x.shape[0]} launched {made}, want one "
                         f"launch of {kernel_of[mode].symbol}")
                launches[kernel_of[mode].symbol] += 1
                own[key, mode][0] += 1
                own[key, mode][1] += x.shape[0]
    torch.cuda.synchronize()
    want = dict.fromkeys(launches, 0)
    for key, modes in calls.items():
        for mode, _ in modes:
            want[kernel_of[mode].symbol] += 2 if key in served else 1
    if launches != want:
        fail(f"[14] the main path launched {launches}, want one launch a call: {want}")
    print(f"[14] main path at {FRAME}, batch 1 and 4: launches {launches}; per network and "
          f"mode (launches, frames) {own}; corrected by split mask "
          f"{dict(corrected_net.split_launches)}", flush=True)
    # the same outputs from the plain interpreter on the card
    plain = {"fast": dict(corrected=True, compute="fast"), "sim": dict(corrected=False),
             "hybrid": None, "pe-exact": dict(corrected=True, compute="exact"),
             "sim-c": dict(corrected=True)}
    for (key, mode, batch), got in outs.items():
        spec, qp, _ = nets[key]
        x = x1 if batch == 1 else x4
        kw = plain[mode] or dict(corrected=True, compute="exact",
                                 fast_layers=tuple(qp.fast_cert_layers))
        if mode in ("sim", "sim-c"):
            want_y = integer_forward(spec, qp, x, **kw)[0]
        else:
            want_y = integer_forward_int8(spec, qp, x, **kw)
        if got.shape != want_y.shape or not torch.equal(got, want_y):
            fail(f"[14] {key} {mode} batch {batch}: differs from the plain interpreter")
        if not bool(torch.isfinite(got.float()).all()):
            fail(f"[14] {key} {mode} batch {batch}: non-finite output")
        print(f"[14] {spec.name} ({key}) {mode} batch {batch}: output {tuple(got.shape)} "
              f"{got.dtype}, torch.equal with plain (cuda)", flush=True)
        del want_y
    del outs

    # the runtime audit on the saturated XL at 4, 8 and 16 PEs (its convs 3
    # and 9 fire the 18-bit clamp; at 16 the split layers' B in pieces): one
    # counting launch a call, the counters at 0 before it, counts
    # array_equal with the plain interpreter's overflow_18 on the card and
    # the output torch.equal; timed after the CUPTI process has ended
    xl_spec, xlu_qp, _ = nets["xlu"]
    audited = {"xlu": xlu_qp,
               "xlu_pe8": dataclasses.replace(xlu_qp, hw=dataclasses.replace(xlu_qp.hw, pe=8)),
               "xlu_pe16": nets["xlu_pe16"][1]}
    to_time = []
    for key, aqp in audited.items():
        reset_launch_counts()
        got = audit_check(torch, xl_spec, aqp, x1, f"{aqp.hw.pe} PEs, batch 1", 14)
        if corrected_net.audit_launches != 1 or any(counts().values()):
            fail(f"[14] the audit of {key} launched {counts()} and "
                 f"{corrected_net.audit_launches} counting launches, want one counting launch")
        if not all(got[i] for i in SATURATED):
            fail(f"[14] the audit of {key}: convs {SATURATED} did not fire ({got.tolist()})")
        to_time.append((xl_spec, aqp, f"sesr_corrected_audit[{xl_spec.name}, {aqp.hw.pe} PEs]"))
    # the wide form: the saturated M11 at pe16_wide, its largest |pe_add +
    # bias| per layer on x1 from the plain interpreter's dumps on the card,
    # on the corrected datapath (past 2^22 on conv 3 and the last conv, the
    # adder's 24-bit clamp on the last) and the reference one (K1: past
    # 2^22 on the last conv); then its counting form
    m11_spec, wqp, _ = nets["m11w"]
    hi16 = (1 << (wqp.hw.bias_bits - 1)) - 1
    for corrected in (True, False):
        _, dumps = integer_forward(m11_spec, wqp, x1, collect_dumps=True, corrected=corrected)
        big = []
        for i in range(m11_spec.num_convs):
            bias = np.clip(np.asarray(wqp.bias_int[i], np.int64), -hi16 - 1, hi16) \
                if corrected else wqp.fused_bias(i)
            y = dumps[f"pe_add.{i}"].double() + torch.as_tensor(np.asarray(bias, np.float64),
                                                                device=dev)
            big.append(int(y.abs().max()))
        layer = int(np.argmax(big))
        print(f"[14] {m11_spec.name} at pe16_wide, convs {WIDE_SATURATED} at +127, "
              f"{'corrected' if corrected else 'reference'} datapath on {tuple(x1.shape)}: the "
              f"largest |pe_add + bias| is {big[layer]} on conv {layer} (2^22 = {1 << 22}; per "
              f"layer {big}); overflow_18 {dumps['overflow_18'].tolist()}, overflow_20 "
              f"{dumps['overflow_20'].tolist()}", flush=True)
        if big[layer] <= 1 << 22:
            fail(f"[14] the wide M11's sums stay within 2^22 on the "
                 f"{'corrected' if corrected else 'reference'} datapath: {big}")
        del dumps
    reset_launch_counts()
    audit_check(torch, m11_spec, wqp, x1, "pe16_wide, batch 1", 14)
    if corrected_net.audit_launches != 1 or any(counts().values()):
        fail(f"[14] the audit of m11w launched {counts()} and {corrected_net.audit_launches} "
             f"counting launches, want one counting launch")
    audited["m11w"] = wqp
    to_time.append((m11_spec, wqp, f"sesr_corrected_audit[{m11_spec.name}, pe16_wide]"))

    # no time is taken beside the CUPTI process: it ends here
    t0 = time.perf_counter()
    cupti_check(handed, tag)
    print(f"[14] waited {time.perf_counter() - t0:.1f} s for the CUPTI process", flush=True)
    audit_entries = [audit_entry(torch, dev, aspec, aqp, x1, name, tag, 14, (1, 1))
                     for aspec, aqp, name in to_time]
    # timing, each kernel batch 1 at its default tile and K1 / K2 over the sweep
    lib = _build.load("sesr_net")
    lib_c = _build.load("sesr_corrected")
    entries = []
    # each kernel's launch at its default tile, for CUPTI in a process of its own
    cupti_dir = os.path.join(REPO, "build", "chip_smoke_cupti")
    os.makedirs(cupti_dir, exist_ok=True)
    cupti_jobs = []
    cases = [(pe_exact_net, "m11", None, "sim"), (fast_net, "m11", None, "fast"),
             (pe_exact_net, "xl", None, "sim"), (fast_net, "xl", None, "fast"),
             (corrected_net, "m11u", "hybrid", "hybrid"),
             (corrected_net, "m11u", "pe-exact", "pe-exact"),
             (corrected_net, "xlu", "hybrid", "hybrid"),
             (corrected_net, "xlu", "pe-exact", "pe-exact"),
             *[(corrected_net, f"xl_{c}", "pe-exact", "sim-c") for c in HW_CONFIGS],
             *[(pe_exact_net, f"xl_{c}", None, "sim") for c in HW_CONFIGS],
             (pe_exact_net, "xl_pe8_acc12", None, "sim"),
             (corrected_net, "xl_pe8_acc12", "pe-exact", "sim-c"),
             (pe_exact_net, "m11u_pe16", None, "sim"),
             (corrected_net, "m11u_pe16", "pe-exact", "sim-c"),
             (pe_exact_net, "xlu_pe16", None, "sim"),
             (corrected_net, "xlu_pe16", "pe-exact", "sim-c"),
             (corrected_net, "xlu_pe16", "hybrid", "hybrid"),
             (pe_exact_net, "m11w", None, "sim"), (fast_net, "m11w", None, "fast"),
             (corrected_net, "m11w", "hybrid", "hybrid"),
             (corrected_net, "m11w", "pe-exact", "pe-exact")]
    config_of = {**{f"xl_{c}": c for c in HW_CONFIGS}, "xl_pe8_acc12": "pe8_acc12",
                 **NEW_FAMILY}
    for kern, key, mode, path_mode in cases:
        if (key, path_mode) not in own:               # refused, or not served
            continue
        n_launch, n_frames = own[key, path_mode]
        spec, qp, _ = nets[key]
        split_arg = split_layers(qp, mode) if mode else None
        kc = kernel_constants(spec, qp, kern.datapath, split_arg)
        x_q = quantize_input(x1, qp).to(torch.int8).contiguous()
        tile0 = kern.tile(spec, kc.pe_split, kc.pe, kc.general)
        ref = kern(spec, qp, x_q, split=split_arg)
        at = f" {config_of[key]}{' saturated' if key in NEW_FAMILY else ''}" \
            if key in config_of else ""
        label = f"{kern.symbol} {spec.name}{f' {mode}' if mode else ''}{at} {FRAME[0]}x{FRAME[1]}"
        pkey, (p_regs, p_spill) = ptxas_line(kern, spec, kc)
        if kern is corrected_net:
            tiles = [tile0]
            mask = sum(1 << i for i, f in enumerate(kc.pe_split) if f)
            plan = corrected_plan(spec.num_convs, spec.in_channels, spec.conv_out_channels, tile0,
                                  kc.pe_split, kc.pe, kc.width, kc.general)
            built = lib_c.sesr_corrected_smem(spec.num_convs, spec.in_channels,
                                              spec.conv_out_channels, *tile0, mask, kc.pe,
                                              int(kc.general), kc.width)
            if plan[0] != built:
                fail(f"[14] {label} tile {tile0}: the wrapper plans {plan[0]} B of shared "
                     f"memory, the library {built}")
            print(f"[14] {label}: tile {tile0[0]}x{tile0[1]}, {plan[0]} B of shared memory "
                  f"(the wrapper's plan and the library's agree), B "
                  f"{'resident' if plan[1] == 0 else f'staged in {plan[1]} region(s)'}"
                  f"{' in pieces' if plan.pieces else ''}",
                  flush=True)
        else:
            tiles = []
            mask = sum(1 << i for i, f in enumerate(kc.pe_split) if f)
            for tile in NET_TILES:
                plan = kern.smem_bytes(spec, tile, kc.pe_split, kc.pe, kc.general)
                built = lib.sesr_net_smem(int(kern is pe_exact_net), spec.num_convs,
                                          spec.in_channels, spec.conv_out_channels, *tile, mask,
                                          kc.pe, int(kc.general), kc.width)
                if plan != built:
                    fail(f"[14] {label} tile {tile}: the wrapper plans {plan} B of shared "
                         f"memory, the library {built}")
                if plan > SMEM_LIMIT:
                    print(f"[14] {label} tile {tile[0]}x{tile[1]}: needs {plan} B of shared "
                          f"memory, more than a block's {SMEM_LIMIT}: not taken", flush=True)
                else:
                    tiles.append(tile)
            if config_of.get(key) in NEW_CONFIGS:       # the new configs: the default tile
                tiles = [tile0]
        pattern = kernel_family(kern, kc)
        attrs = launch_attrs(torch, {t: (lambda t=t: kern(spec, qp, x_q, tile=t, split=split_arg))
                                     for t in tiles}, pattern)
        weights = sum(int(np.prod(np.shape(w))) for w in qp.w_int)
        n, h, w = x_q.shape[:3]
        macs = weights * n * h * w
        moved = x_q.numel() + n * h * w * spec.conv_out_channels + weights
        bnd = bound(2 * macs, moved, INT8_OPS_PER_S)
        ms = None
        for tile in tiles:
            if not torch.equal(kern(spec, qp, x_q, tile=tile, split=split_arg), ref):
                fail(f"[14] {label} at tile {tile} differs from tile {tile0}")
            tile_ms = median_ms(lambda: kern(spec, qp, x_q, tile=tile, split=split_arg), dev,
                                20, warmup=3, lead_ms=2.0)
            regs, smem = attrs[tile]
            plan = kern.smem_bytes(spec, tile, kc.pe_split, kc.pe, kc.general)
            if smem is not None and smem != plan:
                fail(f"[14] {label} tile {tile}: CUPTI reports {smem} B of shared memory, the "
                     f"plan {plan}")
            _, tc_macs, instr = tensor_count(kern, spec, kc.pe_split, n, h, w, tile, kc.pe)
            print(f"[14] {label} tile {tile[0]}x{tile[1]}{' (default)' if tile == tile0 else ''}"
                  f": {tile_ms:.4f} ms/frame, share of bound {bnd[0] / tile_ms:.4f}; MACs "
                  f"computed / needed {halo_ratio(spec, tile):.3f} (extents), tensor-core MACs "
                  f"{tc_macs / macs:.3f}x the network's ({instr}); CUPTI "
                  f"{regs if regs is not None else 'not measured'} registers, "
                  f"{smem if smem is not None else 'not measured'} B shared memory per block "
                  f"(plan {plan}) {tag}", flush=True)
            if tile == tile0:
                ms = tile_ms
        qp_path = os.path.join(cupti_dir, f"{key}.npz")
        qp.save(qp_path)
        cupti_jobs.append(dict(label=label, spec=dataclasses.asdict(spec), qparams=qp_path,
                               symbol=kern.symbol, mode=mode, tile=list(tile0),
                               pattern=kernel_family(kern, kc),
                               plan=kern.smem_bytes(spec, tile0, kc.pe_split, kc.pe,
                                                    kc.general)))
        kw = plain_kwargs(kern, qp, mode)
        # one timed call of the plain version, warm from the main path
        plain_ms = median_ms(lambda: integer_forward(spec, qp, x1, **kw), dev, 1, warmup=0)
        print(f"[14] {label}: {ms:.4f} ms/frame at tile {tile0[0]}x{tile0[1]}, "
              f"{'general' if kc.general else 'shipped'} instantiation {pkey}: ptxas {p_regs} "
              f"registers, {p_spill} B spill stores; per-PE passes on convs "
              f"{[i for i in range(spec.num_convs) if kc.pe_split[i]]}; bound "
              f"{bnd[0] * 1e3:.3f} us ({bnd[1]}: {2 * macs:.4g} int8 ops, {moved} bytes), share "
              f"{bnd[0] / ms:.4f}; plain {plain_ms:.3f} ms; launches on the main path "
              f"{n_launch} over {n_frames} frames ({launches[kern.symbol]} of every "
              f"network) {tag}", flush=True)
        name = f"{kern.symbol}[{spec.name}{f', {mode}' if mode else ''}{at.replace(' ', ', ', 1)}]"
        entries.append(dict(
            name=name, route="cuda", source=SOURCES[kern.symbol],
            replaces=REPLACES[kern.symbol], launches=n_launch,
            launches_per_frame={"main path": n_launch / n_frames},
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
            library_ms=None, tile=list(tile0),
            work=f"{spec.name}, {FRAME} frame, batch 1{f', {mode} mode' if mode else ''}, "
                 f"{qp.hw.pe} PEs, {qp.hw.pe_acc_bits}-bit accumulators"))
    # CUPTI's registers and shared memory of each kernel at its default
    # tile, read in a process of its own (this process's trace, after the
    # earlier phases' traces, misses them): the shared memory must be the
    # plan's
    # the counting form at its default tile, on nr's shipped artifact (phases
    # 8 and 11) and the XL above: the served kernel's plan
    nr_spec = spec_for_task("nr")
    audited["nr"] = QuantParams.load(os.path.join(REPO, "artifacts", "qparams_nr.npz"))
    for key, aqp in audited.items():
        aspec = {"nr": nr_spec, "m11w": m11_spec}.get(key, xl_spec)
        split = split_layers(aqp, "pe-exact")
        kc = kernel_constants(aspec, aqp, "corrected", split)
        tile0 = corrected_net.tile(aspec, kc.pe_split, kc.pe, kc.general)
        qp_path = os.path.join(cupti_dir, f"{key}_audit.npz")
        aqp.save(qp_path)
        cupti_jobs.append(dict(label=f"sesr_corrected_audit {aspec.name} {aqp.hw.pe} PEs",
                               spec=dataclasses.asdict(aspec), qparams=qp_path,
                               symbol=corrected_net.symbol, mode="pe-exact", audit=True,
                               pattern=kernel_family(corrected_net, kc, audit=True),
                               tile=list(tile0),
                               plan=corrected_net.smem_bytes(aspec, tile0, kc.pe_split, kc.pe,
                                                             kc.general)))
    entries += audit_entries
    cupti_check(cupti_start(cupti_jobs, "jobs.json", procs=2), tag)
    print(f"[14] the family phase took {time.perf_counter() - t_phase:.1f} s {tag}", flush=True)
    return entries


def cupti_start(jobs, name, procs=1):
    """``chip_smoke.py --cupti`` on ``jobs`` in ``procs`` processes of their
    own, each on every procs-th job (written to build/chip_smoke_cupti/
    ``name`` with the process's index), started and not waited for: [(the
    process, its jobs, its start time)]."""
    labels = [job["label"] for job in jobs]
    if len(set(labels)) != len(labels):
        fail(f"[14] CUPTI jobs share a label: {sorted({k for k in labels if labels.count(k) > 1})}")
    runs = []
    for i in range(procs):
        share = jobs[i::procs]
        stem, ext = os.path.splitext(name)
        jobs_path = os.path.join(REPO, "build", "chip_smoke_cupti",
                                 f"{stem}_{i}{ext}" if procs > 1 else name)
        os.makedirs(os.path.dirname(jobs_path), exist_ok=True)
        with open(jobs_path, "w") as f:
            json.dump(share, f)
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__), "--cupti",
                                 jobs_path], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True)
        runs.append((proc, share, time.perf_counter()))
    return runs


def cupti_check(runs, tag):
    """Wait for the CUPTI processes of ``cupti_start`` and hold each job's
    shared memory per block to its plan."""
    for proc, jobs, t0 in runs:
        try:
            out, err = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for other, _, _ in runs:
                other.kill()
            fail("[14] a CUPTI process took more than 300 s")
        if proc.returncode != 0:
            fail(f"[14] a CUPTI process failed:\n{out[-2000:]}{err[-4000:]}")
        *notes, last = out.strip().splitlines()
        for line in notes:
            print(f"[14] the CUPTI process: {line}", flush=True)
        attrs = json.loads(last)
        for job in jobs:
            regs, smem = attrs[job["label"]]
            print(f"[14] {job['label']} tile {job['tile'][0]}x{job['tile'][1]}: CUPTI (a "
                  f"process of its own) {regs} registers, {smem} B shared memory per block "
                  f"(plan {job['plan']}) {tag}", flush=True)
            if smem != job["plan"]:
                fail(f"[14] {job['label']}: CUPTI reports {smem} B of shared memory, the plan "
                     f"{job['plan']}")
        print(f"[14] the CUPTI process of {len(jobs)} jobs took "
              f"{time.perf_counter() - t0:.1f} s after its start", flush=True)


def out_channels_phase(torch, dev, card):
    """Phase 15, last convs of 1 to 48 output channels on the card: the
    networks of OUT_NETS from seeded weights (the published checkpoints are
    not in the repository), each calibrated and certified on the card at 4
    PEs and at phase 12's pe16, and a copy of each with its last conv at
    +127 (its 18-bit clamp fires, the certificate leaves it unstamped and
    both corrected modes split it per PE: 32 or 48 columns a PE group past
    16 outputs, B staged in pieces where a layer's does not fit). Then, with
    the launch counters at 0 before and read after each call, at the input
    size whose output is 540x960 (cut_frame): K1 (``pe_exact_forward``,
    behind ``sim``), K2 where the network certifies fully (else its
    wrapper on the quantized frame against the plain fast datapath, "k2":
    the kernel's instantiation checked, the main path never takes it), the hybrid and
    corrected PE-exact modes and the counting form (``audit_forward``),
    each at batch 1 and 4 (the saturated copies at batch 1), one launch a
    call of its wrapper; every output torch.equal with the plain
    interpreter on the card, the counts with its overflow_18 (K1 takes
    SESR-XL x4 RGB at pe16, whose split last conv's B fits no tile of its
    one-launch kernel, as one group of its layer-group form, that conv
    staged a PE pass at a time: one launch). Then the sweep (``out_sweep``): every instantiation of
    a padded count or past 16 outputs launched. Then each
    (kernel, network, config)'s device time per frame at batch 1 and its
    default tile, the plan's shared memory (the wrapper's and the
    library's, which must agree; CUPTI's in phase 14's process of its own
    through the jobs returned), the bound (the network's int8 MACs at
    1,979 TOP/s) and share, the plain interpreter's time, and ptxas's
    registers and spills of the instantiation. A generator: it yields
    after the sweep, and ``finish`` runs the times and returns (the
    kernels-line entries, the CUPTI jobs)."""
    from sesr_tpu_torch.config import HardwareConfig, SESRSpec
    from sesr_tpu_torch.convert import kernel_constants, out_columns
    from sesr_tpu_torch.deploy import select_forward
    from sesr_tpu_torch.models.sesr import init_params
    from sesr_tpu_torch.ops.corrected import split_layers
    from sesr_tpu_torch.ops.kernels import (NET_KERNELS, corrected_net, corrected_plan,
                                            reset_launch_counts)
    from sesr_tpu_torch.quant.calibrate import calibrate
    from sesr_tpu_torch.quant.certify import certify_fast
    from sesr_tpu_torch.quant.integer import quantize_input
    from sesr_tpu_torch.timing import median_ms

    tag = f"({card})"
    t_phase = time.perf_counter()
    rng = np.random.default_rng(15)
    configs = {"pe4": {}, "pe16": HW_CONFIGS["pe16"]}
    nets, frames = {}, {}
    for seed, (name, kw) in enumerate(OUT_NETS.items()):
        spec = SESRSpec(**kw)
        L = spec.num_convs
        params = init_params(spec, torch.Generator().manual_seed(seed))
        calib = [rng.random((1, 96, 128, spec.in_channels), dtype=np.float32) for _ in range(2)]
        cert = [rng.random((1,) + CERT_FRAME + (spec.in_channels,), dtype=np.float32)
                for _ in range(2)]
        for cname, hw in configs.items():
            t0 = time.perf_counter()
            qp = calibrate(spec, params, calib, hw=HardwareConfig(**hw), safe_zero_floor=True,
                           device="cuda")
            qp = certify_fast(spec, qp, cert, device="cuda")
            sat = dataclasses.replace(qp, w_int=[
                np.full_like(np.asarray(w), 127) if i == L - 1 else np.asarray(w)
                for i, w in enumerate(qp.w_int)])
            sat = certify_fast(spec, sat, cert, device="cuda")
            print(f"[15] {name} ({spec.in_channels} in, {spec.conv_out_channels} out, "
                  f"{out_columns(spec.conv_out_channels)} columns; {L} convs of "
                  f"{spec.num_channels}) at {cname}: {qp.cert_grade} {qp.cert_stamps}, serves "
                  f"{select_forward(qp)[0]}; the last conv at +127: {sat.cert_grade} "
                  f"{sat.cert_stamps}, serves {select_forward(sat)[0]}, split hybrid "
                  f"{[i for i, f in enumerate(split_layers(sat, 'hybrid')) if f]} pe-exact "
                  f"{[i for i, f in enumerate(split_layers(sat, 'pe-exact')) if f]}; calibrate "
                  f"and two certify_fast {time.perf_counter() - t0:.2f} s on the card",
                  flush=True)
            if not (split_layers(sat, "hybrid")[L - 1] and split_layers(sat, "pe-exact")[L - 1]):
                fail(f"[15] {name} at {cname}: the saturated last conv is not split")
            nets[name, cname] = (spec, qp)
            nets[name, f"{cname}_sat"] = (spec, sat)
        frames[name] = torch.from_numpy(rng.random((4,) + cut_frame(spec) + (spec.in_channels,),
                                                   dtype=np.float32)).to(dev)

    kernel_of = {m: mode_kernel(m) for m in ("sim", "fast", "k2", "hybrid", "pe-exact", "audit")}

    def instance(mode, spec, qp):
        """The instantiation (ptxas_line's name) a call of ``mode`` launches."""
        kern = kernel_of[mode]
        split = split_layers(qp, "pe-exact" if mode == "audit" else mode) \
            if kern is corrected_net else None
        kc = kernel_constants(spec, qp, kern.datapath, split)
        return ptxas_line(kern, spec, kc, mode == "audit")[0]

    # the main path: one launch a call, counters at 0 before and read after
    own, launches, hit = {}, {k.symbol: 0 for k in NET_KERNELS}, set()
    launches["sesr_corrected_audit"] = 0
    for (name, cname), (spec, qp) in nets.items():
        modes = ("hybrid", "pe-exact", "audit") if cname.endswith("_sat") else \
            ("sim", "fast" if qp.fast_cert_ok else "k2", "hybrid", "pe-exact", "audit")
        for mode in modes:
            hit.add(instance(mode, spec, qp))
            for batch in ((1,) if cname.endswith("_sat") else (1, 4)):
                x = frames[name][:batch]
                reset_launch_counts()
                got = mode_forward(mode, spec, qp, x)
                made = {k.symbol: k.launches for k in NET_KERNELS if k.launches}
                if mode == "audit":
                    if made or corrected_net.audit_launches != 1:
                        fail(f"[15] {name} {cname} audit batch {batch} launched {made} and "
                             f"{corrected_net.audit_launches} counting launches")
                    launches["sesr_corrected_audit"] += 1
                elif made != {kernel_of[mode].symbol: 1} or corrected_net.audit_launches:
                    fail(f"[15] {name} {cname} {mode} batch {batch} launched {made}, want one "
                         f"launch of {kernel_of[mode].symbol}")
                else:
                    launches[kernel_of[mode].symbol] += 1
                entry = own.setdefault((name, cname, mode), [0, 0])
                entry[0] += 1
                entry[1] += batch
                want = mode_plain(mode, spec, qp, x)
                if mode == "audit":
                    (got, counts), (want, want_counts) = got, want
                    if not torch.equal(counts, want_counts):
                        fail(f"[15] {name} {cname} audit batch {batch}: counts "
                             f"{counts.tolist()} against the plain {want_counts.tolist()}")
                if got.shape != want.shape or not torch.equal(got, want):
                    fail(f"[15] {name} {cname} {mode} batch {batch}: differs from the plain "
                         f"interpreter")
                if not bool(torch.isfinite(got.float()).all()):
                    fail(f"[15] {name} {cname} {mode} batch {batch}: non-finite output")
                print(f"[15] {name} {cname} {mode} batch {batch}: output {tuple(got.shape)} "
                      f"{got.dtype}, torch.equal with plain (cuda)"
                      f"{f'; counts {counts.tolist()}' if mode == 'audit' else ''}", flush=True)
                del got, want
    torch.cuda.synchronize()
    print(f"[15] main path: launches {launches}; per network, config and mode (launches, "
          f"frames) {own}; corrected by split mask {dict(corrected_net.split_launches)} {tag}",
          flush=True)
    out_sweep(torch, dev, {name: nets[name, "pe4"] for name in OUT_NETS}, hit, instance, tag)
    checks = time.perf_counter() - t_phase
    yield                            # the times after the builds (``finish``)
    t_phase = time.perf_counter()

    # each (kernel, network, config) at batch 1 and its default tile
    cupti_dir = os.path.join(REPO, "build", "chip_smoke_cupti")
    os.makedirs(cupti_dir, exist_ok=True)
    entries, jobs, plain_ms = [], [], {}
    for (name, cname, mode), (n_launch, n_frames) in own.items():
        spec, qp = nets[name, cname]
        kern = kernel_of[mode]
        audit = mode == "audit"
        split = split_layers(qp, "pe-exact" if audit else mode) \
            if kern is corrected_net else None
        kc = kernel_constants(spec, qp, kern.datapath, split)
        x1 = frames[name][:1]
        x_q = quantize_input(x1, qp).to(torch.int8).contiguous()
        (group, tile, plan), = chain_plans(kern, spec, kc, 15)
        if group is not None:           # K1 on SESR-XL x4 RGB at pe16
            how = ("one group of the layer-group form, its split last conv's B staged a PE "
                   "pass at a time")
        elif kern is corrected_net:
            cplan = corrected_plan(spec.num_convs, spec.in_channels, spec.conv_out_channels,
                                   tile, kc.pe_split, kc.pe, kc.width, kc.general)
            how = ("B resident" if cplan.regions == 0 else
                   f"B staged in {cplan.regions} region(s){' in pieces' if cplan.pieces else ''}")
        else:
            how = f"{'general' if kc.general else 'shipped'} instantiation"
        symbol = "sesr_corrected_audit" if audit else kern.symbol
        label = f"{symbol} {name} {cname}{f' {mode}' if kern is corrected_net else ''}"
        if audit:
            e = audit_entry(torch, dev, spec, qp, x1, f"sesr_corrected_audit[{name}, {cname}]",
                            tag, 15, (n_launch, n_frames))
            e.update(tile=list(tile), smem_plan=plan)
            entries.append(e)
        else:
            ms = median_ms(lambda: kern(spec, qp, x_q, split=split), dev, 20, warmup=3,
                           lead_ms=2.0)
            pkey = (name, cname, mode if mode in ("sim", "hybrid") else "fast"
                    if mode in ("fast", "k2") else "pe-exact")
            if pkey not in plain_ms:
                # one timed call of the plain version, warm from the main path
                plain_ms[pkey] = median_ms(lambda: mode_plain(mode, spec, qp, x1), dev, 1,
                                           warmup=0)
            weights = sum(int(np.prod(np.shape(w))) for w in qp.w_int)
            n, h, w = x_q.shape[:3]
            macs = weights * n * h * w
            moved = x_q.numel() + n * h * w * spec.conv_out_channels + weights
            bnd = bound(2 * macs, moved, INT8_OPS_PER_S)
            ikey, (regs, spill) = ptxas_line(kern, spec, kc)
            print(f"[15] {label} {h}x{w}: {ms:.4f} ms/frame at tile {tile[0]}x{tile[1]}, "
                  f"{plan} B of shared memory (the wrapper's plan and the library's agree), "
                  f"{how}; {ikey} ptxas {regs} registers, {spill} B spill stores; per-PE passes "
                  f"on convs {[i for i in range(spec.num_convs) if kc.pe_split[i]]}; bound "
                  f"{bnd[0] * 1e3:.3f} us ({bnd[1]}: {2 * macs:.4g} int8 ops, {moved} bytes), "
                  f"share {bnd[0] / ms:.4f}; plain {plain_ms[pkey]:.3f} ms; launches on the "
                  f"main path {n_launch} over {n_frames} frames {tag}", flush=True)
            if mode == "k2":                # a kernel check, off the main path: no entry
                continue
            entries.append(dict(
                name=f"{kern.symbol}[{name}, {cname}{f', {mode}' if kern is corrected_net else ''}]",
                route="cuda", source=SOURCES[kern.symbol], replaces=REPLACES[kern.symbol],
                launches=n_launch, launches_per_frame={"main path": n_launch / n_frames},
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms[pkey], bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=None, tile=list(tile), smem_plan=plan,
                ptxas=[regs, spill],
                work=f"{name}, {h}x{w} frame, batch 1"
                     f"{f', {mode} mode' if kern is corrected_net else ''}, {qp.hw.pe} PEs"))
        qp_path = os.path.join(cupti_dir, f"p15_{name}_{cname}.npz")
        qp.save(qp_path)
        jobs.append(dict(label=label, spec=dataclasses.asdict(spec), qparams=qp_path,
                         symbol=kern.symbol, audit=audit, tile=list(tile), plan=plan,
                         out_frame=True,
                         mode=("pe-exact" if audit else mode) if kern is corrected_net else None,
                         pattern=kernel_family(kern, kc, audit)))
    print(f"[15] the output-channels phase took {checks:.1f} s for its checks and "
          f"{time.perf_counter() - t_phase:.1f} s for its times {tag}", flush=True)
    return entries, jobs


def out_sweep(torch, dev, calibrated, hit, instance, tag):
    """Phase 15's sweep (SWEEP_NETS, SWEEP_HW): each network of
    ``calibrated`` (OUT_NETS at 4 PEs) and of SWEEP_NETS (calibrated here
    at 4 PEs on the card) at each config of SWEEP_HW (the artifact's
    HardwareConfig replaced: the same weights and scales on another
    datapath), on a seeded SWEEP_BATCH batch: K1 and K2 at 4 PEs (K2's
    wrapper on the quantized batch), and past 16 outputs the corrected
    kernel's PE-exact mode and its counting form with the last conv at
    +127 (split), each torch.equal with the plain interpreter on the card.
    These launches compare, off the main path. Then every instantiation of
    a padded count (K1 / K2) and of a last conv past 16 channels (the
    corrected kernel, served and counting) in the libraries' ptxas reports
    must be among ``hit`` (the main path's) and the sweep's, or it fails."""
    from sesr_tpu_torch.config import HardwareConfig, SESRSpec
    from sesr_tpu_torch.models.sesr import init_params
    from sesr_tpu_torch.ops import _build
    from sesr_tpu_torch.quant.calibrate import calibrate

    t0 = time.perf_counter()
    rng = np.random.default_rng(151)
    nets = dict(calibrated)
    for seed, (name, kw) in enumerate(SWEEP_NETS.items(), start=len(OUT_NETS)):
        spec = SESRSpec(**kw)
        params = init_params(spec, torch.Generator().manual_seed(seed))
        calib = [rng.random((1, 96, 128, spec.in_channels), dtype=np.float32) for _ in range(2)]
        nets[name] = (spec, calibrate(spec, params, calib, safe_zero_floor=True, device="cuda"))
    runs = 0
    for name, (spec, qp) in nets.items():
        L = spec.num_convs
        x = torch.from_numpy(rng.random(SWEEP_BATCH + (spec.in_channels,),
                                        dtype=np.float32)).to(dev)
        for hname, hw in SWEEP_HW.items():
            hq = dataclasses.replace(qp, hw=HardwareConfig(**hw), fast_cert_layers=None,
                                     fast_cert_ok=False)
            sat = dataclasses.replace(hq, w_int=[
                np.full_like(np.asarray(w), 127) if i == L - 1 else np.asarray(w)
                for i, w in enumerate(hq.w_int)])
            calls = [("sim", hq), ("k2", hq)] if hq.hw.pe == 4 else []
            if spec.conv_out_channels > 16:
                calls += [("pe-exact", hq), ("pe-exact", sat), ("audit", sat)]
            for mode, cqp in calls:
                got, want = mode_forward(mode, spec, cqp, x), mode_plain(mode, spec, cqp, x)
                if mode == "audit":
                    (got, counts), (want, want_counts) = got, want
                    if not torch.equal(counts, want_counts):
                        fail(f"[15] sweep {name} {hname} audit: counts {counts.tolist()} "
                             f"against the plain {want_counts.tolist()}")
                if got.shape != want.shape or not torch.equal(got, want):
                    fail(f"[15] sweep {name} {hname} {mode}"
                         f"{' (last conv at +127)' if cqp is sat else ''}: differs from the "
                         f"plain interpreter")
                hit.add(instance(mode, spec, cqp))
                runs += 1
    torch.cuda.synchronize()
    want = set()
    for lib, families in (("sesr_net", ("sesr_net_kernel", "sesr_net_wide_kernel")),
                          ("sesr_corrected", ("sesr_corrected_wideout_kernel",
                                              "sesr_corrected_audit_wideout_kernel"))):
        log = _build.build(lib).log
        for family in families:
            want |= {f"{family}<{args}>" for args in _build.ptxas_report(log, family)
                     if family != "sesr_net_kernel" or "ELin" in args}
    missing = sorted(want - hit)
    print(f"[15] sweep: {len(nets)} networks at {len(SWEEP_HW)} configs, {runs} calls on "
          f"{SWEEP_BATCH}, each torch.equal with the plain interpreter (cuda); instantiations "
          f"of a padded count or past 16 outputs launched in phase 15: "
          f"{len(want & hit)} of {len(want)}; {time.perf_counter() - t0:.1f} s {tag}",
          flush=True)
    if missing:
        fail(f"[15] instantiations phase 15 never launched: {missing}")


# phase 16: each deep network's convs at +127 (one in each group of its
# partition), and the sweep config each also runs at
DEEP_SATURATED = {"m16": (3, 12), "xl22": (3, 18)}
DEEP_CONFIG = {"m16": "pe3_nondivisible", "xl22": "pe8_wide"}
# the main path's modes ("K2": K2 where certified, else its wrapper) and
# batches at each config ("config": the sweep config)
DEEP_MODES = {"pe4": (("sim", "K2", "hybrid", "pe-exact", "audit"), (1, 4)),
              "pe4_sat": (("sim", "hybrid", "pe-exact", "audit"), (1,)),
              "pe16": (("sim", "K2", "pe-exact", "audit"), (1,)),
              "config": (("sim", "pe-exact"), (1,))}
# phase 16's sweep of the layer-group instantiations on a small batch: a
# 33-conv network at each padded count of its last conv (out_cols 8, 16,
# 32, 48: 3, 12, 27 and 48 outputs) at widths 16 and 32, which the
# partition rule runs in three groups or more (the first writes, a middle
# one reads and writes, the last reads), and a two-conv network at each
# (one group, whose first conv also adds the shortcut), calibrated at 4
# PEs on the card and run at SWEEP_HW's configs: K1 and K2 at 4 PEs (wide
# sums or not), the corrected kernel's PE-exact mode and counting form at
# every config (past 16 outputs, and the two-conv group, in its tail
# instantiations)
GROUP_NETS_CONVS = 33
GROUP_NETS = {f"g{c}_{oc}": dict(name=f"g{c}_{oc}", in_channels=3, out_channels=3,
                                 num_channels=c, num_lblocks=GROUP_NETS_CONVS - 2,
                                 scaling_factor=s)
              for c in (16, 32) for oc, s in ((3, 1), (12, 2), (27, 3), (48, 4))}
PAIR_NETS = {f"p{c}_{oc}": dict(name=f"p{c}_{oc}", in_channels=3, out_channels=3,
                                num_channels=c, num_lblocks=0, scaling_factor=s)
             for c in (16, 32) for oc, s in ((3, 1), (12, 2), (27, 3), (48, 4))}
# phase 17: the layer-group form's corners (Bhardwaj et al., MLSys 2022:
# depth, num_lblocks, is the family's own knob; widths 16 as SESR-M*, 32
# as SESR-XL): RGB x4 at 18 convs and x3 at 24, whose last conv of 48 / 27
# outputs runs in the corrected kernel's tail group past 16 convs, and two
# convs (num_lblocks 0) at x2 and at RGB x4 (both corners at once), from
# seeded weights, at the input whose output is 540x960 (cut_frame)
CORNER_NETS = {"m16_x4": dict(name="sesr_m16_x4_rgb", in_channels=3, out_channels=3,
                              num_channels=16, num_lblocks=16, scaling_factor=4),
               "xl22_x3": dict(name="sesr_xl22_x3_rgb", in_channels=3, out_channels=3,
                               num_channels=32, num_lblocks=22, scaling_factor=3),
               "m0_x2": dict(name="sesr_m0_x2", in_channels=3, out_channels=3,
                             num_channels=16, num_lblocks=0, scaling_factor=2),
               "xl0_x4": dict(name="sesr_xl0_x4_rgb", in_channels=3, out_channels=3,
                              num_channels=32, num_lblocks=0, scaling_factor=4)}
# each network's convs at +127 (a split conv in its last group; the
# two-conv networks' last conv), and its sweep config
CORNER_SATURATED = {"m16_x4": (3, 12), "xl22_x3": (3, 18), "m0_x2": (1,), "xl0_x4": (1,)}
# phase 18: networks of other conv sizes (each conv odd, 1 to 9, the first
# conv, the block convs and the last conv each on its own: SESRSpec
# k_first, k_block, k_last) at the SESR paper's widths and depths (SESR-M5:
# 16 channels, 7 convs; SESR-XL: 32 and 13), x2 and RGB x4, from seeded
# weights, at the input whose output is 540x960 (cut_frame), each run as
# layer groups in the forms of other conv sizes (one group where its plan
# fits a block)
KSIZE_NETS = {"m5_k3": dict(name="sesr_m5_k3_x2", in_channels=3, out_channels=3, num_channels=16,
                            num_lblocks=5, scaling_factor=2, k_first=3, k_block=3, k_last=3),
              "m5_k717": dict(name="sesr_m5_k717_x2", in_channels=3, out_channels=3,
                              num_channels=16, num_lblocks=5, scaling_factor=2, k_first=7,
                              k_block=1, k_last=7),
              "xl_k5": dict(name="sesr_xl_k5_x2", in_channels=3, out_channels=3,
                            num_channels=32, num_lblocks=11, scaling_factor=2, k_first=5,
                            k_block=5, k_last=5),
              "m5_k939_x4": dict(name="sesr_m5_k939_x4_rgb", in_channels=3, out_channels=3,
                                 num_channels=16, num_lblocks=5, scaling_factor=4, k_first=9,
                                 k_block=3, k_last=9)}
# each network's convs at +127 (a split conv in its last group: a 3x3 or
# 5x5 conv between, or sesr_m5_k717_x2's 7x7 last conv, whose 1x1 convs'
# partials cannot reach 18 bits), and its sweep config
KSIZE_SATURATED = {"m5_k3": (3,), "m5_k717": (6,), "xl_k5": (3, 9), "m5_k939_x4": (3,)}
KSIZE_CONFIG = {"m5_k3": "pe3_nondivisible", "m5_k717": "pe8_wide", "xl_k5": "pe2_servable",
                "m5_k939_x4": "pe2_narrow"}
# every mode at batch 1 and 4 at each config
KSIZE_MODES = {"pe4_sat": (("sim", "hybrid", "pe-exact", "audit"), (1,)),
               "config": (("sim", "K2", "hybrid", "pe-exact", "audit"), (1, 4))}
# phase 18's sweep of the forms of other conv sizes on a small batch: at
# widths 16 and 32, five-conv networks whose (first, block, last) sizes put
# each of 1, 3, 5, 7 and 9 in each position, at each padded count of the
# last conv (3, 12, 27 and 48 outputs), and two-conv networks at each
# count, at the configs that launch every instantiation (K2 at 4 PEs; K1's
# split passes unrolled at 4 PEs, looped and staged at 3, 8 and 16; the
# corrected kernel's 4, 8 and 16 PE groups)
KSIZE_TRIPLES = ((1, 3, 5), (3, 5, 7), (5, 7, 9), (7, 9, 1), (9, 1, 3))
KSIZE_SWEEP = {f"s{c}_{a}{b}{d}": dict(name=f"s{c}_{a}{b}{d}", in_channels=3, out_channels=3,
                                       num_channels=c, num_lblocks=3, scaling_factor=sc,
                                       k_first=a, k_block=b, k_last=d)
               for c in (16, 32) for (a, b, d), sc in zip(KSIZE_TRIPLES, (1, 2, 3, 4, 1))}
KSIZE_PAIRS = {f"q{c}_{a}{d}": dict(name=f"q{c}_{a}{d}", in_channels=3, out_channels=3,
                                    num_channels=c, num_lblocks=0, scaling_factor=sc,
                                    k_first=a, k_last=d)
               for c in (16, 32) for (a, d), sc in zip(((9, 1), (1, 9), (3, 7), (7, 5)),
                                                       (1, 2, 3, 4))}
KSIZE_SWEEP_HW = {"pe4": {}, "pe3": dict(pe=3), "pe8": dict(pe=8), "pe16": dict(pe=16)}
# phase 19: networks of hidden width 33 to 64, which the SESR paper's
# family does not publish (Bhardwaj et al., MLSys 2022: widths 16 and 32),
# at SESR-M5's and SESR-XL's depths, x2 and RGB x4, and two convs, from
# seeded weights, at the input whose output is 1080x1920 (out_frame), each
# run in the width-64 instantiations of the forms of other conv sizes; a
# network of width 48 runs padded with zero channels to 64
W64_NETS = {"m5_w64": dict(name="sesr_w64_m5_x2", in_channels=3, out_channels=3,
                           num_channels=64, num_lblocks=5, scaling_factor=2),
            "xl_w48": dict(name="sesr_w48_xl_x2", in_channels=3, out_channels=3,
                           num_channels=48, num_lblocks=11, scaling_factor=2),
            "m5_w64_x4": dict(name="sesr_w64_m5_x4_rgb", in_channels=3, out_channels=3,
                              num_channels=64, num_lblocks=5, scaling_factor=4),
            "m0_w64": dict(name="sesr_w64_m0_x2", in_channels=3, out_channels=3,
                           num_channels=64, num_lblocks=0, scaling_factor=2)}
# each network's convs at +127 (a split conv in its last group; the
# two-conv network's last conv), and its sweep config
W64_SATURATED = {"m5_w64": (3,), "xl_w48": (3, 9), "m5_w64_x4": (3,), "m0_w64": (1,)}
W64_CONFIG = {"m5_w64": "pe3_nondivisible", "xl_w48": "pe8_wide", "m5_w64_x4": "pe2_narrow",
              "m0_w64": "pe2_servable"}
# phase 19's sweep of the width-64 instantiations on a small batch: at
# widths 64 and 48 (padded), networks of three convs at each padded count
# of the last conv (3, 12, 27 and 48 outputs) and two-conv networks at each
# count, one group each, with a 9x9 first conv (the corrected kernel's split
# layer 0 in pieces), a 9x9 block conv and a 7x7 last conv (B in pieces in
# every kernel), at KSIZE_SWEEP_HW (K2 at 4 PEs; K1's split passes staged
# in pieces at 4, 3, 8 and 16; the corrected kernel's 4, 8 and 16 PE groups)
W64_SWEEP = {f"w{c}_{a}{b}{d}": dict(name=f"w{c}_{a}{b}{d}", in_channels=3, out_channels=3,
                                     num_channels=c, num_lblocks=nb, scaling_factor=sc,
                                     k_first=a, k_block=b, k_last=d)
             for c, (a, b, d), nb, sc in ((64, (5, 3, 5), 1, 1), (48, (3, 5, 3), 1, 2),
                                         (64, (9, 1, 3), 1, 3), (64, (1, 9, 1), 1, 4))}
W64_PAIRS = {f"v{c}_{a}{d}": dict(name=f"v{c}_{a}{d}", in_channels=3, out_channels=3,
                                  num_channels=c, num_lblocks=0, scaling_factor=sc, k_first=a,
                                  k_last=d)
             for c, (a, d), sc in ((64, (5, 5), 1), (64, (3, 3), 2), (48, (9, 1), 3),
                                   (64, (1, 7), 4))}
# the mode each saturated copy of phases 16 and 17 serves: hybrid, but
# pe-exact for sesr_xl0_x4_rgb, whose certificate stamps neither of its two
# convs once its last is at +127 (its 4-PE artifact, which must serve
# hybrid, runs ``infer --audit 1`` instead)
SATURATED_SERVES = {"m16": "hybrid", "xl22": "hybrid", "m16_x4": "hybrid",
                    "xl22_x3": "hybrid", "m0_x2": "hybrid", "xl0_x4": "pe-exact",
                    **{key: "hybrid" for key in {**KSIZE_NETS, **W64_NETS}}}
CORNER_CONFIG = {"m16_x4": "pe3_nondivisible", "xl22_x3": "pe8_wide", "m0_x2": "pe2_servable",
                 "xl0_x4": "pe2_narrow"}
# every mode at batch 1 and 4 at each config
CORNER_MODES = {"pe4_sat": (("sim", "hybrid", "pe-exact", "audit"), (1,)),
                "config": (("sim", "K2", "hybrid", "pe-exact", "audit"), (1, 4))}


def mode_kernel(mode):
    """The wrapper a call of ``mode_forward(mode, ...)`` launches."""
    from sesr_tpu_torch.ops.kernels import corrected_net, fast_net, pe_exact_net

    return {"sim": pe_exact_net, "fast": fast_net, "k2": fast_net}.get(mode, corrected_net)


def mode_constants(mode, spec, qp, device="cpu"):
    """(wrapper, split mask, KernelConstants) of ``mode_forward(mode, ...)``'s
    launch on ``device``, from the wrappers' own cache on the QuantParams
    (a call on that device then reuses it)."""
    from sesr_tpu_torch.convert import device_constants
    from sesr_tpu_torch.ops.corrected import split_layers
    from sesr_tpu_torch.ops.kernels import corrected_net

    kern = mode_kernel(mode)
    split = split_layers(qp, "pe-exact" if mode == "audit" else mode) \
        if kern is corrected_net else None
    return kern, split, device_constants(spec, qp, kern.datapath, device, split)[0]


def mode_forward(mode, spec, qp, x):
    """The main path's call of ``mode`` (phases 15 and 16): "sim" K1 behind
    ``sim``, "fast" K2, "hybrid" / "pe-exact" the corrected kernel's modes,
    "audit" its counting form ((output, counts)), "k2" K2's wrapper on the
    quantized frame (a kernel check off the main path, for an artifact the
    certificate does not serve fast)."""
    import torch

    from sesr_tpu_torch.ops.corrected import (audit_forward, hybrid_forward,
                                              pe_exact_corrected_forward)
    from sesr_tpu_torch.ops.fast import fast_forward
    from sesr_tpu_torch.ops.kernels import fast_net
    from sesr_tpu_torch.ops.pe_exact import pe_exact_forward
    from sesr_tpu_torch.quant.integer import quantize_input

    if mode == "sim":
        return pe_exact_forward(spec, qp, x)
    if mode == "fast":
        return fast_forward(spec, qp, x, out_dtype="int8")
    if mode == "hybrid":
        return hybrid_forward(spec, qp, x, out_dtype="int8")
    if mode == "pe-exact":
        return pe_exact_corrected_forward(spec, qp, x, out_dtype="int8")
    if mode == "audit":
        return audit_forward(spec, qp, x)
    return fast_net(spec, qp, quantize_input(x, qp).to(torch.int8).contiguous())


def mode_plain(mode, spec, qp, x):
    """The plain interpreter's output of ``mode_forward(mode, ...)`` on the
    card ("audit": (output, overflow_18))."""
    return chain_plain(mode, spec, qp, x, len(x), {})


def chain_plain(mode, spec, qp, x, batch, memo):
    """``mode_plain(mode, spec, qp, x[:batch])`` from one run of the plain
    interpreter on the card a datapath over the largest batch ``x`` (its
    frames are independent, so a smaller batch's output is the first
    frames'), kept in ``memo`` (one dict a network and config: K2's two
    modes share the fast datapath's run, the PE-exact mode and the counting
    form the corrected one's); the counting form's counts are a batch's
    own, so its run is the batch's."""
    import torch

    from sesr_tpu_torch.ops.conv import pixel_shuffle_nhwc
    from sesr_tpu_torch.quant.integer import integer_forward

    L = spec.num_convs
    corrected, compute, fast_layers = {
        "sim": (False, "exact", None), "fast": (True, "fast", None), "k2": (True, "fast", None),
        "hybrid": (True, "exact", qp.fast_cert_layers and tuple(qp.fast_cert_layers))}.get(
            mode, (True, "exact", None))
    n = batch if mode == "audit" else len(x)
    key = (corrected, compute, fast_layers, n)
    if key not in memo:
        # (the reference datapath's run serves "sim" alone: its output) frame
        # by frame, so that one frame's dumps are held at a time (a 32-channel
        # network's per-PE partials at 16 PEs are 1 GB a layer and frame)
        ys, outs, ovf18 = [], [], 0
        for i in range(n):
            y, dumps = integer_forward(spec, dataclasses.replace(qp, fast_cert_ok=True),
                                       x[i:i + 1], collect_dumps=corrected, corrected=corrected,
                                       compute=compute, fast_layers=fast_layers)
            ys.append(y)
            if corrected:
                outs.append(dumps[f"input.{L}"].to(torch.int8))
                ovf18 = ovf18 + dumps["overflow_18"]
            del dumps
        memo[key] = (torch.cat(ys), torch.cat(outs), ovf18) if corrected \
            else (torch.cat(ys), None, None)
    y, out, ovf18 = memo[key]
    if mode == "sim":
        return y[:batch]
    if mode == "audit":
        return y, ovf18
    if mode != "k2" and spec.has_pixel_shuffle:
        out = pixel_shuffle_nhwc(out, spec.scaling_factor)
    return out[:batch]


def sweep_plain(mode, spec, qp, x, memo):
    """(``mode_plain(mode, ...)``'s output, the plain interpreter's dumps)
    in the sweep, from one run of the plain interpreter on the card a
    datapath, kept in ``memo`` (one dict a network and config: the PE-exact
    mode and the counting form share the corrected datapath's run)."""
    import torch

    from sesr_tpu_torch.ops.conv import pixel_shuffle_nhwc
    from sesr_tpu_torch.quant.integer import integer_forward

    corrected, compute = {"sim": (False, "exact"), "k2": (True, "fast")}.get(mode, (True, "exact"))
    if (corrected, compute) not in memo:
        memo[corrected, compute] = integer_forward(
            spec, dataclasses.replace(qp, fast_cert_ok=True), x, collect_dumps=True,
            corrected=corrected, compute=compute)
    y, dumps = memo[corrected, compute]
    if mode == "sim":
        return y, dumps
    if mode == "audit":
        return (y, dumps["overflow_18"]), dumps
    out = dumps[f"input.{spec.num_convs}"].to(torch.int8)
    if mode == "pe-exact" and spec.has_pixel_shuffle:
        out = pixel_shuffle_nhwc(out, spec.scaling_factor)
    return out, dumps


def boundaries_held(torch, kern, spec, qp, x, dumps, phase=16):
    """The tensors that cross the layer-group boundaries of ``kern``'s chain
    on x (``NetKernel.run``) against the plain interpreter's ``dumps`` (of
    ``kern``'s datapath, ``sweep_plain``): each group's output its
    ``input.{last + 1}`` (the real channels of the width), the shortcut
    ``shortcut_term`` of its ``shortcut``. Returns the boundaries held."""
    from sesr_tpu_torch.ops.corrected import split_layers
    from sesr_tpu_torch.quant.integer import quantize_input, shortcut_term

    split = split_layers(qp, "pe-exact") if kern.datapath == "corrected" else None
    x_q = quantize_input(x, qp).to(torch.int8).contiguous()
    _, trail = kern.run(spec, qp, x_q, split=split)
    c = spec.num_channels
    for g, act, sc in trail:
        if not torch.equal(act[..., :c], dumps[f"input.{g.last + 1}"].to(torch.int8)):
            fail(f"[{phase}] {kern.symbol} {spec.name} {qp.hw}: the activation after convs "
                 f"{g.first}-{g.last} differs from the plain input.{g.last + 1}")
    if trail and not torch.equal(trail[0][2][..., :c],
                                 shortcut_term(dumps["shortcut"], qp, kern.datapath)):
        fail(f"[{phase}] {kern.symbol} {spec.name} {qp.hw}: the shortcut differs from the plain "
             f"one")
    return len(trail) + bool(trail)


def chain_halo(spec, plans):
    """MACs a call computes over the MACs the network needs, from the
    extents of each launch (``halo_ratio``'s, per layer group: a group's
    conv i computes the tile and the ring of the group's convs after it)."""
    L = spec.num_convs
    ks = spec.kernel_sizes
    chans = [spec.in_channels] + [spec.num_channels] * (L - 1) + [spec.conv_out_channels]
    done = need = 0.0
    for g, (th, tw), _ in plans:
        first, last = (0, L - 1) if g is None else (g.first, g.last)
        for i in range(first, last + 1):
            r = sum(k // 2 for k in ks[i + 1:last + 1])
            macs = ks[i] ** 2 * chans[i] * chans[i + 1]
            done += (th + 2 * r) * (tw + 2 * r) * macs / (th * tw)
            need += macs
    return done / need


def boundary_bytes(spec, kc, plans, n, h, w, sc_bytes):
    """(bytes written, bytes read) in device memory at the layer-group
    boundaries of a call over (n, h, w): each group before the last writes
    its activation (width bytes a pixel) once and the next group reads it
    over every tile's extent (its ring); the first group writes the
    shortcut (``sc_bytes`` a channel: K1 int8, the corrected datapath's
    kernels int16) and the last reads it over its tiles' last-conv input
    extents (a ring of k // 2, the last conv's)."""
    written = read = 0
    L = spec.num_convs
    for g, (th, tw), _ in plans:
        tiles = n * -(-h // th) * -(-w // tw)
        if g.first > 0:
            r = sum(k // 2 for k in spec.kernel_sizes[g.first:g.last + 1])
            read += tiles * (th + 2 * r) * (tw + 2 * r) * kc.width
            if g.last == L - 1:
                rs = spec.kernel_sizes[-1] // 2
                read += tiles * (th + 2 * rs) * (tw + 2 * rs) * kc.width * sc_bytes
        if g.last < L - 1:
            written += n * h * w * kc.width * (1 + (sc_bytes if g.first == 0 else 0))
    return written, read


def group_sweep(torch, dev, tag, rng, hit):
    """Phase 16's sweep of every layer-group instantiation: GROUP_NETS (33
    convs, three groups or more a chain: a first, a middle and a last
    group) and PAIR_NETS (two convs, one group whose first conv also adds
    the shortcut) calibrated on the card at 4 PEs and run on a SWEEP_BATCH
    batch at SWEEP_HW's configs through K1 and K2 at 4 PEs, the corrected
    kernel's PE-exact mode and counting form (past 16 outputs the last
    group in its tail instantiations), one launch a group, each output,
    count and boundary tensor torch.equal with the plain interpreter's,
    each group's plan the library's; fails unless every instantiation in
    the two libraries' ptxas reports (the group, two-conv and tail kernels)
    was launched in the phase (``hit``, which it extends). Returns
    (``chain_sweep``'s CUPTI jobs: a middle group of a 33-conv chain, or the
    tail or two-conv group that runs it; no kernels-line entries)."""
    return chain_sweep(torch, dev, tag, rng, hit, 16, {**GROUP_NETS, **PAIR_NETS}, SWEEP_HW,
                       GROUP_FAMILIES, lambda spec: 1 if spec.num_convs == 2 else 3,
                       f"{len(GROUP_NETS)} networks of {GROUP_NETS_CONVS} convs and "
                       f"{len(PAIR_NETS)} of 2")


# each sweep's libraries and the kernel families whose every instantiation
# it must launch
GROUP_FAMILIES = (("sesr_net_group", ("sesr_net_group_kernel", "sesr_net_pair_kernel")),
                  ("sesr_corrected_group", ("sesr_corrected_group_kernel",
                                            "sesr_corrected_group_audit_kernel",
                                            "sesr_corrected_tail_kernel",
                                            "sesr_corrected_tail_audit_kernel")))
KSIZE_FAMILIES = (("sesr_net_ksize", ("sesr_net_ksize_kernel", "sesr_net_ksize_pair_kernel")),
                  ("sesr_corrected_ksize", ("sesr_corrected_ksize_kernel",)),
                  ("sesr_corrected_ksize_audit", ("sesr_corrected_ksize_audit_kernel",)))
W64_FAMILIES = (("sesr_net_w64", ("sesr_net_ksize_kernel", "sesr_net_ksize_pair_kernel")),
                ("sesr_corrected_w64", ("sesr_corrected_ksize_kernel",)),
                ("sesr_corrected_w64_audit", ("sesr_corrected_ksize_audit_kernel",)))


def chain_sweep(torch, dev, tag, rng, hit, phase, nets_kw, configs, families, least, what,
                timed=False):
    """A sweep of layer-group instantiations (phases 16 and 18): each of
    ``nets_kw`` calibrated on the card at 4 PEs and run on a SWEEP_BATCH
    batch at each of ``configs`` through K1, K2 at 4 PEs, the corrected
    kernel's PE-exact mode and its counting form, in at least
    ``least(spec)`` groups (a two-conv network: one), one launch a group,
    each output, count and boundary tensor torch.equal with the plain
    interpreter's, each group's plan the library's; fails unless every
    instantiation of ``families`` ((library, kernel families) pairs, from
    their ptxas reports) was launched in the phase (``hit``, which it
    extends). Returns (a CUPTI job for each instantiation's first group in
    the sweep that is not a chain's first or last, or runs a two-conv or
    tail group, or a network of other conv sizes; with ``timed``, where
    every call is one group, a kernels-line entry for each instantiation:
    its launches in the sweep, and the device ms, plain ms and bound of the
    call that first launched it)."""
    from sesr_tpu_torch.config import HardwareConfig, SESRSpec
    from sesr_tpu_torch.models.sesr import init_params
    from sesr_tpu_torch.ops.kernels import NET_KERNELS, corrected_net, reset_launch_counts
    from sesr_tpu_torch.quant.calibrate import calibrate
    from sesr_tpu_torch.quant.integer import quantize_input
    from sesr_tpu_torch.timing import median_ms

    t0 = time.perf_counter()
    cupti_dir = os.path.join(REPO, "build", "chip_smoke_cupti")
    os.makedirs(cupti_dir, exist_ok=True)
    runs = held = 0
    jobs, swept, pieces0 = [], set(), []
    first, launched = {}, collections.Counter()      # timed: each instantiation's first call
    for seed, (name, kw) in enumerate(nets_kw.items()):
        spec = SESRSpec(**kw)
        params = init_params(spec, torch.Generator().manual_seed(10 * phase + seed))
        calib = [rng.random((1, 48, 64, spec.in_channels), dtype=np.float32)]
        qp = calibrate(spec, params, calib, safe_zero_floor=True, device="cuda")
        x = torch.from_numpy(rng.random(SWEEP_BATCH + (spec.in_channels,),
                                        dtype=np.float32)).to(dev)
        for hname, hw in configs.items():
            hq = dataclasses.replace(qp, hw=HardwareConfig(**hw), fast_cert_layers=None,
                                     fast_cert_ok=False)
            calls = ["sim", "k2"] if hq.hw.pe == 4 else ["sim"]
            calls += ["pe-exact", "audit"]
            memo = {}
            for mode in calls:
                kern, _, kc = mode_constants(mode, spec, hq, dev)
                reset_launch_counts()
                # the plain interpreter once a datapath: outputs and boundaries
                got = mode_forward(mode, spec, hq, x)
                want, dumps = sweep_plain(mode, spec, hq, x, memo)
                made = sum(k.launches for k in NET_KERNELS) + corrected_net.audit_launches
                if mode == "audit":
                    (got, counts), (want, want_counts) = got, want
                    if not torch.equal(counts, want_counts):
                        fail(f"[{phase}] sweep {name} {hname} audit: counts {counts.tolist()} "
                             f"against the plain {want_counts.tolist()}")
                want_groups = least(spec)
                groups_ok = len(kc.groups) == 1 if want_groups == 1 and spec.num_convs == 2 \
                    else len(kc.groups) >= want_groups
                if not groups_ok or made != len(kc.groups) or got.shape != want.shape \
                        or not torch.equal(got, want):
                    fail(f"[{phase}] sweep {name} {hname} {mode}: {len(kc.groups)} groups (want "
                         f"{want_groups} or more), {made} launches (want one a group), "
                         f"equal {got.shape == want.shape and torch.equal(got, want)}")
                plans = chain_plans(kern, spec, kc, phase)  # each group's plan = the library's
                if kern is corrected_net:
                    pieces0 += [f"{name} {hname} {mode} group {gi} (conv {c})"
                                for gi, c in first_in_pieces(spec, kc, plans)]
                for gi, g in enumerate(kc.groups):
                    ikey = ptxas_line(kern, spec, kc, mode == "audit", g)[0]
                    hit.add(ikey)
                    if timed:
                        if len(kc.groups) != 1:
                            fail(f"[{phase}] sweep {name} {hname} {mode}: a timed sweep's calls "
                                 f"are one group each, not {len(kc.groups)}")
                        launched[ikey] += 1
                        first.setdefault(ikey, (name, hname, mode, spec, hq, x, kern, kc))
                    # a middle group of a chain of the group instantiations; the
                    # group that runs a two-conv, tail or other-sizes one
                    if ikey in swept or (gi in (0, len(kc.groups) - 1) and "_group_" in ikey):
                        continue
                    swept.add(ikey)
                    qp_path = os.path.join(cupti_dir, f"p{phase}_sweep_{name}_{hname}.npz")
                    if not os.path.exists(qp_path):
                        hq.save(qp_path)
                    _, t, b = plans[gi]
                    jobs.append(dict(label=f"{ikey} sweep {name} {hname} {mode} convs "
                                           f"{g.first}-{g.last}",
                                     spec=dataclasses.asdict(spec), qparams=qp_path,
                                     symbol=kern.symbol, audit=mode == "audit", tile=list(t),
                                     plan=b, index=gi, groups=len(plans),
                                     shape=list(SWEEP_BATCH),
                                     mode="pe-exact" if kern is corrected_net else None,
                                     pattern=kernel_family(kern, kc, mode == "audit")))
                if mode != "audit":
                    held += boundaries_held(torch, kern, spec, hq, x, dumps, phase)
                runs += 1
    torch.cuda.synchronize()
    want = set()
    for lib, fams in families:
        for family in fams:
            want |= {f"{family}<{args}>" for args in ptxas_report(lib, family)}
    missing = sorted(want - hit)
    print(f"[{phase}] sweep: {what} at {len(configs)} configs, {runs} chains on {SWEEP_BATCH} "
          f"(one launch a group), each torch.equal with the plain interpreter (cuda), each "
          f"group's plan the library's, {held} boundary tensors (activations and shortcuts) "
          f"torch.equal with the plain interpreter's; instantiations of "
          f"{[lib for lib, _ in families]} launched in phase {phase}: {len(want & hit)} of "
          f"{len(want)}, {len(jobs)} CUPTI jobs; {time.perf_counter() - t0:.1f} s {tag}",
          flush=True)
    if pieces0:
        print(f"[{phase}] sweep: groups of the old corrected group kernels whose first conv "
              f"goes in pieces (no whole layer 0 staged): {pieces0}", flush=True)
    if missing:
        fail(f"[{phase}] instantiations phase {phase} never launched: {missing}")
    entries = []
    for ikey, (name, hname, mode, spec, hq, x, kern, kc) in first.items():
        _, split, _ = mode_constants(mode, spec, hq, dev)
        x_q = quantize_input(x, hq).to(torch.int8).contiguous()
        if mode == "audit":
            ms = median_ms(lambda: corrected_net.audit(spec, hq, x_q, split), dev, 20, warmup=3,
                           lead_ms=2.0)
        else:
            ms = median_ms(lambda: kern(spec, hq, x_q, split=split), dev, 20, warmup=3,
                           lead_ms=2.0)
        plain_ms = median_ms(lambda: mode_plain(mode, spec, hq, x), dev, 1, warmup=0)
        weights = sum(int(np.prod(np.shape(wt))) for wt in hq.w_int)
        pixels = int(np.prod(SWEEP_BATCH))
        bnd = bound(2 * weights * pixels,
                    x_q.numel() + pixels * spec.conv_out_channels + weights, INT8_OPS_PER_S)
        print(f"[{phase}] sweep {ikey} ({name} {hname} {mode}, {SWEEP_BATCH}): {ms:.4f} ms a "
              f"call, bound {bnd[0] * 1e3:.3f} us ({bnd[1]}), plain {plain_ms:.3f} ms, "
              f"{launched[ikey]} launches in the sweep {tag}", flush=True)
        entries.append(dict(
            name=f"{ikey}[{spec.name}, {hname}, {mode}, sweep]", route="cuda",
            source=group_source(kern, kc, mode == "audit"),
            replaces=AUDIT_REPLACES if mode == "audit" else REPLACES[kern.symbol],
            launches=launched[ikey], launches_per_frame={"sweep": 1 / SWEEP_BATCH[0]},
            max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
            library_ms=None, ptxas=list(ptxas_line(kern, spec, kc, mode == "audit",
                                                   kc.groups[0])[1]),
            work=f"{spec.name} (sizes {spec.kernel_sizes}), {SWEEP_BATCH}, {mode}, {hq.hw.pe} PEs, "
                 f"one group"))
    return jobs, entries


def deep_phase(torch, dev, card):
    """Phase 16, networks deeper than one launch runs (DEEP_NETS: 18 and 24
    convs) on the card as chains of layer groups, at 270x480 (cut_frame;
    ``chain_phase``: each calibrated and certified at 4 PEs, pe16 and
    DEEP_CONFIG, a copy at 4 PEs with DEEP_SATURATED at +127, the main path
    of DEEP_MODES, ``infer --audit 1``, two virtual ranks of m16, then
    ``group_sweep``, then the times and plans). Returns (the kernels-line
    entries, the CUPTI jobs)."""
    return chain_phase(torch, dev, card, 16, DEEP_NETS, DEEP_CONFIG, DEEP_SATURATED, DEEP_MODES,
                       cut_frame, "m16", group_sweep)


def corner_phase(torch, dev, card):
    """Phase 17, the layer-group form's two corners on the card
    (CORNER_NETS): RGB x3 / x4 networks past 16 convs, whose last group
    runs the corrected kernel's tail instantiations, and two-conv networks,
    one group whose first conv also adds the shortcut, each at the input
    whose output is 540x960 (cut_frame), through ``chain_phase``: every
    mode at batch 1 and 4 at 4 PEs, pe16 and CORNER_CONFIG, a copy at 4 PEs
    with CORNER_SATURATED at +127 (a split conv in the last group),
    ``infer --audit 1``, sesr_m0_x2 at two virtual ranks, then the times
    and plans (phase 16's sweep launches every two-conv and tail
    instantiation). Returns (the kernels-line entries, the CUPTI jobs)."""
    return chain_phase(torch, dev, card, 17, CORNER_NETS, CORNER_CONFIG, CORNER_SATURATED,
                       CORNER_MODES, cut_frame, "m0_x2", None)


def ksize_sweep(torch, dev, tag, rng, hit):
    """Phase 18's sweep of every instantiation of the forms of other conv
    sizes (``chain_sweep``): KSIZE_SWEEP and KSIZE_PAIRS at KSIZE_SWEEP_HW,
    every group launched in sesr_net_ksize.cu's and
    sesr_corrected_ksize.cu's kernels."""
    return chain_sweep(torch, dev, tag, rng, hit, 18, {**KSIZE_SWEEP, **KSIZE_PAIRS},
                       KSIZE_SWEEP_HW, KSIZE_FAMILIES, lambda spec: 1,
                       f"{len(KSIZE_SWEEP)} five-conv networks (sizes {KSIZE_TRIPLES}) and "
                       f"{len(KSIZE_PAIRS)} two-conv ones", timed=True)


def ksize_phase(torch, dev, card):
    """Phase 18, networks of other conv sizes on the card (KSIZE_NETS), at
    the input whose output is 540x960 (cut_frame), through
    ``chain_phase``: every mode at batch 1 and 4 at 4 PEs, pe16 and
    KSIZE_CONFIG, a copy at 4 PEs with KSIZE_SATURATED at +127, ``infer
    --audit 1``, sesr_m5_k3_x2 at two virtual ranks, then ``ksize_sweep``,
    then the times and plans. Returns (the kernels-line entries, the CUPTI
    jobs)."""
    return chain_phase(torch, dev, card, 18, KSIZE_NETS, KSIZE_CONFIG, KSIZE_SATURATED,
                       KSIZE_MODES, cut_frame, "m5_k3", ksize_sweep)


def width_sweep(torch, dev, tag, rng, hit):
    """Phase 19's sweep of every width-64 instantiation (``chain_sweep``):
    W64_SWEEP and W64_PAIRS at KSIZE_SWEEP_HW, every group launched in
    sesr_net_w64.cu's, sesr_corrected_w64.cu's and
    sesr_corrected_w64_audit.cu's kernels."""
    return chain_sweep(torch, dev, tag, rng, hit, 19, {**W64_SWEEP, **W64_PAIRS},
                       KSIZE_SWEEP_HW, W64_FAMILIES, lambda spec: 1,
                       f"{len(W64_SWEEP)} networks of 3 convs and {len(W64_PAIRS)} two-conv "
                       f"ones at widths 48 and 64", timed=True)


def width_phase(torch, dev, card):
    """Phase 19, networks of hidden width 33 to 64 on the card (W64_NETS),
    at the input whose output is 1080x1920 (out_frame), through
    ``chain_phase``: every mode at batch 1 and 4 at 4 PEs, pe16 and
    W64_CONFIG, a copy at 4 PEs with W64_SATURATED at +127, ``infer --audit
    1``, sesr_w64_m0_x2 at two virtual ranks, then ``width_sweep``, then the
    times and plans. Returns (the kernels-line entries, the CUPTI jobs)."""
    return chain_phase(torch, dev, card, 19, W64_NETS, W64_CONFIG, W64_SATURATED, KSIZE_MODES,
                       out_frame, "m0_w64", width_sweep)


def chain_phase(torch, dev, card, phase, nets_kw, configs, saturated, modes_of, frame_of,
                sharded, sweep):
    """Networks that run as chains of layer groups on the card (phases 16
    and 17): each of ``nets_kw`` calibrated from seeded weights and
    certified (``certify_fast``, its kernel equality run through the chain)
    on the card at 4 PEs, at pe16 and at its sweep config (``configs``),
    and a copy at 4 PEs with the convs ``saturated`` at +127 (a split conv
    in the last group: it serves SATURATED_SERVES' mode). Then, with the
    launch counters at
    0 before and read after each call, at ``frame_of(spec)``: the modes and
    batches of ``modes_of`` (K1 ``pe_exact_forward``; "K2": K2 where
    certified, else its wrapper against the plain fast datapath; both
    corrected modes; the counting form) at each config; each call must
    launch its kernel once a group (the counting form: once a group,
    counted in ``audit_launches``), each output torch.equal with the plain
    interpreter on the card, each count array with its overflow_18.
    ``serve`` with ``audit_every=1`` (``infer --audit 1``) on the saturated
    networks, its audits on the counting chain held to the plain
    interpreter; the network ``sharded`` through ``virtual_rank_forward``'s
    windows at 2 virtual ranks, equal to its monolithic chain. Then
    ``sweep``. Then each (kernel, network, mode, config)'s device ms per
    frame at batch 1, bound and share, launches per call, each group's tile
    and plan (held to the library's; CUPTI's in phase 14's process through
    the jobs returned, the sweep's among them), MACs computed over needed
    (``chain_halo``) beside a single launch's at the largest tile its plan
    fits (not run), the bytes crossing the boundaries, ptxas's registers
    and spills of each instantiation. Returns (the kernels-line entries,
    the CUPTI jobs)."""
    from sesr_tpu_torch.cli import serve
    from sesr_tpu_torch.config import HardwareConfig, SESRSpec
    from sesr_tpu_torch.deploy import select_forward
    from sesr_tpu_torch.models.sesr import init_params
    from sesr_tpu_torch.ops.corrected import split_layers
    from sesr_tpu_torch.ops.kernels import (NET_KERNELS, SMEM_LIMIT, corrected_net,
                                            pe_exact_net, reset_launch_counts)
    from sesr_tpu_torch.parallel.tiling import virtual_rank_forward
    from sesr_tpu_torch.quant.calibrate import calibrate
    from sesr_tpu_torch.quant.certify import certify_fast
    from sesr_tpu_torch.quant.integer import quantize_input
    from sesr_tpu_torch.timing import median_ms

    tag = f"({card})"
    t_phase, st = time.perf_counter(), Steps()
    rng = np.random.default_rng(phase)
    nets = {}
    for seed, (key, kw) in enumerate(nets_kw.items()):
        spec = SESRSpec(**kw)
        params = init_params(spec, torch.Generator().manual_seed(phase + seed))
        calib = [rng.random((1, 96, 128, 3), dtype=np.float32) for _ in range(2)]
        cert = [rng.random((1,) + CERT_FRAME + (3,), dtype=np.float32) for _ in range(2)]
        for cname in ("pe4", "pe16", configs[key]):
            t0 = time.perf_counter()
            qp = calibrate(spec, params, calib, hw=HardwareConfig(**HW_CONFIGS.get(cname, {})),
                           safe_zero_floor=True, device="cuda")
            t1 = time.perf_counter()
            reset_launch_counts()
            qp = certify_fast(spec, qp, cert, device="cuda")
            made = {k.symbol: k.launches for k in NET_KERNELS if k.launches}
            print(f"[{phase}] {spec.name} ({spec.num_convs} convs of {spec.num_channels}, "
                  f"{spec.conv_out_channels} outputs) at {cname}: calibrate {t1 - t0:.2f} s, "
                  f"certify_fast {time.perf_counter() - t1:.2f} s on the card ({made} launches: "
                  f"the kernel equality through the chain); {qp.cert_grade} {qp.cert_stamps}, "
                  f"serves {select_forward(qp)[0]}", flush=True)
            nets[key, cname] = (spec, qp, cert)
        spec, qp, cert = nets[key, "pe4"]
        sats = saturated[key]
        sat = dataclasses.replace(qp, w_int=[
            np.full_like(np.asarray(w), 127) if i in sats else np.asarray(w)
            for i, w in enumerate(qp.w_int)])
        sat = certify_fast(spec, sat, cert, device="cuda")
        hyb = split_layers(sat, "hybrid")
        print(f"[{phase}] {spec.name} with convs {sats} at +127: {sat.cert_grade} "
              f"{sat.cert_stamps}, serves {select_forward(sat)[0]}; split hybrid "
              f"{[i for i, f in enumerate(hyb) if f]}", flush=True)
        serves = SATURATED_SERVES[key]
        if select_forward(sat)[0] != serves or not all(hyb[i] for i in sats):
            fail(f"[{phase}] the saturated {spec.name} should serve {serves} with convs {sats} "
                 f"split")
        nets[key, "pe4_sat"] = (spec, sat, cert)

    st("artifacts")
    x4 = {key: torch.from_numpy(rng.random((4, *frame_of(SESRSpec(**kw)), 3),
                                           dtype=np.float32)).to(dev)
          for key, kw in nets_kw.items()}
    # the main path: every (network, config, mode), counters at 0 before
    # each call and read after
    own, hit = {}, set()
    launches = {k.symbol: 0 for k in NET_KERNELS}
    launches["sesr_corrected_audit"] = 0
    for (key, cname), (spec, qp, _) in nets.items():
        served = select_forward(qp)[0]
        k2 = "fast" if qp.fast_cert_ok else "k2"
        modes, batches = modes_of.get(cname, modes_of["config"])
        modes = tuple(k2 if m == "K2" else m for m in modes)
        modes += (served,) if served not in modes else ()
        memo = {}
        for mode in modes:
            kern, split, kc = mode_constants(mode, spec, qp, dev)
            # a network of other conv sizes runs in groups from one on
            least = 1 if spec.num_convs == 2 or kc.ksize_form else 2
            if len(kc.groups) < least or (spec.num_convs == 2 and len(kc.groups) != 1):
                fail(f"[{phase}] {key} {cname} {mode}: {len(kc.groups)} layer groups, want "
                     f"{'1' if spec.num_convs == 2 else f'{least} or more'}")
            hit.update(chain_lines(kern, spec, kc, mode == "audit"))
            for batch in batches:
                x = x4[key][:batch]
                reset_launch_counts()
                got = mode_forward(mode, spec, qp, x)
                made = {k.symbol: k.launches for k in NET_KERNELS if k.launches}
                if mode == "audit":
                    if made or corrected_net.audit_launches != len(kc.groups):
                        fail(f"[{phase}] {key} {cname} audit batch {batch} launched {made} and "
                             f"{corrected_net.audit_launches} counting launches, want "
                             f"{len(kc.groups)} counting launches")
                    launches["sesr_corrected_audit"] += len(kc.groups)
                elif made != {kern.symbol: len(kc.groups)} or corrected_net.audit_launches:
                    fail(f"[{phase}] {key} {cname} {mode} batch {batch} launched {made}, want "
                         f"{len(kc.groups)} launches of {kern.symbol} (one a group)")
                else:
                    launches[kern.symbol] += len(kc.groups)
                entry = own.setdefault((key, cname, mode), [0, 0])
                entry[0] += len(kc.groups)
                entry[1] += batch
                want = chain_plain(mode, spec, qp, x4[key][:max(batches)], batch, memo)
                counts = None
                if mode == "audit":
                    (got, counts), (want, want_counts) = got, want
                    if not torch.equal(counts, want_counts):
                        fail(f"[{phase}] {key} {cname} audit batch {batch}: counts "
                             f"{counts.tolist()} against the plain {want_counts.tolist()}")
                if got.shape != want.shape or not torch.equal(got, want):
                    fail(f"[{phase}] {key} {cname} {mode} batch {batch}: differs from the plain "
                         f"interpreter")
                if not bool(torch.isfinite(got.float()).all()):
                    fail(f"[{phase}] {key} {cname} {mode} batch {batch}: non-finite output")
                print(f"[{phase}] {spec.name} {cname} {mode} batch {batch}: "
                      f"{len(kc.groups)} groups {[(g.first, g.last) for g in kc.groups]}, "
                      f"{len(kc.groups)} launches, output {tuple(got.shape)} {got.dtype} "
                      f"torch.equal with plain (cuda)"
                      f"{'' if counts is None else f'; counts {counts.tolist()}'}", flush=True)
                del got, want
    torch.cuda.synchronize()
    st("main path")
    print(f"[{phase}] main path: launches {launches}; per network, config and mode (launches, "
          f"frames) {own} {tag}", flush=True)

    # infer --audit 1 (cli.serve) on the saturated networks (or, where the
    # saturated copy serves pe-exact, which audits nothing, the 4-PE
    # artifact, which must serve hybrid): the audits on the counting chain
    # (the plain interpreter barred on the card), then held to it; the
    # artifact's static proofs dropped, so that every layer stamped fast is
    # trusted on empirical evidence and audited
    for key in nets_kw:
        spec, sat, _ = nets[key, "pe4_sat"]
        if SATURATED_SERVES[key] == "pe-exact":
            spec, sat, _ = nets[key, "pe4"]
            if select_forward(sat)[0] != "hybrid":
                fail(f"[{phase}] {spec.name}: the 4-PE artifact serves "
                     f"{select_forward(sat)[0]}, not hybrid")
            print(f"[{phase}] {spec.name}: the saturated copy serves pe-exact, the 4-PE "
                  f"artifact {select_forward(sat)[0]} ({sat.cert_stamps}) runs --audit 1",
                  flush=True)
        aqp = dataclasses.replace(sat, fast_cert_static=None)
        s = spec.scaling_factor
        data = [(x4[key][i:i + 1].cpu().numpy(),
                 np.zeros((1, s * x4[key].shape[1], s * x4[key].shape[2], 3), np.float32))
                for i in range(2)]
        reset_launch_counts()
        with audit_on_the_kernel(torch) as audits:
            res = serve(spec, aqp, data, batch=1, device="cuda", audit_every=1)
        made = {k.symbol: k.launches for k in NET_KERNELS if k.launches}
        held = check_audits(torch, spec, aqp, audits, phase)
        print(f"[{phase}] infer --audit 1 {spec.name} (convs {saturated[key]} at +127): "
              f"{res.n} frames, mode {res.mode}, {len(audits)} audits on the counting chain "
              f"({corrected_net.audit_launches} counting launches), counts {held}, equal to the "
              f"plain interpreter; launches {made}", flush=True)
        if not audits or corrected_net.audit_launches != len(audits) * len(
                mode_constants("audit", spec, aqp, dev)[2].groups):
            fail(f"[{phase}] infer --audit 1 on {spec.name}: {len(audits)} audits, "
                 f"{corrected_net.audit_launches} counting launches")

    st("--audit 1")
    # the sharded windows: one network served at 2 virtual ranks (one
    # window a rank, each a chain) against the monolithic chain
    spec, qp, _ = nets[sharded, "pe4"]
    mode, fwd = select_forward(qp)
    kern, _, kc = mode_constants(mode, spec, qp, dev)
    x = x4[sharded][:1]
    want = fwd(spec, qp, x, out_dtype="int8")
    reset_launch_counts()
    got = virtual_rank_forward(spec, qp, x, (1, 2), fwd, "int8")
    made = {k.symbol: k.launches for k in NET_KERNELS if k.launches}
    if made != {kern.symbol: 2 * len(kc.groups)} or not torch.equal(got, want):
        fail(f"[{phase}] {spec.name} at 2 virtual ranks: launches {made} (want "
             f"{2 * len(kc.groups)}), equal {torch.equal(got, want)}")
    print(f"[{phase}] {spec.name} {mode} at 2 virtual ranks ({tuple(x.shape)}): two windows, "
          f"{made} launches, torch.equal with the monolithic chain", flush=True)

    # the sweep: every instantiation of the phase on a small batch (phase
    # 18's with a kernels-line entry each)
    st("virtual ranks")
    jobs, entries = sweep(torch, dev, tag, rng, hit) if sweep else ([], [])
    st("sweep")
    cupti_dir = os.path.join(REPO, "build", "chip_smoke_cupti")

    # each (kernel, network, config, mode) at batch 1: times, plans, work
    plain_ms, pieces0 = {}, []
    for (key, cname, mode), (n_launch, n_frames) in own.items():
        spec, qp, _ = nets[key, cname]
        kern, split, kc = mode_constants(mode, spec, qp, dev)
        audit = mode == "audit"
        x1 = x4[key][:1]
        x_q = quantize_input(x1, qp).to(torch.int8).contiguous()
        plans = chain_plans(kern, spec, kc, phase)
        if kern is corrected_net:
            pieces0 += [f"{spec.name} {cname} {mode} group {gi} (conv {c})"
                        for gi, c in first_in_pieces(spec, kc, plans)]
        n, h, w = x_q.shape[:3]
        if audit:
            ms = median_ms(lambda: corrected_net.audit(spec, qp, x_q, split), dev, 20, warmup=3,
                           lead_ms=2.0)
        else:
            ms = median_ms(lambda: kern(spec, qp, x_q, split=split), dev, 20, warmup=3,
                           lead_ms=2.0)
        pkey = (key, cname, mode)
        # one timed call of the plain version, warm from the main path
        plain_ms[pkey] = median_ms(lambda: mode_plain(mode, spec, qp, x1), dev, 1, warmup=0)
        weights = sum(int(np.prod(np.shape(wt))) for wt in qp.w_int)
        macs = weights * n * h * w
        moved = x_q.numel() + n * h * w * spec.conv_out_channels + weights
        bnd = bound(2 * macs, moved, INT8_OPS_PER_S)
        lines = chain_lines(kern, spec, kc, audit)
        # one launch's plan at the largest tile it fits (not run)
        single = next((t for t in kern.tiles
                       if kern.smem_bytes(spec, t, kc.pe_split, kc.pe, True) <= SMEM_LIMIT),
                      None) if spec.num_convs >= 3 and not kc.ksize_form else None
        one = f"{chain_halo(spec, [(None, single, 0)]):.3f} at {single[0]}x{single[1]}" \
            if single else "none: the forms of other conv sizes run in groups" \
            if kc.ksize_form \
            else "none: no tile fits one launch" if spec.num_convs >= 3 \
            else "none: one launch runs 3 or more convs"
        wrote, read = boundary_bytes(spec, kc, plans, n, h, w, 1 if kern is pe_exact_net else 2)
        tiles = "; ".join(f"convs {g.first}-{g.last} {t[0]}x{t[1]} {b} B" for g, t, b in plans)
        label = f"{'sesr_corrected_audit' if audit else kern.symbol} {spec.name} {cname} {mode}"
        ptxas = "; ".join(f"{k} ptxas {r} registers, {sp} B spill stores"
                          for k, (r, sp) in lines.items())
        print(f"[{phase}] {label} {h}x{w}: {ms:.4f} ms/frame, {len(plans)} launches a call "
              f"({tiles}; plans = the library's); share of bound {bnd[0] / ms:.4f} (bound "
              f"{bnd[0] * 1e3:.3f} us, {bnd[1]}: {2 * macs:.4g} int8 ops); MACs computed / "
              f"needed {chain_halo(spec, plans):.3f} (one launch: {one}); boundaries "
              f"(activations and the shortcut) {wrote} B written, {read} B read; {ptxas}; "
              f"split {[i for i in range(spec.num_convs) if kc.pe_split[i]]}; plain "
              f"{plain_ms[pkey]:.3f} ms; launches on the main path {n_launch} over {n_frames} "
              f"frames {tag}", flush=True)
        if mode != "k2":
            entries.append(dict(
                name=f"{'sesr_corrected_audit' if audit else kern.symbol}[{spec.name}, {cname}, "
                     f"{mode}, layer groups]",
                route="cuda", source=group_source(kern, kc, audit),
                replaces=AUDIT_REPLACES if audit else REPLACES[kern.symbol],
                launches=n_launch, launches_per_frame={"main path": n_launch / n_frames},
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms[pkey], bound_ms=bnd[0],
                bound_by=bnd[1], library_ms=None, tiles=[list(t) for _, t, _ in plans],
                smem_plan=[b for _, _, b in plans],
                ptxas={k: list(v) for k, v in lines.items()},
                work=f"{spec.name}, {h}x{w} frame, batch 1, {mode}, {qp.hw.pe} PEs, "
                     f"{len(plans)} layer groups"))
        qp_path = os.path.join(cupti_dir, f"p{phase}_{key}_{cname}.npz")
        qp.save(qp_path)
        for gi, (g, t, b) in enumerate(plans):
            jobs.append(dict(label=f"{label} convs {g.first}-{g.last}",
                             spec=dataclasses.asdict(spec), qparams=qp_path,
                             symbol=kern.symbol, audit=audit, tile=list(t), plan=b, index=gi,
                             groups=len(plans), shape=[1, h, w],
                             mode=("pe-exact" if audit else mode) if kern is corrected_net
                             else None, pattern=kernel_family(kern, kc, audit)))
    what = {16: "deep", 17: "corners", 19: "widths"}.get(phase, "conv sizes")
    st("times and plans")
    if pieces0:
        print(f"[{phase}] groups of the old corrected group kernels whose first conv goes in "
              f"pieces (no whole layer 0 staged): {pieces0}", flush=True)
    print(f"[{phase}] the {what} phase took {time.perf_counter() - t_phase:.1f} s ({st}) {tag}",
          flush=True)
    return entries, jobs


class Steps:
    """Seconds between marks, summed by name: a phase's breakdown line."""

    def __init__(self):
        self.t, self.s = time.perf_counter(), {}

    def __call__(self, what):
        now = time.perf_counter()
        self.s[what] = self.s.get(what, 0.0) + now - self.t
        self.t = now

    def __str__(self):
        return ", ".join(f"{k} {v:.1f} s" for k, v in self.s.items())


def cupti_process(jobs_path):
    """``chip_smoke.py --cupti JOBS``: launch each kernel of JOBS (a JSON
    list of phases 14-16's default-tile launches: the network, its
    QuantParams file, the wrapper, the corrected kernel's mode, whether the
    launch is its counting form, and the tile; for a layer group its index
    in the chain and the chain's groups) once on a seeded 540x960 frame
    (phase 15's: out_frame; the sweep's: its ``shape``, batch first) of the
    network's input channels, and print {label: [registers, shared memory]}
    as CUPTI reports them (``launch_attrs``)."""
    import torch

    sys.path.insert(0, REPO)
    from sesr_tpu_torch.config import SESRSpec
    from sesr_tpu_torch.ops.corrected import split_layers
    from sesr_tpu_torch.ops.kernels import NET_KERNELS, corrected_net
    from sesr_tpu_torch.quant.integer import quantize_input
    from sesr_tpu_torch.quant.params import QuantParams

    with open(jobs_path) as f:
        jobs = json.load(f)
    kernels = {k.symbol: k for k in NET_KERNELS}
    attrs = {}
    for job in jobs:
        spec, qp = SESRSpec(**job["spec"]), QuantParams.load(job["qparams"])
        kern = kernels[job["symbol"]]
        split = split_layers(qp, job["mode"]) if job["mode"] else None
        shape = job.get("shape") or (1, *(out_frame(spec) if job.get("out_frame") else FRAME))
        x = torch.from_numpy(np.random.default_rng(0).random(
            (*shape, spec.in_channels), dtype=np.float32)).to("cuda")
        x_q = quantize_input(x, qp).to(torch.int8).contiguous()
        tile = tuple(job["tile"])
        # a layer group of a chain: the chain at each group's own tile, the
        # group's kernel read from the trace (two chains a trace)
        index, need = job.get("index", -1), 2 * job.get("groups", 1)
        if job.get("groups"):
            tile = None
        if job.get("audit"):
            def fn():
                return corrected_net.audit(spec, qp, x_q, split, tile=tile)
        else:
            def fn():
                return kern(spec, qp, x_q, tile=tile, split=split)
        pattern = job["pattern"]
        fn()                                                      # loads the library

        def twice(fn=fn):
            # a trace may lose a launch's kernel record (on the H100 up to
            # three traces in a row held none): two identical launches a
            # trace, up to five traces
            fn()
            fn()
        attrs.update(launch_attrs(torch, {job["label"]: twice}, pattern, tries=5, index=index,
                                  need=need))
    print(json.dumps(attrs), flush=True)


def bench_phase(torch, dev, card):
    """Phase 13: ``bench`` and ``profile`` on the card (see the module
    docstring). Fails on a row that launched anything but one launch of its
    mode's kernel a call, on a row whose output differs from the plain
    version, and on a profile whose FLOPs are not the convs' or whose peak
    memory was not measured."""
    import contextlib
    import tempfile
    from unittest import mock

    from sesr_tpu_torch import bench
    from sesr_tpu_torch.cli import main as cli_main
    from sesr_tpu_torch.config import spec_for_task
    from sesr_tpu_torch.costs import conv_flops
    from sesr_tpu_torch.ops import corrected, fast, pe_exact
    from sesr_tpu_torch.quant.integer import integer_forward, integer_forward_int8

    t_phase = time.perf_counter()

    def barred(*args, **kwargs):
        raise AssertionError("a timed bench row reached the plain interpreter")

    # the forwards take their plain version only on a CPU tensor: bar it
    # while the rows are timed (the CPU baseline calls bench.integer_forward)
    with contextlib.ExitStack() as stack:
        for mod in (fast, corrected, pe_exact):
            for fn in ("integer_forward", "integer_forward_int8"):
                if hasattr(mod, fn):
                    stack.enter_context(mock.patch.object(mod, fn, barred))
        res = bench.run_bench(device=dev, repeats=BENCH_REPEATS, calls=BENCH_CALLS,
                              all_paths=True, per_task=True)
    print(f"[13] run_bench: {len(res.rows)} rows, {BENCH_REPEATS} samples of {BENCH_CALLS} "
          f"calls each; value {res.result['value']} Mpx/s, baseline {res.baseline_mpxs} "
          f"Mpx/s ({card})", flush=True)
    for row in res.rows:
        expect = {row.kernel.symbol: row.calls}
        if dict(row.launches) != expect:
            fail(f"[13] bench row {row.name}: launches {dict(row.launches)}, not {expect}")
        kw = plain_kwargs(row.kernel, row.qp, row.mode)
        got = row()
        if row.out_dtype == "int8":
            want = integer_forward_int8(row.spec, row.qp, row.x,
                                        compute=kw.pop("compute", "exact"), **kw)
        else:
            want = integer_forward(row.spec, row.qp, row.x, **kw)[0]
        if not torch.equal(got, want):
            fail(f"[13] bench row {row.name}: the output differs from the plain version")
        print(f"[13] {row.name} ({row.mode}): {row.median_mpxs} Mpx/s, {row.ms_per_frame} "
              f"ms/frame as the host issues it, device busy {row.busy_ms / row.x.shape[0]} "
              f"ms/frame; {row.calls} calls launched {dict(row.launches)}; output "
              f"{tuple(got.shape)} {got.dtype} array_equal with plain (cuda)", flush=True)
        del got, want
    if [r.mode for r in res.rows if r.name.startswith("per-task ")] != \
            ["fast", "fast", "fast", "fast", "hybrid", "hybrid", "fast"]:
        fail("[13] the per-task rows do not serve the modes JAX's select_packed_forward picks")

    artifacts = os.path.join(REPO, "artifacts")
    with np.load(os.path.join(REPO, "tests", "goldens", "sr_x2.npz")) as g, \
            tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "sr_x2_collapsed.npz")
        L = int(g["num_convs"])
        np.savez(ckpt, **{f"w_{i}": np.transpose(g[f"w_collapsed_{i}"], (2, 3, 1, 0))
                          for i in range(L)},
                 **{f"b_{i}": g[f"b_collapsed_{i}"] for i in range(L)})
        sr_qp = os.path.join(artifacts, "qparams_sr_x2.npz")
        for task, extra, hw in (
                ("sr_x2", ["--qparams", sr_qp, "--path", "deployment"], FRAME),
                ("sr_x2", ["--qparams", sr_qp, "--path", "interpreter"], FRAME),
                ("sr_x2", ["--checkpoint", ckpt, "--path", "float"], FRAME),
                ("nr", ["--qparams", os.path.join(artifacts, "qparams_nr.npz"), "--path",
                        "deployment"], BAYER_FRAME)):
            c = cli_main(["profile", "--task", task, *extra, "--height", str(hw[0]),
                          "--width", str(hw[1])])
            if c.flops != conv_flops(spec_for_task(task), 1, *hw) or c.peak_temp_bytes is None:
                fail(f"[13] profile {task} {extra}: flops {c.flops}, peak temporaries "
                     f"{c.peak_temp_bytes}")
    print(f"[13] the bench and profile phase took {time.perf_counter() - t_phase:.1f} s "
          f"({card})", flush=True)


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
        from sesr_tpu_torch.quant.certify import adversarial_image
        from sesr_tpu_torch.quant.params import QuantParams
        from sesr_tpu_torch.timing import median_ms
    except ImportError as e:
        fail(f"the port is not next to this script ({e})")

    # 1. the card
    t_start = time.perf_counter()
    laps, lap_at = {}, [t_start]

    def lap(phase):
        """Keep the seconds since the last lap as ``phase``'s (the summary
        line before the last lines)."""
        now = time.perf_counter()
        laps[phase] = round(now - lap_at[0], 1)
        lap_at[0] = now

    card = card_line()
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch: {name} | torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    torch.backends.cudnn.allow_tf32 = False       # the plain version's convs
    torch.backends.cuda.matmul.allow_tf32 = False

    # 2. build every library, one nvcc per source, all started together at
    # BUILD_NICE's priorities; beside them the float parts of phases 8 and
    # 9 (no kernel: they run while K1's library builds), then phases 10, 3,
    # the rest of 9 and 4, in that order (a library's first use waits for
    # its build: K1's, then the corrected kernel's), then the halves of
    # phases 8, 12 and 15 that take no time (their checks and main paths),
    # each phase after the last (one at a time). All the builds are waited
    # for before phase 5: no time in the kernels line is taken beside nvcc
    # (phase 7, whose probes time host-issued library and plain calls,
    # runs after them too)
    t_builds = time.perf_counter()
    pool = ThreadPoolExecutor(len(_build.SIGNATURES))
    builds = {name: pool.submit(_build.build, name, BUILD_NICE.get(name, LATE_NICE))
              for name in _build.SIGNATURES}

    def built():
        for job in builds.values():
            build = job.result()
            print(f"[2] built {os.path.relpath(build.path, REPO)}: nvcc {build.seconds:.1f} s"
                  f"\n{build.log.strip()}", flush=True)
        pool.shutdown()
        print(f"[2] the builds and phases 10, 3, 9, 4 and the untimed halves of 8, 12 and 15 "
              f"beside them took {time.perf_counter() - t_builds:.1f} s", flush=True)
        laps["2 (the builds, nvcc's longest)"] = round(max(
            job.result().seconds for job in builds.values()), 1)
        lap("the wait for the builds after 15's first half")

    # 8. and 9.: their float parts (no kernel) while K1's library builds
    toolchain = toolchain_phase(torch, dev, card)
    training = training_phase(torch, dev, card)
    for phase, part in (("8", toolchain), ("9", training)):
        t0 = time.perf_counter()
        next(part)
        print(f"[{phase}] the float part took {time.perf_counter() - t0:.1f} s ({card}), beside "
              f"the nvcc builds", flush=True)
        lap(f"{phase} (its float part, beside the builds)")

    # 10. the RTL vector export, hist and the experimental models (K1 only):
    # K1's export launches join its entry
    t0 = time.perf_counter()
    export_launches = export_phase(torch, dev, card)
    print(f"[10] the export phase took {time.perf_counter() - t0:.1f} s ({card}); it ran "
          f"beside the nvcc builds: its host-side times (walls, formatting) include the "
          f"builds' CPU load, its device times do not", flush=True)
    lap("10 (beside the builds)")

    spec = spec_for_task(TASK)
    qp = QuantParams.load(os.path.join(REPO, "artifacts", f"qparams_{TASK}.npz"))
    rng = np.random.default_rng(0)

    def artifact(task):
        return spec_for_task(task), QuantParams.load(
            os.path.join(REPO, "artifacts", f"qparams_{task}.npz"))

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
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
    # the counting form (sesr_corrected_audit) on the same edges, nr's
    # adversarial frame first in each batch (layer 0 fires), the others
    # random; then two W blocks as count regions of the (3, 40, 70) batch
    adv_rows = {}
    for shape in CORRECTED_EDGES:
        xt = frames(shape, 3)
        xt[0] = torch.from_numpy(adversarial_image(nr_qp, hw=shape[1:])[0]).to(dev)
        adv_rows[shape] = xt
        audit_check(torch, nr_spec, nr_qp, xt, f"{shape} edge", 3)
    xt = adv_rows[CORRECTED_EDGES[-1]]
    whole = audit_check(torch, nr_spec, nr_qp, xt, "(3, 40, 70) whole", 3)
    halves = sum(audit_check(torch, nr_spec, nr_qp, xt, "block", 3, region=(0, 40, a, b))
                 for a, b in ((0, 33), (33, 70)))
    print(f"[3] sesr_corrected_audit nr (3, 40, 70), count regions of W columns 0-32 and "
          f"33-69: counts {halves.tolist()} sum to the whole frame's: "
          f"{np.array_equal(halves, whole)}", flush=True)
    if not np.array_equal(halves, whole) or not whole[0]:
        fail("the counting form's regions do not add up to the whole frame")
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

    print(f"[3] the kernel checks took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    lap("3 (beside the builds)")
    # 9. training, QAT, AdaRound and make_qparams (the libraries of phase 3
    # only), beside the builds still running: their launches join too
    t0 = time.perf_counter()
    training_launches = finish(training)
    print(f"[9] the training phase's kernels part took {time.perf_counter() - t0:.1f} s "
          f"({card}); it ran beside the nvcc builds still running: its host-side times (walls, "
          f"steps/s) include their CPU load, its device times do not", flush=True)
    lap("9 (its kernels part, beside the builds)")
    t0 = time.perf_counter()
    # 4. the main path, with the launch counters at 0: sr_x2 (infer through
    # K2, sim through K1), beside the builds still running
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

    print(f"[4] the main paths took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    lap("4 (beside the builds)")
    # 8., 12. and 15.: their checks and main paths beside the builds still
    # running (host-side times printed there include the builds' CPU load),
    # their times after the builds
    hwconfig = hwconfig_phase(torch, dev, card)
    out_channels = out_channels_phase(torch, dev, card)
    for phase, checks in (("8", toolchain), ("12", hwconfig), ("15", out_channels)):
        t0 = time.perf_counter()
        next(checks)
        print(f"[{phase}] the checks and main paths took {time.perf_counter() - t0:.1f} s "
              f"({card}), beside the nvcc builds still running", flush=True)
        lap(f"{phase} (its checks, beside the builds)")
    built()
    t0 = time.perf_counter()
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

    print(f"[5] the timing phase took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    lap("5")
    t0 = time.perf_counter()
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
                wall, busy, per, _ = breakdown(torch, fn, batch)
                idle = f"{1.0 - busy / wall}" if busy else "not measured (no device events)"
                print(f"[6] {task} {window}, batch {batch}: wall {wall} ms/frame, device busy "
                      f"{busy} ms/frame, idle share {idle}", flush=True)
                for k, t in per.items():
                    print(f"[6]     {t:.4f} ms  {k}", flush=True)

    print(f"[6] the breakdown phase took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    lap("6")
    # 7. the probes
    t0 = time.perf_counter()
    entries += probes_phase(torch, dev)
    print(f"[7] the probes phase took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    lap("7")

    # 8. the artifact toolchain's times: its launches join the network
    # kernels'
    t0 = time.perf_counter()
    toolchain_launches, audit_e = finish(toolchain)
    entries.append(audit_e)
    print(f"[8] the toolchain phase's times took {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    lap("8 (its times)")
    # 11. sharded execution: the windows' and slabs' launches join K2's and
    # the corrected kernel's entries
    t0 = time.perf_counter()
    sharding_launches = sharding_phase(torch, dev, card)
    print(f"[11] the sharding phase took {time.perf_counter() - t0:.1f} s ({card})", flush=True)
    lap("11")
    # 12. the HardwareConfig family's times: one entry per (kernel, config)
    hw_entries, hw_jobs = finish(hwconfig)
    lap("12 (its times)")
    for e in entries:
        for phase in (toolchain_launches, training_launches, export_launches,
                      sharding_launches):
            for path, (count, n_frames) in phase.get(e["name"], {}).items():
                e["launches"] += count
                e["launches_per_frame"][path] = count / n_frames

    entries += hw_entries
    # 13. bench and profile (their launches stay out of the kernels line)
    bench_phase(torch, dev, card)
    lap("13")
    # 15. last convs of 1 to 48 output channels (its times), 16. networks
    # deeper than one launch runs and 17. the layer-group form's corners
    # (past 16 convs and 16 outputs; two convs), before 14
    out_entries, out_jobs = finish(out_channels)
    lap("15 (its times)")
    deep_entries, deep_jobs = deep_phase(torch, dev, card)
    lap("16")
    corner_entries, corner_jobs = corner_phase(torch, dev, card)
    lap("17")
    # 18. networks of other conv sizes, 19. of hidden width 33 to 64
    ksize_entries, ksize_jobs = ksize_phase(torch, dev, card)
    lap("18")
    width_entries, width_jobs = width_phase(torch, dev, card)
    lap("19")
    # 14. SESR-M11 and SESR-XL: one entry per (kernel, network, mode); the
    # CUPTI processes of phases 12 and 15-19's jobs (six, each on a sixth
    # of them) run beside its main path, before its times
    early = cupti_start(hw_jobs + out_jobs + deep_jobs + corner_jobs + ksize_jobs + width_jobs,
                        "jobs_12_15_16_17_18_19.json", procs=6)
    entries += family_phase(torch, dev, card, early)
    lap("14")
    entries += out_entries + deep_entries + corner_entries + ksize_entries + width_entries
    print(f"[19] chip_smoke.py took {time.perf_counter() - t_start:.1f} s in all ({card})",
          flush=True)
    print(json.dumps({"phase_seconds": laps, "total": round(time.perf_counter() - t_start, 1)}),
          flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}),
          flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cupti"]:
        cupti_process(sys.argv[2])
    else:
        main()
