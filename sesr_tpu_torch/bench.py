"""Single-card throughput benchmark of the deployment forward: the
counterpart of the JAX package's ``bench.py`` (``main`` and ``measure``).

    python -m sesr_tpu_torch bench [--all-paths] [--per-task] [--device cuda|cpu]

Prints one JSON line on stdout, ``{"metric", "value", "unit",
"vs_baseline"}``; every row, the baseline and the card's name and power
limit (as ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
gives them) go to stderr.

What is timed: the deployment forward that ``deploy.py`` ``select_forward``
returns for the artifact (the input quantization, the fused kernel, the
dequantize and the pixel shuffle), on an input already on the card, made
once per row from ``np.random.default_rng(0)``. One sample is CUDA events
around ``calls`` back-to-back calls as the host issues them, after a
warm-up call, with no synchronization inside the loop, divided by
``calls``: at batch 1 the host sets that pace. Beside each row go two
device times: its device busy time (``timing.device_busy_ms``:
torch.profiler's kernels and copies of a call), so the gap to the first
number is what the host adds; and ``timing.median_ms`` with ``lead_ms`` > 0
(the card kept busy while the host enqueues a call), which reads the
host's pace too when the call waits for the card inside (the input
quantization's scale is copied from pageable host memory, and such a copy
waits for the stream). Mpx/s is n * H * W input pixels
over a call's seconds, as in the JAX ``measure``. The rows are interleaved
across ``repeats`` and each row's median is reported.

On the card every row must launch the kernel its mode names (K2
``sesr_fast_net`` for fast, the corrected kernel ``sesr_corrected_net`` for
hybrid and pe-exact, K1 ``sesr_pe_exact_net`` for reference-exact) once per
call and no other; a row that launches anything else, or raises, makes the
run raise. No row's failure is caught.

Rows (``H`` x ``W`` is the headline frame, 540x960 by default):

- default: sr_x2 at H x W, batch 1, f32 out (the headline, ``value``);
  batch 8 (the throughput configuration); 2H x 2W input with the int8
  output contract (resolution scaling);
- ``--per-task``: sr_x2, sr_x4, sr_x4_qat, nrdm_3, nrdm_6, nr and dm at
  H x W with their own input channels, each in the mode ``select_forward``
  picks (fast for the certified five, hybrid for nr and nrdm_6);
- ``--all-paths``: K2 at batch 4 (batch 8 is a default row), with the int8
  output at H x W, with a 2H x 2W input and f32 out; K1 on sr_x2 (the
  reference-exact datapath ``sim`` runs); the corrected kernel in its
  PE-exact mode on sr_x2; nr in its hybrid mode and its PE-exact mode.

Rows of the JAX benchmark with no counterpart here: the (2, 4) cell
control row and the 2x4 / 4x4 cell rows (the port does not pack, so cell
geometries do not exist); ``fast_unpacked`` (the XLA interpreter: the port
serves no interpreter, its plain version is the CPU baseline below);
``f32stores`` (an XLA lowering choice of the inter-layer stores; the fused
kernels keep activations on chip); the Pallas rows (their counterpart is K2
itself, which every fast row runs).

``vs_baseline``: the headline median over the rate of the port's own
counterpart of the reference's bit-exact path, measured in the same run:
the plain reference-exact interpreter (``quant/integer.py``
``integer_forward``, ``corrected=False``) on the host CPU over the top-left
quarter of the headline input (270x480 at the default size), after a
warm-up call, median of three calls. Per-pixel rates make the crop fair.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from sesr_tpu_torch.config import SESRSpec, spec_for_task
from sesr_tpu_torch.deploy import select_forward
from sesr_tpu_torch.ops.corrected import pe_exact_corrected_forward
from sesr_tpu_torch.ops.kernels import (NET_KERNELS, NetKernel, corrected_net, fast_net,
                                        pe_exact_net)
from sesr_tpu_torch.ops.pe_exact import pe_exact_forward
from sesr_tpu_torch.quant.integer import integer_forward
from sesr_tpu_torch.quant.params import QuantParams
from sesr_tpu_torch.timing import device_busy_ms, median_ms

ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "artifacts")
TASK = "sr_x2"
FRAME = (540, 960)                  # qHD input -> 1080p output at x2
PER_TASK = ("sr_x2", "sr_x4", "sr_x4_qat", "nrdm_3", "nrdm_6", "nr", "dm")
REPEATS = 5                         # samples per row, interleaved across the rows
CALLS = 50                          # back-to-back calls per sample
DEVICE_CALLS = 20                   # calls behind each device time
LEAD_MS = 1.0                       # the card's sleep before each led call
BASELINE_CALLS = 3
# the kernel each mode launches, and its short name
KERNEL_OF = {"fast": fast_net, "hybrid": corrected_net, "pe-exact": corrected_net,
             "reference-exact": pe_exact_net}
SHORT = {"sesr_fast_net": "K2", "sesr_pe_exact_net": "K1",
         "sesr_corrected_net": "the corrected kernel"}


def _reference_exact(spec: SESRSpec, qp: QuantParams, x, out_dtype: str = "f32"):
    """K1's forward in the rows' signature (it has the f32 output only)."""
    if out_dtype != "f32":
        raise ValueError(f"the reference-exact forward has no {out_dtype!r} output")
    return pe_exact_forward(spec, qp, x)


# the forwards of the rows that do not serve the certificate's mode
FORCED = {"pe-exact": pe_exact_corrected_forward, "reference-exact": _reference_exact}


@dataclasses.dataclass
class Row:
    """One timed configuration: ``forward(spec, qp, x, out_dtype)`` in
    ``mode`` on the device-resident input ``x``."""

    name: str
    task: str                   # the artifact, artifacts/qparams_<task>.npz
    spec: SESRSpec
    qp: QuantParams
    mode: str                   # fast, hybrid, pe-exact or reference-exact
    forward: Callable
    x: torch.Tensor
    out_dtype: str = "f32"
    samples_ms: List[float] = dataclasses.field(default_factory=list)   # ms per call
    busy_ms: Optional[float] = None     # device busy per call (torch.profiler); cuda only
    device_events: Optional[float] = None   # kernels and copies per call
    lead_ms: Optional[float] = None     # per call, the card led by LEAD_MS; cuda only
    launches: collections.Counter = dataclasses.field(default_factory=collections.Counter)
    calls: int = 0              # calls made, warm-ups included

    def __call__(self) -> torch.Tensor:
        return self.forward(self.spec, self.qp, self.x, out_dtype=self.out_dtype)

    @property
    def kernel(self) -> NetKernel:
        return KERNEL_OF[self.mode]

    @property
    def pixels(self) -> int:
        """Input pixels per call, n * H * W."""
        n, h, w, _ = self.x.shape
        return n * h * w

    @property
    def mpxs(self) -> List[float]:
        return [self.pixels / ms / 1e3 for ms in self.samples_ms]

    @property
    def median_mpxs(self) -> float:
        return statistics.median(self.mpxs)

    @property
    def ms_per_frame(self) -> float:
        return statistics.median(self.samples_ms) / self.x.shape[0]


@dataclasses.dataclass
class BenchResult:
    rows: List[Row]             # the headline first
    baseline_mpxs: float        # the plain reference-exact interpreter on the host CPU
    result: dict                # the stdout JSON line's object


def load_artifact(task: str):
    """(spec, qp) of a shipped artifact; sr_x4_qat is sr_x4's network."""
    return (spec_for_task(task.removesuffix("_qat")),
            QuantParams.load(os.path.join(ARTIFACTS, f"qparams_{task}.npz")))


def make_rows(device, height: int = FRAME[0], width: int = FRAME[1],
              all_paths: bool = False, per_task: bool = False) -> List[Row]:
    """The rows of a run, the headline first, each with its input on
    ``device`` (see the module docstring)."""
    device = torch.device(device)
    rng = np.random.default_rng(0)
    frame, hd = (height, width), (2 * height, 2 * width)
    rows = []

    def add(task, batch, hw, out_dtype="f32", mode=None, prefix=""):
        spec, qp = load_artifact(task)
        served, forward = select_forward(qp)
        if mode is not None:
            forward = FORCED[mode]
        x = torch.from_numpy(rng.random((batch,) + hw + (spec.in_channels,),
                                        dtype=np.float32)).to(device)
        name = f"{prefix}{task} {hw[0]}x{hw[1]} batch {batch} {out_dtype}"
        rows.append(Row(name + (f" {mode}" if mode else ""), task, spec, qp, mode or served,
                        forward, x, out_dtype))

    add(TASK, 1, frame)
    add(TASK, 8, frame)
    add(TASK, 1, hd, "int8")
    if per_task:
        for task in PER_TASK:
            add(task, 1, frame, prefix="per-task ")
    if all_paths:
        add(TASK, 4, frame)
        add(TASK, 1, frame, "int8")
        add(TASK, 1, hd)
        add(TASK, 1, frame, mode="reference-exact")
        add(TASK, 1, frame, mode="pe-exact")
        add("nr", 1, frame)
        add("nr", 1, frame, mode="pe-exact")
    return rows


def _launch_counts() -> collections.Counter:
    return collections.Counter({k.symbol: k.launches for k in NET_KERNELS})


def sample(row: Row, device: torch.device, calls: int) -> float:
    """One sample of ``row``: ms per call over ``calls`` back-to-back calls
    after a warm-up call (CUDA events on the card, the host clock on the
    CPU). The launches it made join ``row.launches``."""
    before = _launch_counts()
    row()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            row()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / calls
    else:
        t0 = time.perf_counter()
        for _ in range(calls):
            row()
        ms = (time.perf_counter() - t0) * 1e3 / calls
    row.launches.update(_launch_counts() - before)
    row.calls += calls + 1
    return ms


def device_time(row: Row, device: torch.device, calls: int) -> None:
    """``row``'s device times: busy ms and device events per call over
    ``calls`` traced calls, and the median of ``calls`` calls each led by
    LEAD_MS of card time. Their launches join ``row.launches``."""
    before = _launch_counts()
    row.busy_ms, row.device_events = device_busy_ms(row, device, calls)
    row.lead_ms = median_ms(row, device, calls, warmup=1, lead_ms=LEAD_MS)
    row.launches.update(_launch_counts() - before)
    row.calls += 2 * (calls + 1)


def baseline_mpxs(row: Row) -> float:
    """Mpx/s of the plain reference-exact interpreter on the host CPU over
    the top-left quarter of ``row``'s input."""
    n, h, w, _ = row.x.shape
    crop = row.x[:, :h // 2, :w // 2].cpu().contiguous()

    def run():
        integer_forward(row.spec, row.qp, crop, corrected=False)

    ms = median_ms(run, torch.device("cpu"), BASELINE_CALLS, warmup=1)
    mpxs = n * (h // 2) * (w // 2) / ms / 1e3
    print(f"bench: baseline: the plain reference-exact interpreter (integer_forward, "
          f"corrected=False) on the host CPU ({torch.get_num_threads()} threads), "
          f"{h // 2}x{w // 2} crop of the headline input: {mpxs} Mpx/s "
          f"({ms} ms a call, median of {BASELINE_CALLS})", file=sys.stderr, flush=True)
    return mpxs


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu" on
    the CPU); raises when nvidia-smi fails."""
    if device.type != "cuda":
        return "cpu"
    index = device.index if device.index is not None else torch.cuda.current_device()
    res = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return res.stdout.strip()


def run_bench(device="cuda", height: int = FRAME[0], width: int = FRAME[1],
              repeats: int = REPEATS, all_paths: bool = False, per_task: bool = False,
              calls: int = CALLS) -> BenchResult:
    """Measure the rows (``make_rows``), interleaved across ``repeats``,
    print each on stderr and the JSON line on stdout. Raises if a row
    raises, or on the card if a row launched anything but one launch of
    its mode's kernel per call."""
    device = torch.device(device)
    card = card_line(device)
    rows = make_rows(device, height, width, all_paths, per_task)
    for _ in range(repeats):
        for row in rows:
            row.samples_ms.append(sample(row, device, calls))
    for row in rows:
        where = "plain PyTorch"
        if device.type == "cuda":
            device_time(row, device, DEVICE_CALLS)
            expect = {row.kernel.symbol: row.calls}
            if dict(row.launches) != expect:
                raise RuntimeError(f"bench row {row.name}: {row.calls} calls made the launches "
                                   f"{dict(row.launches)}, not {expect}")
            where = f"{SHORT[row.kernel.symbol]} {row.kernel.symbol}"
        n = row.x.shape[0]
        dev_ms = ("not measured on cpu" if row.busy_ms is None
                  else f"busy {row.busy_ms / n} ms/frame ({row.device_events} kernels and "
                       f"copies a call), {row.lead_ms / n} ms/frame led by {LEAD_MS} ms")
        print(f"bench: {row.name} ({row.mode}, {where}): samples "
              f"{row.mpxs} Mpx/s -> median {row.median_mpxs} Mpx/s, "
              f"{row.ms_per_frame} ms/frame as the host issues it; device {dev_ms}",
              file=sys.stderr, flush=True)
    head = rows[0]
    base = baseline_mpxs(head)
    kernel = (f"{SHORT[head.kernel.symbol]} {head.kernel.symbol}" if device.type == "cuda"
              else "plain PyTorch")
    result = {"metric": f"SESR-x2 INT8 inference ({head.mode} deployment datapath, {kernel}), "
                        f"{height}x{width} input, {'1 card' if device.type == 'cuda' else 'cpu'}",
              "value": head.median_mpxs,
              "unit": "Mpixel/s",
              "vs_baseline": head.median_mpxs / base}
    print(f"bench: card: {card}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return BenchResult(rows, base, result)
