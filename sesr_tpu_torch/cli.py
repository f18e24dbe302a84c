"""Command-line entry points of the port:

    python -m sesr_tpu_torch eval-float --task sr_x2 --checkpoint W.npz [--data DIR]
    python -m sesr_tpu_torch calibrate --task sr_x2 --checkpoint W.npz --out QP.npz \
        [--observer minmax|percentile|kl] [--force] [--no-eval] \
        [--weight-rounding nearest|adaround] [--adaround-steps N]
    python -m sesr_tpu_torch train --task sr_x4 --steps N [--qat] [--lr LR] [--seed S] \
        [--init-checkpoint X.pth] [--resume STATE] [--save-every K] [--out W.npz] \
        [--preview-dir D --preview-every K]
    python -m sesr_tpu_torch certify --task sr_x2 --qparams QP.npz [--out STAMPED.npz]
    python -m sesr_tpu_torch infer --task nr --qparams artifacts/qparams_nr.npz \
        --n-images N [--data DIR] [--batch B] [--out-dtype int8] [--save-dir D] \
        [--audit N]
    python -m sesr_tpu_torch sim --task sr_x2 --qparams artifacts/qparams_sr_x2.npz \
        [--fixture X.npy] [--corrected] [--dump-dir D]
    python -m sesr_tpu_torch export --task nr --qparams artifacts/qparams_nr.npz \
        --out-dir D [--fixture X.npy]
    python -m sesr_tpu_torch hist --task sr_x2 --checkpoint W.npz --out D
    python -m sesr_tpu_torch profile --task sr_x2 --qparams artifacts/qparams_sr_x2.npz \
        [--path deployment|interpreter|float] [--height 540] [--width 960]
    python -m sesr_tpu_torch bench [--all-paths] [--per-task]

Every command takes ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions), ``--data`` (a GTmod12 folder for the super-resolution
tasks, a folder of ``.raw`` Bayer planes for the others; default the
synthetic set of ``--n-images``) and ``--checkpoint`` (float weights: a
reference ``.pth`` or a collapsed ``.npz`` with ``w_i`` HWIO and ``b_i``;
default the reference's own checkpoint).

``train`` trains the expanded network (float, or fake-quant with
``--qat``), saves and resumes its whole state, and writes the collapsed
weights the other commands read; ``eval-float`` scores the float network;
``calibrate`` turns its weights into an artifact, re-rounding them with
AdaRound on request; ``certify`` stamps an artifact with the proofs of where
the fast datapath is exact; ``infer`` serves a dataset through the
certificate-selected deployment forward and scores it, with ``--audit N``
shadow-running the PE-exact datapath with its 18-bit event counters on
every Nth dispatch (on the card one launch of the corrected kernel's
counting form); ``sim`` runs
the reference-exact simulation, or with ``--corrected`` the corrected
datapath; ``export`` writes the simulation's RTL hex test vectors (the
input is ``--fixture``, else the reference's own 80x960 sim input, which
``sim`` also takes when it is present); ``hist`` draws the weight and
activation histograms of the float network's fake-quant forward;
``profile`` prints the FLOPs, bytes and peak memory of one forward of a
path (``costs.py``); ``bench`` is the single-card throughput benchmark
(``bench.py``; it takes no ``--task``). Each
command is a thin shell around a function (``evaluate_float``, ``serve``,
``simulate``, ``export_vectors``, ``dump_histograms``, ``calibrate``,
``adaround_weights``, ``certify_fast``, ``make_train_step``) that callers
can drive with their own data. ``python -m sesr_tpu_torch.make_qparams``
builds artifacts.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from sesr_tpu_torch.bench import BenchResult, run_bench
from sesr_tpu_torch.config import REFERENCE_CHECKPOINTS, SESRSpec, spec_for_task
from sesr_tpu_torch.costs import PATHS, Cost, profile_path
from sesr_tpu_torch.data import (RawBayerDataset, SRFolderDataset, SyntheticDataset,
                                 TrainBayerDataset)
from sesr_tpu_torch.data.datasets import (SR_SCALE, load_reference_fixture,
                                          reference_fixture_path)
from sesr_tpu_torch.deploy import select_forward
from sesr_tpu_torch.export.vectors import export_all
from sesr_tpu_torch.io.checkpoint import (load_training_state, save_training_state,
                                          tensor_leaves)
from sesr_tpu_torch.io.torch_import import (checkpoint_path, load_reference_checkpoint,
                                            numpy_state_dict, save_collapsed_npz)
from sesr_tpu_torch.metrics import evaluate_pair
from sesr_tpu_torch.models.expanded import (ExpandedParams, ExpandedSESR, collapse_expanded,
                                            collapse_expanded_qat, expanded_from_state_dict,
                                            forward_expanded, init_expanded)
from sesr_tpu_torch.models.sesr import CollapsedParams, forward_float
from sesr_tpu_torch.ops.corrected import pe_exact_corrected_forward
from sesr_tpu_torch.ops.kernels import OUT_DTYPES
from sesr_tpu_torch.ops.pe_exact import pe_exact_forward
from sesr_tpu_torch.png import save_png
from sesr_tpu_torch.quant.audit import audit_frame, empirically_trusted_layers
from sesr_tpu_torch.quant.adaround import adaround_weights
from sesr_tpu_torch.quant.calibrate import (OBSERVERS, ObserverRegressionWarning, calibrate,
                                            fake_quant_forward, guarded_calibrate)
from sesr_tpu_torch.quant.certify import (certify_fast, static_layer_stamps,
                                          static_shortcut_safe)
from sesr_tpu_torch.quant.integer import dequantize_output, integer_forward
from sesr_tpu_torch.quant.observers import HistogramDump, dump_histograms
from sesr_tpu_torch.quant.params import QuantParams
from sesr_tpu_torch.quant.qat import (QATConfig, QATState, adam, device_batches,
                                     make_train_step, prepare, run_steps)


@dataclasses.dataclass
class ServeResult:
    mode: str                   # the deployment mode served last
    psnr: List[float]           # per image
    ssim: List[float]
    out_shapes: List[tuple]     # per dispatch
    finite: bool                # every served value finite
    forward_seconds: float      # host clock around the forwards, synchronized
    audited: int = 0            # dispatches audited (--audit)
    # (dispatch, layers) of a failed audit; the stream served pe-exact from
    # that dispatch on, so there is at most one
    violations: List[Tuple[int, Tuple[int, ...]]] = dataclasses.field(default_factory=list)
    audit_seconds: float = 0.0  # host clock around the audits, synchronized
    outputs: Optional[List[np.ndarray]] = None   # float32, per image (keep_outputs)

    @property
    def n(self) -> int:
        return len(self.psnr)

    @property
    def mean_psnr(self) -> float:
        return float(np.mean(self.psnr))

    @property
    def mean_ssim(self) -> float:
        return float(np.mean(self.ssim))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# serve and evaluate_float score their outputs on the host in this many
# threads beside the next forwards (numpy frees the GIL)
SCORE_THREADS = 4


class _Scores:
    """Each frame's (PSNR, SSIM) of ``evaluate_pair`` for ``task``, scored
    SCORE_THREADS frames at once beside the caller's next forwards, at most
    twice as many in flight, kept in the order the frames were added; all
    in at the end of the ``with`` block."""

    def __init__(self, task: str):
        self.task = task
        self.psnr, self.ssim = [], []
        self._pending = collections.deque()
        self._pool = ThreadPoolExecutor(SCORE_THREADS)

    def __len__(self) -> int:
        return len(self.psnr) + len(self._pending)

    def add(self, pred, gt, inp) -> None:
        self._pending.append(self._pool.submit(evaluate_pair, self.task, pred, gt, inp))
        self._take(2 * SCORE_THREADS)

    def _take(self, n_left: int) -> None:
        while len(self._pending) > n_left:
            p, s = self._pending.popleft().result()
            self.psnr.append(float(p))
            self.ssim.append(float(s))

    def __enter__(self):
        return self

    def __exit__(self, kind, *_):
        if kind is None:
            self._take(0)
        self._pool.shutdown(cancel_futures=True)


def serve(spec: SESRSpec, qp: QuantParams, dataset, batch: int = 1,
          out_dtype: str = "f32", device="cuda", save_dir: Optional[str] = None,
          audit_every: int = 0, keep_outputs: bool = False) -> ServeResult:
    """Serve every (input, ground truth, ...) item of ``dataset`` through
    the deployment forward the artifact's certificate selects, ``batch``
    frames per dispatch (equal shapes batch together), and score each
    output against its ground truth (on the host, SCORE_THREADS frames at
    once beside the next dispatches; the scores in the stream's order).
    With ``save_dir`` each output is also written there as
    ``out_{n:04d}.png``; with ``keep_outputs`` the float32 outputs are kept
    in the result.

    ``audit_every`` = N > 0: every Nth dispatch also runs ``audit_frame``
    (the PE-exact datapath with its counters: on the card one launch of
    the corrected kernel's counting form) where the serving mode
    trusts a layer on empirical evidence. When the audit fails, the
    dispatch is served again, and the rest of the stream served, through
    the corrected PE-exact forward (sound for every input)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    device = torch.device(device)
    mode, fwd = select_forward(qp)
    trusted = empirically_trusted_layers(qp, mode) if audit_every > 0 else ()
    data = list(dataset)
    shapes = []
    outputs = [] if keep_outputs else None
    finite = True
    seconds = audit_seconds = 0.0
    audited, violations = 0, []
    i = dispatch = 0
    with _Scores(spec.name) as scores:
        while i < len(data):
            group = [data[i]]
            while (len(group) < batch and i + len(group) < len(data)
                   and data[i + len(group)][0].shape == group[0][0].shape):
                group.append(data[i + len(group)])
            x = torch.from_numpy(np.concatenate([g[0] for g in group])).to(device)
            _sync(device)
            t0 = time.perf_counter()
            y = fwd(spec, qp, x, out_dtype=out_dtype)
            _sync(device)
            seconds += time.perf_counter() - t0
            if trusted and dispatch % audit_every == 0:
                t0 = time.perf_counter()
                res = audit_frame(spec, qp, x, y_served=y if out_dtype == "f32" else None,
                                  mode=mode, warn=False)
                _sync(device)
                audit_seconds += time.perf_counter() - t0
                audited += 1
                if not res.ok:
                    violations.append((dispatch, res.violations))
                    print(f"audit: OOD saturation on dispatch {dispatch}: empirically stamped "
                          f"layer(s) {list(res.violations)} fired 18-bit events (counts "
                          f"{res.ovf18.tolist()}); degrading to pe-exact serving",
                          file=sys.stderr)
                    mode, fwd, trusted = "pe-exact", pe_exact_corrected_forward, ()
                    y = fwd(spec, qp, x, out_dtype=out_dtype)
            shapes.append(tuple(y.shape))
            if out_dtype == "int8":
                # the int8 contract: the consumer dequantizes
                y = dequantize_output(y, qp)
            y = y.cpu().numpy()
            finite = finite and bool(np.isfinite(y).all())
            for j, (inp, gt, *_) in enumerate(group):
                if save_dir:
                    os.makedirs(save_dir, exist_ok=True)
                    save_png(y[j], os.path.join(save_dir, f"out_{len(scores):04d}.png"))
                if keep_outputs:
                    outputs.append(y[j])
                scores.add(y[j], gt[0], inp[0])
            i += len(group)
            dispatch += 1
    return ServeResult(mode, scores.psnr, scores.ssim, shapes, finite, seconds, audited,
                       violations, audit_seconds, outputs)


@dataclasses.dataclass
class FloatEvalResult:
    psnr: List[float]                     # per image
    ssim: List[float]
    outputs: Optional[List[np.ndarray]]   # float32, per image (keep_outputs)

    @property
    def mean_psnr(self) -> float:
        return float(np.mean(self.psnr))

    @property
    def mean_ssim(self) -> float:
        return float(np.mean(self.ssim))


def evaluate_float(spec: SESRSpec, params: CollapsedParams, dataset, device="cuda",
                   keep_outputs: bool = False) -> FloatEvalResult:
    """Score the float32 network (``forward_float``, no TF32) on every
    (input, ground truth, ...) item of ``dataset`` (the scores on the host,
    SCORE_THREADS frames at once beside the next forwards, as ``serve``)."""
    outputs = [] if keep_outputs else None
    with torch.inference_mode(), _Scores(spec.name) as scores:
        for inp, gt, *_ in dataset:
            y = forward_float(spec, params, inp, device=device).cpu().numpy()
            scores.add(y[0], gt[0], inp[0])
            if keep_outputs:
                outputs.append(y[0])
    return FloatEvalResult(scores.psnr, scores.ssim, outputs)


@dataclasses.dataclass
class SimResult:
    y: torch.Tensor                       # dequantized output, pixel-shuffled
    source: str                           # what computed y
    overflow_counts: Optional[List[int]]  # from the plain interpreter, if run
    matches_plain: Optional[bool]         # y == the plain interpreter's, if run
    dumps: Optional[dict] = None          # the plain interpreter's, on the host (keep_dumps)
    interpreter_seconds: float = 0.0      # host clock around it, synchronized


def simulate(spec: SESRSpec, qp: QuantParams, x, device="cuda",
             dump_dir: Optional[str] = None, corrected: bool = False,
             keep_dumps: bool = False) -> SimResult:
    """The reference-exact simulation of one input, or with ``corrected``
    the corrected datapath (the corrected PE-exact mode). Its output comes
    from a fused kernel on the card (sesr_pe_exact_net, or
    sesr_corrected_net) and from the plain interpreter on the CPU. With
    ``dump_dir`` or ``keep_dumps`` the plain interpreter also runs, for the
    stage dumps and the per-layer saturation counts the kernels do not
    keep, and its output is compared with the simulated one; ``dump_dir``
    writes the dumps there, ``keep_dumps`` returns them as numpy."""
    device = torch.device(device)
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    if corrected:
        y = pe_exact_corrected_forward(spec, qp, x)
    else:
        y = pe_exact_forward(spec, qp, x)
    source = (("kernel sesr_corrected_net" if corrected else "kernel sesr_pe_exact_net")
              if device.type == "cuda" else "plain interpreter")
    if dump_dir is None and not keep_dumps:
        return SimResult(y, source, None, None)
    _sync(device)
    t0 = time.perf_counter()
    y_plain, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=corrected)
    host = {k: v.cpu().numpy() for k, v in dumps.items()}
    seconds = time.perf_counter() - t0
    if dump_dir is not None:
        os.makedirs(dump_dir, exist_ok=True)
        np.savez_compressed(os.path.join(dump_dir, "dumps.npz"), y=y.cpu().numpy(), **host)
    return SimResult(y, source, [int(v) for v in host["overflow_counts"]],
                     bool(torch.equal(y, y_plain)), host if keep_dumps else None, seconds)


@dataclasses.dataclass
class ExportResult:
    files: List[str]                      # the paths written
    nbytes: int                           # their total size
    source: str                           # what computed the checked output
    interpreter_seconds: float            # the plain interpreter with dumps
    format_seconds: float                 # formatting and writing the files


def export_vectors(spec: SESRSpec, qp: QuantParams, x, out_dir: str,
                   device="cuda") -> ExportResult:
    """The RTL test vectors of one input (NHWC, batch 1) under ``out_dir``,
    in the reference's output_txt/ layout (``export/vectors.py``). The
    route of ``simulate`` with dumps: the reference-exact output from K1
    on the card (the plain interpreter on the CPU) and the plain
    interpreter's stage dumps, which must give the same output, else
    nothing is written."""
    res = simulate(spec, qp, x, device=device, keep_dumps=True)
    if not res.matches_plain:
        raise RuntimeError(f"export: the output of {res.source} differs from the plain "
                           f"interpreter's; no vectors written")
    t0 = time.perf_counter()
    files = export_all(qp, res.dumps, list(spec.kernel_sizes), out_dir)
    seconds = time.perf_counter() - t0
    return ExportResult(files, sum(os.path.getsize(f) for f in files), res.source,
                        res.interpreter_seconds, seconds)


def dataset_for(task: str, data: Optional[str], n_images: int):
    """The set ``infer`` serves: a GTmod12 folder (super-resolution) or a
    folder of ``.raw`` Bayer planes (the other tasks) when ``data`` is
    given, else ``n_images`` synthetic pairs."""
    if data:
        if task in SR_SCALE:
            return SRFolderDataset(data, scale=SR_SCALE[task])
        return RawBayerDataset(data)
    return SyntheticDataset(task, n=n_images)


def _load_params(args) -> CollapsedParams:
    return load_reference_checkpoint(args.task, path=args.checkpoint or None)


def cmd_eval_float(args) -> FloatEvalResult:
    spec = spec_for_task(args.task)
    res = evaluate_float(spec, _load_params(args),
                         dataset_for(args.task, args.data, args.n_images), device=args.device)
    for p, s in zip(res.psnr, res.ssim):
        print(f"psnr={p:.4f} ssim={s:.4f}")
    print(f"{args.task} mean psnr: {res.mean_psnr:.4f}  ssim: {res.mean_ssim:.4f}")
    return res


def cmd_calibrate(args) -> QuantParams:
    spec = spec_for_task(args.task)
    params = _load_params(args)
    data = list(dataset_for(args.task, args.data, args.n_images))
    extra = {}
    if args.weight_rounding == "adaround":
        # a nearest-rounding calibration drives the layer-by-layer rounding;
        # the guarded calibration and its minmax control then both run at
        # the optimized w_int, so the observer comparison stays fair
        images = [d[0] for d in data]
        qp0 = calibrate(spec, params, images, observer=args.observer, device=args.device)
        extra["w_int_override"] = [r.w_int for r in adaround_weights(
            spec, params, qp0, images, steps=args.adaround_steps, device=args.device)]
    # the observer guardrail: a loss of more than 1 dB of ground-truth PSNR
    # against minmax is an error unless --force keeps the observer anyway
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", ObserverRegressionWarning)
        qp = guarded_calibrate(spec, params, data, args.task, observer=args.observer,
                               device=args.device, **extra)
    for w in caught:
        if not issubclass(w.category, ObserverRegressionWarning):
            warnings.warn_explicit(w.message, w.category, w.filename, w.lineno)
        elif args.force:
            print(f"WARNING (forced): {w.message}", file=sys.stderr)
        else:
            raise SystemExit(f"calibrate: {w.message}\n(re-run with --force to keep "
                             f"this observer anyway)")
    qp.save(args.out)
    print(f"saved {args.out}")
    if not args.no_eval:
        tot_p = tot_s = 0.0
        for inp, gt, *_ in data:
            y = fake_quant_forward(spec, params, inp, device=args.device).cpu().numpy()
            p, s = evaluate_pair(args.task, y[0], gt[0], inp[0])
            tot_p, tot_s = tot_p + p, tot_s + s
        print(f"{args.task} fake-quant mean psnr: {tot_p / len(data):.4f}  "
              f"ssim: {tot_s / len(data):.4f}")
    for d in range(spec.num_convs + 1):
        print(f"domain {d}: scale={qp.a_scale[d]:.6g} zero={qp.a_zero[d]}")
    return qp


def cmd_certify(args) -> QuantParams:
    """Certify an artifact on a data source and print its per-layer stamps
    (S = proven for all inputs, F = fast-safe on this set, x = saturates)."""
    spec = spec_for_task(args.task)
    qp = QuantParams.load(args.qparams)
    images = [inp for inp, *_ in dataset_for(args.task, args.data, args.n_images)]
    if not images and not (all(static_layer_stamps(qp)) and static_shortcut_safe(qp)):
        raise SystemExit(
            "certify: zero images can only certify a fully STATIC artifact (every "
            "layer and the int16 shortcut store proven by interval arithmetic); this "
            "artifact needs empirical evidence: use --n-images > 0 or point --data at "
            "a calibration set")
    qp2 = certify_fast(spec, qp, images, device=args.device)
    print(f"{args.task}: grade={qp2.cert_grade} layers={qp2.cert_stamps} "
          f"over {qp2.fast_cert_images} images")
    static_n = sum(qp2.fast_cert_static)
    emp_n = sum(f and not s for f, s in zip(qp2.fast_cert_layers, qp2.fast_cert_static))
    print(f"  {static_n}/{qp2.num_convs} layers statically proven (input-independent "
          f"interval bound); {emp_n} empirically safe; "
          f"{qp2.num_convs - sum(qp2.fast_cert_layers)} saturate (PE-exact lowering only)")
    print(f"  int16 shortcut store: "
          f"{'statically proven wrap-free' if qp2.shortcut_static else 'empirical bound only'}")
    if args.out:
        qp2.save(args.out)
        print(f"stamped artifact -> {args.out}")
    return qp2


@dataclasses.dataclass
class TrainResult:
    params: ExpandedParams            # trained, on the run's device
    qstate: QATState                  # the QAT observers (fresh when not --qat)
    losses: List[float]               # per step of this run
    start: int                        # the step this run started from (resume)
    seconds: float                    # host clock around the steps, synchronized
    collapsed: Optional[CollapsedParams] = None   # what --out wrote

    @property
    def steps_per_second(self) -> float:
        return len(self.losses) / self.seconds


def training_set(task: str, data: Optional[str], n_images: int) -> list:
    """(inp, gt[, variance]) items: random crops of a .raw Bayer tree for
    the Bayer tasks with ``data``, else ``dataset_for``'s set."""
    if data and task not in SR_SCALE:
        return list(TrainBayerDataset(data))
    return list(dataset_for(task, data, n_images))


def _initial_weights(spec: SESRSpec, args) -> ExpandedParams:
    if not args.init_checkpoint:
        return init_expanded(spec, torch.Generator().manual_seed(args.seed))
    # a warm start from an uncollapsed float checkpoint (expand / squeeze
    # shapes), the reference's own training recipe
    ckpt = args.init_checkpoint
    if ckpt == "reference":
        ckpt = checkpoint_path(REFERENCE_CHECKPOINTS[args.task], None)
    try:
        params = expanded_from_state_dict(spec, numpy_state_dict(ckpt))
    except KeyError as e:
        raise SystemExit(f"--init-checkpoint {ckpt}: missing {e}; a warm start needs an "
                         f"UNCOLLAPSED (expand / squeeze) float checkpoint like the "
                         f"reference's *_raw_G.pth / *_G.pth files")
    print(f"warm start from {ckpt}")
    return params


def cmd_train(args) -> TrainResult:
    """Float or QAT training of the expanded network: Adam + MSE, with
    save / resume of the whole training state (--resume), preview PNGs and
    the collapsed weights (--out) that eval-float, calibrate and certify
    read."""
    spec = spec_for_task(args.task)
    device = torch.device(args.device)
    model = ExpandedSESR(spec, _initial_weights(spec, args)).to(device)
    params = model.params()
    cfg = QATConfig() if args.qat else None
    qstate = prepare(spec, cfg or QATConfig(), device)
    opt = adam(params, args.lr)
    start = 0
    if args.resume and os.path.exists(args.resume):
        saved, qstate, opt_state, start = load_training_state(args.resume, params, qstate)
        with torch.no_grad():
            for p, v in zip(tensor_leaves(params), tensor_leaves(saved)):
                p.copy_(v)
        opt.load_state_dict(opt_state)
        print(f"resumed from {args.resume} at step {start}")
    step = make_train_step(spec, cfg, params, opt)
    data = training_set(args.task, args.data, args.n_images)

    def preview(it):
        # the output on the first training input, as a PNG
        os.makedirs(args.preview_dir, exist_ok=True)
        inp = data[0][0]
        with torch.no_grad():
            y = forward_expanded(spec, params, inp, device=device)[0].cpu().numpy()
        if spec.global_input_skip:
            # sr_x2 predicts a residual: preview the image
            r = spec.scaling_factor
            y = y + np.repeat(np.repeat(inp[0], r, axis=0), r, axis=1)
        save_png(y, os.path.join(args.preview_dir, f"preview_{it:06d}.png"))

    def after(it, qstate, loss):
        if (it - start) % max(1, args.steps // 10) == 0:
            print(f"step {it}: loss {float(loss):.6f}")
        if args.preview_dir and args.preview_every > 0 and (it + 1) % args.preview_every == 0:
            preview(it + 1)
        if args.resume and (it + 1) % args.save_every == 0:
            save_training_state(args.resume, params, qstate, opt.state_dict(), it + 1)

    qstate, losses, seconds = run_steps(step, qstate, device_batches(data, device), start,
                                        args.steps, after)
    if args.resume:
        save_training_state(args.resume, params, qstate, opt.state_dict(), start + args.steps)
    print(f"{args.steps} steps in {seconds:.1f}s ({args.steps / max(seconds, 1e-9):.2f} "
          f"steps/s on {device.type})")
    res = TrainResult(params, qstate, losses, start, seconds)
    if args.out:
        # QAT-trained weights collapse through the fake-quant delta
        # response, the reference's own qat deployment composition
        res.collapsed = (collapse_expanded_qat if args.qat else collapse_expanded)(spec, params)
        save_collapsed_npz(args.out, res.collapsed)
        print(f"collapsed checkpoint -> {args.out}"
              + (" (fake-quant-delta collapse)" if args.qat else ""))
    return res


def cmd_infer(args) -> ServeResult:
    spec = spec_for_task(args.task)
    qp = QuantParams.load(args.qparams)
    if args.out_dtype is None:
        # the PNGs are 8-bit whatever the output, so --save-dir takes the
        # int8 contract and skips the full-resolution float32 output
        args.out_dtype = "int8" if args.save_dir else "f32"
    mode = select_forward(qp)[0]
    if args.audit > 0 and not empirically_trusted_layers(qp, mode):
        print(f"audit: '{mode}' serving of this artifact carries no "
              f"empirical trust (statically proven or PE-exact): nothing to audit",
              file=sys.stderr)
    res = serve(spec, qp, dataset_for(args.task, args.data, args.n_images),
                batch=args.batch, out_dtype=args.out_dtype, device=args.device,
                save_dir=args.save_dir, audit_every=args.audit)
    print(f"{args.task} {torch.device(args.device).type}({res.mode}"
          f"{', int8' if args.out_dtype == 'int8' else ''}"
          f"{f', batch {args.batch}' if args.batch > 1 else ''}) "
          f"mean psnr: {res.mean_psnr:.4f}  ssim: {res.mean_ssim:.4f}  "
          f"({res.n} images)")
    if args.audit > 0:
        print(f"audit: {res.audited} dispatch(es) audited, {len(res.violations)} OOD "
              f"saturation violation(s)"
              + (" - stream degraded to pe-exact" if res.violations else ""))
    if args.save_dir:
        print(f"outputs -> {args.save_dir}/")
    return res


def _fixture(args) -> Tuple[np.ndarray, str]:
    """(input, where it came from): ``--fixture`` (an NHWC .npy), else the
    reference's own sim input (FileNotFoundError when it is absent)."""
    if args.fixture:
        return np.load(args.fixture), args.fixture
    return load_reference_fixture(args.task), reference_fixture_path(args.task)


def cmd_sim(args) -> SimResult:
    spec = spec_for_task(args.task)
    qp = QuantParams.load(args.qparams)
    if args.fixture or os.path.exists(reference_fixture_path(args.task)):
        x, what = _fixture(args)
    else:
        x = SyntheticDataset(args.task, n=1)[0][0]
        what = (f"the first synthetic input ({reference_fixture_path(args.task)} "
                f"is absent)")
    print(f"sim input: {what}")
    res = simulate(spec, qp, x, device=args.device, dump_dir=args.dump_dir,
                   corrected=args.corrected)
    print(f"sim: input {tuple(x.shape)} -> output {tuple(res.y.shape)} "
          f"({res.source} on {args.device})")
    if res.overflow_counts is None:
        print("overflow counts per layer: not computed (the kernel keeps no "
              "counters; --dump-dir runs the plain interpreter for them)")
    else:
        print("overflow counts per layer (plain interpreter):", res.overflow_counts)
        print(f"output equals the plain interpreter's: {res.matches_plain}")
    print(f"QUAN_BIT: {qp.hw.quan_bits}\nBIAS_BIT: {qp.hw.bias_bits}\n"
          f"PE_ACC_BIT: {qp.hw.pe_acc_bits}\nPE_ADD_BIT: {qp.hw.pe_add_bits}\n"
          f"REQUAN_BIT: {qp.hw.requant_bits}\nREQUAN_N_MAX: {qp.hw.requant_n_max}")
    if args.dump_dir:
        print(f"dumps -> {args.dump_dir}/dumps.npz")
    return res


def cmd_export(args) -> ExportResult:
    spec = spec_for_task(args.task)
    qp = QuantParams.load(args.qparams)
    try:
        x, _ = _fixture(args)
    except FileNotFoundError as e:
        # a synthetic frame would write hundreds of MB of vectors at a size
        # the RTL bench never runs
        raise SystemExit(f"export: {e}; pass the input as --fixture X.npy (NHWC)")
    res = export_vectors(spec, qp, x, args.out_dir, device=args.device)
    print(f"export: input {tuple(x.shape)}; the output of {res.source} on {args.device} "
          f"equals the interpreter's whose dumps were written")
    print(f"hex vectors -> {args.out_dir}/: {len(res.files)} files, {res.nbytes / 1e6:.1f} MB; "
          f"interpreter {res.interpreter_seconds:.3f} s, formatting "
          f"{res.format_seconds:.3f} s")
    return res


def cmd_hist(args) -> HistogramDump:
    spec = spec_for_task(args.task)
    data = dataset_for(args.task, args.data, args.n_images)
    res = dump_histograms(spec, _load_params(args), [d[0] for d in data], args.out,
                          device=args.device)
    for d in range(spec.num_convs + 1):
        print(f"domain {d}: range [{res.lo[d]:.6g}, {res.hi[d]:.6g}], "
              f"{int(res.activation[d].sum())} values")
    print(f"wrote {len(res.files)} histogram PNGs under {args.out}")
    return res


def cmd_profile(args) -> Cost:
    """FLOPs, bytes accessed and peak memory of one forward of a path at
    --height x --width (costs.py)."""
    spec = spec_for_task(args.task)
    if args.path in ("deployment", "interpreter") and not args.qparams:
        raise SystemExit(f"--path {args.path} requires --qparams "
                         "(e.g. artifacts/qparams_<task>.npz)")
    qp = QuantParams.load(args.qparams) if args.path != "float" else None
    params = _load_params(args) if args.path == "float" else None
    c = profile_path(spec, args.path, args.height, args.width, args.device, qp=qp,
                     params=params)
    px = args.height * args.width
    print(f"{args.task} {c.label} @ {args.height}x{args.width}:")
    print(f"  flops/frame:          {c.flops:.3e}  ({c.flops / px:.0f}/px; {c.flops_how})")
    print(f"  bytes accessed/frame: {c.bytes:.3e}  (arithmetic intensity "
          f"{c.flops / max(c.bytes, 1):.1f}; {c.bytes_how})")
    temp = ("not measured on cpu" if c.peak_temp_bytes is None
            else f"{c.peak_temp_bytes / 1e6:.1f} MB")
    print(f"  peak temp allocation: {temp}; argument {c.argument_bytes / 1e6:.1f} MB; "
          f"output {c.output_bytes / 1e6:.1f} MB")
    return c


def cmd_bench(args) -> BenchResult:
    return run_bench(device=args.device, all_paths=args.all_paths, per_task=args.per_task)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="sesr_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, qparams=False):
        p.add_argument("--task", required=True,
                       choices=["nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2"])
        if qparams:
            p.add_argument("--qparams", required=True)
        p.add_argument("--device", default="cuda",
                       help="cuda (default: the fused kernels) or cpu (their "
                            "plain PyTorch version)")
        p.add_argument("--data", default=None,
                       help="a GTmod12 folder beside its LRbicx{2,4} folder "
                            "(sr_x2, sr_x4) or a folder of name_H_W.raw Bayer "
                            "planes with name.png ground truth (the other "
                            "tasks); omit for the synthetic set")
        p.add_argument("--n-images", type=int, default=4,
                       help="synthetic images (without --data)")
        p.add_argument("--checkpoint", default=None,
                       help="float weights: a reference .pth or a collapsed .npz "
                            "(w_i HWIO, b_i); default the reference's own "
                            "checkpoint under SESR_REFERENCE_ROOT")

    p = sub.add_parser("eval-float", help="float32 PSNR/SSIM of the float network")
    common(p)
    p.set_defaults(fn=cmd_eval_float)

    p = sub.add_parser("calibrate", help="PTQ calibration into an artifact, and "
                                         "the fake-quant eval")
    common(p)
    p.add_argument("--out", required=True)
    p.add_argument("--observer", default="minmax", choices=list(OBSERVERS))
    p.add_argument("--force", action="store_true",
                   help="keep the chosen observer even when it loses more than 1 dB "
                        "against minmax on the calibration set")
    p.add_argument("--no-eval", action="store_true")
    p.add_argument("--weight-rounding", default="nearest", choices=["nearest", "adaround"],
                   help="round-to-nearest weights, or adaptive rounding fitted layer by "
                        "layer on the calibration set (quant/adaround.py)")
    p.add_argument("--adaround-steps", type=int, default=800,
                   help="optimizer steps per layer of --weight-rounding adaround")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("certify", help="stamp an artifact with the proofs of where "
                                       "the fast datapath is exact")
    common(p, qparams=True)
    p.add_argument("--out", default=None, help="write the stamped artifact here")
    p.set_defaults(fn=cmd_certify)

    p = sub.add_parser("train", help="float / QAT training of the expanded network")
    common(p)
    p.add_argument("--qat", action="store_true",
                   help="fake-quant training (quant/qat.py); --out then collapses "
                        "through the fake-quant delta response")
    p.add_argument("--init-checkpoint", default=None,
                   help="warm start from an uncollapsed reference .pth ('reference': "
                        "the task's own under SESR_REFERENCE_ROOT); default random "
                        "weights from --seed")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None,
                   help="write the collapsed weights (w_i HWIO, b_i) to exactly this path")
    p.add_argument("--resume", default=None,
                   help="training-state file to save to and resume from")
    p.add_argument("--save-every", type=int, default=50)
    p.add_argument("--preview-dir", default=None,
                   help="write the output on the first training input here as a PNG")
    p.add_argument("--preview-every", type=int, default=0,
                   help="steps between preview PNGs (0 = off)")
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("infer", help="deployment inference, scored on a "
                                     "dataset (default: the synthetic set)")
    common(p, qparams=True)
    p.add_argument("--batch", type=int, default=1,
                   help="frames per dispatch (1 = latency mode)")
    p.add_argument("--out-dtype", default=None, choices=list(OUT_DTYPES),
                   help="int8 = the raw quantized image contract; scoring "
                        "dequantizes it. Default: int8 with --save-dir, "
                        "else f32")
    p.add_argument("--save-dir", default=None,
                   help="write the outputs here as out_NNNN.png (8-bit)")
    p.add_argument("--audit", type=int, default=0, metavar="N",
                   help="every Nth dispatch shadow-runs the PE-exact datapath "
                        "with its overflow counters (on the card one launch of the "
                        "corrected kernel's counting form); an 18-bit event on an "
                        "empirically stamped layer serves the rest of the stream "
                        "PE-exact (0 = off)")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("sim", help="bit-exact reference integer simulation")
    common(p, qparams=True)
    p.add_argument("--fixture", default=None,
                   help=".npy NHWC input (default: the reference's sim input when "
                        "present, else the first synthetic input)")
    p.add_argument("--corrected", action="store_true",
                   help="the corrected deployment datapath (its PE-exact "
                        "mode) instead of the reference-exact one")
    p.add_argument("--dump-dir", default=None,
                   help="also run the plain interpreter: stage dumps and "
                        "per-layer saturation counts")
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("export", help="RTL hex test vectors of one simulated input")
    common(p, qparams=True)
    p.add_argument("--fixture", default=None,
                   help=".npy NHWC input (default: the reference's 80x960 sim input "
                        "under SESR_REFERENCE_ROOT)")
    p.add_argument("--out-dir", required=True)
    p.set_defaults(fn=cmd_export)

    p = sub.add_parser("hist", help="weight and activation histogram PNGs")
    common(p)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_hist)

    p = sub.add_parser("profile", help="FLOPs, bytes accessed and peak memory of one "
                                       "forward of a path")
    common(p)
    p.add_argument("--qparams", default=None,
                   help="the artifact (required for the deployment and interpreter paths)")
    p.add_argument("--path", default="deployment", choices=list(PATHS))
    p.add_argument("--height", type=int, default=540)
    p.add_argument("--width", type=int, default=960)
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("bench", help="single-card throughput benchmark")
    p.add_argument("--all-paths", action="store_true",
                   help="also measure the other lowerings (stderr rows)")
    p.add_argument("--per-task", action="store_true",
                   help="also measure every shipped artifact in the mode its "
                        "certificate selects (stderr rows)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default: the fused kernels) or cpu (their plain "
                        "PyTorch version)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    return args.fn(args)
