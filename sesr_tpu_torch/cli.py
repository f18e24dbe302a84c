"""Command-line entry points of the port:

    python -m sesr_tpu_torch eval-float --task sr_x2 --checkpoint W.npz [--data DIR]
    python -m sesr_tpu_torch calibrate --task sr_x2 --checkpoint W.npz --out QP.npz \
        [--observer minmax|percentile|kl] [--force] [--no-eval]
    python -m sesr_tpu_torch certify --task sr_x2 --qparams QP.npz [--out STAMPED.npz]
    python -m sesr_tpu_torch infer --task nr --qparams artifacts/qparams_nr.npz \
        --n-images N [--data DIR] [--batch B] [--out-dtype int8] [--save-dir D] \
        [--audit N]
    python -m sesr_tpu_torch sim --task sr_x2 --qparams artifacts/qparams_sr_x2.npz \
        [--fixture X.npy] [--corrected] [--dump-dir D]

Every command takes ``--device`` (default ``cuda``; ``cpu`` runs the plain
PyTorch versions), ``--data`` (a GTmod12 folder for the super-resolution
tasks, a folder of ``.raw`` Bayer planes for the others; default the
synthetic set of ``--n-images``) and ``--checkpoint`` (float weights: a
reference ``.pth`` or a collapsed ``.npz`` with ``w_i`` HWIO and ``b_i``;
default the reference's own checkpoint).

``eval-float`` scores the float network; ``calibrate`` turns its weights
into an artifact; ``certify`` stamps an artifact with the proofs of where
the fast datapath is exact; ``infer`` serves a dataset through the
certificate-selected deployment forward and scores it, with ``--audit N``
shadow-running the PE-exact interpreter on every Nth dispatch; ``sim`` runs
the reference-exact simulation, or with ``--corrected`` the corrected
datapath. Each command is a thin shell around a function (``evaluate_float``,
``serve``, ``simulate``, ``calibrate``, ``certify_fast``) that callers can
drive with their own data.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from sesr_tpu_torch.config import SESRSpec, spec_for_task
from sesr_tpu_torch.data import RawBayerDataset, SRFolderDataset, SyntheticDataset
from sesr_tpu_torch.data.datasets import SR_SCALE
from sesr_tpu_torch.deploy import select_forward
from sesr_tpu_torch.io.torch_import import load_reference_checkpoint
from sesr_tpu_torch.metrics import evaluate_pair
from sesr_tpu_torch.models.sesr import CollapsedParams, forward_float
from sesr_tpu_torch.ops.corrected import pe_exact_corrected_forward
from sesr_tpu_torch.ops.kernels import OUT_DTYPES
from sesr_tpu_torch.ops.pe_exact import pe_exact_forward
from sesr_tpu_torch.png import save_png
from sesr_tpu_torch.quant.audit import audit_frame, empirically_trusted_layers
from sesr_tpu_torch.quant.calibrate import (OBSERVERS, ObserverRegressionWarning,
                                            fake_quant_forward, guarded_calibrate)
from sesr_tpu_torch.quant.certify import (certify_fast, static_layer_stamps,
                                          static_shortcut_safe)
from sesr_tpu_torch.quant.integer import dequantize_output, integer_forward
from sesr_tpu_torch.quant.params import QuantParams


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


def serve(spec: SESRSpec, qp: QuantParams, dataset, batch: int = 1,
          out_dtype: str = "f32", device="cuda", save_dir: Optional[str] = None,
          audit_every: int = 0, keep_outputs: bool = False) -> ServeResult:
    """Serve every (input, ground truth, ...) item of ``dataset`` through
    the deployment forward the artifact's certificate selects, ``batch``
    frames per dispatch (equal shapes batch together), and score each
    output against its ground truth. With ``save_dir`` each output is
    also written there as ``out_{n:04d}.png``; with ``keep_outputs`` the
    float32 outputs are kept in the result.

    ``audit_every`` = N > 0: every Nth dispatch also runs ``audit_frame``
    (the PE-exact interpreter with its counters) where the serving mode
    trusts a layer on empirical evidence. When the audit fails, the
    dispatch is served again, and the rest of the stream served, through
    the corrected PE-exact forward (sound for every input)."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    device = torch.device(device)
    mode, fwd = select_forward(qp)
    trusted = empirically_trusted_layers(qp, mode) if audit_every > 0 else ()
    data = list(dataset)
    psnrs, ssims, shapes = [], [], []
    outputs = [] if keep_outputs else None
    finite = True
    seconds = audit_seconds = 0.0
    audited, violations = 0, []
    i = dispatch = 0
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
            p, s = evaluate_pair(spec.name, y[j], gt[0], inp[0])
            if save_dir:
                os.makedirs(save_dir, exist_ok=True)
                save_png(y[j], os.path.join(save_dir, f"out_{len(psnrs):04d}.png"))
            if keep_outputs:
                outputs.append(y[j])
            psnrs.append(float(p))
            ssims.append(float(s))
        i += len(group)
        dispatch += 1
    return ServeResult(mode, psnrs, ssims, shapes, finite, seconds, audited, violations,
                       audit_seconds, outputs)


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
    (input, ground truth, ...) item of ``dataset``."""
    psnrs, ssims = [], []
    outputs = [] if keep_outputs else None
    with torch.inference_mode():
        for inp, gt, *_ in dataset:
            y = forward_float(spec, params, inp, device=device).cpu().numpy()
            p, s = evaluate_pair(spec.name, y[0], gt[0], inp[0])
            psnrs.append(float(p))
            ssims.append(float(s))
            if keep_outputs:
                outputs.append(y[0])
    return FloatEvalResult(psnrs, ssims, outputs)


@dataclasses.dataclass
class SimResult:
    y: torch.Tensor                       # dequantized output, pixel-shuffled
    source: str                           # what computed y
    overflow_counts: Optional[List[int]]  # from the plain interpreter, if run
    matches_plain: Optional[bool]         # y == the plain interpreter's, if run


def simulate(spec: SESRSpec, qp: QuantParams, x, device="cuda",
             dump_dir: Optional[str] = None, corrected: bool = False) -> SimResult:
    """The reference-exact simulation of one input, or with ``corrected``
    the corrected datapath (the corrected PE-exact mode). Its output comes
    from a fused kernel on the card (sesr_pe_exact_net, or
    sesr_corrected_net) and from the plain interpreter on the CPU. With
    ``dump_dir`` the plain interpreter also runs, for the stage dumps and
    the per-layer saturation counts the kernels do not keep, and its
    output is compared with the simulated one."""
    device = torch.device(device)
    x = torch.as_tensor(np.asarray(x, np.float32), device=device)
    if corrected:
        y = pe_exact_corrected_forward(spec, qp, x)
    else:
        y = pe_exact_forward(spec, qp, x)
    source = (("kernel sesr_corrected_net" if corrected else "kernel sesr_pe_exact_net")
              if device.type == "cuda" else "plain interpreter")
    if dump_dir is None:
        return SimResult(y, source, None, None)
    y_plain, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=corrected)
    os.makedirs(dump_dir, exist_ok=True)
    np.savez_compressed(os.path.join(dump_dir, "dumps.npz"),
                        y=y.cpu().numpy(),
                        **{k: v.cpu().numpy() for k, v in dumps.items()})
    return SimResult(y, source, [int(v) for v in dumps["overflow_counts"]],
                     bool(torch.equal(y, y_plain)))


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
    # the observer guardrail: a loss of more than 1 dB of ground-truth PSNR
    # against minmax is an error unless --force keeps the observer anyway
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", ObserverRegressionWarning)
        qp = guarded_calibrate(spec, params, data, args.task, observer=args.observer,
                               device=args.device)
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


def cmd_sim(args) -> SimResult:
    spec = spec_for_task(args.task)
    qp = QuantParams.load(args.qparams)
    if args.fixture:
        x = np.load(args.fixture)
    else:
        # the reference's fixture is not shipped: the first synthetic input
        x = SyntheticDataset(args.task, n=1)[0][0]
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
    p.add_argument("--weight-rounding", default="nearest", choices=["nearest"],
                   help="round-to-nearest weights; adaptive rounding (adaround) is "
                        "not ported yet")
    p.set_defaults(fn=cmd_calibrate)

    p = sub.add_parser("certify", help="stamp an artifact with the proofs of where "
                                       "the fast datapath is exact")
    common(p, qparams=True)
    p.add_argument("--out", default=None, help="write the stamped artifact here")
    p.set_defaults(fn=cmd_certify)

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
                   help="every Nth dispatch shadow-runs the PE-exact interpreter "
                        "with its overflow counters; an 18-bit event on an "
                        "empirically stamped layer serves the rest of the stream "
                        "PE-exact (0 = off)")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("sim", help="bit-exact reference integer simulation")
    common(p, qparams=True)
    p.add_argument("--fixture", default=None, help=".npy NHWC input")
    p.add_argument("--corrected", action="store_true",
                   help="the corrected deployment datapath (its PE-exact "
                        "mode) instead of the reference-exact one")
    p.add_argument("--dump-dir", default=None,
                   help="also run the plain interpreter: stage dumps and "
                        "per-layer saturation counts")
    p.set_defaults(fn=cmd_sim)

    args = ap.parse_args(argv)
    return args.fn(args)
