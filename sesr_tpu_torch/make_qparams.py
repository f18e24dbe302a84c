"""Artifacts from float weights: calibrated, re-rounded, certified.

    python -m sesr_tpu_torch.make_qparams --out-dir DIR [--tasks sr_x4 nr ...] \
        [--checkpoint W.npz] [--weight-rounding nearest|adaround] \
        [--observer minmax|percentile|kl] [--device cpu]
    python -m sesr_tpu_torch.make_qparams --out-dir DIR --qat sr_x4

The counterpart of the JAX package's ``tools/make_qparams.py``. For each
task: calibrate its float weights (the reference checkpoint under
``SESR_REFERENCE_ROOT``, or ``--checkpoint`` for a single task) with the
task's recipe (the per-task defaults below: AdaRound plus the percentile
observer for sr_x4, KL for sr_x2, round-to-nearest and minmax elsewhere),
with ``safe_zero_floor``, certify it over the calibration set and write
``DIR/qparams_{task}.npz``. ``--qat TASK`` also builds the QAT-closed
artifact of TASK (``build_qat_artifact``): a QAT fine-tune of the
reference's expanded checkpoint, the fake-quant-delta collapse,
calibration and certification.

``--out-dir`` is required and may not be the repository's ``artifacts/``:
the shipped artifacts are the JAX package's and this module never
overwrites them. The calibration set is the synthetic one: the real-photo
crops ``tools/make_qparams.py`` adds come from JPEGs that this package
does not read, and that script calibrates on synthetic images alone
without them, too. Everything runs on ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sesr_tpu_torch.config import REFERENCE_CHECKPOINTS, TASKS, spec_for_task
from sesr_tpu_torch.data import SyntheticDataset
from sesr_tpu_torch.io.torch_import import (checkpoint_path, load_reference_checkpoint,
                                            numpy_state_dict, save_collapsed_npz)
from sesr_tpu_torch.metrics import evaluate_pair
from sesr_tpu_torch.models.expanded import (ExpandedParams, ExpandedSESR,
                                            collapse_expanded_qat, expanded_from_state_dict)
from sesr_tpu_torch.models.sesr import CollapsedParams, forward_float
from sesr_tpu_torch.quant.adaround import LayerRounding, adaround_weights
from sesr_tpu_torch.quant.calibrate import calibrate
from sesr_tpu_torch.quant.certify import certify_fast
from sesr_tpu_torch.quant.integer import integer_forward, resolve_device
from sesr_tpu_torch.quant.params import QuantParams
from sesr_tpu_torch.quant.qat import (QATConfig, adam, device_batches, make_train_step, prepare,
                                      run_steps)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# per-task observer winners on held-out real-pixel crops (the JAX
# package's observer study): KL for the super-resolution tasks, minmax for
# the raw-domain tasks (KL clips their sparse Bayer ranges badly)
OBSERVER_DEFAULTS = {"sr_x2": "kl", "sr_x4": "kl"}
# per-task weight-rounding winners: AdaRound gains on sr_x4 and does not
# transfer to held-out data on the small-gap tasks, which keep nearest
WEIGHT_ROUNDING_DEFAULTS = {"sr_x4": "adaround"}
# on AdaRound weights percentile beats KL and minmax on sr_x4: histogram
# clipping tuned on the raw checkpoint does not survive the re-rounding
ADAROUND_OBSERVER_DEFAULTS = {"sr_x4": "percentile"}
# nor does it survive QAT: percentile for the QAT-collapsed weights
QAT_OBSERVER_DEFAULTS = {"sr_x4": "percentile"}


def calibration_images(task: str, n: int, images_dir: Optional[str] = None
                       ) -> List[np.ndarray]:
    """NHWC float32 model inputs of ``task``: the ``.npy`` files of
    ``images_dir``, else ``n`` synthetic images at ground-truth size
    96x128."""
    if images_dir:
        return [np.load(f) for f in sorted(glob.glob(os.path.join(images_dir, "*.npy")))]
    print(f"[make_qparams] {task}: no real-photo crops in this package; calibrating on "
          f"synthetic only", flush=True)
    return [inp for inp, _gt in SyntheticDataset(task, n=n, hw=(96, 128))]


def recipe(task: str, rounding: Optional[str] = None, observer: Optional[str] = None):
    """(rounding, observer) of ``task``: the given ones, else the defaults."""
    rounding = rounding or WEIGHT_ROUNDING_DEFAULTS.get(task, "nearest")
    if observer is None:
        observer = OBSERVER_DEFAULTS.get(task, "minmax")
        if rounding == "adaround":
            observer = ADAROUND_OBSERVER_DEFAULTS.get(task, observer)
    return rounding, observer


@dataclasses.dataclass
class Built:
    """One artifact made here."""

    qp: QuantParams                   # calibrated and certified
    rounding: str
    observer: str
    images: int                       # calibration (and certification) images
    seconds: float                    # wall clock of calibrate + rounding + certify
    layers: List[LayerRounding] = dataclasses.field(default_factory=list)  # AdaRound's
    path: Optional[str] = None


def build_ptq_artifact(task: str, params: CollapsedParams, images: Sequence[np.ndarray],
                       rounding: str = "nearest", observer: str = "minmax",
                       adaround_steps: int = 800, device=None) -> Built:
    """Calibrate ``params`` on ``images`` (safe_zero_floor), optionally
    re-rounding the weights with AdaRound between a nearest-rounding
    calibration and the final one, then certify over the same images."""
    spec = spec_for_task(task)
    dev = resolve_device(None, device)
    t0 = time.perf_counter()
    kwargs = dict(safe_zero_floor=True, observer=observer, device=dev)
    if rounding not in ("nearest", "adaround"):
        raise ValueError(f"rounding must be 'nearest' or 'adaround', got {rounding!r}")
    qp = calibrate(spec, params, images, **kwargs)
    layers: List[LayerRounding] = []
    if rounding == "adaround":
        # the rounding runs on the nearest-rounding artifact's own inputs,
        # then every activation constant is recalibrated at its w_int
        layers = adaround_weights(spec, params, qp, images, steps=adaround_steps,
                                  verbose=True, device=dev)
        qp = calibrate(spec, params, images, w_int_override=[r.w_int for r in layers],
                       **kwargs)
    qp = certify_fast(spec, qp, images, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return Built(qp, rounding, observer, len(images), time.perf_counter() - t0, layers)


@dataclasses.dataclass
class QATBuilt:
    built: Built                      # the calibrated, certified QAT artifact
    collapsed: CollapsedParams        # its own float weights
    losses: List[float]               # per training step
    train_seconds: float
    float_psnr: float                 # held-out, the collapsed float net
    int8_psnr: float                  # held-out, the corrected integer path

    @property
    def gap(self) -> float:
        return self.float_psnr - self.int8_psnr


def build_qat_artifact(task: str, expanded: ExpandedParams, train_data, eval_data,
                       calib_images: Sequence[np.ndarray], steps: int = 300,
                       lr: float = 1e-4, observer: Optional[str] = None,
                       device=None) -> QATBuilt:
    """The QAT-closed artifact: a QAT fine-tune of the expanded weights on
    ``train_data`` ((inp, gt, ...) pairs), the fake-quant-delta collapse,
    calibration (the task's QAT observer, safe_zero_floor) on
    ``calib_images`` and certification; then the held-out PSNR on
    ``eval_data`` of the collapsed float net and of the corrected integer
    path (the gap QAT closes is measured against the artifact's OWN float
    weights)."""
    spec = spec_for_task(task)
    dev = resolve_device(None, device)
    model = ExpandedSESR(spec, expanded).to(dev)
    params = model.params()
    cfg = QATConfig()
    qstate = prepare(spec, cfg, dev)
    step = make_train_step(spec, cfg, params, adam(params, lr))
    qstate, losses, train_seconds = run_steps(step, qstate, device_batches(train_data, dev),
                                              0, steps)
    print(f"[make_qparams] {task} qat: {steps} steps in {train_seconds:.2f} s, final loss "
          f"{losses[-1] if losses else float('nan'):.6f}", flush=True)
    collapsed = collapse_expanded_qat(spec, params)
    obs = observer or QAT_OBSERVER_DEFAULTS.get(task, "percentile")
    built = build_ptq_artifact(task, collapsed, calib_images, "nearest", obs, device=dev)
    fp, ip = [], []
    with torch.inference_mode():
        for inp, gt, *_ in eval_data:
            yf = forward_float(spec, collapsed, inp, device=dev).cpu().numpy()
            fp.append(evaluate_pair(task, yf[0], gt[0], inp[0])[0])
            yi = integer_forward(spec, built.qp, inp, corrected=True,
                                 device=dev)[0].cpu().numpy()
            ip.append(evaluate_pair(task, yi[0], gt[0], inp[0])[0])
    res = QATBuilt(built, collapsed, losses, train_seconds, float(np.mean(fp)),
                   float(np.mean(ip)))
    print(f"[make_qparams] {task} qat: grade={built.qp.cert_grade} "
          f"layers={built.qp.cert_stamps}, observer={obs}; held-out own-FP32 "
          f"{res.float_psnr:.3f} dB, deployment INT8 {res.int8_psnr:.3f} dB, gap "
          f"{res.gap:+.3f} dB", flush=True)
    return res


def _out_dir(path: str) -> str:
    shipped = os.path.realpath(os.path.join(REPO, "artifacts"))
    real = os.path.realpath(path)
    if os.path.commonpath([real, shipped]) == shipped:
        raise SystemExit(f"--out-dir {path} is under the shipped artifacts/ directory, "
                         f"which make_qparams never writes: choose another directory")
    os.makedirs(real, exist_ok=True)
    return path


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(prog="python -m sesr_tpu_torch.make_qparams")
    ap.add_argument("--out-dir", required=True,
                    help="where the artifacts go (never the shipped artifacts/)")
    ap.add_argument("--tasks", nargs="*", default=None,
                    help="PTQ artifacts to build; default every task, or none when "
                         "--qat is given without --tasks")
    ap.add_argument("--checkpoint", default=None,
                    help="float weights of the one task of --tasks (a reference .pth or "
                         "a collapsed .npz); default the reference's own checkpoint")
    ap.add_argument("--images", default=None,
                    help="a folder of .npy NHWC calibration inputs (else synthetic)")
    ap.add_argument("--n-images", type=int, default=8)
    ap.add_argument("--observer", default=None, choices=("minmax", "percentile", "kl"),
                    help="default: the task's recipe")
    ap.add_argument("--weight-rounding", default=None, choices=("nearest", "adaround"),
                    help="default: the task's recipe (adaround for sr_x4)")
    ap.add_argument("--qat", nargs="*", default=None, metavar="TASK",
                    help="also build the QAT-closed artifacts of these tasks from the "
                         "reference's expanded checkpoints")
    ap.add_argument("--qat-steps", type=int, default=300)
    ap.add_argument("--qat-lr", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    out_dir = _out_dir(args.out_dir)
    if args.tasks is None:
        args.tasks = [] if args.qat is not None else sorted(TASKS)
    if args.checkpoint and len(args.tasks) != 1:
        raise SystemExit("--checkpoint holds one task's weights: give exactly one --tasks")
    built: Dict[str, object] = {}
    for task in args.qat or []:
        name = REFERENCE_CHECKPOINTS[task]
        try:
            state = numpy_state_dict(checkpoint_path(name, None))
        except FileNotFoundError as e:
            raise SystemExit(f"--qat {task}: the QAT recipe fine-tunes the reference's "
                             f"expanded checkpoint, and {e}. build_qat_artifact takes "
                             f"expanded weights as an argument (e.g. the port's own "
                             f"float training)")
        expanded = expanded_from_state_dict(spec_for_task(task), state)
        print(f"[make_qparams] {task} qat: synthetic training pairs and held-out set (the "
              f"real-photo crops are not in this package)", flush=True)
        train = list(SyntheticDataset(task, n=16, hw=(96, 128), seed=1000))
        held_out = list(SyntheticDataset(task, n=6, hw=(96, 128), seed=77))
        res = build_qat_artifact(task, expanded, train, held_out,
                                 calibration_images(task, args.n_images, args.images),
                                 steps=args.qat_steps, lr=args.qat_lr,
                                 observer=args.observer, device=args.device)
        save_collapsed_npz(os.path.join(out_dir, f"{task}_qat_collapsed.npz"), res.collapsed)
        res.built.path = os.path.join(out_dir, f"qparams_{task}_qat.npz")
        res.built.qp.save(res.built.path)
        built[f"{task}_qat"] = res
    for task in args.tasks:
        params = load_reference_checkpoint(task, path=args.checkpoint)
        images = calibration_images(task, args.n_images, args.images)
        rounding, observer = recipe(task, args.weight_rounding, args.observer)
        b = build_ptq_artifact(task, params, images, rounding, observer, device=args.device)
        b.path = os.path.join(out_dir, f"qparams_{task}.npz")
        b.qp.save(b.path)
        print(f"[make_qparams] {task}: {b.path} ({os.path.getsize(b.path) / 1e3:.0f} kB, "
              f"grade={b.qp.cert_grade} layers={b.qp.cert_stamps} rounding={rounding} "
              f"observer={observer} over {b.qp.fast_cert_images} images, {b.seconds:.2f} s "
              f"on {torch.device(args.device).type})", flush=True)
        built[task] = b
    return built


if __name__ == "__main__":
    main()
