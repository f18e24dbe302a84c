"""Command-line entry points of the port:

    python -m sesr_tpu_torch infer --task nr --qparams artifacts/qparams_nr.npz \
        --n-images N [--data DIR] [--batch B] [--out-dtype int8] [--save-dir D] \
        [--device cuda]
    python -m sesr_tpu_torch sim --task sr_x2 --qparams artifacts/qparams_sr_x2.npz \
        [--fixture X.npy] [--corrected] [--dump-dir D] [--device cuda]

``infer`` serves a dataset (the synthetic set, or ``--data``: a
GTmod12 folder for the super-resolution tasks, a folder of ``.raw`` Bayer
planes for the others) through the certificate-selected deployment
forward and scores it; ``sim`` runs the reference-exact simulation, or
with ``--corrected`` the corrected datapath. Each command is a thin shell
around one function (``serve``, ``simulate``) that callers can drive with
their own data.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List, Optional

import numpy as np
import torch

from sesr_tpu_torch.config import SESRSpec, spec_for_task
from sesr_tpu_torch.data import RawBayerDataset, SRFolderDataset, SyntheticDataset
from sesr_tpu_torch.data.datasets import SR_SCALE
from sesr_tpu_torch.deploy import select_forward
from sesr_tpu_torch.metrics import evaluate_pair
from sesr_tpu_torch.ops.corrected import pe_exact_corrected_forward
from sesr_tpu_torch.ops.kernels import OUT_DTYPES
from sesr_tpu_torch.ops.pe_exact import pe_exact_forward
from sesr_tpu_torch.png import save_png
from sesr_tpu_torch.quant.integer import dequantize_output, integer_forward
from sesr_tpu_torch.quant.params import QuantParams


@dataclasses.dataclass
class ServeResult:
    mode: str                   # the certificate-selected deployment mode
    psnr: List[float]           # per image
    ssim: List[float]
    out_shapes: List[tuple]     # per dispatch
    finite: bool                # every served value finite
    forward_seconds: float      # host clock around the forwards, synchronized

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
          out_dtype: str = "f32", device="cuda",
          save_dir: Optional[str] = None) -> ServeResult:
    """Serve every (input, ground truth, ...) item of ``dataset`` through
    the deployment forward the artifact's certificate selects, ``batch``
    frames per dispatch (equal shapes batch together), and score each
    output against its ground truth. With ``save_dir`` each output is
    also written there as ``out_{n:04d}.png``."""
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    device = torch.device(device)
    mode, fwd = select_forward(qp)
    data = list(dataset)
    psnrs, ssims, shapes = [], [], []
    finite = True
    seconds = 0.0
    i = 0
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
            psnrs.append(float(p))
            ssims.append(float(s))
        i += len(group)
    return ServeResult(mode, psnrs, ssims, shapes, finite, seconds)


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


def cmd_infer(args) -> ServeResult:
    spec = spec_for_task(args.task)
    qp = QuantParams.load(args.qparams)
    if args.out_dtype is None:
        # the PNGs are 8-bit whatever the output, so --save-dir takes the
        # int8 contract and skips the full-resolution float32 output
        args.out_dtype = "int8" if args.save_dir else "f32"
    res = serve(spec, qp, dataset_for(args.task, args.data, args.n_images),
                batch=args.batch, out_dtype=args.out_dtype, device=args.device,
                save_dir=args.save_dir)
    print(f"{args.task} {torch.device(args.device).type}({res.mode}"
          f"{', int8' if args.out_dtype == 'int8' else ''}"
          f"{f', batch {args.batch}' if args.batch > 1 else ''}) "
          f"mean psnr: {res.mean_psnr:.4f}  ssim: {res.mean_ssim:.4f}  "
          f"({res.n} images)")
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

    def common(p):
        p.add_argument("--task", required=True,
                       choices=["nr", "dm", "nrdm_3", "nrdm_6", "sr_x4", "sr_x2"])
        p.add_argument("--qparams", required=True)
        p.add_argument("--device", default="cuda",
                       help="cuda (default: the fused kernels) or cpu (their "
                            "plain PyTorch version)")

    p = sub.add_parser("infer", help="deployment inference, scored on a "
                                     "dataset (default: the synthetic set)")
    common(p)
    p.add_argument("--data", default=None,
                   help="a GTmod12 folder beside its LRbicx{2,4} folder "
                        "(sr_x2, sr_x4) or a folder of name_H_W.raw Bayer "
                        "planes with name.png ground truth (the other "
                        "tasks); omit for the synthetic set")
    p.add_argument("--n-images", type=int, default=4,
                   help="synthetic images (without --data)")
    p.add_argument("--batch", type=int, default=1,
                   help="frames per dispatch (1 = latency mode)")
    p.add_argument("--out-dtype", default=None, choices=list(OUT_DTYPES),
                   help="int8 = the raw quantized image contract; scoring "
                        "dequantizes it. Default: int8 with --save-dir, "
                        "else f32")
    p.add_argument("--save-dir", default=None,
                   help="write the outputs here as out_NNNN.png (8-bit)")
    p.set_defaults(fn=cmd_infer)

    p = sub.add_parser("sim", help="bit-exact reference integer simulation")
    common(p)
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
