"""python -m sesr_tpu_torch.probes {conv,gemm,bitcast} [--device cpu] [--reps N] ...

Runs one probe on the card (``--device cuda``, the default) through the
kernels of ``csrc/probes.cu``, or its plain versions on the CPU (``--device
cpu``), and prints its results as one JSON line.
"""

from __future__ import annotations

import argparse

import torch

from sesr_tpu_torch.probes import bitcast, conv, int8_gemm


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m sesr_tpu_torch.probes")
    sub = ap.add_subparsers(dest="probe", required=True)
    p_conv = sub.add_parser("conv", help="tools/bench_probe_pallas_conv.py: the conv-tile probe")
    p_conv.add_argument("--shape", type=int, nargs=3, default=[conv.E_H, conv.E_W, conv.C],
                        metavar=("E_H", "E_W", "C"))
    p_conv.add_argument("--iters", type=int, default=conv.ITERS)
    p_gemm = sub.add_parser("gemm", help="tools/bench_probe_pallas_int8.py: the tiled GEMM")
    p_gemm.add_argument("--size", type=int, default=int8_gemm.SIZE)
    p_bit = sub.add_parser("bitcast", help="tools/bench_probe_r3a.py / r3b.py: packed words")
    for p in (p_conv, p_gemm, p_bit):
        p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
        p.add_argument("--reps", type=int, default=10, help="timed calls (median)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: the probes run on the card, or on the CPU with --device cpu")
    if args.probe == "conv":
        return conv.main(device, tuple(args.shape), args.iters, args.reps)
    if args.probe == "gemm":
        return int8_gemm.main(device, args.size, args.reps)
    return bitcast.main(device, args.reps)


if __name__ == "__main__":
    main()
