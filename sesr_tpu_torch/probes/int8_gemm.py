"""The tiled-GEMM probe (tools/bench_probe_pallas_int8.py, P2) on the card.

(M, K) x (K, N) at 4096^3 with data in [-8, 8), in three variants under the
TPU probe's names: ``pallas_mm_bf16`` (bf16 inputs, f32 sums and output),
``pallas_mm_int8`` (int8 -> int32) and ``pallas_mm_int8_f32acc`` (int8 ->
float32; the kernel sums in int32 and converts once, the same value as an
f32 accumulation while |sum| < 2^24, and here |sum| <= 2^18). On the card
``probe_gemm`` runs; on the CPU its plain version.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from sesr_tpu_torch.probes import kernels, plain
from sesr_tpu_torch.timing import device_label, median_ms

SIZE = 4096
VARIANTS = {                      # name: (input type, output type)
    "pallas_mm_bf16": (torch.bfloat16, torch.float32),
    "pallas_mm_int8": (torch.int8, torch.int32),
    "pallas_mm_int8_f32acc": (torch.int8, torch.float32),
}


def make_inputs(size: int = SIZE, seed: int = 0) -> dict:
    """{variant: (a, b)} as float32 numpy arrays of integers in [-8, 8),
    drawn in the TPU probe's order from one generator."""
    rng = np.random.default_rng(seed)
    return {name: tuple(rng.integers(-8, 8, size=(size, size)).astype(np.float32)
                        for _ in range(2))
            for name in VARIANTS}


def gemm_probe(a: torch.Tensor, b: torch.Tensor, variant: str) -> torch.Tensor:
    """a @ b as ``variant`` does it, on a's device."""
    dtype, out_dtype = VARIANTS[variant]
    a = a.to(dtype).contiguous()
    b = b.to(dtype).contiguous()
    if a.device.type == "cpu":
        return plain.gemm(a, b, out_dtype)
    return kernels.probe_gemm(a, b, out_dtype)


def main(device: torch.device, size: int = SIZE, reps: int = 10) -> dict:
    """Times every variant (median of ``reps`` calls) and prints one JSON
    line of TOP/s under the TPU probe's keys, with the device."""
    results = {}
    for name, (a, b) in make_inputs(size).items():
        dtype = VARIANTS[name][0]
        try:
            at = torch.from_numpy(a).to(device=device, dtype=dtype)
            bt = torch.from_numpy(b).to(device=device, dtype=dtype)
            ms = median_ms(lambda: gemm_probe(at, bt, name), device, reps)
            results[name] = 2 * size ** 3 / (ms * 1e-3) / 1e12
        except Exception as e:  # a variant that fails is reported, as the TPU probe does
            msg = str(e).splitlines()[0][:200] if str(e) else type(e).__name__
            results[name] = f"ERROR: {msg}"
    print(json.dumps({"device": device_label(device), "unit": "TOP/s", **results}), flush=True)
    return results
