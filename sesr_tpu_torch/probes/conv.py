"""The conv-tile probe (tools/bench_probe_pallas_conv.py, P1) on the card.

``iters`` sequential steps on one (E_H, E_W, C) tile; each step is one full
circular 3x3 C -> C conv, written back into the tile's type:

    x <- wb(sum over qy, qx, ci of x[(h + qy - 1) % E_H, (w + qx - 1) % E_W, ci]
            * W[qy, qx, ci, co])

with wb the int32 clip to int8, or bf16(f32 acc * f32(1e-3)). The output is
f32(x). The six variants keep the TPU probe's names and weight layouts:

    v1_bf16_concat3, v2_int8_concat3   w (3, 3C, C), row qx C + ci of tap row qy
    v3_int8_dot9, v4_bf16_dot9         w (9, C, C), tap 3 qy + qx
    v5_int8_mm, v6_bf16_mm             w (9C, C): x viewed (E_H E_W / 9, 9C)
                                       times w, each result row repeated to 9
                                       consecutive pixels (no im2col)

On the card the concat and dot9 forms run ``probe_conv_run`` (one launch
for all steps) and the mm forms ``probe_gemm``'s write-back epilogue (one
launch per step, ping-ponging two buffers); on the CPU the plain versions
run.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from sesr_tpu_torch.probes import kernels, plain
from sesr_tpu_torch.timing import device_label, median_ms

E_H, E_W, C = 48, 72, 128
ITERS = 50
VARIANTS = {                      # name: (form, tile type)
    "v1_bf16_concat3": ("concat3", torch.bfloat16),
    "v2_int8_concat3": ("concat3", torch.int8),
    "v3_int8_dot9": ("dot9", torch.int8),
    "v4_bf16_dot9": ("dot9", torch.bfloat16),
    "v5_int8_mm": ("mm", torch.int8),
    "v6_bf16_mm": ("mm", torch.bfloat16),
}


def weight_shape(form: str, c: int) -> tuple:
    return {"concat3": (3, 3 * c, c), "dot9": (9, c, c), "mm": (9 * c, c)}[form]


def make_inputs(shape=(E_H, E_W, C), seed: int = 0) -> dict:
    """{variant: (x, w)} as float32 numpy arrays of integers, drawn in the
    TPU probe's order from one generator: x in [-3, 3], w in [-2, 2]."""
    rng = np.random.default_rng(seed)
    c = shape[2]
    out = {}
    for name, (form, _) in VARIANTS.items():
        x = rng.integers(-3, 4, size=shape).astype(np.float32)
        w = rng.integers(-2, 3, size=weight_shape(form, c)).astype(np.float32)
        out[name] = (x, w)
    return out


def conv_probe(x: torch.Tensor, w: torch.Tensor, variant: str,
               iters: int = ITERS) -> torch.Tensor:
    """f32(x) after ``iters`` steps of ``variant`` from the tile x (E_H,
    E_W, C) and the variant's weights w, both cast to the variant's type,
    on x's device."""
    form, dtype = VARIANTS[variant]
    if iters < 1:
        raise ValueError(f"iters must be >= 1, got {iters}")
    eh, ew, c = x.shape
    if tuple(w.shape) != weight_shape(form, c):
        raise ValueError(f"{variant} takes w {weight_shape(form, c)}, got {tuple(w.shape)}")
    m = eh * ew
    if form == "mm" and m % plain.MM_REP:
        raise ValueError(f"{variant} views the tile as ({m} / 9, 9C): E_H E_W % 9 != 0")
    x = x.to(dtype).contiguous()
    w9 = w.to(dtype).reshape(9 * c, c).contiguous()
    if x.device.type == "cpu":
        return plain_probe(x, w9, form, iters)
    if form != "mm":
        return kernels.probe_conv_run(x, w9, iters)[1]
    bufs = (torch.empty_like(x), torch.empty_like(x))
    for i in range(iters):
        x, f32 = kernels.probe_gemm.write_back(
            x.reshape(m // 9, 9 * c), w9, plain.MM_REP, out_x=bufs[i % 2].view(m, c),
            f32=i == iters - 1)
    return f32.view(eh, ew, c)


def plain_probe(x: torch.Tensor, w9: torch.Tensor, form: str, iters: int) -> torch.Tensor:
    """The plain version of ``conv_probe`` on any device: x in the tile's
    type, w9 the (9C, C) weights in the same type."""
    eh, ew, c = x.shape
    for _ in range(iters):
        if form == "mm":
            x = plain.gemm_write_back(x.reshape(eh * ew // 9, 9 * c), w9, plain.MM_REP)
        else:
            x = plain.conv_step(x, w9)
    return x.reshape(eh, ew, c).float()


def step_ops(shape=(E_H, E_W, C), form: str = "concat3") -> int:
    """Operations of one step: 2 M 9C C, and a ninth of that for mm."""
    eh, ew, c = shape
    ops = 2 * eh * ew * 9 * c * c
    return ops // 9 if form == "mm" else ops


def main(device: torch.device, shape=(E_H, E_W, C), iters: int = ITERS,
         reps: int = 10) -> dict:
    """Times every variant (median of ``reps`` probe calls) and prints one
    JSON line of TOP/s under the TPU probe's keys, with the device."""
    results = {}
    for name, (x, w) in make_inputs(shape).items():
        form, dtype = VARIANTS[name]
        try:
            xt = torch.from_numpy(x).to(device=device, dtype=dtype)
            wt = torch.from_numpy(w).to(device=device, dtype=dtype)
            ms = median_ms(lambda: conv_probe(xt, wt, name, iters), device, reps)
            results[name] = step_ops(shape, form) * iters / (ms * 1e-3) / 1e12
        except Exception as e:  # a variant that fails is reported, as the TPU probe does
            msg = str(e).splitlines()[0][:160] if str(e) else type(e).__name__
            results[name] = f"ERROR: {msg}"
    print(json.dumps({"device": device_label(device), "unit": "TOP/s", **results}), flush=True)
    return results
