"""AdaRound: adaptive per-weight rounding for PTQ artifacts.

The same recipe as the JAX package's ``sesr_tpu/quant/adaround.py``
(after "Up or Down? Adaptive Rounding for Post-Training Quantization",
arXiv:2004.10568: a continuous relaxation of each weight's floor / ceil
choice through a rectified sigmoid, with an annealed binary regularizer):

- w_int stays per-tensor at the artifact's weight scale; only the
  neighbour each weight rounds to changes, so every consumer downstream
  (the integer interpreter, the kernels, certification) is untouched;
- the per-layer objective is the rounding error on the quantized
  pipeline's own layer inputs, in integer conv units:
      min_h E_n || conv(x_shift_n, (floor(W/s) + h) - W/s) ||^2,
  x_shift collected from the corrected integer path under the running
  artifact;
- layers optimize in order (layer i+1 sees layers 0..i re-rounded), and a
  layer is accepted only if its final binary rounding strictly lowers the
  calibration error against round-to-nearest;
- the activations are then recalibrated with the new w_int
  (``calibrate(w_int_override=...)``).

The nearest baseline and the final snap clip to ``hw.quan_bits``' range.
The optimizer is ``torch.optim.Adam`` with optax.adam's constants, and the
float32 convs run inside ``float_exact()``; the rectifier's clip is
``torch.minimum(torch.maximum(.))``, whose gradient at a bound is 0.5 as
``jax.grad`` of ``jnp.clip`` is. The optimizer's trajectory is not bit
for bit the JAX package's (another summation order in the convs and their
gradients moves a few weights across 0.5): the start point, the inputs
and the baseline are exact, the result agrees on all but a few weights.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Sequence

import numpy as np
import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.models.sesr import CollapsedParams
from sesr_tpu_torch.ops.conv import conv2d_nhwc, float_exact
from sesr_tpu_torch.quant.integer import as_input, layer_input, layer_step, resolve_device
from sesr_tpu_torch.quant.params import QuantParams


@dataclasses.dataclass
class LayerRounding:
    """One layer's outcome: the integer weights and what they cost."""

    w_int: np.ndarray       # int32 HWIO
    moved: float            # share of weights off round-to-nearest
    mse_nearest: float      # calibration rounding error of nearest (+1e-12)
    mse_final: float        # of w_int; <= mse_nearest
    seconds: float = 0.0    # wall clock of the layer's optimization


def rounding_start(w_float, w_scale: float, bits: int = 8):
    """(w_real, base, v0, w_nearest) of one layer, numpy: W / s in float64,
    its floor, the relaxation's start v0 (float32; h(v0) equals the
    fractional part) and the shipped round-to-nearest (np.rint, half to
    even, clipped to ``bits``' range)."""
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    w_real = np.asarray(w_float, np.float64) / w_scale
    base = np.floor(w_real)
    r = np.clip(w_real - base, 1e-4, 1 - 1e-4)
    p = np.clip((r + 0.1) / 1.2, 1e-6, 1 - 1e-6)
    v0 = np.log(p / (1 - p)).astype(np.float32)
    w_nearest = np.clip(np.rint(w_real), lo, hi).astype(np.int32)
    return w_real, base, v0, w_nearest


def optimize_layer_rounding(w_float, w_scale: float, xs, steps: int = 800, lr: float = 1e-2,
                            lam: float = 1e-2, beta0: float = 18.0, beta1: float = 2.0,
                            bits: int = 8, device=None) -> LayerRounding:
    """One layer. xs: (N, H, W, IC) stacked integer-unit inputs (numpy or
    tensor) on ``device`` (default: xs's device, else ``cuda``). With the
    accept guard mse_final <= mse_nearest always, and w_int is
    round-to-nearest where the optimizer cannot beat it."""
    t0 = time.perf_counter()
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    w_real, base, v0, w_nearest = rounding_start(w_float, w_scale, bits)
    xs = as_input(xs, device)
    dev = xs.device
    base_t = torch.tensor(base, dtype=torch.float32, device=dev)
    w_real_t = torch.tensor(w_real, dtype=torch.float32, device=dev)
    zero, one = (torch.full((), v, dtype=torch.float32, device=dev) for v in (0.0, 1.0))

    def h_of(v):
        return torch.minimum(torch.maximum(torch.sigmoid(v) * 1.2 - 0.1, zero), one)

    def mse_of_ints(w_int) -> float:
        """The rounding error of the tensor that ships (clipped)."""
        dw = torch.tensor(w_int.astype(np.float64) - w_real, dtype=torch.float32, device=dev)
        with torch.no_grad(), float_exact():
            err = conv2d_nhwc(xs, dw)
            return float(torch.mean(err * err))

    mse_nearest = mse_of_ints(w_nearest) + 1e-12
    mse_nearest_t = torch.full((), mse_nearest, dtype=torch.float32, device=dev)
    v = torch.tensor(v0, device=dev, requires_grad=True)
    opt = torch.optim.Adam([v], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    # the annealed exponent of every step, copied to the card once: the
    # loop then never waits for it
    betas = torch.tensor([beta0 + (beta1 - beta0) * (t / max(1, steps - 1))
                          for t in range(steps)], dtype=torch.float32, device=dev)
    for t in range(steps):
        opt.zero_grad(set_to_none=True)
        with float_exact():
            h = h_of(v)
            err = conv2d_nhwc(xs, base_t + h - w_real_t)
            reg = torch.mean(1.0 - torch.abs(2.0 * h - 1.0) ** betas[t])
            loss = torch.mean(err * err) / mse_nearest_t + lam * reg
            loss.backward()
        opt.step()
    with torch.no_grad():
        h_bin = (h_of(v) > 0.5).cpu().numpy().astype(np.int64)
    w_new = np.clip(base.astype(np.int64) + h_bin, lo, hi).astype(np.int32)
    final = mse_of_ints(w_new)
    if final >= mse_nearest:
        # the annealed snap can land above nearest on an under-converged
        # layer: keep nearest there
        return LayerRounding(w_nearest, 0.0, mse_nearest, mse_nearest,
                             time.perf_counter() - t0)
    return LayerRounding(w_new, float(np.mean(w_new != w_nearest)), mse_nearest, final,
                         time.perf_counter() - t0)


def layer_inputs(qp: QuantParams, states, i: int) -> List[torch.Tensor]:
    """x_shift of conv i for every (h, shortcut) image state."""
    return [layer_input(h, i, qp.num_convs, qp, sc, True)[1] for h, sc in states]


def adaround_weights(spec: SESRSpec, params: CollapsedParams, qp_baseline: QuantParams,
                     images: Sequence[np.ndarray], steps: int = 800, verbose: bool = False,
                     device=None) -> List[LayerRounding]:
    """Every layer's rounding, in order (its ``w_int`` is the optimized
    integer weight), on ``device`` (default ``cuda``). qp_baseline: a
    finalized artifact at the target scales; its activation constants
    drive the input collection (they are refreshed afterwards by
    ``calibrate(w_int_override=...)``). Each image's state is
    carried one layer forward per layer through the corrected integer
    path's own step (``layer_step``), under the roundings accepted so far."""
    dev = resolve_device(None, device)
    L = qp_baseline.num_convs
    qp_work = qp_baseline
    w_new = [np.asarray(w) for w in qp_baseline.w_int]
    rounds = []
    states = [(as_input(img, dev), None) for img in images]
    for i in range(L):
        # x_shift depends on the activations and the constants only, not
        # on w_int[i]: collect once, reuse for the advance
        with torch.no_grad():
            xshifts = layer_inputs(qp_work, states, i)
        res = optimize_layer_rounding(params.weights[i], qp_baseline.w_scale[i],
                                      torch.cat(xshifts), steps=steps,
                                      bits=qp_baseline.hw.quan_bits, device=dev)
        w_new[i] = res.w_int
        qp_work = dataclasses.replace(qp_work, w_int=list(w_new))
        rounds.append(res)
        if verbose:
            print(f"[adaround] layer {i}: {res.moved * 100:.1f}% off nearest; calib "
                  f"rounding mse {res.mse_nearest:.3e} -> {res.mse_final:.3e} "
                  f"({res.seconds:.2f} s)", flush=True)
        if i < L - 1:
            with torch.no_grad():
                states = [layer_step(x_shift, i, L, qp_work, sc, True, False)[2:4]
                          for (_, sc), x_shift in zip(states, xshifts)]
    return rounds


def adaround_calibrate(spec: SESRSpec, params: CollapsedParams, images: Sequence[np.ndarray],
                       steps: int = 800, verbose: bool = False, device=None,
                       **calibrate_kwargs) -> QuantParams:
    """The two-phase recipe: a nearest-rounding calibrate, the layer-by-
    layer rounding on the quantized pipeline's own inputs, then the full
    recalibration at the optimized w_int. Not certified: run
    ``certify_fast`` on the result. ``calibrate_kwargs`` go to both
    calibrate calls (observer, safe_zero_floor, hw, ...)."""
    from sesr_tpu_torch.quant.calibrate import calibrate

    qp0 = calibrate(spec, params, images, device=device, **calibrate_kwargs)
    rounds = adaround_weights(spec, params, qp0, images, steps=steps, verbose=verbose,
                              device=device)
    return calibrate(spec, params, images, w_int_override=[r.w_int for r in rounds],
                     device=device, **calibrate_kwargs)
