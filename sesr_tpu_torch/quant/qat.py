"""Quantization-aware training: fake-quant with straight-through estimators.

The same functions as the JAX package's ``sesr_tpu/quant/qat.py``: pure
functions over explicit observer state (no module swapping, no buffers).

- observers: MinMax, MovingAverageMinMax (momentum 0.1), and the
  percentile "histogram" observer (the percentile-th |x| order statistic);
  each sees the detached value;
- quantizers: symmetric / asymmetric, with the STE round
  sign * floor(|x| + 0.5) whose gradient is cut outside the observer
  range, then clipped to the integer range;
- QuantConv2d: fake-quant input and weight, then the conv;
- QuantAdd: the residual and the shortcut share a union min/max;
- ``prepare``: a fresh ``QATState``.

The frozen QuantAdd of the reference's qatf="qat_" composition
(``quant_add_frozen``) lives in ``quant/frozen_add.py``, which the
integer interpreter imports, and is re-exported here as the JAX package
has it in this module.

Reference quirks kept: ``q_level="C"`` selects LAYER-level weight scales
(the reference compares q_level against 0; every shipped *_qat_G.pth has
scale buffers of shape (1,)); "C_real" gives true per-channel scales. The
weight range is [-127, 127] against the activations' [-128, 127].

Numerics. Every clip through which a gradient flows is
``torch.minimum(torch.maximum(x, lo), hi)`` on tensor bounds: at a value
exactly on a bound its gradient is 0.5, as ``jax.grad`` of ``jnp.clip``
gives, where ``torch.clamp`` gives 1. The largest-magnitude weight of
every conv maps exactly onto +-127, so the tie is hit in every step.
Every division is by a tensor (a CUDA division by a Python scalar is a
multiply by the reciprocal), and the convs run inside ``float_exact()``.

``make_train_step`` is Adam + MSE; the step holds ``float_exact()``
around the forward AND the backward, so that cuDNN's data and weight
gradients do not run in TF32 either.

Sharded training (``parallel/tiling.py`` ``sharded_train_step``, the
counterpart of the JAX step under GSPMD): each rank runs its block of the
batch; the k x k convs exchange their halo (``halo_group``, through the
differentiable exchange of ``ops/halo.py``), the activation observers'
current ranges reduce over the mesh (``reduce_group``), each rank's loss
is its local sum over the global count, and the gradients are summed over
the mesh before the optimizer's step, so every rank takes the same step.
The percentile observer takes the exact order statistic of the whole
mesh's tensor (``global_order_statistic``: a radix select whose bin counts
are summed over the group), the element the unsharded observer picks.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.io.torch_import import block_names
from sesr_tpu_torch.models.expanded import (ExpandedParams, block_channels, expanded_graph,
                                            forward_expanded)
from sesr_tpu_torch.ops.conv import conv2d_nhwc, float_exact
from sesr_tpu_torch.ops.halo import exchange_for_conv
from sesr_tpu_torch.quant.calibrate import reduce_range
from sesr_tpu_torch.quant.frozen_add import (quant_add_frozen,  # noqa: F401 (this module's API
                                             quant_add_scale_from_bounds)  # in the JAX package)
from sesr_tpu_torch.quant.integer import as_input

# --------------------------------------------------------------------------
# config / state


@dataclasses.dataclass(frozen=True)
class QATConfig:
    a_bits: int = 8
    w_bits: int = 8
    q_type: int = 0              # 0 symmetric, 1 asymmetric (activations)
    q_level: str = "C"           # "C" / "L": layer-level (the reference's quirk);
                                 # "C_real": per-channel weight scales
    weight_observer: int = 0     # 0 MinMax, 1 MovingAverageMinMax
    momentum: float = 0.1
    ptq: bool = False            # percentile observer for the activations
    percentile: float = 0.9999

    @property
    def per_channel(self) -> bool:
        return self.q_level == "C_real"


class QuantizerState(NamedTuple):
    min_val: torch.Tensor
    max_val: torch.Tensor
    num_flag: torch.Tensor       # int32 scalar, 0 before the first observation


class ConvQuantState(NamedTuple):
    act: QuantizerState
    weight: QuantizerState


class AddQuantState(NamedTuple):
    res: QuantizerState
    shortcut: QuantizerState


class QATState(NamedTuple):
    convs: Tuple[ConvQuantState, ...]   # two per block: expand, squeeze
    add: AddQuantState


def _fresh_qstate(shape, device) -> QuantizerState:
    return QuantizerState(torch.zeros(shape, dtype=torch.float32, device=device),
                          torch.zeros(shape, dtype=torch.float32, device=device),
                          torch.zeros((), dtype=torch.int32, device=device))


def prepare(spec: SESRSpec, cfg: QATConfig = QATConfig(), device="cuda") -> QATState:
    """A fresh QAT state for the network of ``spec`` on ``device``."""
    chans = block_channels(spec)[1:]
    t = spec.tmp_channels
    convs = []
    for i in range(spec.num_convs):
        w_shape_e = (t, 1, 1, 1) if cfg.per_channel else (1,)
        w_shape_s = (chans[i], 1, 1, 1) if cfg.per_channel else (1,)
        convs.append(ConvQuantState(_fresh_qstate((1,), device),
                                    _fresh_qstate(w_shape_e, device)))
        convs.append(ConvQuantState(_fresh_qstate((1,), device),
                                    _fresh_qstate(w_shape_s, device)))
    return QATState(tuple(convs), AddQuantState(_fresh_qstate((1,), device),
                                                _fresh_qstate((1,), device)))


# --------------------------------------------------------------------------
# observers (x already detached)


def _f32(v, device) -> torch.Tensor:
    """A float32 scalar on ``device``, filled there (``torch.tensor`` of a
    Python number would copy it from the host and wait for the card)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def _current_range(state: QuantizerState, x: torch.Tensor, per_channel: bool, group=None):
    """x's range (per output channel, or over the whole mesh's tensor when
    ``group`` holds the ranks sharing it)."""
    if per_channel:
        flat = x.reshape(x.shape[0], -1) if x.ndim == 2 else \
            torch.movedim(x, -1, 0).reshape(x.shape[-1], -1)
        return (flat.amin(dim=1).reshape(state.min_val.shape),
                flat.amax(dim=1).reshape(state.max_val.shape))
    lo, hi = reduce_range(x.min(), x.max(), group)
    return torch.full_like(state.min_val, 0) + lo, torch.full_like(state.max_val, 0) + hi


def _next_flag(state: QuantizerState, first: torch.Tensor) -> torch.Tensor:
    return state.num_flag + first.to(torch.int32)


def _minmax_update(state: QuantizerState, x, per_channel: bool) -> QuantizerState:
    cur_min, cur_max = _current_range(state, x, per_channel)
    first = state.num_flag == 0
    return QuantizerState(torch.where(first, cur_min, torch.minimum(cur_min, state.min_val)),
                          torch.where(first, cur_max, torch.maximum(cur_max, state.max_val)),
                          _next_flag(state, first))


def _moving_average(old, cur, momentum: float):
    """(1 - momentum) * old + momentum * cur, with both factors float32
    tensors (the JAX package multiplies by weakly typed float32 scalars)."""
    return (_f32(1 - momentum, old.device) * old + _f32(momentum, old.device) * cur)


def _moving_avg_update(state: QuantizerState, x, momentum: float,
                       per_channel: bool, group=None) -> QuantizerState:
    cur_min, cur_max = _current_range(state, x, per_channel, group)
    first = state.num_flag == 0
    return QuantizerState(
        torch.where(first, cur_min, _moving_average(state.min_val, cur_min, momentum)),
        torch.where(first, cur_max, _moving_average(state.max_val, cur_max, momentum)),
        _next_flag(state, first))


RADIX_BITS = 16                 # two rounds of 65,536 bins over a float's 32 bits


def global_order_statistic(a: torch.Tensor, index: int, group) -> torch.Tensor:
    """The ``index``-th smallest (from 0) of the non-negative float32 values
    of ``a`` over every rank of ``group``, each rank passing its own block
    (one element tensor, the same on every rank). A radix select over the
    values' int32 bits, which order non-negative floats as the floats do:
    each round counts the candidates by their next 16 bits, sums the counts
    over the group, and keeps the bin that holds the index-th. Exact (it
    returns the element itself) and it moves 2 x 65,536 counts, not the
    tensor."""
    bits = a.detach().reshape(-1).to(torch.float32).view(torch.int32).to(torch.int64)
    bins = 1 << RADIX_BITS
    hi, lo = bits >> RADIX_BITS, bits & (bins - 1)

    def counts(keys, weight):
        c = torch.zeros(bins, dtype=torch.int64, device=a.device).scatter_add_(0, keys, weight)
        dist.all_reduce(c, group=group)
        return c

    left = torch.full((1,), index, dtype=torch.int64, device=a.device)
    c_hi = counts(hi, torch.ones_like(hi))
    cum = torch.cumsum(c_hi, 0)
    b_hi = torch.searchsorted(cum, left, right=True)           # the bin of the index-th
    left = left - (cum[b_hi] - c_hi[b_hi])
    c_lo = counts(lo, (hi == b_hi).to(torch.int64))
    b_lo = torch.searchsorted(torch.cumsum(c_lo, 0), left, right=True)
    return ((b_hi << RADIX_BITS) | b_lo).to(torch.int32).view(torch.float32)


def _percentile_update(state: QuantizerState, x, momentum: float,
                       percentile: float, group=None) -> QuantizerState:
    """The moving average of the percentile-th |x| order statistic; the
    minimum stays at -max (symmetric use). With a ``group`` the statistic
    is over every rank's block of x, the unsharded tensor's."""
    a = torch.abs(x)
    if group is None:
        flat = torch.sort(a.reshape(-1)).values
        k = int(percentile * flat.shape[0])
        stat = flat[max(k - 1, 0)]
    else:
        n = torch.full((1,), a.numel(), dtype=torch.int64, device=a.device)
        dist.all_reduce(n, group=group)
        k = int(percentile * int(n.item()))
        stat = global_order_statistic(a, max(k - 1, 0), group)
    cur_max = torch.full_like(state.max_val, 0) + stat
    first = state.num_flag == 0
    new_max = torch.where(first, cur_max, _moving_average(state.max_val, cur_max, momentum))
    return QuantizerState(-new_max, new_max, _next_flag(state, first))


# --------------------------------------------------------------------------
# STE round + fake quant


class SteRound(torch.autograd.Function):
    """sign(t) * floor(|t| + 0.5) forward; the gradient passes where
    lo <= t <= hi and is 0 elsewhere (the reference's Round function)."""

    @staticmethod
    def forward(ctx, t, lo, hi):
        ctx.save_for_backward(t, lo, hi)
        return torch.sign(t) * torch.floor(torch.abs(t) + 0.5)

    @staticmethod
    def backward(ctx, g):
        t, lo, hi = ctx.saved_tensors
        mask = torch.logical_and(t >= lo, t <= hi)
        return torch.where(mask, g, torch.zeros_like(g)), None, None


def ste_round(t: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return SteRound.apply(t, lo, hi)


def _qparams(state: QuantizerState, bits: int, q_type: int, is_weight: bool):
    """(scale, zero, qmin, qmax) from the observer state: the symmetric or
    asymmetric quantizer, the weight range [-127, 127] against the
    activations' [-128, 127]. scale and zero are float32 tensors, qmin and
    qmax float32 scalars on the state's device."""
    dev = state.min_val.device
    eps = _f32(np.finfo(np.float32).eps, dev)
    if q_type == 0:
        if is_weight:
            qmin, qmax = float(-(2 ** (bits - 1) - 1)), float(2 ** (bits - 1) - 1)
        else:
            qmin, qmax = float(-(2 ** (bits - 1))), float(2 ** (bits - 1) - 1)
        float_range = torch.maximum(torch.abs(state.min_val), torch.abs(state.max_val))
        scale = torch.maximum(float_range / _f32((qmax - qmin) / 2, dev), eps)
        zero = torch.zeros_like(scale)
    else:
        qmin, qmax = 0.0, float((1 << bits) - (2 if is_weight else 1))
        scale = torch.maximum((state.max_val - state.min_val) / _f32(qmax - qmin, dev), eps)
        zero = torch.sign(state.min_val) * torch.floor(torch.abs(state.min_val / scale) + 0.5)
    return scale, zero, _f32(qmin, dev), _f32(qmax, dev)


def fake_quant(x: torch.Tensor, state: QuantizerState, bits: int, q_type: int,
               is_weight: bool) -> torch.Tensor:
    """The reference Quantizer's forward: the STE round of x / scale - zero
    (gradient cut outside the observer range), clipped to the integer
    range, dequantized."""
    scale, zero, qmin, qmax = _qparams(state, bits, q_type, is_weight)
    t = x / scale - zero
    lo = state.min_val / scale - zero
    hi = state.max_val / scale - zero
    if q_type == 0:
        m = torch.maximum(torch.abs(lo), torch.abs(hi))
        lo, hi = -m, m
    q = torch.minimum(torch.maximum(ste_round(t, lo, hi), qmin), qmax)
    return (q + zero) * scale


# --------------------------------------------------------------------------
# the QAT forward


def _observe_act(cfg: QATConfig, state: QuantizerState, x, training: bool, group=None):
    if not training:
        return state
    xs = x.detach()
    if cfg.ptq:
        return _percentile_update(state, xs, cfg.momentum, cfg.percentile, group)
    return _moving_avg_update(state, xs, cfg.momentum, False, group)


def _observe_weight(cfg: QATConfig, state: QuantizerState, w, training: bool):
    if not training:
        return state
    ws = w.detach()
    if cfg.weight_observer == 0:
        return _minmax_update(state, ws, cfg.per_channel)
    return _moving_avg_update(state, ws, cfg.momentum, cfg.per_channel)


def _quant_conv(cfg: QATConfig, cstate: ConvQuantState, x, w_hwio, bias, training: bool,
                halo_group=None, reduce_group=None):
    """QuantConv2d: fake-quant the input and the weight, then the conv
    (sharded: the fake-quantized input extended by its halo)."""
    astate = _observe_act(cfg, cstate.act, x, training, reduce_group)
    wstate = _observe_weight(cfg, cstate.weight, w_hwio, training)
    x_fq = fake_quant(x, astate, cfg.a_bits, cfg.q_type, is_weight=False)
    w_scale_state = wstate
    if cfg.per_channel:
        # the (OC, 1, 1, 1) state broadcast over HWIO
        w_scale_state = QuantizerState(wstate.min_val.reshape(1, 1, 1, -1),
                                       wstate.max_val.reshape(1, 1, 1, -1), wstate.num_flag)
    w_fq = fake_quant(w_hwio, w_scale_state, cfg.w_bits, 0, is_weight=True)
    if halo_group is None:
        return conv2d_nhwc(x_fq, w_fq, bias), ConvQuantState(astate, wstate)
    x_fq, w_valid, h_valid = exchange_for_conv(x_fq, w_hwio.shape[0], halo_group)
    return (conv2d_nhwc(x_fq, w_fq, bias, w_valid=w_valid, h_valid=h_valid),
            ConvQuantState(astate, wstate))


def _quant_add(cfg: QATConfig, astate: AddQuantState, res, shortcut, training: bool,
               reduce_group=None):
    """QuantAdd: both operands fake-quantized over the union of their
    observers' ranges, then added."""
    rs = _observe_act(cfg, astate.res, res, training, reduce_group)
    ss = _observe_act(cfg, astate.shortcut, shortcut, training, reduce_group)
    union = QuantizerState(torch.minimum(rs.min_val, ss.min_val),
                           torch.maximum(rs.max_val, ss.max_val), rs.num_flag)
    q_res = fake_quant(res, union, cfg.a_bits, cfg.q_type, is_weight=False)
    q_short = fake_quant(shortcut, union, cfg.a_bits, cfg.q_type, is_weight=False)
    return q_res + q_short, AddQuantState(rs, ss)


def qat_forward(spec: SESRSpec, cfg: QATConfig, params: ExpandedParams, state: QATState,
                x, training: bool = True, device=None, halo_group=None, reduce_group=None):
    """The fake-quant forward of the uncollapsed network: (y, state'). x:
    NHWC (numpy or tensor) on ``device`` (default: the state's device); the
    state and the parameters must lie there. Sharded (x: this rank's block):
    ``halo_group`` as ``forward_expanded`` takes it, ``reduce_group`` the
    ranks over which the observers' ranges reduce."""
    x = as_input(x, device or state.add.res.min_val.device)
    convs = list(state.convs)
    add = [state.add]

    def block(h, i):
        blk = params.blocks[i]
        y, convs[2 * i] = _quant_conv(cfg, state.convs[2 * i], h, blk.w_expand, None,
                                      training, halo_group, reduce_group)
        y, convs[2 * i + 1] = _quant_conv(cfg, state.convs[2 * i + 1], y, blk.w_squeeze,
                                          blk.b_squeeze, training, None, reduce_group)
        return y

    def outer_add(h, c0):
        y, add[0] = _quant_add(cfg, state.add, h, c0, training, reduce_group)
        return y

    with float_exact():
        y = expanded_graph(spec, x, block, outer_add)
    return y, QATState(tuple(convs), add[0])


# --------------------------------------------------------------------------
# quantized activation ops (the reference also ships QuantReLU,
# QuantLeakyReLU and QuantAdaptiveAvgPool2d: each fake-quants its input,
# then applies the float op)


def quant_relu(cfg: QATConfig, state: QuantizerState, x, training: bool):
    """QuantReLU: (y, state')."""
    st = _observe_act(cfg, state, x, training)
    return torch.relu(fake_quant(x, st, cfg.a_bits, cfg.q_type, False)), st


def quant_leaky_relu(cfg: QATConfig, state: QuantizerState, x,
                     negative_slope: float = 0.01, training: bool = True):
    """QuantLeakyReLU: (y, state')."""
    st = _observe_act(cfg, state, x, training)
    xq = fake_quant(x, st, cfg.a_bits, cfg.q_type, False)
    return torch.where(xq >= 0, xq, _f32(negative_slope, xq.device) * xq), st


def quant_adaptive_avg_pool(cfg: QATConfig, state: QuantizerState, x, output_size,
                            training: bool = True):
    """QuantAdaptiveAvgPool2d on NHWC: fake-quant, then the average over
    (H / oh, W / ow) windows (sizes must divide, the only case the
    reference's networks could use)."""
    st = _observe_act(cfg, state, x, training)
    xq = fake_quant(x, st, cfg.a_bits, cfg.q_type, False)
    n, h, w, c = xq.shape
    oh, ow = output_size if isinstance(output_size, tuple) else (output_size,) * 2
    if h % oh or w % ow:
        raise ValueError(f"adaptive pool needs divisible sizes, got {(h, w)} -> {(oh, ow)}")
    xq = xq.reshape(n, oh, h // oh, ow, w // ow, c)
    return xq.mean(dim=(2, 4)), st


# --------------------------------------------------------------------------
# training


def adam(params: ExpandedParams, lr: float) -> torch.optim.Adam:
    """Adam over every leaf of ``params`` with optax.adam's constants
    (b1 0.9, b2 0.999, eps 1e-8, no weight decay): the same update
    formula."""
    return torch.optim.Adam([v for blk in params.blocks for v in blk], lr=lr,
                            betas=(0.9, 0.999), eps=1e-8)


def train_loss(spec: SESRSpec, cfg: Optional[QATConfig], params: ExpandedParams,
               qstate: QATState, x: torch.Tensor, gt: torch.Tensor,
               halo_group=None, reduce_group=None):
    """(MSE loss, qstate') of one batch: the float network when ``cfg`` is
    None, else the fake-quant one. Specs with ``global_input_skip``
    (sr_x2) predict a residual: the loss scores y + nearest_up(x) against
    the full image. Call inside ``float_exact()`` when the backward runs
    too. Sharded (x, gt: this rank's blocks; see ``qat_forward``): this
    rank's squared error summed, over the whole mesh's count, a division
    by a one-element tensor."""
    if cfg is None:
        y, qstate = forward_expanded(spec, params, x, halo_group=halo_group), qstate
    else:
        y, qstate = qat_forward(spec, cfg, params, qstate, x, training=True,
                                halo_group=halo_group, reduce_group=reduce_group)
    if spec.global_input_skip:
        r = spec.scaling_factor
        y = y + x.repeat_interleave(r, dim=1).repeat_interleave(r, dim=2)
    if reduce_group is None:
        return torch.mean((y - gt) ** 2), qstate
    count = torch.tensor([float(y.numel())], device=y.device)
    dist.all_reduce(count, group=reduce_group)
    return ((y - gt) ** 2).sum() / count[0], qstate


def make_train_step(spec: SESRSpec, cfg: Optional[QATConfig], params: ExpandedParams,
                    optimizer: torch.optim.Optimizer, halo_group=None, reduce_group=None):
    """A train step over ``params`` (leaf tensors the optimizer updates in
    place): ``step(qstate, (x, gt)) -> (qstate', loss)``, MSE + the
    optimizer's update. ``cfg`` None trains the float network (the
    reference's default path; its QAT trigger is dead code). The forward
    and the backward run inside one ``float_exact()``. Sharded (see
    ``train_loss``): the gradients and the loss are summed over
    ``reduce_group`` before the update."""

    def step(qstate: QATState, batch):
        x, gt = batch
        optimizer.zero_grad(set_to_none=True)
        with float_exact():
            loss, qstate = train_loss(spec, cfg, params, qstate, x, gt, halo_group,
                                      reduce_group)
            loss.backward()
        loss = loss.detach()
        if reduce_group is not None:
            for v in (v for blk in params.blocks for v in blk):
                dist.all_reduce(v.grad, group=reduce_group)
            dist.all_reduce(loss, group=reduce_group)
        optimizer.step()
        return qstate, loss

    return step


def device_batches(data, device) -> list:
    """(inp, gt) tensors on ``device`` of every (inp, gt[, variance]) item
    (training drops the variance, as the reference does), copied once:
    a copy from the host inside the step loop would stall it."""
    return [(torch.from_numpy(d[0]).to(device), torch.from_numpy(d[1]).to(device))
            for d in data]


def run_steps(step, qstate: QATState, batches: list, start: int, steps: int,
              on_step: Optional[Callable[[int, QATState, torch.Tensor], None]] = None):
    """Steps ``start`` .. ``start + steps - 1`` of ``step`` (from
    ``make_train_step``), step ``it`` on ``batches[it % len(batches)]``:
    (qstate', the per-step losses, seconds). ``on_step(it, qstate, loss)``
    runs after each step; the clock is the host's, synchronized with the
    card at both ends."""
    dev = batches[0][0].device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    losses = []
    for it in range(start, start + steps):
        qstate, loss = step(qstate, batches[it % len(batches)])
        losses.append(loss)
        if on_step is not None:
            on_step(it, qstate, loss)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return qstate, torch.stack(losses).tolist() if losses else [], seconds


# --------------------------------------------------------------------------
# reference QAT checkpoint import


def qat_state_from_state_dict(spec: SESRSpec, state_dict, device="cuda") -> QATState:
    """The observer buffers of a reference *_qat_G.pth state dict (numpy)
    as a QATState on ``device`` (layer-level: the first element)."""

    def qs(prefix, lo_key="min_val", hi_key="max_val", n=None):
        lo = np.asarray(state_dict[f"{prefix}.{lo_key}"], np.float32).reshape(-1)[:1]
        hi = np.asarray(state_dict[f"{prefix}.{hi_key}"], np.float32).reshape(-1)[:1]
        return QuantizerState(torch.tensor(lo, device=device), torch.tensor(hi, device=device),
                              torch.ones((), dtype=torch.int32, device=device))

    convs = []
    for name in block_names(spec):
        for sub in ("conv_expand", "conv_squeeze"):
            convs.append(ConvQuantState(
                qs(f"{name}.{sub}.activation_quantizer.observer"),
                qs(f"{name}.{sub}.weight_quantizer.observer")))
    return QATState(tuple(convs), AddQuantState(qs("add_residual.observer_res"),
                                                qs("add_residual.observer_shortcut")))
