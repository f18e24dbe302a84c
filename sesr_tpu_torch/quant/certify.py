"""Fast-mode certification: prove where the deployment fast datapath is
exact, statically where possible and over a calibration set otherwise.

The same proofs and the same stamps as the JAX package's
``sesr_tpu/quant/certify.py``. The fast datapath runs one full-channel conv
per layer and skips the per-PE 18-bit saturation; it equals the PE-exact
datapath exactly when no accumulator saturates. Per layer:

STATIC: interval arithmetic over the whole enforced int8 input domain.
Every layer input is clamped to [qmin, qmax] before the shift, so the
shifted input lies in [qmin - z_eff, qmax - z_eff] (hulled with 0 for the
zero padding) whatever the image. A layer whose per-PE prefix-sum interval
in the strict tap order (channel, kernel row, kernel column) stays inside
+-2^(PE_ACC_BIT-1) can never saturate, on the way or at the end.

EMPIRICAL: for the other layers, per calibration image, the 18-bit per-PE
counters of the PE-exact interpreter are zero (20-bit events do not
disqualify: the fast datapath applies the same clamp), and the per-MAC
strict model agrees with the clamp-once conv at the layer's real input,
per PE.

EQUALITY: a fully certified artifact has the fast interpreter and the
served fast forward (``ops/fast.py``, K2 on a card) equal to the PE-exact
interpreter on every image; a partial certificate has the served hybrid
forward (``ops/corrected.py``, the corrected kernel on a card) equal the
same way. The int16 shortcut store is bounded on the images, and proven
for all inputs where the static bound clears 2^15 (``shortcut_static``).

The port does not pack, so it runs its own served forwards once per image
where the JAX package runs its packed lowerings per cell geometry; the
artifact still records ``CERTIFIED_CELLS`` as ``cert_cells``, so that it is
field for field what the JAX package writes and serves there.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.ops.corrected import hybrid_forward
from sesr_tpu_torch.ops.fast import fast_forward
from sesr_tpu_torch.quant.integer import as_input, integer_forward, pe_channel_mask, resolve_device
from sesr_tpu_torch.quant.params import QuantParams
from sesr_tpu_torch.quant.strict import _pe_weights, strict_vs_fast_divergence

# A copy of sesr_tpu/ops/packed.py CERTIFIED_CELLS: the cell geometries whose
# packed lowerings the JAX package's certification runs. The port serves no
# cells, but stamps them so that its artifacts equal the JAX package's and
# serve there on the same geometries.
CERTIFIED_CELLS: Tuple[Tuple[int, int], ...] = ((1, 8), (2, 4), (4, 2), (2, 2), (4, 4))


def _input_interval(qp: QuantParams, i: int) -> Tuple[int, int]:
    """The enforced domain of layer i's shifted conv input, hulled with 0."""
    bits = qp.hw.quan_bits
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    z = qp.effective_zero(i)
    return min(0, qmin - z), max(0, qmax - z)


def _pe_tap_matrix(w_int: np.ndarray, pe: int, p: int) -> np.ndarray:
    """(T, OC) int64 tap weights of PE p in the strict per-MAC order:
    input channel outermost, then kernel row, then column (the channels of
    the other PEs zero)."""
    w = np.asarray(w_int, np.int64)
    w_p = w * pe_channel_mask(w.shape[2], pe, p)[None, None, :, None]
    return w_p.transpose(2, 0, 1, 3).reshape(-1, w.shape[3])


def static_layer_safe(qp: QuantParams, i: int) -> bool:
    """True iff, for every PE and output channel, the prefix-sum interval
    of the per-MAC accumulation over the enforced input domain stays
    inside the PE_ACC_BIT bounds: layer i never saturates, for any input."""
    hw = qp.hw
    lo_x, hi_x = _input_interval(qp, i)
    lim_hi = (1 << (hw.pe_acc_bits - 1)) - 1
    lim_lo = -(1 << (hw.pe_acc_bits - 1))
    for p in range(hw.pe):
        taps = _pe_tap_matrix(qp.w_int[i], hw.pe, p)
        t_lo = np.minimum(taps * lo_x, taps * hi_x)
        t_hi = np.maximum(taps * lo_x, taps * hi_x)
        if np.cumsum(t_lo, axis=0).min() < lim_lo or np.cumsum(t_hi, axis=0).max() > lim_hi:
            return False
    return True


def static_layer_stamps(qp: QuantParams) -> Tuple[bool, ...]:
    """static_layer_safe for every conv."""
    return tuple(static_layer_safe(qp, i) for i in range(qp.num_convs))


def static_requant_bound(qp: QuantParams, i: int) -> float:
    """An input-independent upper bound on max |round(relu(requant_i))|,
    the post-ReLU requantized output of conv i (i < L-1), over both forms
    of the layer: one conv with the 20-bit clamp and the clipped bias_int
    (fast), and per-PE 18-bit clamps on partial conv plus floored-zero
    restoration, the 20-bit clamp and the fused bias with the raw zero
    (PE-exact). The (1 + 1e-6) headroom covers the two float32 roundings of
    the requantization, and round(x) <= x + 0.5."""
    hw = qp.hw
    lo_x, hi_x = _input_interval(qp, i)
    w = np.asarray(qp.w_int[i], np.int64)
    add_lo, add_hi = -(1 << (hw.pe_add_bits - 1)), (1 << (hw.pe_add_bits - 1)) - 1
    acc_lo, acc_hi = -(1 << (hw.pe_acc_bits - 1)), (1 << (hw.pe_acc_bits - 1)) - 1
    b_lo, b_hi = -(1 << (hw.bias_bits - 1)), (1 << (hw.bias_bits - 1)) - 1
    bias = np.asarray(qp.bias_int[i], np.int64)

    t_hi = np.maximum(w * lo_x, w * hi_x).sum(axis=(0, 1, 2))
    hi_a = np.clip(t_hi, add_lo, add_hi) + np.clip(bias, b_lo, b_hi)

    z = qp.a_zero[i]
    z_eff = qp.effective_zero(i)
    ic = w.shape[2]
    s_hi = np.zeros(w.shape[3], np.int64)
    for p in range(hw.pe):
        wp = w * pe_channel_mask(ic, hw.pe, p)[None, None, :, None]
        p_hi = np.maximum(wp * lo_x, wp * hi_x).sum(axis=(0, 1, 2))
        s_hi += np.clip(p_hi + z_eff * wp.sum(axis=(0, 1, 2)), acc_lo, acc_hi)
    fused = np.clip(bias - z * w.sum(axis=(0, 1, 2)), b_lo, b_hi)
    hi_b = np.clip(s_hi, add_lo, add_hi) + fused

    hi_y = float(max(hi_a.max(), hi_b.max(), 0))
    return hi_y * qp.requant_m[i] * 2.0 ** (-qp.requant_n[i]) * (1 + 1e-6) + 0.5


def static_shortcut_bound(qp: QuantParams) -> float:
    """static_requant_bound for the residual shortcut (layer 0)."""
    return static_requant_bound(qp, 0)


def static_shortcut_safe(qp: QuantParams) -> bool:
    """True iff the int16 store of the residual shortcut is proven
    wrap-free for all inputs."""
    return static_shortcut_bound(qp) < float(1 << 15)


def adversarial_input_for_layer(qp: QuantParams, i: int):
    """The worst-case shifted input patch of layer i, (1, k, k, IC) int32:
    each site takes lo_x or hi_x by the sign of the worst (PE, output
    channel)'s weight there, so the centre position's accumulation follows
    the interval bound. Returns (patch, (p, o, sign))."""
    hw = qp.hw
    w = np.asarray(qp.w_int[i], np.int64)
    _, _, ic, oc = w.shape
    lo_x, hi_x = _input_interval(qp, i)
    best = None                                     # (|extreme|, p, o, sign)
    for p in range(hw.pe):
        taps = _pe_tap_matrix(w, hw.pe, p)
        t_lo = np.minimum(taps * lo_x, taps * hi_x)
        t_hi = np.maximum(taps * lo_x, taps * hi_x)
        hi_ext = np.cumsum(t_hi, axis=0).max(axis=0)
        lo_ext = np.cumsum(t_lo, axis=0).min(axis=0)
        for o in range(oc):
            for val, sign in ((hi_ext[o], +1), (-lo_ext[o], -1)):
                if best is None or val > best[0]:
                    best = (val, p, o, sign)
    _, p, o, sign = best
    mask = pe_channel_mask(ic, hw.pe, p)[None, None, :]
    w_po = w[:, :, :, o] * mask
    x = np.where(w_po * sign > 0, hi_x, lo_x).astype(np.int32)
    x = np.where((w_po == 0) & ~np.broadcast_to(mask, w_po.shape), 0, x)
    return x[None], (p, o, sign)


def adversarial_image(qp: QuantParams, hw: Tuple[int, int] = (64, 96)) -> np.ndarray:
    """A [0, 1] NHWC image that realizes layer 0's interval-extreme
    trajectory: adversarial_input_for_layer(qp, 0) mapped back through the
    layer-0 quantizer and tiled to ``hw``. Where layer 0 is not statically
    proven it fires real 18-bit events: the out-of-distribution input the
    empirical stamps cannot cover."""
    x_shift, _ = adversarial_input_for_layer(qp, 0)
    q = x_shift[0] + qp.effective_zero(0)                # (k, k, IC)
    k = q.shape[0]
    reps = (hw[0] + k - 1) // k, (hw[1] + k - 1) // k
    img_q = np.tile(q, (reps[0], reps[1], 1))[: hw[0], : hw[1], :]
    x = ((img_q - qp.a_zero[0]) * qp.a_scale[0]).astype(np.float32)
    return np.clip(x, 0.0, 1.0)[None]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def certify_fast(spec: SESRSpec, qp: QuantParams, images: Sequence[np.ndarray],
                 device=None, seconds: Optional[dict] = None) -> QuantParams:
    """Run the proof obligations over ``images`` (NHWC float in [0, 1]) on
    ``device`` (default ``cuda``) and return a copy of ``qp`` stamped with
    fast_cert_ok / fast_cert_images / fast_cert_layers / fast_cert_static /
    shortcut_static / cert_cells:

    - fast_cert_static[i]: layer i is proven saturation-free for all inputs.
    - fast_cert_layers[i]: layer i is fast-safe, statically or over every
      image (no 18-bit event, no per-MAC divergence).
    - fast_cert_ok: every layer is fast-safe, the shortcut store is bounded,
      and the fast interpreter and the served fast forward equal the
      PE-exact interpreter on every image.

    With no images only the static proofs stamp, and fast_cert_ok also
    needs the shortcut store's static proof. ``seconds``, when given, is
    filled with the wall seconds of the "interpreter", "strict" and
    "equality" parts (each ends with a device synchronize).
    """
    dev = resolve_device(None, device)
    L = qp.num_convs
    clock = {"interpreter": 0.0, "strict": 0.0, "equality": 0.0}
    static = list(static_layer_stamps(qp))
    # an optimistically stamped copy, so that the fast and hybrid forwards
    # run during their own certification; convert.py caches its kernel
    # constants per instance, so the returned artifact never serves these
    qp_try = dataclasses.replace(qp, fast_cert_ok=True, fast_cert_images=len(images),
                                 fast_cert_layers=tuple([True] * L),
                                 fast_cert_static=tuple(static))
    layer_ok = [True] * L if images else list(static)
    xs, exact_outs = [], []
    shortcut_max = 0.0
    with torch.inference_mode():
        for img in images:
            t0 = time.perf_counter()
            x = as_input(img, dev)
            y_exact, dumps = integer_forward(spec, qp_try, x, collect_dumps=True,
                                             corrected=True)
            xs.append(x)
            exact_outs.append(y_exact)
            shortcut_max = max(shortcut_max,
                               float(torch.round(dumps["shortcut"]).abs().max()))
            ovf18 = dumps["overflow_18"].tolist()
            _sync(dev)
            t1 = time.perf_counter()
            clock["interpreter"] += t1 - t0
            for i in range(L):
                if static[i]:
                    # the static proof covers every input: a counter here
                    # would mean the bound is unsound
                    if ovf18[i] != 0:
                        raise RuntimeError(
                            f"layer {i}: statically proven safe but the 18-bit counter "
                            f"fired ({ovf18[i]} events): interval bound bug")
                elif ovf18[i] != 0:
                    layer_ok[i] = False
            for i in range(L):
                if static[i] or not layer_ok[i]:
                    continue
                x_shift = dumps[f"input.{i}"].to(torch.int32) - qp.effective_zero(i)
                if any(strict_vs_fast_divergence(x_shift, w_p, qp.hw) != 0
                       for w_p in _pe_weights(qp.w_int[i], qp.hw.pe)):
                    layer_ok[i] = False
            del dumps
            _sync(dev)
            clock["strict"] += time.perf_counter() - t1

        sc_bound = static_shortcut_bound(qp)
        sc_static = sc_bound < float(1 << 15)
        if sc_static and images and shortcut_max > sc_bound:
            raise RuntimeError(f"shortcut statically bounded at {sc_bound:.1f} but "
                               f"measured {shortcut_max:.1f}: interval bound bug")

        ok = all(layer_ok)
        if ok and not images and not sc_static:
            # zero images, all layers static, but no static proof for the
            # shortcut store: its empirical bound would pass vacuously
            ok = False
        if ok and shortcut_max >= float(1 << 15):
            ok, layer_ok = False, [False] * L
        t0 = time.perf_counter()
        if ok:
            for x, y_e in zip(xs, exact_outs):
                y_fast = integer_forward(spec, qp_try, x, corrected=True, compute="fast")[0]
                if not (torch.equal(y_e, y_fast) and torch.equal(y_e, fast_forward(spec, qp_try, x))):
                    # unreachable given the per-layer obligations; demote
                    # everything rather than ship unsound stamps
                    ok, layer_ok = False, [False] * L
                    break
        elif any(layer_ok):
            # the hybrid forward narrow-stores its boundaries exactly when
            # the artifact holds the shortcut proof, so the program checked
            # here is the one that will serve
            qp_h = dataclasses.replace(qp_try, fast_cert_ok=False,
                                       fast_cert_layers=tuple(layer_ok),
                                       shortcut_static=sc_static)
            for x, y_e in zip(xs, exact_outs):
                if not torch.equal(y_e, hybrid_forward(spec, qp_h, x)):
                    layer_ok = [False] * L
                    break
        _sync(dev)
        clock["equality"] += time.perf_counter() - t0
    if seconds is not None:
        seconds.update(clock)
    return dataclasses.replace(qp, fast_cert_ok=ok, fast_cert_images=len(images),
                               fast_cert_layers=tuple(layer_ok),
                               fast_cert_static=tuple(static),
                               shortcut_static=sc_static,
                               cert_cells=CERTIFIED_CELLS)
