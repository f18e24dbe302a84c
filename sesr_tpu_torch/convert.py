"""Carrying weights across: from the JAX package's parameters to the port's
``QuantParams``, and from a ``QuantParams`` to the device constants of the
fused kernels in ``csrc/sesr_net.cu``.

The JAX side is given as plain numpy arrays and Python scalars (the fields
of a ``sesr_tpu`` QuantParams), so nothing here imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from sesr_tpu_torch.config import HardwareConfig, SESRSpec
from sesr_tpu_torch.ops.fixedpoint import requant_factors
from sesr_tpu_torch.quant.integer import pe_channel_mask
from sesr_tpu_torch.quant.params import QuantParams

# The int32 parameter block of the kernels (csrc/sesr_net.cu P_*): offset
# of each field, in words. Float fields travel as their float32 bits.
MAX_LAYERS = 8
HIDDEN = 16
PARAM_LAYOUT = dict(w_off=0, z_eff=8, z_in=16, rq_m=24, rq_p=32, res_m=40,
                    res_p=41, z_out=42, acc_hi=43, add_hi=44, pe_split=45,
                    clamp20=46, bias=48, zc=48 + MAX_LAYERS * HIDDEN)
PARAM_WORDS = PARAM_LAYOUT["zc"] + MAX_LAYERS * HIDDEN
# the kernels' datapath widths
_KERNEL_HW = dict(pe=4, quan_bits=8)


def quantparams_from_fields(fields: Mapping[str, Any]) -> QuantParams:
    """The port's QuantParams from the fields of a JAX-package QuantParams:
    numpy arrays, Python scalars and tuples; ``hw`` as a mapping of the
    HardwareConfig fields (or any object that carries them)."""
    hw = fields["hw"]
    if not isinstance(hw, Mapping):
        hw = {f.name: getattr(hw, f.name)
              for f in dataclasses.fields(HardwareConfig)}
    kw = {}
    for f in dataclasses.fields(QuantParams):
        v = fields.get(f.name, f.default)
        if f.name in ("w_int", "bias_f", "bias_int"):
            v = [np.array(a) for a in v]
        elif f.name in ("w_scale", "a_scale"):
            v = [float(s) for s in v]
        elif f.name in ("a_zero", "requant_m", "requant_n"):
            v = [int(s) for s in v]
        elif f.name == "hw":
            v = HardwareConfig(**{k: int(x) for k, x in hw.items()})
        elif f.name in ("fast_cert_layers", "fast_cert_static"):
            v = None if v is None else tuple(bool(b) for b in v)
        elif f.name == "cert_cells":
            v = None if v is None else tuple(tuple(int(c) for c in cell)
                                            for cell in v)
        kw[f.name] = v
    return QuantParams(**kw)


@dataclasses.dataclass(frozen=True)
class KernelConstants:
    """What one fused kernel needs besides its input: the packed weight
    words of every layer, the parameter block, and the shapes."""

    weights: np.ndarray          # int32 B-fragment words of every layer (_fragment_words)
    params: np.ndarray           # int32 (PARAM_WORDS,)
    num_layers: int
    in_channels: int
    out_channels: int
    pe_split: tuple              # per layer: one accumulation pass per PE
    clamp20: tuple               # per layer: the fast datapath's 20-bit clamp can fire


def _f32_bits(v: float) -> int:
    return int(np.array(v, np.float32).view(np.int32))


def _act_byte(ic: int, c: int) -> int:
    """Byte of input channel c in its 32-bit activation word: a pixel of a
    <= 4-channel input is one word (channel c in byte c); a 16-channel pixel
    is four words, word p holding channels p, p+4, p+8, p+12 (one PE)."""
    return c if ic <= 4 else c // 4


def _passes(ic: int, split: bool, pe: int):
    """The input channels of each accumulation pass of a layer: one PE's
    channels per pass where the kernel clamps each PE's sum to 18 bits
    (``split``), else one pass over all channels."""
    if split:
        groups = [np.flatnonzero(pe_channel_mask(ic, pe, p)) for p in range(pe)]
        return [g for g in groups if len(g)]
    return [np.arange(ic)]


def _tap_words(w_hwio: np.ndarray, split: bool, pe: int) -> np.ndarray:
    """uint32 words (pass, k*k tap, input word, OC): in the word of pass g
    for output channel o, the byte of each channel c of the pass holds
    w[dy, dx, c, o], in the byte where the activation word holds channel c."""
    k, _, ic, oc = w_hwio.shape
    passes = _passes(ic, split, pe)
    words = np.zeros((len(passes), k * k, 1 if ic <= 4 else 4, oc), np.uint32)
    taps = np.asarray(w_hwio, np.int64).reshape(k * k, ic, oc)
    for g, chans in enumerate(passes):
        for c in chans:
            byte = (taps[:, c, :] & 0xFF).astype(np.uint32)
            words[g, :, 0 if ic <= 4 else c % 4, :] |= byte << np.uint32(8 * _act_byte(ic, c))
    return words


def layer_geometry(k: int, ic: int, split: bool, pe: int = 4):
    """(passes, k32 chunks, tap_major) of one layer's implicit GEMM in the
    kernels, with one pass per PE (``split``) or one over all channels.
    Tap-major (per-PE passes, and any layer that reads one word per pixel):
    k-slot word s of chunk c is tap 8c + s of the pass's input word; else
    (one pass over 16 channels): tap 2c + s // 4, word s % 4."""
    tap_major = split or ic <= 4
    passes = len(_passes(ic, split, pe))
    chunks = -(-k * k // 8) if tap_major else -(-k * k // 2)
    return passes, chunks, tap_major


def _fragment_columns(oc: int, last: bool) -> np.ndarray:
    """Output channel of each B column (n-tile n, column g) -> 8n + g index,
    -1 past OC. A hidden layer permutes them so that the accumulators a lane
    (g, t) holds for a pixel (columns 2t, 2t+1 of both n-tiles) are channels
    t, t+4, t+8, t+12: word t of the next layer's input. The last layer
    keeps them in order (n-tile n, columns 2t, 2t+1 -> channels 8n + 2t,
    8n + 2t + 1) for its NHWC int8 stores."""
    n = np.arange(8 * -(-oc // 8))
    g = n % 8
    cols = n if last else (g >> 1) + 4 * (g & 1) + 8 * (n // 8)
    return np.where(cols < oc, cols, -1)


def _fragment_words(w_hwio: np.ndarray, split: bool, pe: int, last: bool) -> np.ndarray:
    """B fragments of one layer for mma.sync.m16n8k32.row.col.s8: int32
    words (pass, chunk, lane, n-tile, reg), the order in which lane
    4g + t loads its registers. reg 0 is k-slot word t of the chunk, reg 1
    word t + 4, both for column g of the n-tile; a padded tap or channel
    is a zero word."""
    k, _, ic, oc = w_hwio.shape
    words = _tap_words(w_hwio, split, pe)
    npass, chunks, tap_major = layer_geometry(k, ic, split, pe)
    cols = _fragment_columns(oc, last).reshape(-1, 8)          # (n-tile, g)
    lane = np.arange(32)
    g, t = lane // 4, lane % 4
    slot = np.stack([t, t + 4], axis=-1)                       # (lane, reg)
    frag = np.zeros((npass, chunks, 32, cols.shape[0], 2), np.uint32)
    for p in range(npass):
        for c in range(chunks):
            if tap_major:
                tap, word = 8 * c + slot, np.full_like(slot, p if ic > 4 else 0)
            else:
                tap, word = 2 * c + slot // 4, slot % 4
            for n in range(cols.shape[0]):
                o = cols[n, g][:, None]                        # (lane, 1)
                ok = (tap < k * k) & (o >= 0)
                frag[p, c, :, n, :] = np.where(
                    ok, words[p, np.minimum(tap, k * k - 1), word, np.maximum(o, 0)], 0)
    return frag.view(np.int32).reshape(-1)


def pe_split_layers(qp: QuantParams) -> tuple:
    """Per layer: whether the PE-exact datapath's 18-bit clamp of a PE's
    partial sum can fire. The kernels' partial is conv(q, pads = z_eff) on
    int8 values, so over every input it lies in [sum_{w>0} -128 w +
    sum_{w<0} 127 w, sum_{w>0} 127 w + sum_{w<0} -128 w]; where that range
    fits 18 bits for every PE and output channel, the clamp is the
    identity and the sum of the clamped partials is the full conv: the
    PE-exact kernel then runs the layer in one pass, as the fast kernel
    does."""
    hw = qp.hw
    lo_acc, hi_acc = -(1 << (hw.pe_acc_bits - 1)), (1 << (hw.pe_acc_bits - 1)) - 1
    split = []
    for w in qp.w_int:
        w = np.asarray(w, np.int64)
        pos, neg = np.maximum(w, 0), np.minimum(w, 0)
        fire = False
        for p in range(hw.pe):
            m = pe_channel_mask(w.shape[2], hw.pe, p)
            hi = (127 * pos[:, :, m] - 128 * neg[:, :, m]).sum(axis=(0, 1, 2))
            lo = (-128 * pos[:, :, m] + 127 * neg[:, :, m]).sum(axis=(0, 1, 2))
            fire |= bool((hi > hi_acc).any() or (lo < lo_acc).any())
        split.append(fire)
    return tuple(split)


def clamp20_layers(qp: QuantParams) -> tuple:
    """Per layer: whether the fast datapath's 20-bit clamp of conv(q -
    z_eff) can fire. Over every int8 input that sum lies in [sum_{w>0}
    (-128 - z_eff) w + sum_{w<0} (127 - z_eff) w, sum_{w>0} (127 - z_eff) w
    + sum_{w<0} (-128 - z_eff) w] per output channel; where that fits 20
    bits the fast kernel skips the clamp. (The PE-exact datapath's 20-bit
    clamp never fires: four 18-bit PE sums fit 20 bits.)"""
    hw = qp.hw
    lo_add, hi_add = -(1 << (hw.pe_add_bits - 1)), (1 << (hw.pe_add_bits - 1)) - 1
    fire = []
    for i, w in enumerate(qp.w_int):
        w = np.asarray(w, np.int64)
        z = qp.effective_zero(i)
        pos, neg = np.maximum(w, 0), np.minimum(w, 0)
        hi = ((127 - z) * pos + (-128 - z) * neg).sum(axis=(0, 1, 2))
        lo = ((-128 - z) * pos + (127 - z) * neg).sum(axis=(0, 1, 2))
        fire.append(bool((hi > hi_add).any() or (lo < lo_add).any()))
    return tuple(fire)


def shortcut_bound(qp: QuantParams) -> float:
    """The largest round(h) the fast kernel can store as its residual
    shortcut (conv 0's ReLU output, kept as int16): over every int8 input,
    conv(q - z_eff) is at most sum_{w>0} w (127 - z_eff) + sum_{w<0} w
    (-128 - z_eff) per channel, then the 20-bit clamp, the clipped bias
    and the float32 requantization, all monotone."""
    hw = qp.hw
    w = np.asarray(qp.w_int[0], np.int64)
    z = qp.effective_zero(0)
    hi = np.where(w > 0, w * (127 - z), w * (-128 - z)).sum(axis=(0, 1, 2))
    hi16 = (1 << (hw.bias_bits - 1)) - 1
    y = np.minimum(hi, (1 << (hw.pe_add_bits - 1)) - 1) \
        + np.clip(np.asarray(qp.bias_int[0], np.int64), -hi16 - 1, hi16)
    m_f, p_f = requant_factors(qp.requant_m[0], qp.requant_n[0])
    h = (y.astype(np.float32) * np.float32(m_f)) * np.float32(p_f)
    return float(np.rint(max(float(h.max()), 0.0)))


def kernel_constants(spec: SESRSpec, qp: QuantParams, exact: bool) -> KernelConstants:
    """Constants of the PE-exact kernel (``exact``, the reference datapath)
    or the fast kernel (the certified corrected datapath).

    The kernels keep raw int8 activations and hold z_eff at positions
    outside the image, so conv(q, pads=z_eff) = conv(q - z_eff) +
    z_eff * sum(W). Per PE that is the reference's zero-restored partial,
    so the PE-exact kernel needs no restoration term; the fast kernel
    subtracts ``zc`` = z_eff * sum(W) before its 20-bit clamp. The
    PE-exact kernel runs one pass per PE only on the layers where the
    18-bit clamp can fire (``pe_split_layers``), and the fast kernel clamps
    to 20 bits only where that clamp can fire (``clamp20_layers``). Raises
    NotImplementedError for a network or artifact outside what the kernels
    were built for (including a fast-kernel shortcut that may not fit
    int16, ``shortcut_bound``).
    """
    hw = qp.hw
    L = spec.num_convs
    ks = spec.kernel_sizes
    for name, want in _KERNEL_HW.items():
        if getattr(hw, name) != want:
            raise NotImplementedError(
                f"the fused kernels are built for {name}={want}, "
                f"this artifact has {getattr(hw, name)}")
    if not (3 <= L <= MAX_LAYERS and ks[0] == 5 and ks[-1] == 5
            and all(k == 3 for k in ks[1:-1])
            and spec.num_channels == HIDDEN and spec.in_channels <= 4
            and spec.conv_out_channels in (3, 12, 16)):
        raise NotImplementedError(
            f"the fused kernels run 5x5 / 3x3 ... / 5x5 convs of width "
            f"{HIDDEN}, 1-4 input and 3, 12 or 16 output channels, at most "
            f"{MAX_LAYERS} convs; {spec.name} is outside that")
    for i in range(L):
        z = qp.effective_zero(i)
        if not -128 <= z <= 127:
            raise NotImplementedError(
                f"layer {i}: effective zero {z} does not fit int8, and the "
                f"kernels hold it in the int8 pads of their input buffers")
    for m, n in [*zip(qp.requant_m, qp.requant_n), (qp.res_requant_m, qp.res_requant_n)]:
        if not (0 <= m < 1 << 22 and -64 <= n <= 64):
            raise NotImplementedError(
                f"requantization (m={m}, n={n}): the kernels round y * (m * 2^-n) "
                f"once, which equals the reference's (y * m) * 2^-n only while "
                f"m < 2^22 and |n| <= 64 keep every product a normal float")
    if exact and hw.pe << (hw.pe_acc_bits - 1) > 1 << (hw.pe_add_bits - 1):
        raise NotImplementedError(
            f"the PE-exact kernel has no 20-bit clamp: it needs {hw.pe} PE sums "
            f"of {hw.pe_acc_bits} bits to fit {hw.pe_add_bits} bits")
    if not exact and clamp20_layers(qp)[0]:
        raise NotImplementedError(
            "the fast kernel runs conv 0 without its 20-bit clamp; this "
            "artifact's conv 0 can reach it")
    if not exact and shortcut_bound(qp) > 32767:
        raise NotImplementedError(
            f"the fast kernel keeps the residual shortcut round(s) as int16; "
            f"this artifact bounds it only by {shortcut_bound(qp)}")

    lay = PARAM_LAYOUT
    prm = np.zeros(PARAM_WORDS, np.int32)
    chunks, off = [], 0
    hi16 = (1 << (hw.bias_bits - 1)) - 1
    split = pe_split_layers(qp) if exact else (False,) * L
    clamp = (False,) * L if exact else clamp20_layers(qp)
    prm[lay["pe_split"]] = sum(1 << i for i in range(L) if split[i])
    prm[lay["clamp20"]] = sum(1 << i for i in range(L) if clamp[i])
    for i in range(L):
        w = np.asarray(qp.w_int[i])
        words = _fragment_words(w, split[i], hw.pe, last=i == L - 1)
        prm[lay["w_off"] + i] = off
        chunks.append(words)
        off += words.size
        prm[lay["z_eff"] + i] = qp.effective_zero(i)
        prm[lay["z_in"] + i] = _f32_bits(float(qp.a_zero[i]))
        m_f, p_f = requant_factors(qp.requant_m[i], qp.requant_n[i])
        prm[lay["rq_m"] + i] = _f32_bits(m_f)
        prm[lay["rq_p"] + i] = _f32_bits(p_f)
        oc = w.shape[3]
        if exact:
            bias = qp.fused_bias(i)
            zc = np.zeros(oc, np.int64)
        else:
            bias = np.clip(np.asarray(qp.bias_int[i]), -hi16 - 1, hi16)
            zc = qp.effective_zero(i) * w.sum(axis=(0, 1, 2)).astype(np.int64)
        prm[lay["bias"] + i * HIDDEN: lay["bias"] + i * HIDDEN + oc] = bias
        prm[lay["zc"] + i * HIDDEN: lay["zc"] + i * HIDDEN + oc] = zc
    res_m, res_p = requant_factors(qp.res_requant_m, qp.res_requant_n)
    prm[lay["res_m"]] = _f32_bits(res_m)
    prm[lay["res_p"]] = _f32_bits(res_p)
    prm[lay["z_out"]] = _f32_bits(float(qp.a_zero[L]))
    prm[lay["acc_hi"]] = (1 << (hw.pe_acc_bits - 1)) - 1
    prm[lay["add_hi"]] = (1 << (hw.pe_add_bits - 1)) - 1
    return KernelConstants(np.concatenate(chunks), prm, L, spec.in_channels,
                           spec.conv_out_channels, split, clamp)


def device_constants(spec: SESRSpec, qp: QuantParams, exact: bool,
                     device: torch.device):
    """(weights, params) int32 tensors of kernel_constants on ``device``,
    built once per QuantParams instance and device, and kept on the
    instance (a ``dataclasses.replace`` copy builds its own)."""
    cache = qp.__dict__.setdefault("_kernel_constants", {})
    key = (spec.name, exact, str(device))
    if key not in cache:
        kc = kernel_constants(spec, qp, exact)
        cache[key] = (kc, torch.as_tensor(kc.weights, device=device),
                      torch.as_tensor(kc.params, device=device))
    return cache[key]
