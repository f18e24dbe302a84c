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
                    res_p=41, z_out=42, acc_hi=43, add_hi=44, bias=48,
                    zc=48 + MAX_LAYERS * HIDDEN)
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

    weights: np.ndarray          # int32 words, every layer at a 4-word boundary
    params: np.ndarray           # int32 (PARAM_WORDS,)
    num_layers: int
    in_channels: int
    out_channels: int


def _f32_bits(v: float) -> int:
    return int(np.array(v, np.float32).view(np.int32))


def _act_byte(ic: int, c: int) -> int:
    """Byte of input channel c in its 32-bit activation word: a pixel of a
    <= 4-channel input is one word (channel c in byte c); a 16-channel pixel
    is four words, word p holding channels p, p+4, p+8, p+12 (one PE)."""
    return c if ic <= 4 else c // 4


def _passes(ic: int, exact: bool, pe: int):
    """The input channels of each accumulation pass of a layer. The
    PE-exact kernel clamps each pass to 18 bits, so a pass is one PE's
    channels; the fast kernel only needs each pass to read one word."""
    if ic > 4 or exact:
        groups = [np.flatnonzero(pe_channel_mask(ic, pe, p)) for p in range(pe)]
        return [g for g in groups if len(g)]
    return [np.arange(ic)]


def _layer_words(w_hwio: np.ndarray, exact: bool, pe: int) -> np.ndarray:
    """Weight words (pass, k*k tap, OC rounded up to 4) of one layer: in the
    word of pass g for output channel o, the byte of each channel c of the
    pass holds w[dy, dx, c, o], in the byte where the activation word holds
    channel c."""
    k, _, ic, oc = w_hwio.shape
    ocp = -(-oc // 4) * 4
    passes = _passes(ic, exact, pe)
    words = np.zeros((len(passes), k * k, ocp), np.uint32)
    taps = np.asarray(w_hwio, np.int64).reshape(k * k, ic, oc)
    for g, chans in enumerate(passes):
        for c in chans:
            byte = (taps[:, c, :] & 0xFF).astype(np.uint32)
            words[g, :, :oc] |= byte << np.uint32(8 * _act_byte(ic, c))
    return words.view(np.int32).reshape(-1)


def kernel_constants(spec: SESRSpec, qp: QuantParams, exact: bool) -> KernelConstants:
    """Constants of the PE-exact kernel (``exact``, the reference datapath)
    or the fast kernel (the certified corrected datapath).

    The kernels keep raw int8 activations and hold z_eff at positions
    outside the image, so conv(q, pads=z_eff) = conv(q - z_eff) +
    z_eff * sum(W). Per PE that is the reference's zero-restored partial,
    so the PE-exact kernel needs no restoration term; the fast kernel
    subtracts ``zc`` = z_eff * sum(W) before its 20-bit clamp. Raises
    NotImplementedError for a network or artifact outside what the kernels
    were built for.
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

    lay = PARAM_LAYOUT
    prm = np.zeros(PARAM_WORDS, np.int32)
    chunks, off = [], 0
    hi16 = (1 << (hw.bias_bits - 1)) - 1
    for i in range(L):
        w = np.asarray(qp.w_int[i])
        words = _layer_words(w, exact, hw.pe)
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
                           spec.conv_out_channels)


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
