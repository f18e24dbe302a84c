"""QuantParams: the one artifact that holds every quantization constant of
a network, in the same npz + ``__meta__`` JSON format as the JAX
package's ``sesr_tpu/quant/params.py``, so an artifact written by either
package loads in the other.

Scalar arithmetic happens in Python float64, as the reference does with
``.item()`` floats; tensors only ever see the float32 cast of a scalar.
Everything here is numpy: the tensors are built from it per device
(``sesr_tpu_torch/convert.py``).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from sesr_tpu_torch.config import DEFAULT_HW, HardwareConfig, SESRSpec
from sesr_tpu_torch.ops.fixedpoint import encode_requant

# cell geometries whose equality obligations a legacy certificate (one
# stamped before the geometry record existed) executed
LEGACY_CERT_CELLS = ((2, 4), (4, 2), (2, 2), (4, 4))


@dataclasses.dataclass
class CalibState:
    """Running per-domain activation min/max. Domain i = input of conv i;
    domain L = the output domain."""

    min_vals: List[float]
    max_vals: List[float]

    @classmethod
    def fresh(cls, num_domains: int) -> "CalibState":
        return cls([float("inf")] * num_domains, [float("-inf")] * num_domains)

    def update(self, domain: int, lo: float, hi: float) -> None:
        if lo < self.min_vals[domain]:
            self.min_vals[domain] = float(lo)
        if hi > self.max_vals[domain]:
            self.max_vals[domain] = float(hi)


def asym_qparams(lo: float, hi: float, bits: int):
    """Asymmetric per-tensor scale/zero: scale=(max-min)/(qmax-qmin),
    zero=qmin-round(min/scale), with Python's banker's rounding."""
    qmax = 2 ** (bits - 1) - 1
    qmin = -(2 ** (bits - 1))
    scale = (hi - lo) / (qmax - qmin)
    if scale == 0.0:
        raise ValueError(
            f"degenerate calibration domain [{lo}, {hi}]: every observed "
            f"activation is equal — calibrate on images with signal")
    zero = qmin - round(lo / scale)
    return scale, int(zero)


def sym_qparams(absmax: float, bits: int) -> float:
    """Symmetric per-tensor weight scale: 2*absmax / (qmax-qmin)."""
    qmax = 2 ** (bits - 1) - 1
    qmin = -(2 ** (bits - 1))
    return (absmax - (-absmax)) / (qmax - qmin)


@dataclasses.dataclass
class QuantParams:
    """Everything needed to run a collapsed SESR net in INT8.

    Lists are indexed by conv id 0..L-1; activation domains by 0..L.
    """

    task: str
    hw: HardwareConfig
    w_scale: List[float]                # symmetric per-tensor weight scales
    w_int: List[np.ndarray]             # HWIO int8-valued arrays (stored int32)
    bias_f: List[np.ndarray]            # float biases, (OC,)
    a_scale: List[float]                # len L+1
    a_zero: List[int]                   # len L+1
    bias_int: List[np.ndarray]          # clamp(round(bias/(s_a*s_w)), 16b), (OC,)
    requant_m: List[int]                # per conv: mantissa into its wired domain
    requant_n: List[int]
    res_requant_m: int                  # residual-add rescale s_1/s_{L-1}
    res_requant_n: int
    # the fast-mode certificate: the single full-channel conv per layer
    # (no per-PE 18-bit saturation) is exact only where no accumulator
    # saturates; the fast datapath refuses an artifact without it
    fast_cert_ok: bool = False
    fast_cert_images: int = 0
    fast_cert_layers: Optional[Tuple[bool, ...]] = None   # per-layer, empirical
    fast_cert_static: Optional[Tuple[bool, ...]] = None   # per-layer, for all inputs
    shortcut_static: bool = False       # int16 shortcut store proven wrap-free
    cert_cells: Optional[Tuple[Tuple[int, int], ...]] = None

    @property
    def cert_grade(self) -> str:
        """"static", "empirical", "partial" or "none"."""
        if (self.fast_cert_ok and self.shortcut_static
                and self.fast_cert_static is not None
                and all(self.fast_cert_static)):
            return "static"
        if self.fast_cert_ok:
            return "empirical"
        if self.fast_cert_layers is not None and any(self.fast_cert_layers):
            return "partial"
        return "none"

    @property
    def cert_stamps(self) -> str:
        """Per-layer stamps: S = proven for all inputs, F = fast-safe on the
        calibration set, x = saturates; "?" per layer when unstamped."""
        if self.fast_cert_layers is None or self.fast_cert_static is None:
            return "?" * self.num_convs
        return "".join("S" if s else ("F" if f else "x")
                       for f, s in zip(self.fast_cert_layers,
                                       self.fast_cert_static))

    @property
    def num_convs(self) -> int:
        return len(self.w_int)

    def effective_zero(self, i: int) -> int:
        """Zero point subtracted before conv i: floored at -128, because the
        hardware can only zero-pad."""
        return max(self.a_zero[i], -(1 << (self.hw.quan_bits - 1)))

    def fused_bias(self, i: int) -> np.ndarray:
        """clamp(bias_int - zero_i * sum(W_int), +-2^15) per output channel.

        The zero here is the RAW zero point, not the floored one of the
        per-PE restoration (a reference quirk, replicated).
        """
        hi = (1 << (self.hw.bias_bits - 1)) - 1
        lo = -(1 << (self.hw.bias_bits - 1))
        w_sum = self.w_int[i].sum(axis=(0, 1, 2))          # (OC,)
        const = self.bias_int[i] - w_sum * self.a_zero[i]
        return np.clip(const, lo, hi)

    # ---- serialization ----------------------------------------------------
    def save(self, path: str) -> None:
        """Write the artifact to the literal ``path`` (through a file
        object: ``np.savez`` given a str appends ".npz")."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrays = {}
        for i in range(self.num_convs):
            arrays[f"w_int_{i}"] = self.w_int[i]
            arrays[f"bias_f_{i}"] = self.bias_f[i]
            arrays[f"bias_int_{i}"] = self.bias_int[i]
        meta = dict(
            task=self.task,
            hw=dataclasses.asdict(self.hw),
            w_scale=self.w_scale, a_scale=self.a_scale, a_zero=self.a_zero,
            requant_m=self.requant_m, requant_n=self.requant_n,
            res_requant_m=self.res_requant_m, res_requant_n=self.res_requant_n,
            num_convs=self.num_convs,
            fast_cert_ok=self.fast_cert_ok,
            fast_cert_images=self.fast_cert_images,
            fast_cert_layers=(None if self.fast_cert_layers is None
                              else list(self.fast_cert_layers)),
            fast_cert_static=(None if self.fast_cert_static is None
                              else list(self.fast_cert_static)),
            shortcut_static=self.shortcut_static,
            cert_cells=(None if self.cert_cells is None
                        else [list(c) for c in self.cert_cells]),
        )
        with open(path, "wb") as f:
            np.savez(f, __meta__=json.dumps(meta), **arrays)

    @classmethod
    def load(cls, path: str) -> "QuantParams":
        with np.load(path, allow_pickle=False) as data:
            meta = json.loads(str(data["__meta__"]))
            L = meta["num_convs"]
            w_int = [data[f"w_int_{i}"] for i in range(L)]
            bias_f = [data[f"bias_f_{i}"] for i in range(L)]
            bias_int = [data[f"bias_int_{i}"] for i in range(L)]

        def flags(key):
            v = meta.get(key)
            return None if v is None else tuple(bool(b) for b in v)

        if meta.get("cert_cells") is not None:
            cells = tuple(tuple(int(v) for v in c) for c in meta["cert_cells"])
        else:
            cells = (LEGACY_CERT_CELLS
                     if meta.get("fast_cert_layers") is not None else None)
        return cls(
            task=meta["task"],
            hw=HardwareConfig(**meta["hw"]),
            w_scale=[float(s) for s in meta["w_scale"]],
            w_int=w_int,
            bias_f=bias_f,
            a_scale=[float(s) for s in meta["a_scale"]],
            a_zero=[int(z) for z in meta["a_zero"]],
            bias_int=bias_int,
            requant_m=[int(m) for m in meta["requant_m"]],
            requant_n=[int(n) for n in meta["requant_n"]],
            res_requant_m=int(meta["res_requant_m"]),
            res_requant_n=int(meta["res_requant_n"]),
            fast_cert_ok=bool(meta.get("fast_cert_ok", False)),
            fast_cert_images=int(meta.get("fast_cert_images", 0)),
            fast_cert_layers=flags("fast_cert_layers"),
            fast_cert_static=flags("fast_cert_static"),
            shortcut_static=bool(meta.get("shortcut_static", False)),
            cert_cells=cells,
        )


def quantize_weights(weights_hwio: Sequence[np.ndarray],
                     hw: HardwareConfig = DEFAULT_HW):
    """Symmetric per-tensor INT8 weight quantization.

    Returns (w_int list [int32 arrays with int8 values], w_scale list
    [f64]). Rounding is to-nearest-even on the float32 tensor.
    """
    w_ints, w_scales = [], []
    for w in weights_hwio:
        w = np.asarray(w, dtype=np.float32)
        absmax = max(abs(float(w.max())), abs(float(w.min())))
        if not absmax > 0:
            raise ValueError("conv weight tensor is all zero")
        scale = sym_qparams(absmax, hw.quan_bits)
        q = np.clip(np.rint(w / np.float32(scale)),
                    -(1 << (hw.quan_bits - 1)), (1 << (hw.quan_bits - 1)) - 1)
        w_ints.append(q.astype(np.int32))
        w_scales.append(scale)
    return w_ints, w_scales


def requant_target_domain(i: int, num_convs: int) -> int:
    """The activation domain conv i's output is requantized into: conv 0 ->
    domain 1 (its post-ReLU output is the residual shortcut); the last
    residual block -> domain 1's scale (shortcut and branch share a scale
    for the integer residual add); the last conv -> the output domain L;
    everything else -> the next conv's domain."""
    L = num_convs
    if i == 0:
        return 1
    if i == L - 2:
        return 1
    if i == L - 1:
        return L
    return i + 1


def finalize(spec: SESRSpec,
             w_int: Sequence[np.ndarray],
             w_scale: Sequence[float],
             bias_f: Sequence[np.ndarray],
             calib: CalibState,
             hw: HardwareConfig = DEFAULT_HW,
             force_output_min_zero: bool = True,
             safe_zero_floor: bool = False) -> QuantParams:
    """Turn calibration min/max into a complete QuantParams.

    The output domain's min is forced to 0 (zero = -128), as the reference
    does. ``safe_zero_floor`` re-anchors any domain whose zero would fall
    below -128 at min=0, instead of letting execution floor the zero.
    """
    L = spec.num_convs
    a_scale, a_zero = [], []
    for d in range(L + 1):
        lo, hi = calib.min_vals[d], calib.max_vals[d]
        if d == L and force_output_min_zero:
            lo = 0.0
        s, z = asym_qparams(lo, hi, hw.quan_bits)
        if safe_zero_floor and z < -(1 << (hw.quan_bits - 1)):
            s, z = asym_qparams(0.0, hi, hw.quan_bits)
        a_scale.append(s)
        a_zero.append(z)

    bias_hi = (1 << (hw.bias_bits - 1)) - 1
    bias_lo = -(1 << (hw.bias_bits - 1))
    bias_int = []
    for i in range(L):
        bscale = a_scale[i] * w_scale[i]
        q = np.clip(np.rint(np.asarray(bias_f[i], np.float32) / np.float32(bscale)),
                    bias_lo, bias_hi)
        bias_int.append(q.astype(np.int32))

    requant_m, requant_n = [], []
    for i in range(L):
        target = requant_target_domain(i, L)
        # op order (s_i / s_target) * s_w, as the reference
        const = a_scale[i] / a_scale[target] * w_scale[i]
        m, n = encode_requant(const, hw.requant_bits, hw.requant_n_max)
        requant_m.append(m)
        requant_n.append(n)

    res_const = a_scale[1] / a_scale[L - 1]
    res_m, res_n = encode_requant(res_const, hw.requant_bits, hw.requant_n_max)

    return QuantParams(
        task=spec.name, hw=hw,
        w_scale=list(w_scale), w_int=list(w_int),
        bias_f=[np.asarray(b, np.float32) for b in bias_f],
        a_scale=a_scale, a_zero=a_zero, bias_int=bias_int,
        requant_m=requant_m, requant_n=requant_n,
        res_requant_m=res_m, res_requant_n=res_n,
    )
