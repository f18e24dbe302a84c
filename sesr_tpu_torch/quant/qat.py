"""The frozen QuantAdd of the reference's qatf="qat_" composition.

Only the two functions the integer interpreter and calibration need, the
same as the JAX package's ``sesr_tpu/quant/qat.py``
``quant_add_scale_from_bounds`` and ``quant_add_frozen``. The fx trace of
the reference inlines QuantAdd and reads its observers' union min/max from
the checkpoint's buffers, so the scale is a constant: a fixed symmetric
fake-quant of each operand, then the add.
"""

from __future__ import annotations

import numpy as np
import torch


def quant_add_scale_from_bounds(lo: float, hi: float, bits: int = 8) -> float:
    """max(|lo|, |hi|) / 127.5 with the float32 eps floor, computed in
    float32 as torch does at trace time."""
    qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    quant_range = np.float32((qmax - qmin) / 2.0)
    float_range = np.float32(max(abs(np.float32(lo)), abs(np.float32(hi))))
    return float(np.maximum(np.float32(float_range / quant_range),
                            np.float32(np.finfo(np.float32).eps)))


def quant_add_frozen(res: torch.Tensor, shortcut: torch.Tensor, union_lo: float,
                     union_hi: float, bits: int = 8) -> torch.Tensor:
    """fq(res) + fq(shortcut), fq the fake-quant at the frozen scale. It
    rounds half away from zero (sign * floor(|t| + 0.5)), as the reference's
    quantizer does, not half to even. The division is by a one-element
    tensor on the operands' device, so no backend turns it into a multiply
    by the reciprocal."""
    qmin, qmax = float(-(1 << (bits - 1))), float((1 << (bits - 1)) - 1)
    scale = torch.tensor([quant_add_scale_from_bounds(union_lo, union_hi, bits)],
                         dtype=torch.float32, device=res.device)

    def fq(x):
        t = x / scale
        q = torch.clamp(torch.sign(t) * torch.floor(torch.abs(t) + 0.5), qmin, qmax)
        return q * scale

    return fq(res) + fq(shortcut)
