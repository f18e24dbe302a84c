"""Fixed-point primitives of the ASIC datapath, on torch tensors.

- saturating clamp at an arbitrary bit width (PE accumulator 18b, adder
  20b, fused bias 16b);
- the 16-bit-mantissa x 2^-n requantization constant encoder, with its
  truncating ``int()`` conversions and the ``shift_max`` clamp that only
  applies to ratios below 1;
- requantization in float32: two multiplies, each rounded to float32,
  never a pre-folded ``m * 2^-n`` (the intermediate rounding is observable
  once |x * m| exceeds 2^24);
- two's-complement hex of one value, the scalar spec of the RTL vector
  exporters' formatter (``export/hexfmt.py``).
"""

from __future__ import annotations

import math

import torch


def saturate(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Clamp to the signed two's-complement range of ``bits`` bits."""
    lo = -(1 << (bits - 1))
    hi = (1 << (bits - 1)) - 1
    return torch.clamp(x, lo, hi)


def encode_requant(value: float, data_bits: int = 16, shift_max: int = 32):
    """Encode a positive scale ratio as (mantissa, n) with value ~= m * 2^-n.

    Values >= 1 take n so that the mantissa has exactly ``data_bits``
    significant bits (not clamped to ``shift_max``); values < 1 take
    n = leading-zero count + data_bits, clamped to ``shift_max``. Both
    conversions to int truncate.
    """
    if not data_bits < shift_max:
        raise ValueError("requant data bit must be less than shift_max")
    value = float(value)
    if not value > 0.0:
        raise ValueError("requant constant must be positive")
    if int(value) != 0:
        before_point_bits = math.ceil(math.log2(int(value) + 1))
        n = data_bits - before_point_bits
    else:
        data = value * 2
        times = 0
        while int(data) == 0:
            times += 1
            data = data * 2
        n = times + data_bits
        if n > shift_max:
            n = shift_max
    mantissa = int(value * (2 ** n))
    return mantissa, n


def requant_factors(mantissa: int, n: int):
    """The two float32 factors of apply_requant_f32, as Python floats that
    are exactly representable in float32 (m < 2^24; 2^-n a power of two)."""
    return float(torch.tensor(float(mantissa), dtype=torch.float32)), \
        float(torch.tensor(2.0 ** (-n), dtype=torch.float32))


def apply_requant_f32(x: torch.Tensor, mantissa: int, n: int) -> torch.Tensor:
    """x * mantissa * 2^-n, rounded to float32 after each multiply."""
    m_f, p_f = requant_factors(mantissa, n)
    y = x.to(torch.float32) * m_f
    return y * p_f


def int_to_hex(value, bit_width: int) -> str:
    """Two's-complement hex string of ``value`` at ``bit_width`` bits, with
    ceil(bit_width/4) digits (at least 2)."""
    digits = math.ceil(bit_width / 4)
    v = int(value)
    if v < 0:
        v += 1 << bit_width
    return format(v, "0{}x".format(max(digits, 2)))
