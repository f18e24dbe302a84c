"""The port's fixed-point primitives (sesr_tpu_torch/ops/fixedpoint.py)
against the JAX package's, bit for bit."""

import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sesr_tpu.ops import fixedpoint as jfp
from sesr_tpu_torch.ops import fixedpoint as tfp

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")


def _golden_requant_pairs():
    pairs = set()
    for path in sorted(glob.glob(os.path.join(GOLDEN_DIR, "*.npz"))):
        g = np.load(path)
        L = int(g["num_convs"])
        pairs.update((int(g[f"requan_m_{i}"]), int(g[f"requan_n_{i}"]))
                     for i in range(L))
        pairs.add((int(g["res_requant_m"]), int(g["res_requant_n"])))
    return sorted(pairs)


REQUANT_PAIRS = _golden_requant_pairs()


def test_golden_pairs_include_negative_shift():
    # sr_x2_qat's residual rescale has n = -1
    assert any(n < 0 for _, n in REQUANT_PAIRS)


@pytest.mark.parametrize("lo,hi", [(1e-9, 1e-3), (1e-3, 1.0), (1.0, 3.0e4)])
def test_encode_requant_sweep(lo, hi):
    rng = np.random.default_rng(0)
    values = np.exp(rng.uniform(np.log(lo), np.log(hi), 400))
    values = np.concatenate([values, [lo, hi, 0.5, 1.0, 2.0 ** -20, 2.0 ** -40,
                                      65535.9, 65536.0, 1.5, 2.0]])
    for v in values:
        for bits, shift_max in ((16, 32), (8, 12), (12, 16)):
            assert tfp.encode_requant(v, bits, shift_max) == \
                jfp.encode_requant(v, bits, shift_max), (v, bits, shift_max)


def test_encode_requant_shift_max_clamp():
    # below 1 the shift clamps to shift_max; at or above 1 it does not
    m, n = tfp.encode_requant(2.0 ** -40, 16, 32)
    assert n == 32 and (m, n) == jfp.encode_requant(2.0 ** -40, 16, 32)
    m, n = tfp.encode_requant(3.0e4, 16, 32)
    assert n == 1 and (m, n) == jfp.encode_requant(3.0e4, 16, 32)
    with pytest.raises(ValueError):
        tfp.encode_requant(0.0)


@pytest.mark.parametrize("m,n", REQUANT_PAIRS)
def test_apply_requant_f32_bitexact(m, n):
    rng = np.random.default_rng(m ^ (n & 0xFF))
    x = np.concatenate([rng.integers(-(1 << 19), 1 << 19, 20000),
                        [-(1 << 19), (1 << 19) - 1, 0, 1, -1]]).astype(np.int32)
    want = np.asarray(jfp.apply_requant_f32(jnp.asarray(x), m, n))
    got = tfp.apply_requant_f32(torch.from_numpy(x), m, n).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_saturate_and_hex():
    x = np.arange(-300000, 300000, 997, dtype=np.int32)
    for bits in (8, 16, 18, 20):
        np.testing.assert_array_equal(
            tfp.saturate(torch.from_numpy(x), bits).numpy(),
            np.asarray(jfp.saturate(jnp.asarray(x), bits)))
    for v, bits in ((-1, 8), (127, 8), (-128, 8), (-5, 18), (70000, 20), (3, 4)):
        assert tfp.int_to_hex(v, bits) == jfp.int_to_hex(v, bits)
