"""The packed-word probes (P3-P6) on the card:

- ``mosaic_int8_bitcast_probe``: tools/bench_probe_r3a.py:323, an int32 roll,
  the int32 -> int8 bitcast, then an int8 dot, on the card one launch of
  ``probe_bitcast_dot``. On its own shapes (words (256, 128), w (512, 256))
  the bitcast gives (1024, 128), whose 128 columns cannot contract with
  w's 512 rows: the dot raises TypeError, as it does in JAX, before
  anything is launched, and the probe prints FAILED and returns False.
- ``bitcast_layout_probe``: tools/bench_probe_r3b.py:63, which row of the
  (4M, N) int8 view holds byte b of word row m; the answer is 4m + b.
- ``byteplane_dot`` / ``byteplane_dot_probe``: tools/bench_probe_r3b.py:107,
  the int8 product of packed words as four byte-plane dots. On the card
  the words are, unchanged, the int8 A operand of one exact dot
  (``probe_packed_dot``), which reads the plane weights wb as they are.

The bitcast alone (with a roll) is ``probe_unpack_words``: row 4m + b holds
byte b of word row m, extracted explicitly (an int8 view of the words would
be (M, 4N), byte b of word (m, n) at column 4n + b).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from sesr_tpu_torch.probes import kernels, plain
from sesr_tpu_torch.timing import device_label, median_ms

R3A_SHAPES = (256, 512, 256)           # M, Kd, N of tools/bench_probe_r3a.py:338
CONSISTENT_W_ROWS = R3A_SHAPES[1] // 4  # w rows that contract with r3a's words
LAYOUT_SHAPE = (8, 128)                # tools/bench_probe_r3b.py:70
BYTEPLANE_SHAPES = (1024, 512, 128)    # tools/bench_probe_r3b.py:115
LAYOUTS = {"m*4+b": lambda m, b, M: 4 * m + b, "b*M+m": lambda m, b, M: b * M + m}


def pack_words(a8: np.ndarray) -> np.ndarray:
    """(..., 4) int8 -> (...) int32, byte b = a8[..., b], as the probes pack."""
    a = a8.astype(np.int32) & 0xFF
    return a[..., 0] | (a[..., 1] << 8) | (a[..., 2] << 16) | (a[..., 3] << 24)


def unpack_words(words: torch.Tensor, roll: int = 0) -> torch.Tensor:
    """(4M, N) int8, row 4m + b = byte b of words[m, (n - roll) mod N]: the
    TPU's int32 -> int8 bitcast after a roll of the words by ``roll`` along
    axis 1."""
    if words.device.type == "cpu":
        return plain.unpack_words(words, roll)
    return kernels.probe_unpack_words(words.contiguous(), roll)


def bitcast_dot(words: torch.Tensor, w: torch.Tensor, roll: int = 1) -> torch.Tensor:
    """r3a's kernel: roll the int32 words (M, N) by ``roll`` along axis 1,
    bitcast to int8 (4M, N), and take the exact int32 dot with w (N', P);
    on the card one ``probe_bitcast_dot`` launch. Raises TypeError, as JAX's
    dot_general does, when N' != N."""
    n = words.shape[1]
    if w.shape[0] != n:
        raise TypeError("dot_general requires contracting dimensions to have the same "
                        f"shape, got ({n},) and ({w.shape[0]},).")
    if words.device.type == "cpu":
        return plain.bitcast_dot(words, w, roll)
    return kernels.probe_bitcast_dot(words.contiguous(), w.contiguous(), roll)


def r3a_inputs(w_rows: int = R3A_SHAPES[1]):
    """r3a's operands: x8 = arange(M Kd) as int8 (M, Kd) viewed as int32
    words (M, Kd / 4), and w = ones (w_rows, N) int8 (r3a: w_rows = Kd)."""
    m, kd, n = R3A_SHAPES
    x8 = np.arange(m * kd, dtype=np.int8).reshape(m, kd)
    return x8.view(np.int32), np.ones((w_rows, n), np.int8)


def mosaic_int8_bitcast_probe(device: torch.device, w_rows: int = R3A_SHAPES[1]) -> bool:
    """r3a's probe: True if the roll + bitcast + int8 dot runs. On r3a's
    shapes it does not (see the module docstring); ``w_rows`` =
    CONSISTENT_W_ROWS gives consistent shapes."""
    words, w = r3a_inputs(w_rows)
    try:
        out = bitcast_dot(torch.from_numpy(words).to(device), torch.from_numpy(w).to(device))
        print(f"  int32->int8 bitcast + int8 dot: COMPILED, out[0,0]={int(out[0, 0])}",
              flush=True)
        return True
    except Exception as e:  # the probe reports a failure, as the TPU probe does
        print(f"  int32->int8 bitcast: FAILED {type(e).__name__}: {str(e)[:200]}", flush=True)
        return False


def layout_inputs():
    """r3b's layout operand: byte b of word (m, n) is (4 (m N + n) + b) as int8."""
    m, n = LAYOUT_SHAPE
    x8 = np.arange(m * n * 4, dtype=np.int32).astype(np.int8).reshape(m, n, 4)
    return x8, pack_words(x8)


def bitcast_layout_probe(device: torch.device) -> str:
    """Which row of the (4M, N) int8 view holds byte b of word row m:
    "m*4+b", "b*M+m" or "unknown"."""
    x8, words = layout_inputs()
    m = words.shape[0]
    out = unpack_words(torch.from_numpy(words).to(device)).cpu().numpy()
    for name, rowmap in LAYOUTS.items():
        ok = all(np.array_equal(out[rowmap(i, b, m)], x8[i, :, b])
                 for i in range(m) for b in range(4))
        print(f"  bitcast row layout {name}: {'MATCH' if ok else 'no'}", flush=True)
        if ok:
            return name
    print(f"  bitcast layout: UNRECOGNIZED; out[0,:8]= {out[0, :8]}", flush=True)
    return "unknown"


def byteplane_dot(words: torch.Tensor, wb: torch.Tensor,
                  out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """sum over b of plane_b(words) @ wb[b], plane_b[m, j] = byte b of word
    (m, j), wb (4, K/4, N): the exact int32 sum (float32 for the probe's
    timed form)."""
    if words.device.type == "cpu":
        return plain.packed_dot(words, wb, out_dtype)
    return kernels.probe_packed_dot(words.contiguous(), wb.contiguous(), out_dtype)


def byteplane_inputs(shapes=BYTEPLANE_SHAPES, seed: int = 0):
    """r3b's operands from one generator: a8 (M, K) and w8 (K, N) int8, the
    packed words (M, K/4) and the byte-plane weights wb (4, K/4, N) with
    wb[b][j] = w8[4j + b]."""
    m, k, n = shapes
    rng = np.random.default_rng(seed)
    a8 = rng.integers(-127, 128, (m, k), dtype=np.int8)
    w8 = rng.integers(-127, 128, (k, n), dtype=np.int8)
    wb = np.stack([w8[b::4, :] for b in range(4)])
    return a8, w8, pack_words(a8.reshape(m, k // 4, 4)), wb


def byteplane_dot_probe(device: torch.device) -> bool:
    """r3b's correctness check: the byte-plane dot equals a8 @ w8."""
    a8, w8, words, wb = byteplane_inputs()
    want = a8.astype(np.int64) @ w8.astype(np.int64)
    out = byteplane_dot(torch.from_numpy(words).to(device),
                        torch.from_numpy(wb).to(device)).cpu().numpy()
    ok = np.array_equal(out, want)
    print(f"  byte-plane int8 dot: {'CORRECT' if ok else 'WRONG'} "
          f"(maxdiff {np.abs(out - want).max()})", flush=True)
    return ok


def main(device: torch.device, reps: int = 10) -> dict:
    """The three probes, then the median time of each kernel's call on the
    probes' own shapes (r3a's dot on consistent shapes, w (128, 256)),
    printed as one JSON line."""
    print("bitcast layout discovery:", flush=True)
    layout = bitcast_layout_probe(device)
    print("byte-plane dot probe:", flush=True)
    correct = byteplane_dot_probe(device)
    print("int8 bitcast + dot (r3a's shapes, then consistent shapes):", flush=True)
    r3a = mosaic_int8_bitcast_probe(device)
    consistent = mosaic_int8_bitcast_probe(device, w_rows=CONSISTENT_W_ROWS)
    words = torch.from_numpy(layout_inputs()[1]).to(device)
    _, _, packed, wb = byteplane_inputs()
    packed, wb = torch.from_numpy(packed).to(device), torch.from_numpy(wb).to(device)
    r3a_words, r3a_w = (torch.from_numpy(t).to(device) for t in r3a_inputs(CONSISTENT_W_ROWS))
    m, k, n = BYTEPLANE_SHAPES
    res = {"device": device_label(device), "layout": layout, "byteplane_correct": correct,
           "r3a_shapes_run": r3a, "consistent_shapes_run": consistent,
           "bitcast_layout_ms": median_ms(lambda: unpack_words(words), device, reps),
           "bitcast_dot_ms": median_ms(lambda: bitcast_dot(r3a_words, r3a_w), device, reps),
           "byteplane_f32_ms": median_ms(lambda: byteplane_dot(packed, wb, torch.float32),
                                         device, reps)}
    res["byteplane_f32_TOP/s"] = 2 * m * k * n / (res["byteplane_f32_ms"] * 1e-3) / 1e12
    print(json.dumps(res), flush=True)
    return res
