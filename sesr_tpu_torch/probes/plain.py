"""Plain PyTorch versions of the five probe kernels (``kernels.py``).

They run on any device. Integer products are taken in float64 on integer
values and cast: every sum is exact, since |sum| < 2^53. bf16 inputs are
multiplied in float32 with TF32 off (products of two bf16 values are exact
in float32; the sums are float32 in PyTorch's order). The write-backs are
the TPU probe's, bit for bit: int8 is clip(acc, -128, 127); bf16 is
acc * f32(1e-3) rounded to bf16, nearest-even.
"""

from __future__ import annotations

import torch

MM_REP = 9          # the mm variants repeat each result row to 9 pixels
_MILLI = 1e-3       # the bf16 write-back's scale, as a float32 below


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of int8 (exact, int32) or bf16 (float32) operands."""
    if a.dtype == torch.bfloat16:
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return a.float() @ b.float()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev
    return (a.double() @ b.double()).to(torch.int32)


def gemm(a: torch.Tensor, b: torch.Tensor,
         out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``kernels.probe_gemm``: a @ b in int32 or float32."""
    return _matmul(a, b).to(out_dtype)


def write_back(acc: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The conv probe's write-back of an int32 or float32 sum into x's type."""
    if dtype == torch.int8:
        return acc.clamp(-128, 127).to(torch.int8)
    milli = torch.tensor(_MILLI, dtype=torch.float32, device=acc.device)
    return (acc * milli).to(torch.bfloat16)


def gemm_write_back(a: torch.Tensor, b: torch.Tensor, rep: int) -> torch.Tensor:
    """``kernels.probe_gemm.write_back``: each written-back row of a @ b to
    ``rep`` consecutive rows."""
    return write_back(_matmul(a, b), a.dtype).repeat_interleave(rep, dim=0)


def conv_step(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One step of ``kernels.probe_conv_run``: x (E_H, E_W, C), w (9C, C) with row
    (3 qy + qx) C + ci; pixel (h, w) sums x[(h + qy - 1) mod E_H,
    (w + qx - 1) mod E_W, ci] * w over (qy, qx, ci)."""
    eh, ew, c = x.shape
    taps = [torch.roll(x, shifts=(1 - qy, 1 - qx), dims=(0, 1))
            for qy in range(3) for qx in range(3)]
    patches = torch.cat(taps, dim=2).reshape(eh * ew, 9 * c)
    return write_back(_matmul(patches, w), x.dtype).reshape(eh, ew, c)


def unpack_words(words: torch.Tensor, roll: int = 0) -> torch.Tensor:
    """``kernels.probe_unpack_words``: (4M, N) int8, row 4m + b = byte b of
    words[m, (n - roll) mod N]. The int8 view of the words is (M, 4N) with
    byte b of word (m, n) at column 4n + b (little-endian), hence the
    permute."""
    m, n = words.shape
    rolled = torch.roll(words, shifts=roll, dims=1).contiguous()
    return rolled.view(torch.int8).reshape(m, n, 4).permute(0, 2, 1).reshape(4 * m, n)


def bitcast_dot(words: torch.Tensor, w: torch.Tensor, roll: int = 1) -> torch.Tensor:
    """``kernels.probe_bitcast_dot``: r3a's kernel, the exact int32 dot of
    ``unpack_words(words, roll)`` (4M, N) with w (N, P)."""
    return gemm(unpack_words(words, roll), w, torch.int32)


def packed_dot(words: torch.Tensor, wb: torch.Tensor,
               out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
    """``kernels.probe_packed_dot``: the sum over b of plane_b @ wb[b],
    exactly, with plane_b (M, K/4) byte b of the int32 words and wb the int8
    byte-plane weights (4, K/4, N): the TPU probe's four dots."""
    m, kw = words.shape
    planes = words.contiguous().view(torch.int8).reshape(m, kw, 4)
    return sum(_matmul(planes[:, :, b], wb[b]) for b in range(4)).to(out_dtype)
