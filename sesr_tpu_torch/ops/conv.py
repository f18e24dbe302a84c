"""NHWC convolution and pixel-shuffle primitives on torch tensors.

Public functions keep the JAX package's NHWC activations and HWIO weights;
the convolution runs in torch's native NCHW/OIHW inside.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


def conv2d_nhwc(x: torch.Tensor, w_hwio: torch.Tensor,
                bias: torch.Tensor = None) -> torch.Tensor:
    """Stride-1 SAME-padded 2D convolution, NHWC x HWIO -> NHWC, then
    ``+ bias`` (OC,) when given, as a separate add after the conv.

    The dtype is the caller's. The integer datapath calls it in float64 on
    integer-valued operands, where every sum is exact and any algorithm
    cuDNN picks gives the same values; float32 callers on a card run it
    inside ``float_exact()``.
    """
    k = w_hwio.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 padding=k // 2).permute(0, 2, 3, 1)
    return y if bias is None else y + bias


@contextlib.contextmanager
def float_exact():
    """Context for the float32 convs of the float forward and calibration
    (the JAX package runs them at ``precision=HIGHEST``): cuDNN without TF32
    and with deterministic algorithms, picked without benchmarking, so two
    runs on a card give the same values. The caller's settings come back on
    exit."""
    cudnn = torch.backends.cudnn
    saved = cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic
    cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic = False, False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.benchmark, cudnn.deterministic = saved


def pixel_shuffle_nhwc(x: torch.Tensor, r: int) -> torch.Tensor:
    """Depth-to-space with torch.nn.PixelShuffle channel ordering:
    out[n, h*r+i, w*r+j, c] = in[n, h, w, c*r*r + i*r + j]."""
    n, h, w, c_rr = x.shape
    c = c_rr // (r * r)
    x = x.reshape(n, h, w, c, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)          # (n, h, i, w, j, c)
    return x.reshape(n, h * r, w * r, c)


def nearest_upsample_x2(x: torch.Tensor) -> torch.Tensor:
    """2x nearest-neighbour upsample in NHWC (each pixel -> a 2x2 block)."""
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
