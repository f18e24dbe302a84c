"""NHWC convolution and pixel-shuffle primitives on torch tensors.

Public functions keep the JAX package's NHWC activations and HWIO weights;
the convolution runs in torch's native NCHW/OIHW inside.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_nhwc(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME-padded 2D convolution, NHWC x HWIO -> NHWC.

    The dtype is the caller's. The integer datapath calls it in float64 on
    integer-valued operands, where every sum is exact and any algorithm
    cuDNN picks gives the same values; for float32 operands on a card,
    turn off TF32 first (``torch.backends.cudnn.allow_tf32 = False``).
    """
    k = w_hwio.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 padding=k // 2)
    return y.permute(0, 2, 3, 1)


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
