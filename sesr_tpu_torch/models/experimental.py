"""Experimental SESR variants from the reference's scratchpad
(models/sesr_arch.py:7-205), float only and unused by its entry scripts,
as the JAX package's ``sesr_tpu/models/experimental.py``:

- inception_sesr (:7-98): three parallel SESR paths of different widths,
  summed before the pixel shuffle (or one path chosen with ``single_path``
  and the 1-based ``conv_scale``);
- split_sesr (:101-168): three first convs concatenated into one trunk of
  residual blocks, then three last convs over channel slices, summed (the
  reference names an undefined block class for the trunk; plain residual
  blocks are the one well-defined reading);
- anchor_weights (:171-205 AnchorOp): nearest-neighbour upsampling as a
  frozen 1x1 conv making scaling_factor^2 copies of each channel, for a
  pixel shuffle.

Every float32 conv runs inside ``float_exact()`` (no TF32), as the JAX
package runs them at ``precision=HIGHEST``.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.models.sesr import CollapsedParams, forward_float
from sesr_tpu_torch.ops.conv import conv2d_nhwc, float_exact, pixel_shuffle_nhwc
from sesr_tpu_torch.quant.integer import as_input


class InceptionSESRParams(NamedTuple):
    paths: List[CollapsedParams]       # one collapsed SESR chain per path


def inception_path_spec(base: SESRSpec, widths=(8, 12, 16)) -> List[SESRSpec]:
    """Per-path specs: the base topology at each width (sesr_arch.py:20-63)."""
    return [SESRSpec(f"{base.name}_p{i}", base.in_channels, base.out_channels,
                     num_channels=w, num_lblocks=base.num_lblocks,
                     scaling_factor=base.scaling_factor)
            for i, w in enumerate(widths)]


def forward_inception(base: SESRSpec, params: InceptionSESRParams, x,
                      single_path: bool = False, conv_scale: int = 3,
                      device=None) -> torch.Tensor:
    """The paths' outputs summed before the pixel shuffle (sesr_arch.py:95-97),
    or with ``single_path`` only path ``conv_scale`` (1-based, the
    reference's ``conv_scale == 1/2/3`` chain, :14, 89-94). x: NHWC on
    ``device`` (default: x's device, else ``cuda``)."""
    if not isinstance(single_path, bool):
        # an integer here reads as "use path N", which truthiness would
        # silently turn into path ``conv_scale``
        raise TypeError("single_path is a bool; pass the path index via "
                        "conv_scale= (e.g. single_path=True, conv_scale=2)")
    x = as_input(x, device)
    specs = inception_path_spec(base)[: len(params.paths)]
    outs = []
    for spec, p in zip(specs, params.paths):
        # each path without its own shuffle
        pre = SESRSpec(spec.name, spec.in_channels,
                       spec.out_channels * spec.scaling_factor ** 2,
                       num_channels=spec.num_channels,
                       num_lblocks=spec.num_lblocks, scaling_factor=1)
        outs.append(forward_float(pre, p, x))
    if single_path:
        if not 1 <= conv_scale <= len(outs):
            raise ValueError(f"conv_scale must be 1..{len(outs)}, got {conv_scale}")
        y = outs[conv_scale - 1]
    else:
        y = outs[0]
        for o in outs[1:]:
            y = y + o
    return pixel_shuffle_nhwc(y, base.scaling_factor)


class SplitSESRParams(NamedTuple):
    first: List[CollapsedParams]       # 3 first-conv (k5) params: (w, b) each
    trunk: CollapsedParams             # residual blocks over concat channels
    last: List[CollapsedParams]        # 3 last-conv (k5) params


def forward_split(spec: SESRSpec, params: SplitSESRParams, x, tiny_channels: int = 8,
                  device=None) -> torch.Tensor:
    """split_sesr's forward (sesr_arch.py:155-168). ``params.first`` is a
    list of one-conv CollapsedParams, or one CollapsedParams of the three
    first convs."""
    x = as_input(x, device)

    def param(v):
        return torch.as_tensor(v, dtype=torch.float32, device=x.device)

    def conv(h, w, b):
        return conv2d_nhwc(h, param(w), param(b))

    firsts = (list(zip(params.first.weights, params.first.biases))
              if isinstance(params.first, CollapsedParams)
              else [(p.weights[0], p.biases[0]) for p in params.first])
    with float_exact():
        h = torch.cat([torch.relu(conv(x, w, b)) for w, b in firsts], dim=-1)
        c0 = h
        for w, b in zip(params.trunk.weights, params.trunk.biases):
            h = torch.relu(conv(h, w, b))
        h = h + c0
        t = tiny_channels
        slices = [h[..., :t], h[..., t:t + t // 2], h[..., t + t // 2:]]
        y = None
        for sl, p in zip(slices, params.last):
            o = conv(sl, p.weights[0], p.biases[0])
            y = o if y is None else y + o
    return pixel_shuffle_nhwc(y, spec.scaling_factor)


def anchor_weights(in_channels: int, scaling_factor: int) -> torch.Tensor:
    """AnchorOp as conv weights (sesr_arch.py:171-205): a 1x1 HWIO kernel
    whose output channel c*r^2 + j copies input channel c, nearest-neighbour
    upsampling once followed by PixelShuffle(r)."""
    r2 = scaling_factor ** 2
    w = np.zeros((1, 1, in_channels, in_channels * r2), np.float32)
    for c in range(in_channels):
        w[0, 0, c, c * r2:(c + 1) * r2] = 1.0
    return torch.from_numpy(w)


def anchor_upsample(x, scaling_factor: int, device=None) -> torch.Tensor:
    """Nearest-neighbour upsampling through the anchor conv and a pixel
    shuffle (the conv-only form the reference uses, so the op can ride the
    quantized conv datapath); without TF32, so the 0/1 selector copies
    float32 activations exactly."""
    x = as_input(x, device)
    w = anchor_weights(x.shape[-1], scaling_factor).to(x.device)
    with float_exact():
        y = conv2d_nhwc(x, w)
    return pixel_shuffle_nhwc(y, scaling_factor)
