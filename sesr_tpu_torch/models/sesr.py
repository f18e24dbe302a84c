"""The collapsed SESR network: parameters and its float forward.

The same network as the JAX package's ``sesr_tpu/models/sesr.py``. After
the collapse every task is the same graph:

    c0 = relu(conv_first(x))                 # k_first
    h  = relu(conv_i(h))   for each lblock   # k_block, residual folded into W
    h  = h + c0                              # outer residual add
    y  = conv_last(h)                        # k_last, identity activation
    y  = pixel_shuffle(y, r)                 # only when scaling_factor > 1

``forward_float`` is a function of (spec, params, x), as the fake-quant and
integer paths are; ``SESR`` is the same forward as an ``nn.Module`` that
holds its weights as parameters. Weights are HWIO and activations NHWC.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np
import torch
from torch import nn

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.ops.conv import conv2d_nhwc, float_exact, pixel_shuffle_nhwc
from sesr_tpu_torch.ops.halo import exchange_for_conv
from sesr_tpu_torch.quant.integer import as_input


class CollapsedParams(NamedTuple):
    """Weights of a collapsed SESR net: weights[i] HWIO, biases[i] (OC,);
    numpy arrays or tensors."""

    weights: List
    biases: List

    @property
    def num_convs(self) -> int:
        return len(self.weights)


def init_params(spec: SESRSpec, generator: torch.Generator,
                dtype=torch.float32) -> CollapsedParams:
    """Random collapsed parameters (for tests and smoke runs; real weights
    come from ``io/torch_import.py``): N(0, 1/fan_in) weights, zero biases,
    drawn on the CPU from ``generator``."""
    chans = ([spec.in_channels] + [spec.num_channels] * (spec.num_convs - 1)
             + [spec.conv_out_channels])
    weights, biases = [], []
    for i, k in enumerate(spec.kernel_sizes):
        fan_in = k * k * chans[i]
        w = torch.randn((k, k, chans[i], chans[i + 1]), generator=generator,
                        dtype=dtype) / np.sqrt(fan_in)
        weights.append(w)
        biases.append(torch.zeros((chans[i + 1],), dtype=dtype))
    return CollapsedParams(weights, biases)


def forward_float(spec: SESRSpec, params: CollapsedParams, x,
                  device=None, halo_group=None) -> torch.Tensor:
    """Float32 forward of the collapsed network. x: NHWC in [0, 1] (numpy or
    tensor), on ``device`` (default: x's device, else ``cuda``). The convs
    run without TF32 (``float_exact``).

    ``halo_group``: this rank's spatial block, sharded along W (a process
    group) or along H and W (an (h_group, w_group) pair): each conv
    exchanges its k // 2 halo with the neighbouring ranks in place of the
    zero padding (``ops/halo.py``)."""
    x = as_input(x, device)

    def param(v):
        return torch.as_tensor(v, dtype=torch.float32, device=x.device)

    def conv(h, i):
        w, b = param(params.weights[i]), param(params.biases[i])
        if halo_group is None:
            return conv2d_nhwc(h, w, b)
        h, w_valid, h_valid = exchange_for_conv(h, w.shape[0], halo_group)
        return conv2d_nhwc(h, w, b, w_valid=w_valid, h_valid=h_valid)

    n = params.num_convs
    with float_exact():
        h = torch.relu(conv(x, 0))
        c0 = h
        for i in range(1, n - 1):
            h = torch.relu(conv(h, i))
        y = conv(h + c0, n - 1)
    if spec.has_pixel_shuffle:
        y = pixel_shuffle_nhwc(y, spec.scaling_factor)
    return y


class SESR(nn.Module):
    """The collapsed network as a module: its weights and biases are
    parameters, its forward ``forward_float``."""

    def __init__(self, spec: SESRSpec, params: CollapsedParams):
        super().__init__()
        self.spec = spec

        def plist(vs):
            return nn.ParameterList(
                nn.Parameter(torch.as_tensor(np.asarray(v, np.float32))) for v in vs)

        self.weights = plist(params.weights)
        self.biases = plist(params.biases)

    def params(self) -> CollapsedParams:
        return CollapsedParams(list(self.weights), list(self.biases))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward_float(self.spec, self.params(), x, device=x.device)
