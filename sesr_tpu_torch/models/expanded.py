"""The uncollapsed (train-time) SESR network: expand -> squeeze blocks.

The same network as the JAX package's ``sesr_tpu/models/expanded.py``.
Training and QAT run on this over-parameterized form; the collapse into
the inference network (``models/blocks.py``, ``io/torch_import.py``)
happens only for quantization and serving. Weights are HWIO, activations
NHWC, as in ``models/sesr.py``.

Each block is a k x k expand conv (IC -> T, no bias) followed by a 1 x 1
squeeze conv (T -> OC, with bias); the middle blocks add their input
back. ``forward_expanded`` is a function of (spec, params, x);
``ExpandedSESR`` is the same forward as an ``nn.Module`` that holds the
blocks as parameters.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple

import numpy as np
import torch
from torch import nn

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.io.torch_import import block_names, qat_collapse_block
from sesr_tpu_torch.models.blocks import (collapse_block, fold_residual_identity,
                                          hwio_to_oihw, oihw_to_hwio)
from sesr_tpu_torch.models.sesr import CollapsedParams
from sesr_tpu_torch.ops.conv import conv2d_nhwc, float_exact, pixel_shuffle_nhwc
from sesr_tpu_torch.ops.halo import exchange_for_conv
from sesr_tpu_torch.quant.integer import as_input


class ExpandedBlock(NamedTuple):
    w_expand: torch.Tensor    # HWIO (k, k, IC, T)
    w_squeeze: torch.Tensor   # HWIO (1, 1, T, OC)
    b_squeeze: torch.Tensor   # (OC,)


class ExpandedParams(NamedTuple):
    blocks: List[ExpandedBlock]


def block_channels(spec: SESRSpec) -> List[int]:
    """The channel count between the blocks: input, the middle width, the
    last conv's output (before the pixel shuffle)."""
    return ([spec.in_channels] + [spec.num_channels] * (spec.num_convs - 1)
            + [spec.conv_out_channels])


def init_expanded(spec: SESRSpec, generator: torch.Generator,
                  dtype=torch.float32) -> ExpandedParams:
    """Random expanded parameters, drawn on the CPU from ``generator``:
    N(0, 1/fan_in) expand and squeeze weights, zero squeeze biases."""
    chans = block_channels(spec)
    t = spec.tmp_channels
    blocks = []
    for i, k in enumerate(spec.kernel_sizes):
        w_e = torch.randn((k, k, chans[i], t), generator=generator,
                          dtype=dtype) / np.sqrt(k * k * chans[i])
        w_s = torch.randn((1, 1, t, chans[i + 1]), generator=generator,
                          dtype=dtype) / np.sqrt(t)
        blocks.append(ExpandedBlock(w_e, w_s, torch.zeros((chans[i + 1],), dtype=dtype)))
    return ExpandedParams(blocks)


def expanded_from_arrays(blocks: Iterable) -> ExpandedParams:
    """ExpandedParams (float32 CPU tensors) from (w_expand, w_squeeze,
    b_squeeze) arrays per block, HWIO: numpy arrays, or the leaves of the
    JAX package's ``ExpandedParams``."""
    return ExpandedParams([ExpandedBlock(*(torch.tensor(np.asarray(a, np.float32))
                                           for a in blk)) for blk in blocks])


def expanded_from_state_dict(spec: SESRSpec, state) -> ExpandedParams:
    """ExpandedParams from a reference state dict (numpy, OIHW) with the
    uncollapsed ``conv_expand`` / ``conv_squeeze`` keys. A missing key
    raises KeyError."""
    return expanded_from_arrays(
        (oihw_to_hwio(state[f"{name}.conv_expand.weight"]),
         oihw_to_hwio(state[f"{name}.conv_squeeze.weight"]),
         state[f"{name}.conv_squeeze.bias"]) for name in block_names(spec))


def expanded_graph(spec: SESRSpec, x: torch.Tensor, block, outer_add) -> torch.Tensor:
    """The network's wiring around ``block(h, i)`` (block i's expand ->
    squeeze) and ``outer_add(h, c0)`` (the outer residual add): relu
    after every block but the last, the middle blocks' own residual add,
    the pixel shuffle. The float and the fake-quant forwards share it."""
    L = spec.num_convs
    h = torch.relu(block(x, 0))
    c0 = h
    for i in range(1, L - 1):
        h = torch.relu(block(h, i) + h)
    y = block(outer_add(h, c0), L - 1)
    if spec.has_pixel_shuffle:
        y = pixel_shuffle_nhwc(y, spec.scaling_factor)
    return y


def forward_expanded(spec: SESRSpec, params: ExpandedParams, x,
                     device=None, halo_group=None) -> torch.Tensor:
    """Float32 forward of the uncollapsed network. x: NHWC (numpy or
    tensor) on ``device`` (default: x's device, else ``cuda``). The convs
    run without TF32 (``float_exact``); the parameters keep their autograd
    graph. ``halo_group``: x is this rank's spatial block (as
    ``forward_float`` takes it); each k x k expand conv exchanges its halo,
    differentiably."""
    x = as_input(x, device)

    def block(h, i):
        b = params.blocks[i]
        w_e = b.w_expand.to(h.device)
        if halo_group is None:
            y = conv2d_nhwc(h, w_e)
        else:
            h, w_valid, h_valid = exchange_for_conv(h, w_e.shape[0], halo_group)
            y = conv2d_nhwc(h, w_e, w_valid=w_valid, h_valid=h_valid)
        return conv2d_nhwc(y, b.w_squeeze.to(h.device), b.b_squeeze.to(h.device))

    with float_exact():
        return expanded_graph(spec, x, block, torch.add)


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _collapse(spec: SESRSpec, params: ExpandedParams, collapse) -> CollapsedParams:
    weights, biases = [], []
    for i, blk in enumerate(params.blocks):
        w, b = collapse(hwio_to_oihw(_numpy(blk.w_expand)), hwio_to_oihw(_numpy(blk.w_squeeze)),
                        _numpy(blk.b_squeeze))
        if 0 < i < spec.num_convs - 1:
            w = fold_residual_identity(w)
        weights.append(np.ascontiguousarray(oihw_to_hwio(w)))
        biases.append(np.asarray(b))
    return CollapsedParams(weights, biases)


def collapse_expanded(spec: SESRSpec, params: ExpandedParams) -> CollapsedParams:
    """The analytic collapse of trained float weights (numpy)."""
    return _collapse(spec, params, collapse_block)


def collapse_expanded_qat(spec: SESRSpec, params: ExpandedParams) -> CollapsedParams:
    """The collapse of QAT-trained weights through the fake-quant delta
    response (``io/torch_import.py`` ``qat_collapse_block``), the
    composition the reference's qatf deployment uses: it reproduces the
    quantization noise the weights were trained under, where the analytic
    float contraction would not."""
    return _collapse(spec, params, qat_collapse_block)


class ExpandedSESR(nn.Module):
    """The uncollapsed network as a module: each block's expand and squeeze
    weights and squeeze bias are parameters, its forward
    ``forward_expanded``."""

    def __init__(self, spec: SESRSpec, params: ExpandedParams):
        super().__init__()
        self.spec = spec

        def plist(k):
            return nn.ParameterList(nn.Parameter(torch.as_tensor(blk[k], dtype=torch.float32)
                                                 .detach().clone())
                                    for blk in params.blocks)

        self.w_expand, self.w_squeeze, self.b_squeeze = plist(0), plist(1), plist(2)

    def params(self) -> ExpandedParams:
        return ExpandedParams([ExpandedBlock(*blk) for blk in
                               zip(self.w_expand, self.w_squeeze, self.b_squeeze)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return forward_expanded(self.spec, self.params(), x, device=x.device)
