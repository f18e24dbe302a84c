"""The corrected PE-exact and layer-hybrid deployment forwards: one kernel.

Port of sesr_tpu/ops/packed.py ``packed_exact_forward(corrected=True)`` and
``packed_hybrid_forward`` (both ``_packed_exact_impl``, XLA with no Pallas
kernel): the computation, not its space-to-depth layout. On a CUDA tensor
both run the fused kernel ``sesr_corrected_net`` (csrc/sesr_corrected.cu,
on wgmma) over the whole batch, each PE's partial clamped on its own on the
layers ``split_layers`` flags, for networks of hidden width 16 (the
shipped tasks, SESR-M11) or 32 (SESR-XL) at any PE count from 1 to 16; on
a CPU tensor their plain version, ``integer_forward(corrected=True)``
(with ``fast_layers`` in the hybrid mode).

``audit_forward`` is the PE-exact mode with its 18-bit event counters, the
runtime audit's shadow run (``quant/audit.py``): one launch of the
kernel's counting form on a CUDA tensor, ``integer_forward(corrected=True,
collect_dumps=True)`` on a CPU tensor.
"""

from __future__ import annotations

import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.convert import corrected_split_layers
from sesr_tpu_torch.ops.conv import pixel_shuffle_nhwc
from sesr_tpu_torch.ops.kernels import OUT_DTYPES, corrected_net, output_of, run_net
from sesr_tpu_torch.quant.integer import (as_input, integer_forward, integer_forward_int8,
                                          quantize_input, resolve_device)
from sesr_tpu_torch.quant.params import QuantParams

MODES = ("hybrid", "pe-exact")


def _stamps(qp: QuantParams) -> tuple:
    if qp.fast_cert_layers is None:
        raise ValueError(
            "the hybrid mode requires per-layer certification stamps "
            "(fast_cert_layers): a layer runs as one full-channel conv only "
            "where its stamp proves the 18-bit clamp idle")
    return tuple(bool(s) for s in qp.fast_cert_layers)


def split_layers(qp: QuantParams, mode: str) -> tuple:
    """Per layer: whether the kernel runs it one pass per PE, each PE's
    partial clamped to 18 bits. "hybrid": the layers without a certificate
    stamp (the others run as one conv, as the JAX hybrid lowering runs
    them). "pe-exact": the layers where ``corrected_split_layers`` cannot
    rule that clamp out; on the others one pass gives the same sums."""
    if mode == "hybrid":
        return tuple(not s for s in _stamps(qp))
    if mode == "pe-exact":
        return corrected_split_layers(qp)
    raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def corrected_forward(spec: SESRSpec, qp: QuantParams, x, mode: str,
                      out_dtype: str = "f32", device=None,
                      quantized: bool = False) -> torch.Tensor:
    """The corrected datapath in ``mode``. x: NHWC float in [0, 1] (numpy or
    tensor), on ``device`` (default: x's device, else ``cuda``); with
    ``quantized`` the int8 input image instead.
    ``out_dtype``: "f32" (the dequantized image) or "int8" (the raw
    quantized image; dequantize with (a_zero[L], a_scale[L]))."""
    split = split_layers(qp, mode)
    x = _input(x, out_dtype, device, quantized)
    if x.device.type == "cpu":
        fast_layers = _stamps(qp) if mode == "hybrid" else None
        if out_dtype == "int8":
            return integer_forward_int8(spec, qp, x, corrected=True, compute="exact",
                                        fast_layers=fast_layers, quantized=quantized)
        return integer_forward(spec, qp, x, corrected=True, fast_layers=fast_layers,
                               quantized=quantized)[0]
    if x.device.type != "cuda":
        raise ValueError(f"corrected_forward runs on cuda or cpu, got {x.device}")
    return run_net(corrected_net, spec, qp, x, out_dtype, split=split, quantized=quantized)


def _input(x, out_dtype: str, device, quantized: bool) -> torch.Tensor:
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype!r}")
    if quantized:
        return torch.as_tensor(x, device=resolve_device(x, device))
    return as_input(x, device)


def audit_forward(spec: SESRSpec, qp: QuantParams, x, region=None, out_dtype: str = "f32",
                  device=None, quantized: bool = False) -> tuple:
    """The corrected PE-exact forward with its 18-bit event counters: (y,
    counts), y as ``pe_exact_corrected_forward`` gives it and counts an
    int64 (L,) tensor on y's device, counts[i] the PE partials that the
    18-bit clamp changed on layer i (the plain version's ``overflow_18``).
    On a CUDA tensor one launch of the corrected kernel's counting form
    (``corrected_net.audit``), which counts the layers the PE-exact mode
    splits and gives 0 on the others, where the clamp cannot fire
    (``convert.corrected_split_layers``); with ``region`` = (y0, y1, x0, x1)
    in input pixels it counts only the outputs inside it. On a CPU tensor
    ``integer_forward(corrected=True, collect_dumps=True)``, over the whole
    frame (a region raises ValueError). A kernel that refuses the network
    raises: there is no fallback."""
    split = split_layers(qp, "pe-exact")
    x = _input(x, out_dtype, device, quantized)
    if x.device.type == "cpu":
        if region is not None:
            raise ValueError("audit_forward counts a region on a CUDA tensor only")
        y, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True,
                                   quantized=quantized)
        if out_dtype == "int8":
            y = dumps[f"input.{spec.num_convs}"].to(torch.int8)
            if spec.has_pixel_shuffle:
                y = pixel_shuffle_nhwc(y, spec.scaling_factor)
        return y, dumps["overflow_18"]
    if x.device.type != "cuda":
        raise ValueError(f"audit_forward runs on cuda or cpu, got {x.device}")
    x_q = x if quantized else quantize_input(x, qp).to(torch.int8)
    y, counts = corrected_net.audit(spec, qp, x_q.contiguous(), split, region)
    return output_of(y, spec, qp, out_dtype), counts


def hybrid_forward(spec: SESRSpec, qp: QuantParams, x, out_dtype: str = "f32",
                   device=None, quantized: bool = False) -> torch.Tensor:
    """The layer-hybrid deployment forward (JAX ``packed_hybrid_forward``)."""
    return corrected_forward(spec, qp, x, "hybrid", out_dtype, device, quantized)


def pe_exact_corrected_forward(spec: SESRSpec, qp: QuantParams, x,
                               out_dtype: str = "f32", device=None,
                               quantized: bool = False) -> torch.Tensor:
    """The corrected PE-exact deployment forward (JAX
    ``packed_exact_forward(corrected=True)``)."""
    return corrected_forward(spec, qp, x, "pe-exact", out_dtype, device, quantized)
