"""The certified-fast deployment forward: K2.

Port of sesr_tpu/ops/pallas_packed.py build_pallas_packed_forward: the
computation, not its space-to-depth layout. On a CUDA tensor it runs the
fused kernel ``sesr_fast_net`` (csrc/sesr_net.cu) over the whole batch;
on a CPU tensor its plain version,
``integer_forward(corrected=True, compute="fast")``.
"""

from __future__ import annotations

import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.ops.kernels import OUT_DTYPES, fast_net, run_net
from sesr_tpu_torch.quant.integer import (as_input, integer_forward,
                                          integer_forward_int8, resolve_device)
from sesr_tpu_torch.quant.params import QuantParams


def fast_forward(spec: SESRSpec, qp: QuantParams, x, out_dtype: str = "f32",
                 device=None, quantized: bool = False) -> torch.Tensor:
    """Certified fast deployment forward. x: NHWC float in [0, 1] (numpy or
    tensor), on ``device`` (default: x's device, else ``cuda``); with
    ``quantized`` the int8 input image instead (the windows of
    ``ops/slab.py`` quantize the frame once).

    ``out_dtype``: "f32" (the dequantized image, the scoring contract) or
    "int8" (the raw quantized image; dequantize with (a_zero[L],
    a_scale[L])). Refuses an artifact without the fast certificate.
    """
    if not qp.fast_cert_ok:
        raise ValueError(
            "fast_forward lowers the certified fast datapath and requires a "
            "certified QuantParams (fast_cert_ok)")
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype!r}")
    x = torch.as_tensor(x, device=resolve_device(x, device)) if quantized else \
        as_input(x, device)
    if x.device.type == "cpu":
        if out_dtype == "int8":
            return integer_forward_int8(spec, qp, x, corrected=True, compute="fast",
                                        quantized=quantized)
        return integer_forward(spec, qp, x, corrected=True, compute="fast",
                               quantized=quantized)[0]
    if x.device.type != "cuda":
        raise ValueError(f"fast_forward runs on cuda or cpu, got {x.device}")
    return run_net(fast_net, spec, qp, x, out_dtype, quantized=quantized)
