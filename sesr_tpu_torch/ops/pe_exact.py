"""The reference-exact whole-network forward (the ASIC simulation): K1.

Port of sesr_tpu/ops/pallas_pipeline.py build_pallas_forward. On a CUDA
tensor it runs the fused kernel ``sesr_pe_exact_net`` (csrc/sesr_net.cu);
on a CPU tensor its plain version, ``integer_forward(corrected=False)``.
"""

from __future__ import annotations

import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.ops.kernels import pe_exact_net, run_net
from sesr_tpu_torch.quant.integer import as_input, integer_forward
from sesr_tpu_torch.quant.params import QuantParams


def pe_exact_forward(spec: SESRSpec, qp: QuantParams, x,
                     device=None) -> torch.Tensor:
    """Bit-exact reference integer forward. x: NHWC float in [0, 1] (numpy
    or tensor), on ``device`` (default: x's device, else ``cuda``).
    Returns the dequantized float32 output, pixel-shuffled."""
    x = as_input(x, device)
    if x.device.type == "cpu":
        return integer_forward(spec, qp, x)[0]
    if x.device.type != "cuda":
        raise ValueError(f"pe_exact_forward runs on cuda or cpu, got {x.device}")
    return run_net(pe_exact_net, spec, qp, x)
