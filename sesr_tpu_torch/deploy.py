"""Certificate-gated choice of the deployment forward.

The same decision as sesr_tpu/ops/packed.py select_packed_forward:
"fast" when the artifact is fully certified, "hybrid" when saturation is
confined to stamped-unsafe layers, "pe-exact" (corrected) otherwise. The
port does not pack, so the TPU cell geometries (and the ``cert_cells``
gating of them) have no counterpart here.

Only "fast" has a kernel so far. "hybrid" and corrected "pe-exact" are
both array-equal to the corrected PE-exact datapath: they run its plain
version on a CPU tensor and raise NotImplementedError on any other
device.
"""

from __future__ import annotations

import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.ops.fast import fast_forward
from sesr_tpu_torch.ops.kernels import OUT_DTYPES
from sesr_tpu_torch.quant.integer import (as_input, integer_forward,
                                          integer_forward_int8)
from sesr_tpu_torch.quant.params import QuantParams

ROADMAP_ITEM = ("ROADMAP.md queue 1, item 2: corrected PE-exact and "
                "layer-hybrid deployment modes on the card")


def corrected_pe_exact_forward(spec: SESRSpec, qp: QuantParams, x,
                               out_dtype: str = "f32", device=None) -> torch.Tensor:
    """The corrected PE-exact datapath, the forward of the "hybrid" and
    "pe-exact" modes: its plain version, CPU tensors only."""
    if out_dtype not in OUT_DTYPES:
        raise ValueError(f"out_dtype must be one of {OUT_DTYPES}, got {out_dtype!r}")
    x = as_input(x, device)
    if x.device.type != "cpu":
        raise NotImplementedError(
            f"the hybrid and corrected PE-exact modes have no kernel yet ({ROADMAP_ITEM})")
    if out_dtype == "int8":
        return integer_forward_int8(spec, qp, x, corrected=True, compute="exact")
    return integer_forward(spec, qp, x, corrected=True)[0]


def select_forward(qp: QuantParams):
    """(mode, fn): the fastest certificate-sound deployment forward for
    this artifact. Every fn has the signature
    fn(spec, qp, x, out_dtype="f32", device=None)."""
    if qp.fast_cert_ok:
        return "fast", fast_forward
    layers = qp.fast_cert_layers
    if layers is not None and any(layers):
        return "hybrid", corrected_pe_exact_forward
    return "pe-exact", corrected_pe_exact_forward
