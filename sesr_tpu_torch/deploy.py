"""Certificate-gated choice of the deployment forward.

The same decision as sesr_tpu/ops/packed.py select_packed_forward:
"fast" when the artifact is fully certified, "hybrid" when saturation is
confined to stamped-unsafe layers, "pe-exact" (corrected) otherwise. The
port does not pack, so the TPU cell geometries (and the ``cert_cells``
gating of them) have no counterpart here.

Each mode has a kernel: "fast" runs ``sesr_fast_net`` (ops/fast.py),
"hybrid" and corrected "pe-exact" run ``sesr_corrected_net``
(ops/corrected.py). Each runs its plain version on a CPU tensor and raises
ValueError on any device other than cuda and cpu.
"""

from __future__ import annotations

from sesr_tpu_torch.ops.corrected import hybrid_forward, pe_exact_corrected_forward
from sesr_tpu_torch.ops.fast import fast_forward
from sesr_tpu_torch.quant.params import QuantParams


def select_forward(qp: QuantParams):
    """(mode, fn): the fastest certificate-sound deployment forward for
    this artifact. Every fn has the signature
    fn(spec, qp, x, out_dtype="f32", device=None, quantized=False)."""
    if qp.fast_cert_ok:
        return "fast", fast_forward
    layers = qp.fast_cert_layers
    if layers is not None and any(layers):
        return "hybrid", hybrid_forward
    return "pe-exact", pe_exact_corrected_forward
