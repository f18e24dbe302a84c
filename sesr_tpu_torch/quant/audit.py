"""Runtime audit for out-of-distribution saturation on served frames.

The same audit as the JAX package's ``sesr_tpu/quant/audit.py``.
Certificate stamps are static (proven for every input) or empirical
(evidenced on the calibration set only). A frame that fires an 18-bit
accumulator event on an empirically stamped layer is outside what the
stamps cover, and the fast and hybrid forwards cannot notice: they skip
the per-PE stage on that layer. ``audit_frame`` runs the PE-exact datapath
with its overflow counters on the frame and flags such events; ``infer
--audit N`` (``cli.py`` ``serve``) audits every Nth dispatch and, on a
violation, serves the rest of the stream through the corrected PE-exact
forward, which is sound for every input.

On a CUDA tensor the shadow run is one launch of the corrected kernel's
counting form (``ops/corrected.py`` ``audit_forward``), for a sharded
frame over the rank's window with the rank's block as its count region;
on a CPU tensor it is the plain interpreter, ``integer_forward(corrected=
True, collect_dumps=True)``, the form the certification's empirical
obligations run.
"""

from __future__ import annotations

import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.deploy import select_forward
from sesr_tpu_torch.ops.corrected import audit_forward
from sesr_tpu_torch.ops.slab import crop_block, rank_window
from sesr_tpu_torch.quant.integer import (as_input, dequantize_output, integer_forward,
                                          resolve_device)
from sesr_tpu_torch.quant.params import QuantParams


class OODSaturationWarning(UserWarning):
    """An empirically stamped layer saturated on a served frame: the fast
    forward's exactness does not cover this input."""


class AuditResult(NamedTuple):
    ok: bool
    violations: Tuple[int, ...]     # empirically trusted layers that fired
    ovf18: np.ndarray               # per-layer 18-bit event counts
    diverged: Optional[bool]        # served != exact (None: not compared)
    y_exact: torch.Tensor           # the sound output (float32, dequantized)


def empirically_trusted_layers(qp: QuantParams, mode: str) -> Tuple[int, ...]:
    """The layers that serving ``mode`` runs as one full-channel conv on
    empirical evidence only: for "fast" and "hybrid" the "F" stamps (hybrid
    runs its "x" layers per PE, which is sound for every input); for
    "pe-exact" none."""
    if mode == "pe-exact" or qp.fast_cert_layers is None:
        return ()
    static = qp.fast_cert_static or (False,) * qp.num_convs
    return tuple(i for i in range(qp.num_convs)
                 if qp.fast_cert_layers[i] and not static[i])


def sharded_audit_forward(spec: SESRSpec, qp: QuantParams, x, halo_group) -> tuple:
    """``audit_forward`` of this rank's block x of a sharded frame on the
    card: (the block's f32 output, its counts). One launch over the rank's
    window (``ops/slab.py`` ``rank_window``, the sharded deployment
    forward's), the count region the block, which lies at least R =
    ``spec.halo_width()`` from every window edge that is not an image edge,
    so its partials are the monolithic frame's. ``halo_group`` as
    ``integer_forward`` takes it: a W group, or an (h_group, w_group)
    pair."""
    h_group, w_group = halo_group if isinstance(halo_group, tuple) else (None, halo_group)
    x_q, keep_h, keep_w = rank_window(spec, qp, x, h_group, w_group)
    (ha, lh), (wa, lw) = keep_h, keep_w
    y, counts = audit_forward(spec, qp, x_q, region=(ha, ha + lh, wa, wa + lw),
                              out_dtype="int8", quantized=True)
    return dequantize_output(crop_block(y, spec, keep_h, keep_w), qp), counts


def audit_frame(spec: SESRSpec, qp: QuantParams, x, y_served=None,
                mode: Optional[str] = None, warn: bool = True,
                device=None, halo_group=None) -> AuditResult:
    """Audit one frame (or batch) against the PE-exact datapath with its
    18-bit event counters, on ``device`` (default: x's device, else
    ``cuda``): on the card one launch of the corrected kernel's counting
    form (``audit_forward``), on the CPU the plain interpreter
    (``integer_forward(corrected=True, collect_dumps=True)``, the form the
    certification's empirical obligations run). Flags 18-bit events on the
    ``empirically_trusted_layers(qp, mode)`` and, when ``y_served`` (the
    float32 dequantized output) is given, a served output that differs.
    ``mode`` defaults to the certificate-selected serving mode. Warns
    (OODSaturationWarning) on failure when ``warn``. ``halo_group``: x is
    this rank's block of a sharded frame (on the CPU ``integer_forward``'s
    hook, on the card ``sharded_audit_forward``); the counts and the result
    are then this rank's."""
    if mode is None:
        mode, _ = select_forward(qp)
    trusted = empirically_trusted_layers(qp, mode)
    on_card = resolve_device(x, device).type == "cuda"
    with torch.inference_mode():
        if on_card and halo_group is not None:
            y_exact, counts = sharded_audit_forward(spec, qp, as_input(x, device), halo_group)
        elif on_card or halo_group is None:
            y_exact, counts = audit_forward(spec, qp, x, device=device)
        else:
            y_exact, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True,
                                             device=device, halo_group=halo_group)
            counts = dumps["overflow_18"]
    ovf18 = counts.cpu().numpy()
    violations = tuple(i for i in trusted if ovf18[i] != 0)
    diverged = None
    if y_served is not None:
        served = torch.as_tensor(y_served, dtype=torch.float32, device=y_exact.device)
        diverged = not torch.equal(served, y_exact)
    ok = not violations and not diverged
    if not ok and warn:
        warnings.warn(
            f"OOD saturation audit failed ({mode} serving): {len(violations)} "
            f"empirically stamped layer(s) {list(violations)} fired 18-bit events "
            f"(counts {ovf18.tolist()})"
            + (", served output diverges from the PE-exact path" if diverged else "")
            + ": this frame is outside the calibration distribution the empirical "
              "stamps cover; degrade to the PE-exact forward",
            OODSaturationWarning, stacklevel=2)
    return AuditResult(ok, violations, ovf18, diverged, y_exact)
