"""Multi-host frame batching: frames over hosts and "dp", halos within a host.

Port of sesr_tpu/parallel/multihost.py on ``torch.distributed``. The mesh's
outermost dimension enumerates hosts, in the host-major rank order a
launcher gives (ranks [h * per_host, (h + 1) * per_host) on host h). Work is
laid out so that

- "host" and "dp" carry only data placement: each host feeds its own
  frames, and no inference collective crosses them;
- the halo exchanges (``ops/halo.py``) run only along "sp" (or "sph" and
  "spw"): ranks of one host.

So inference needs no communication between hosts; host scaling is frame
batching. ``make_mesh_multihost`` refuses a (dp, sp) that does not fit one
host's ranks. ``multihost_tail_forward`` serves a partial final batch over
hosts only, each frame's W split over the flattened (dp, sp) ranks of its
host, and ``stream_frames`` groups a frame stream into global batches, with
the tail forward and the runtime audit's degrade to pe-exact.
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.deploy import select_forward
from sesr_tpu_torch.ops.corrected import pe_exact_corrected_forward
from sesr_tpu_torch.parallel.tiling import (_deployment_fn, _mesh, local_block, mesh_device)
from sesr_tpu_torch.quant.audit import (OODSaturationWarning, audit_frame,
                                        empirically_trusted_layers)
from sesr_tpu_torch.quant.integer import as_input, integer_forward
from sesr_tpu_torch.quant.params import QuantParams

HOST_DP_SP = (("host", "dp"), None, "sp", None)
HOST_DP_SPH_SPW = (("host", "dp"), "sph", "spw", None)
TAIL = ("host", None, ("dp", "sp"), None)


def _hosts(n_hosts: Optional[int], need: Optional[int], what: str):
    """(hosts, ranks per host): ``n_hosts``, else the world over the
    launcher's LOCAL_WORLD_SIZE (one host without it). Refuses ``need``
    ranks of spatial work that would not fit one host."""
    world = dist.get_world_size()
    if n_hosts is None:
        n_hosts = world // int(os.environ.get("LOCAL_WORLD_SIZE", world))
    per_host = world // n_hosts
    if need is not None and need > per_host:
        raise ValueError(f"{what}={need} must fit within one host's {per_host} ranks so "
                         "halo exchanges never cross hosts (DCN)")
    return n_hosts, per_host


def make_mesh_multihost(n_hosts: Optional[int] = None, dp: int = 1, sp: Optional[int] = None,
                        device_type: str = "cuda") -> DeviceMesh:
    """A ("host", "dp", "sp") mesh, hosts outermost. ``n_hosts`` defaults to
    the world over LOCAL_WORLD_SIZE, ``sp`` to one host's ranks over dp."""
    n_hosts, per_host = _hosts(n_hosts, None if sp is None else dp * sp, "dp*sp")
    sp = per_host // dp if sp is None else sp
    return _mesh((n_hosts, dp, sp), ("host", "dp", "sp"), device_type)


def make_mesh_multihost_2d(n_hosts: Optional[int] = None, dp: int = 1, sp_h: int = 2,
                           sp_w: int = 2, device_type: str = "cuda") -> DeviceMesh:
    """A ("host", "dp", "sph", "spw") mesh: hosts outermost, the 2D spatial
    grid within a host."""
    n_hosts, _ = _hosts(n_hosts, dp * sp_h * sp_w, "dp*sp_h*sp_w")
    return _mesh((n_hosts, dp, sp_h, sp_w), ("host", "dp", "sph", "spw"), device_type)


def multihost_integer_forward(spec: SESRSpec, qp: QuantParams, mesh: DeviceMesh, **fwd_kwargs):
    """f(x) -> y: the bit-exact integer forward on this rank's block
    (frames over host x dp, W over sp), halos along "sp" only."""
    group = mesh.get_group("sp")
    return lambda x: integer_forward(spec, qp, x, halo_group=group, **fwd_kwargs)[0]


def _deployment(qp: QuantParams, force_mode: Optional[str]):
    """(mode, fwd): the certificate's choice, or the forced sound mode."""
    if force_mode is None:
        return select_forward(qp)
    if force_mode == "pe-exact":
        return "pe-exact", pe_exact_corrected_forward
    raise ValueError(f"force_mode={force_mode!r}: only the sound 'pe-exact' override is "
                     "allowed")


def multihost_packed_forward(spec: SESRSpec, qp: QuantParams, mesh: DeviceMesh,
                             out_dtype: str = "f32", force_mode: Optional[str] = None):
    """The deployment forward on this rank's block (frames over host x dp, W
    over sp; one window a rank): the mode the certificate selects, or with
    ``force_mode="pe-exact"`` the corrected PE-exact mode (the audit's
    degrade). Forcing a faster mode than the certificate grants is refused."""
    return _deployment_fn(spec, qp, _deployment(qp, force_mode)[1], out_dtype,
                          w_group=mesh.get_group("sp"))


def multihost_packed_forward_2d(spec: SESRSpec, qp: QuantParams, mesh: DeviceMesh,
                                out_dtype: str = "f32"):
    """The certificate-selected deployment forward on this rank's block of a
    ("host", "dp", "sph", "spw") mesh: frames over host x dp, H and W over
    the spatial grid within a host."""
    return _deployment_fn(spec, qp, select_forward(qp)[1], out_dtype,
                          mesh.get_group("sph"), mesh.get_group("spw"))


def _host_group(mesh: DeviceMesh):
    """This rank's group of the flattened (dp, sp) ranks of its host. Every
    rank must call this (it creates one group per host)."""
    per_host = [row.flatten().tolist() for row in mesh.mesh]
    group, _ = dist.new_subgroups_by_enumeration(per_host)
    return group


def multihost_tail_forward(spec: SESRSpec, qp: QuantParams, mesh: DeviceMesh,
                           lowering: str = "interpreter", **fwd_kwargs):
    """The forward for a partial final batch: frames over hosts only, each
    frame's W over the flattened (dp, sp) ranks of its host (layout
    ``TAIL``), so every rank still works and a tail of k frames costs
    ceil(k / hosts) frame times. ``lowering``: "interpreter" (the integer
    forward; ``fwd_kwargs`` are its keywords) or "deployment" (the
    deployment forward; ``fwd_kwargs`` may hold ``out_dtype`` and
    ``force_mode``, which the tail honours). Every rank must build it."""
    w_group = _host_group(mesh)
    if lowering == "deployment":
        fwd = _deployment(qp, fwd_kwargs.get("force_mode"))[1]
        return _deployment_fn(spec, qp, fwd, fwd_kwargs.get("out_dtype", "f32"),
                              w_group=w_group)
    return lambda x: integer_forward(spec, qp, x, halo_group=(None, w_group), **fwd_kwargs)[0]


class StreamBatch(NamedTuple):
    y: torch.Tensor      # this rank's block of the batch's output
    layout: tuple        # how the batch lies on the mesh (tiling.py gather_blocks)
    n: int               # the real frames: the first n of the gathered batch


def stream_frames(spec: SESRSpec, qp: QuantParams, mesh: DeviceMesh, frames,
                  lowering: str = "interpreter", frames_per_chip: int = 1,
                  audit_every: int = 0, audit_log: Optional[list] = None, **fwd_kwargs):
    """Group the frames ((1, H, W, C) arrays; every rank iterates the same
    stream) into global batches of host x dp x ``frames_per_chip`` frames
    and yield a ``StreamBatch`` for each: this rank's block of the output.

    ``lowering``: "interpreter" (the bit-exact integer forward, with
    ``fwd_kwargs`` such as ``corrected=True``) or "deployment" (the
    deployment forward, ``multihost_packed_forward``; ``fwd_kwargs`` may
    hold ``out_dtype`` and ``force_mode``).

    A partial final batch at ``frames_per_chip`` 1 runs through
    ``multihost_tail_forward`` (padding at most hosts - 1 frames, with
    zeros) when W splits into dp x sp blocks each at least the exchange's
    width (the network's R in deployment lowering, the largest k // 2
    otherwise) and the stream was not degraded; else it is padded to a
    full batch by repeating its last frame.

    ``audit_every`` = N (deployment lowering): every Nth batch also runs
    the PE-exact datapath with its counters on each rank's block
    (``quant/audit.py`` ``audit_frame``, sharded along "sp": on the card
    one launch of the corrected kernel's counting form over the rank's
    window, on the CPU the plain interpreter). When any
    rank's audit fails, every rank warns (OODSaturationWarning), serves
    the batch again and the rest of the stream through the pe-exact
    forward. ``audit_log``: (batch index, serving mode, this rank's
    AuditResult or None) is appended for every audited batch."""
    if frames_per_chip < 1:
        raise ValueError(f"frames_per_chip must be >= 1, got {frames_per_chip}")
    deployment = lowering == "deployment"
    forced = fwd_kwargs.get("force_mode")
    out_dtype = fwd_kwargs.get("out_dtype", "f32")
    if deployment:
        fwd = multihost_packed_forward(spec, qp, mesh, out_dtype, forced)
        serving_mode = forced or select_forward(qp)[0]
    else:
        fwd = multihost_integer_forward(spec, qp, mesh, **fwd_kwargs)
        serving_mode = lowering
    trusted = empirically_trusted_layers(qp, serving_mode) \
        if deployment and audit_every > 0 else ()
    dev = mesh_device(mesh)
    sp_group = mesh.get_group("sp")
    n_host, dp, sp = (mesh.size(d) for d in range(3))
    n = n_host * dp * frames_per_chip
    batch_idx = 0
    degraded = False

    def serve(x_np):
        nonlocal fwd, serving_mode, trusted, degraded
        x = as_input(local_block(x_np, mesh, HOST_DP_SP), dev)
        y = fwd(x)
        if trusted and batch_idx % audit_every == 0:
            res = audit_frame(spec, qp, x, y_served=y if out_dtype == "f32" else None,
                              mode=serving_mode, warn=False, halo_group=sp_group)
            failed = torch.tensor([0 if res.ok else 1], device=dev)
            dist.all_reduce(failed, op=dist.ReduceOp.MAX)
            if audit_log is not None:
                audit_log.append((batch_idx, serving_mode, res))
            if failed.item():
                warnings.warn(f"OOD saturation audit failed on batch {batch_idx} ({serving_mode} "
                              f"serving; this rank's layers {list(res.violations)}, counts "
                              f"{res.ovf18.tolist()}): degrading the stream to pe-exact",
                              OODSaturationWarning, stacklevel=3)
                fwd = multihost_packed_forward(spec, qp, mesh, out_dtype, "pe-exact")
                serving_mode, trusted, degraded = "pe-exact", (), True
                y = fwd(x)
        elif audit_log is not None and audit_every > 0 and deployment \
                and batch_idx % audit_every == 0:
            audit_log.append((batch_idx, serving_mode, None))
        return y

    buf = []
    for f in frames:
        buf.append(np.asarray(f, np.float32))
        if len(buf) == n:
            yield StreamBatch(serve(np.concatenate(buf)), HOST_DP_SP, n)
            batch_idx += 1
            buf = []
    if not buf:
        return
    k = len(buf)
    W = buf[0].shape[2]
    reach = spec.halo_width() if deployment else max(k_ // 2 for k_ in spec.kernel_sizes)
    if (dp > 1 and frames_per_chip == 1 and W % (dp * sp) == 0
            and W // (dp * sp) >= reach and not degraded):
        buf += [np.zeros_like(buf[-1])] * (-(-k // n_host) * n_host - k)
        tail_fwd = multihost_tail_forward(spec, qp, mesh, lowering, **fwd_kwargs)
        x = as_input(local_block(np.concatenate(buf), mesh, TAIL), dev)
        yield StreamBatch(tail_fwd(x), TAIL, k)
    else:
        buf += [buf[-1]] * (n - k)
        yield StreamBatch(fwd(as_input(local_block(np.concatenate(buf), mesh, HOST_DP_SP), dev)),
                          HOST_DP_SP, k)
