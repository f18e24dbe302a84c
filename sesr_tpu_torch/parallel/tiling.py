"""Spatial tiling over a mesh of ``torch.distributed`` ranks.

Port of sesr_tpu/parallel/tiling.py on ``torch.distributed`` and
``DeviceMesh``: frames are split over the mesh's "dp" dimension, W over
"sp" (or H over "sph" and W over "spw"). JAX's shard_map takes the global
array and returns one; here each rank holds its block: ``local_block``
cuts a rank's block out of a global array, and ``gather_blocks`` (an
all-gather) builds the global one back.

Two kinds of forward:

- the plain interpreters (``sharded_integer_forward``,
  ``sharded_float_forward``, ``sharded_calibrate``) exchange each conv's
  k // 2 halo before every conv (``ops/halo.py``); the ranks at the image
  edge receive zeros, the monolithic SAME padding, so the integer result
  is the monolithic one value for value;
- the deployment forwards run the fused kernels, which hold the whole
  network in one launch, so there is no per-layer exchange: each rank
  quantizes its block, exchanges R = ``spec.halo_width()`` columns (and
  rows) of the int8 input once, drops what an edge rank received from
  beyond the image, runs one launch on that window and keeps its block
  (``ops/slab.py`` proves the window exact). The JAX package exchanges a
  packed halo before every layer (sesr_tpu/ops/packed.py); the outputs
  are the same. ``virtual_rank_forward`` runs every rank's window in turn
  on one device, the launches a deployment of that many cards makes, one a
  card.

Mesh dimensions carry the JAX package's names: ("dp", "sp") and ("dp",
"sph", "spw"). A mesh spans the whole world of ranks.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from sesr_tpu_torch.config import DEFAULT_HW, SESRSpec
from sesr_tpu_torch.deploy import select_forward
from sesr_tpu_torch.models.sesr import CollapsedParams, forward_float
from sesr_tpu_torch.ops.conv import float_exact
from sesr_tpu_torch.ops.fast import fast_forward
from sesr_tpu_torch.ops.corrected import hybrid_forward
from sesr_tpu_torch.ops.halo import check_backend
from sesr_tpu_torch.ops.slab import (blocks, output_contract, rank_window, run_window,
                                     windowed_forward)
from sesr_tpu_torch.quant.calibrate import _calibration_forward_impl, _np, _prep_fq_weights, \
    observe_domains
from sesr_tpu_torch.quant.integer import as_input, integer_forward, quantize_input
from sesr_tpu_torch.quant.params import QuantParams, finalize
from sesr_tpu_torch.quant.qat import make_train_step

# how a global (N, H, W, C) array lies on a mesh: per dim, the mesh
# dimension(s) that split it (row-major over a tuple), or None
DP_SP = ("dp", None, "sp", None)
DP_SPH_SPW = ("dp", "sph", "spw", None)


def _mesh(shape, names, device_type: str) -> DeviceMesh:
    world = dist.get_world_size()
    if int(np.prod(shape)) != world:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {int(np.prod(shape))} "
                         f"ranks, the world has {world}")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_mesh(dp: int = 1, sp=None, device_type: str = "cuda") -> DeviceMesh:
    """A (dp, sp) mesh over the world's ranks (sp default: world // dp)."""
    if sp is None:
        sp = dist.get_world_size() // dp
    return _mesh((dp, sp), ("dp", "sp"), device_type)


def make_mesh_2d(dp: int = 1, sp_h: int = 2, sp_w: int = 2,
                 device_type: str = "cuda") -> DeviceMesh:
    """A (dp, sph, spw) mesh: frames x a 2D spatial grid of ranks."""
    return _mesh((dp, sp_h, sp_w), ("dp", "sph", "spw"), device_type)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's blocks lie on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _names(axes) -> tuple:
    return axes if isinstance(axes, tuple) else (axes,)


def _block_index(mesh: DeviceMesh, axes, coords) -> tuple:
    """(index, count) of the block that ``coords`` (a rank's mesh
    coordinates) hold along mesh dimensions ``axes``, row-major."""
    idx, count = 0, 1
    for name in _names(axes):
        d = mesh.mesh_dim_names.index(name)
        idx, count = idx * mesh.size(d) + coords[d], count * mesh.size(d)
    return idx, count


def _coords(mesh: DeviceMesh, rank: int) -> list:
    return [int(c) for c in (mesh.mesh == rank).nonzero()[0]]


def local_block(x, mesh: DeviceMesh, layout):
    """This rank's block of the global array ``x`` (numpy or tensor) laid
    out by ``layout`` (e.g. ``DP_SP``): each dim split into equal blocks
    over the mesh dimensions that name it."""
    coords = _coords(mesh, dist.get_rank())
    for d, axes in enumerate(layout):
        if axes is None:
            continue
        idx, count = _block_index(mesh, axes, coords)
        if x.shape[d] % count:
            raise ValueError(f"dim {d} of {tuple(x.shape)} does not split into {count} "
                             f"equal blocks over {axes}")
        size = x.shape[d] // count
        x = x[(slice(None),) * d + (slice(idx * size, (idx + 1) * size),)]
    return x


def gather_blocks(y: torch.Tensor, mesh: DeviceMesh, layout) -> torch.Tensor:
    """The global array whose blocks the ranks hold (``y``: this rank's, all
    of one shape), on every rank: one all-gather over the world."""
    check_backend(y, dist.group.WORLD)
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, y.contiguous())
    counts = [1 if axes is None else _block_index(mesh, axes, [0] * mesh.ndim)[1]
              for axes in layout]
    out = y.new_empty([s * c for s, c in zip(y.shape, counts)])
    for rank, part in enumerate(parts):
        coords = _coords(mesh, rank)
        where = []
        for axes, s in zip(layout, y.shape):
            i = 0 if axes is None else _block_index(mesh, axes, coords)[0]
            where.append(slice(i * s, (i + 1) * s))
        out[tuple(where)] = part
    return out


# ---------------------------------------------------------------------------
# the plain interpreters, with a per-layer halo exchange


def sharded_integer_forward(spec: SESRSpec, qp: QuantParams, mesh: DeviceMesh, **fwd_kwargs):
    """f(x) -> y: the bit-exact integer forward (``integer_forward``, with
    ``fwd_kwargs``) on this rank's (dp, sp) block, exchanging every conv's
    halo along "sp"."""
    group = mesh.get_group("sp")
    return lambda x: integer_forward(spec, qp, x, halo_group=group, **fwd_kwargs)[0]


def sharded_integer_forward_2d(spec: SESRSpec, qp: QuantParams, mesh: DeviceMesh,
                               **fwd_kwargs):
    """The integer forward on this rank's (dp, sph, spw) block, every conv's
    halo exchanged along H, then W (corners in two hops)."""
    groups = (mesh.get_group("sph"), mesh.get_group("spw"))
    return lambda x: integer_forward(spec, qp, x, halo_group=groups, **fwd_kwargs)[0]


def sharded_float_forward(spec: SESRSpec, params: CollapsedParams, mesh: DeviceMesh):
    """The float32 forward on this rank's (dp, sp) block."""
    group = mesh.get_group("sp")
    return lambda x: forward_float(spec, params, x, halo_group=group)


def sharded_float_forward_2d(spec: SESRSpec, params: CollapsedParams, mesh: DeviceMesh):
    """The float32 forward on this rank's (dp, sph, spw) block."""
    groups = (mesh.get_group("sph"), mesh.get_group("spw"))
    return lambda x: forward_float(spec, params, x, halo_group=groups)


def sharded_calibrate(spec: SESRSpec, params: CollapsedParams, images, mesh: DeviceMesh,
                      hw=None, **finalize_kwargs) -> QuantParams:
    """Min/max calibration with the fake-quant forward sharded (dp, sp):
    every rank passes the same global ``images`` and runs its block of
    each; every min and max reduces over the whole mesh, so each rank
    returns the QuantParams of single-device calibration (up to float32
    summation order in the convs)."""
    hw = hw or DEFAULT_HW
    dev = mesh_device(mesh)
    halo_group = mesh.get_group("sp")
    with torch.inference_mode(), float_exact():
        fq_weights, w_int, w_scale = _prep_fq_weights(params, hw, dev)

        def fwd(img, hist_bounds=None):
            x = as_input(local_block(img, mesh, DP_SP), dev)
            return _calibration_forward_impl(spec, fq_weights, x, hw, True, hist_bounds,
                                             reduce_group=dist.group.WORLD,
                                             halo_group=halo_group)

        calib, _ = observe_domains(fwd, images, spec.num_convs + 1, dev, histograms=False)
    return finalize(spec, w_int, w_scale, [_np(b) for b in params.biases], calib, hw,
                    **finalize_kwargs)


def sharded_train_step(spec: SESRSpec, cfg, params, optimizer, mesh: DeviceMesh):
    """``quant/qat.py`` ``make_train_step`` on this rank's block of each
    batch (frames over the mesh's outer dimensions, W over "sp"): the same
    step on every rank, the unsharded step's up to float32 summation
    order. ``cfg`` None trains the float network."""
    return make_train_step(spec, cfg, params, optimizer, halo_group=mesh.get_group("sp"),
                           reduce_group=dist.group.WORLD)


# ---------------------------------------------------------------------------
# the deployment forwards: one window a rank, one launch a window


def window_forward(spec: SESRSpec, qp: QuantParams, x, fwd, out_dtype: str = "f32",
                   h_group=None, w_group=None) -> torch.Tensor:
    """This rank's block of the deployment forward ``fwd``: quantize the
    block, exchange R = ``spec.halo_width()`` rows along ``h_group`` and
    columns along ``w_group`` (the int8 input, once; each rank's block at
    least R wide), drop what an edge rank received from beyond the image,
    run ``fwd`` once on the window, keep the block and dequantize it
    (``out_dtype`` "f32") or not ("int8"). The window is ``ops/slab.py``
    ``rank_window``'s."""
    x_q, keep_h, keep_w = rank_window(spec, qp, x, h_group, w_group)
    return output_contract(run_window(fwd, spec, qp, x_q, keep_h, keep_w), qp, out_dtype)


def virtual_rank_forward(spec: SESRSpec, qp: QuantParams, x, grid=(1, 4), fwd=None,
                         out_dtype: str = "f32", device=None) -> torch.Tensor:
    """The deployment forward of the whole frame as a (sph, sp) ``grid`` of
    ranks would compute it, every rank's window in turn on one device: one
    launch a window, the same windows as ``window_forward`` (blocks may
    differ in size by one). ``fwd`` defaults to the certificate's choice."""
    if fwd is None:
        fwd = select_forward(qp)[1]
    x_q = quantize_input(as_input(x, device), qp).to(torch.int8)
    H, W = x_q.shape[1:3]
    return windowed_forward(spec, qp, x_q, blocks(H, grid[0]), blocks(W, grid[1]), fwd,
                            out_dtype)


def _deployment_fn(spec, qp, fwd, out_dtype, h_group=None, w_group=None):
    return lambda x: window_forward(spec, qp, x, fwd, out_dtype, h_group, w_group)


def sharded_deployment_forward(spec: SESRSpec, qp: QuantParams, mesh: DeviceMesh,
                               out_dtype: str = "f32"):
    """f(x) -> y on this rank's (dp, sp) block: the deployment forward the
    artifact's certificate selects (fast, hybrid or pe-exact), one window
    a rank. ``out_dtype``: "f32" or "int8" (the raw quantized image)."""
    return _deployment_fn(spec, qp, select_forward(qp)[1], out_dtype,
                          w_group=mesh.get_group("sp"))


def sharded_deployment_forward_2d(spec: SESRSpec, qp: QuantParams, mesh: DeviceMesh,
                                  out_dtype: str = "f32"):
    """The certificate-selected deployment forward on this rank's (dp, sph,
    spw) block: R rows and R columns exchanged (corners in two hops)."""
    return _deployment_fn(spec, qp, select_forward(qp)[1], out_dtype,
                          mesh.get_group("sph"), mesh.get_group("spw"))


def sharded_packed_forward(spec: SESRSpec, qp: QuantParams, mesh: DeviceMesh,
                           out_dtype: str = "f32"):
    """``sharded_deployment_forward`` pinned to the fast datapath (K2);
    refuses an artifact without the fast certificate."""
    if not qp.fast_cert_ok:
        raise ValueError("sharded_packed_forward lowers the certified fast datapath and "
                         "requires a certified QuantParams (fast_cert_ok)")
    return _deployment_fn(spec, qp, fast_forward, out_dtype, w_group=mesh.get_group("sp"))


def sharded_hybrid_forward(spec: SESRSpec, qp: QuantParams, mesh: DeviceMesh,
                           out_dtype: str = "f32"):
    """``sharded_deployment_forward`` pinned to the layer-hybrid datapath
    (the corrected kernel; requires per-layer stamps)."""
    return _deployment_fn(spec, qp, hybrid_forward, out_dtype, w_group=mesh.get_group("sp"))
