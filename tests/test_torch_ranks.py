"""Rank functions of the port's multi-process tests, and the check that
this module keeps to its import rule.

Each function runs on every rank of a world that ``sesr_tpu_torch.parallel.
launch.spawn`` starts (gloo, CPU tensors, one thread a rank). A rank is a
fresh interpreter that imports this module by name, so the module imports
only numpy, torch and sesr_tpu_torch: no rank ever imports JAX. The test
files hand the ranks numpy inputs and paths of saved artifacts, and hold
the results against the JAX package in the pytest process.

Every rank runs every check of its world; rank 0 returns the gathered
global outputs under their case names, and each rank returns what must be
equal on every rank.
"""

import os
import subprocess
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist

from sesr_tpu_torch.config import spec_for_task
from sesr_tpu_torch.models.expanded import ExpandedBlock, ExpandedParams
from sesr_tpu_torch.models.sesr import CollapsedParams
from sesr_tpu_torch.ops.conv import conv2d_nhwc
from sesr_tpu_torch.ops.halo import halo_exchange, halo_exchange_2d, halo_exchange_w
from sesr_tpu_torch.parallel import multihost as mh
from sesr_tpu_torch.parallel import tiling
from sesr_tpu_torch.quant.params import QuantParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the layouts of the sharding worlds: (dp, sp) and (dp, sph, spw)
LAYOUTS_1D = ((1, 4), (2, 2), (1, 2))
LAYOUTS_2D = ((1, 2, 2), (1, 4, 1), (1, 1, 4))


def _error(fn):
    """The message of the ValueError ``fn()`` raises, or None."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _run(mesh, layout, f, x):
    return tiling.gather_blocks(f(torch.as_tensor(tiling.local_block(x, mesh, layout))),
                                mesh, layout)


# ---------------------------------------------------------------------------
# ops/halo.py


def halo_world(rank, world, x, g):
    """halo_exchange on a (1, 4) and a (1, 2, 2) mesh: the exchanged blocks,
    the refusal of a halo wider than a block, and the backward of a VALID
    conv on the exchanged block against the monolithic SAME conv's
    gradient (float64). x: (1, H, W, C) global, g: the output gradient."""
    out = {}
    w5 = torch.as_tensor(np.random.default_rng(5).standard_normal((5, 5, x.shape[3], 2)))
    for name, mesh in (("1d", tiling.make_mesh(1, 4, "cpu")),
                       ("2d", tiling.make_mesh_2d(1, 2, 2, "cpu"))):
        layout = tiling.DP_SP if name == "1d" else tiling.DP_SPH_SPW
        xb = torch.as_tensor(tiling.local_block(x, mesh, layout))
        if name == "1d":
            group = mesh.get_group("sp")
            out["1d_ext"] = tiling.gather_blocks(halo_exchange_w(xb, 2, group), mesh, layout)
            out["1d_ext_h"] = tiling.gather_blocks(halo_exchange(xb, 1, group, dim=2), mesh,
                                                   layout)
            out["1d_refused"] = _error(lambda: halo_exchange_w(xb, xb.shape[2] + 1, group))

            def ext(t):
                return halo_exchange_w(t, 2, group)
            valid = dict(w_valid=True)
        else:
            groups = (mesh.get_group("sph"), mesh.get_group("spw"))
            out["2d_ext"] = tiling.gather_blocks(halo_exchange_2d(xb, (1, 2), *groups), mesh,
                                                 layout)

            def ext(t):
                return halo_exchange_2d(t, 2, *groups)
            valid = dict(w_valid=True, h_valid=True)
        xb = xb.clone().requires_grad_(True)
        y = conv2d_nhwc(ext(xb), w5, **valid)
        (y * torch.as_tensor(tiling.local_block(g, mesh, layout))).sum().backward()
        out[f"{name}_grad"] = tiling.gather_blocks(xb.grad, mesh, layout)
        out[f"{name}_y"] = tiling.gather_blocks(y.detach(), mesh, layout)
    return out if rank == 0 else None


# ---------------------------------------------------------------------------
# parallel/tiling.py


def _qp(paths, name):
    return QuantParams.load(paths[name])


def _collapsed(arrays):
    n = len(arrays) // 2
    return CollapsedParams([arrays[f"w{i}"] for i in range(n)],
                           [arrays[f"b{i}"] for i in range(n)])


def sharding_world(rank, world, layouts, inputs, paths, float_params, calib_params):
    """Every check of every layout in ``layouts`` (their sizes' product is
    ``world``): the sharded integer forwards (nrdm_3 golden; sr_x4 golden
    with the pixel shuffle), the float forward (nrdm_6), calibration (1D),
    the deployment forwards on sr_x2 (fast) and nr (hybrid), the pinned
    ones and the int8 output (1D), and with a (world, 1) mesh the unsharded
    limit of the halo. Returns (rank 0's global outputs, this rank's
    calibration constants)."""
    out, calib = {}, {}
    qp = {k: _qp(paths, k) for k in paths}
    nrdm3, sr_x4, nrdm6 = (spec_for_task(t) for t in ("nrdm_3", "sr_x4", "nrdm_6"))
    sr_x2, nr = spec_for_task("sr_x2"), spec_for_task("nr")
    fparams = _collapsed(float_params)
    for lay in layouts:
        key = "x".join(map(str, lay))
        if len(lay) == 2:
            mesh, layout = tiling.make_mesh(*lay, device_type="cpu"), tiling.DP_SP
            integer = lambda s, q, **kw: tiling.sharded_integer_forward(s, q, mesh, **kw)  # noqa
            float_fwd = tiling.sharded_float_forward
            deploy = tiling.sharded_deployment_forward
        else:
            mesh, layout = tiling.make_mesh_2d(*lay, device_type="cpu"), tiling.DP_SPH_SPW
            integer = lambda s, q, **kw: tiling.sharded_integer_forward_2d(s, q, mesh, **kw)  # noqa
            float_fwd = tiling.sharded_float_forward_2d
            deploy = tiling.sharded_deployment_forward_2d
        cases = {
            "integer": (integer(nrdm3, qp["nrdm_3"]), "x_int"),
            # the JAX tests shard sr_x4 as the reference datapath in 1D and
            # as the corrected one in 2D
            "shuffle": (integer(sr_x4, qp["sr_x4"], corrected=len(lay) == 3), "x_sr4"),
            "float": (float_fwd(nrdm6, fparams, mesh), "x_float"),
            "deploy_sr_x2": (deploy(sr_x2, qp["sr_x2"], mesh), "x_dep"),
            "deploy_nr": (deploy(nr, qp["nr"], mesh), "x_dep"),
        }
        if len(lay) == 2:
            cases.update({
                "fast_sr_x2": (tiling.sharded_packed_forward(sr_x2, qp["sr_x2"], mesh), "x_dep"),
                "hybrid_nr": (tiling.sharded_hybrid_forward(nr, qp["nr"], mesh), "x_dep"),
                "int8_sr_x2": (deploy(sr_x2, qp["sr_x2"], mesh, out_dtype="int8"), "x_dep"),
            })
            out[f"{key}/refused_nr"] = _error(
                lambda: tiling.sharded_packed_forward(nr, qp["nr"], mesh))
            cq = tiling.sharded_calibrate(nrdm3, _collapsed(calib_params), inputs["calib"],
                                          mesh)
            calib[key] = (np.asarray(cq.a_scale), np.asarray(cq.a_zero),
                          np.asarray(cq.requant_m), np.asarray(cq.requant_n))
        for case, (f, x) in cases.items():
            out[f"{key}/{case}"] = _run(mesh, layout, f, inputs[x])
    mesh = tiling.make_mesh(world, 1, "cpu")
    out["limit"] = _run(mesh, tiling.DP_SP, tiling.sharded_float_forward(nrdm6, fparams, mesh),
                        inputs["x_limit"])
    return (out if rank == 0 else None), calib


# ---------------------------------------------------------------------------
# parallel/multihost.py and the sharded QAT step


def multihost_world(rank, world, paths, inputs, qat):
    """The (host, dp, sp) checks on four ranks: the multihost forwards at
    (2, 1, 2) and (2, 2, 1), the tail forward and the streams at (2, 2, 1),
    the 2D multihost forward at (2, 1, 1, 2), the forced pe-exact mode, the
    audited stream with the adversarial frame at (2, 1, 2), the refusal of a
    cross-host halo, and the QAT step on a (2, 2) and a (2, 1, 2) mesh.
    Returns (rank 0's outputs, this rank's audit log, this rank's QAT
    results)."""
    out = {}
    qp = {k: _qp(paths, k) for k in paths}
    nrdm3, sr_x2, nr = (spec_for_task(t) for t in ("nrdm_3", "sr_x2", "nr"))

    def stream(key, mesh, spec, q, frames, **kw):
        batches = list(mh.stream_frames(spec, q, mesh, frames, **kw))
        out[f"{key}/counts"] = [b.n for b in batches]
        out[key] = np.concatenate([tiling.gather_blocks(b.y, mesh, b.layout)[:b.n].numpy()
                                   for b in batches])

    m212 = mh.make_mesh_multihost(n_hosts=2, dp=1, sp=2, device_type="cpu")
    m221 = mh.make_mesh_multihost(n_hosts=2, dp=2, sp=1, device_type="cpu")
    for key, mesh in (("2x1x2", m212), ("2x2x1", m221)):
        out[f"{key}/integer"] = _run(mesh, mh.HOST_DP_SP,
                                     mh.multihost_integer_forward(nrdm3, qp["nrdm_3"], mesh),
                                     inputs["x_mh"])
        for task, spec in (("sr_x2", sr_x2), ("nr", nr)):
            out[f"{key}/packed_{task}"] = _run(
                mesh, mh.HOST_DP_SP, mh.multihost_packed_forward(spec, qp[task], mesh),
                inputs["x_dep4"])
    out["2x1x2/pe_exact_nr"] = _run(
        m212, mh.HOST_DP_SP, mh.multihost_packed_forward(nr, qp["nr"], m212,
                                                         force_mode="pe-exact"),
        inputs["x_dep4"])
    out["refused_fast"] = _error(lambda: mh.multihost_packed_forward(sr_x2, qp["sr_x2"], m212,
                                                                     force_mode="fast"))
    out["tail"] = _run(m221, mh.TAIL, mh.multihost_tail_forward(nrdm3, qp["nrdm_3"], m221),
                       inputs["x_tail"])
    out["tail_deploy"] = _run(m221, mh.TAIL, mh.multihost_tail_forward(
        sr_x2, qp["sr_x2"], m221, lowering="deployment"), inputs["x_dep2"])
    stream("stream", m221, nrdm3, qp["nrdm_3"], list(inputs["frames7"]))
    stream("stream_tail", m221, nrdm3, qp["nrdm_3"], list(inputs["frames5"]))
    stream("stream_deploy", m221, sr_x2, qp["sr_x2"], list(inputs["frames6"]),
           lowering="deployment")
    stream("stream_int8", m221, sr_x2, qp["sr_x2"], list(inputs["frames6"]),
           lowering="deployment", out_dtype="int8")
    stream("stream_batched", m221, sr_x2, qp["sr_x2"], list(inputs["frames9"]),
           lowering="deployment", frames_per_chip=2)
    log = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        stream("stream_audit", m212, nr, qp["nr"], list(inputs["frames_adv"]),
               lowering="deployment", audit_every=1, audit_log=log)
    audit = ([(i, mode, None if r is None else bool(r.ok)) for i, mode, r in log],
             [str(w.message) for w in caught])
    m2d = mh.make_mesh_multihost_2d(n_hosts=2, dp=1, sp_h=1, sp_w=2, device_type="cpu")
    out["packed_2d"] = _run(m2d, mh.HOST_DP_SPH_SPW,
                            mh.multihost_packed_forward_2d(sr_x2, qp["sr_x2"], m2d),
                            inputs["x_dep2"])
    out["refused_dcn"] = _error(lambda: mh.make_mesh_multihost(n_hosts=2, dp=2, sp=2,
                                                               device_type="cpu"))
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    out["local_world_mesh"] = mh.make_mesh_multihost(dp=1, device_type="cpu").mesh.tolist()
    out["refused_local"] = _error(lambda: mh.make_mesh_multihost(dp=2, sp=2,
                                                                 device_type="cpu"))
    del os.environ["LOCAL_WORLD_SIZE"]
    qat_out = qat_steps(rank, qat, m212)
    qat_out["order_statistics"] = order_statistics(rank, qat["ties"], qat["bounds"],
                                                   qat["indices"])
    return (out if rank == 0 else None), audit, qat_out


def observer_arrays(qstate):
    """Every observer's (min, max) of a QATState, in order, as numpy."""
    states = [s for c in qstate.convs for s in (c.act, c.weight)] + list(qstate.add)
    return [a.detach().numpy() for s in states for a in (s.min_val, s.max_val)]


def qat_steps(rank, qat, m212):
    """The sharded train step (sr_x2; QAT with the default QATConfig, QAT
    with the percentile observer, and float) on a (2, 2) and a (2, 1, 2)
    mesh: this rank's loss and updated parameters, and for the percentile
    observer the observer state after the step."""
    from sesr_tpu_torch.quant.qat import QATConfig, adam, prepare

    spec = spec_for_task("sr_x2")
    res = {}
    for key, mesh, layout in (("2x2", tiling.make_mesh(2, 2, "cpu"), tiling.DP_SP),
                              ("2x1x2", m212, mh.HOST_DP_SP)):
        x, gt = (torch.as_tensor(tiling.local_block(qat[k], mesh, layout)) for k in ("x", "gt"))
        for name, cfg in (("qat", QATConfig()), ("ptq", QATConfig(ptq=True)), ("float", None)):
            params = ExpandedParams([ExpandedBlock(*(torch.tensor(a).requires_grad_(True)
                                                     for a in blk)) for blk in qat["params"]])
            step = tiling.sharded_train_step(spec, cfg, params, adam(params, 1e-5), mesh)
            qstate, loss = step(prepare(spec, QATConfig(), device="cpu"), (x, gt))
            res[f"{key}/{name}"] = (float(loss),
                                    [t.detach().numpy() for blk in params.blocks for t in blk],
                                    observer_arrays(qstate) if name == "ptq" else None)
    return res


def order_statistics(rank, ties, bounds, indices):
    """``quant/qat.py`` ``global_order_statistic`` over the world: rank r
    holds ties[bounds[r]:bounds[r + 1]] (uneven blocks, one of a single
    element); the statistic at each of ``indices``."""
    from sesr_tpu_torch.quant.qat import global_order_statistic

    block = torch.from_numpy(ties[bounds[rank]:bounds[rank + 1]])
    return [float(global_order_statistic(block, i, dist.group.WORLD)) for i in indices]


# ---------------------------------------------------------------------------
# quant/audit.py: the card's sharded audit, its kernel modelled on the CPU


def count_region_model(spec, qp, x, region=None, out_dtype="f32", device=None,
                       quantized=False):
    """``ops/corrected.py`` ``audit_forward`` as the corrected kernel's
    counting form computes it, modelled on the CPU: the plain PE-exact
    output ("int8" or "f32"; a network without a pixel shuffle) and per
    layer the PE partials conv(q - z_eff) that the 18-bit clamp changes at
    the outputs inside ``region`` = (y0, y1, x0, x1), on the layers the
    PE-exact mode splits (0 on the others)."""
    from sesr_tpu_torch.ops.corrected import split_layers
    from sesr_tpu_torch.quant.integer import integer_forward, pe_channel_mask

    assert not spec.has_pixel_shuffle
    L = spec.num_convs
    y, dumps = integer_forward(spec, qp, x, collect_dumps=True, corrected=True,
                               quantized=quantized)
    if out_dtype == "int8":
        y = dumps[f"input.{L}"].to(torch.int8)
    y0, y1, x0, x1 = region
    acc_hi = (1 << (qp.hw.pe_acc_bits - 1)) - 1
    counts = torch.zeros(L, dtype=torch.int64)
    for i, split in enumerate(split_layers(qp, "pe-exact")):
        if not split:
            continue
        shifted = dumps[f"input.{i}"].double() - qp.effective_zero(i)
        w = np.asarray(qp.w_int[i], np.float64)
        for p in range(qp.hw.pe):
            m = pe_channel_mask(w.shape[2], qp.hw.pe, p)
            if m.any():
                part = conv2d_nhwc(shifted[..., torch.from_numpy(m)],
                                   torch.from_numpy(w[:, :, m].copy()))
                fired = (part > acc_hi) | (part < -acc_hi - 1)
                counts[i] += int(fired[:, y0:y1, x0:x1].sum())
    return y, counts


def sharded_audit_world(rank, world, path, frames):
    """``quant/audit.py`` ``sharded_audit_forward`` (the card's sharded
    audit: one counting launch over the rank's window, its block the count
    region) with the kernel modelled by ``count_region_model``, on a (1, 1,
    world) mesh, against the plain sharded audit of the same block. Per
    frame: (its counts, the plain audit's, outputs torch.equal)."""
    from sesr_tpu_torch.quant import audit

    spec, qp = spec_for_task("nr"), QuantParams.load(path)
    mesh = mh.make_mesh_multihost(n_hosts=1, dp=1, sp=world, device_type="cpu")
    sp = mesh.get_group("sp")
    out = []
    for f in frames:
        x = torch.as_tensor(tiling.local_block(f, mesh, mh.HOST_DP_SP))
        plain = audit.audit_frame(spec, qp, x, mode="hybrid", warn=False, halo_group=sp)
        kernel, audit.audit_forward = audit.audit_forward, count_region_model
        try:
            y, counts = audit.sharded_audit_forward(spec, qp, x, sp)
        finally:
            audit.audit_forward = kernel
        out.append((counts.numpy(), plain.ovf18, bool(torch.equal(y, plain.y_exact))))
    return out


# ---------------------------------------------------------------------------
# launch.py


def failing_rank(rank, world):
    """Rank 1 raises; rank 0 waits for it in a collective."""
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()


def sleeping_rank(rank, world):
    import time
    time.sleep(60)


def test_rank_module_imports_no_jax():
    code = ("import sys; sys.path.insert(0, 'tests'); import test_torch_ranks\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'sesr_tpu'))\n"
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
