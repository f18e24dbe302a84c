"""Reference checkpoints into collapsed parameters, collapsed at load time.

The same functions as the JAX package's ``sesr_tpu/io/torch_import.py``:
a state dict becomes ``CollapsedParams`` (numpy, HWIO). ``torch.load`` is
native here. Three checkpoint flavours load:

- plain float checkpoints (uncollapsed expand/squeeze shapes);
- the ``x2sesr.pth.tar`` dict with a ``state_dict`` key;
- QAT checkpoints with extra quantizer buffers (the extra keys are ignored);

and, through ``path=``, an already-collapsed ``.npz`` (keys ``w_i`` HWIO
and ``b_i``), as ``train --out`` of the JAX package writes them.

The reference checkout is found at ``reference_root`` (default: the
``SESR_REFERENCE_ROOT`` environment variable, else ``reference`` under the
current directory); a missing checkpoint raises FileNotFoundError naming
the file.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from sesr_tpu_torch.config import (REFERENCE_CHECKPOINTS, SESRSpec, find_reference_root,
                                   spec_for_task)
from sesr_tpu_torch.models.blocks import (collapse_block, fold_residual_identity,
                                          oihw_to_hwio)
from sesr_tpu_torch.models.sesr import CollapsedParams

# qatf="qat_" checkpoint selection (the reference's test.py:29-52, 64-69):
# mflag 1/2/4 swap in the *_qat_G.pth weights; mflag 5/6 still load the
# float checkpoints (the qatf string never reaches their paths); mflag 3's
# composed name does not exist and maps to the shipped nrdm_3_qat_G.pth
QAT_CHECKPOINTS = {
    "nr": "nr_qat_G.pth",
    "dm": "dm_qat_G.pth",
    "nrdm_3": "nrdm_3_qat_G.pth",
    "nrdm_6": "nrdm_6_qat_G.pth",
    "sr_x4": None,
    "sr_x2": None,
}

_F32EPS = np.float32(np.finfo(np.float32).eps)


def checkpoint_path(name: str, reference_root: Optional[str]) -> str:
    """The reference's checkpoint ``name`` under ``reference_root`` (else
    SESR_REFERENCE_ROOT, else ./reference); FileNotFoundError if absent."""
    path = os.path.join(find_reference_root(reference_root), "model_params", name)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"reference checkpoint {path} not found: pass path= (a .pth, or a "
            f"collapsed .npz with w_i / b_i) or point SESR_REFERENCE_ROOT at the "
            f"reference checkout")
    return path


def numpy_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A reference .pth (or the dict-wrapped .pth.tar) as numpy arrays."""
    state = torch.load(path, map_location="cpu", weights_only=False)
    if "state_dict" in state and not any(k.endswith(".weight") for k in state):
        state = state["state_dict"]
    return {k: v.detach().cpu().numpy() for k, v in state.items()
            if hasattr(v, "detach")}


def block_names(spec: SESRSpec):
    return (["conv_first"] + [f"residual_block.{i}" for i in range(spec.num_lblocks)]
            + ["conv_last"])


def collapse_state_dict(spec: SESRSpec, state: Dict[str, np.ndarray]) -> CollapsedParams:
    """Collapse an (uncollapsed) reference state dict into CollapsedParams."""
    weights, biases = [], []
    for i, name in enumerate(block_names(spec)):
        w_exp = state[f"{name}.conv_expand.weight"]
        if w_exp.ndim != 4:
            raise ValueError(f"unexpected shape for {name}: {w_exp.shape}")
        if f"{name}.conv_squeeze.weight" in state:
            w, b = collapse_block(w_exp, state[f"{name}.conv_squeeze.weight"],
                                  state[f"{name}.conv_squeeze.bias"])
            if 0 < i < spec.num_convs - 1:
                w = fold_residual_identity(w)
        else:
            # an already-collapsed checkpoint: conv_expand is the final conv
            w = w_exp.astype(np.float32)
            b = state[f"{name}.conv_expand.bias"].astype(np.float32)
        weights.append(np.ascontiguousarray(oihw_to_hwio(w)))
        biases.append(np.asarray(b))
    return CollapsedParams(weights, biases)


def _sym_fq_np(x: np.ndarray, bits: int, is_weight: bool) -> np.ndarray:
    """The reference's SymmetricQuantizer in train mode with a fresh
    observer: the range is the tensor's own min/max; float32 op for op,
    rounding half away from zero."""
    x = np.asarray(x, np.float32)
    if is_weight:
        qmin, qmax = -((1 << (bits - 1)) - 1), (1 << (bits - 1)) - 1
    else:
        qmin, qmax = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    quant_range = np.float32((qmax - qmin) / 2.0)
    float_range = np.float32(max(abs(np.float32(x.min())), abs(np.float32(x.max()))))
    scale = np.maximum(np.float32(float_range / quant_range), _F32EPS)
    t = (x / scale).astype(np.float32)
    q = np.clip(np.sign(t) * np.floor(np.abs(t) + np.float32(0.5)), qmin, qmax)
    return (q.astype(np.float32) * scale).astype(np.float32)


def qat_collapse_block(w_exp: np.ndarray, w_sq: np.ndarray, b_sq: np.ndarray) -> tuple:
    """The delta-basis collapse of QuantConv2d(expand) -> QuantConv2d(squeeze)
    as the reference's qatf="qat_" composition runs it: the expand conv of
    the fake-quantized delta is one float product per element (fq(1) times
    the flipped fake-quantized kernel); the squeeze fake-quants that and its
    own weights and contracts the tmp axis in float32; the bias is added and
    subtracted again (two float32 roundings), then the kernel is flipped and
    transposed back. Returns (kernel OIHW, bias)."""
    w_exp = np.asarray(w_exp, np.float32)       # (tmp, in, k, k)
    w_sq = np.asarray(w_sq, np.float32)         # (out, tmp, 1, 1)
    b_sq = np.asarray(b_sq, np.float32)
    fq_one = _sym_fq_np(np.array([0.0, 1.0], np.float32), 8, False)[1]
    fq_we = _sym_fq_np(w_exp, 8, True)
    inter = (np.float32(fq_one) * fq_we[:, :, ::-1, ::-1]).transpose(1, 0, 2, 3)
    inter_fq = _sym_fq_np(inter, 8, False)
    fq_ws = _sym_fq_np(w_sq, 8, True)[:, :, 0, 0]
    out = np.einsum("ot,ntyx->noyx", fq_ws, inter_fq, dtype=np.float32).astype(np.float32)
    out_b = (out + b_sq[None, :, None, None]).astype(np.float32)
    kernel = (out_b - b_sq[None, :, None, None]).astype(np.float32)
    kernel = kernel[:, :, ::-1, ::-1].transpose(1, 0, 2, 3)
    return np.ascontiguousarray(kernel), b_sq.copy()


def collapse_state_dict_qat(spec: SESRSpec, state: Dict[str, np.ndarray]) -> CollapsedParams:
    """collapse_state_dict for the qatf="qat_" composition: every block
    through the fake-quant delta response."""
    weights, biases = [], []
    for i, name in enumerate(block_names(spec)):
        w, b = qat_collapse_block(state[f"{name}.conv_expand.weight"],
                                  state[f"{name}.conv_squeeze.weight"],
                                  state[f"{name}.conv_squeeze.bias"])
        if 0 < i < spec.num_convs - 1:
            w = fold_residual_identity(w)
        weights.append(np.ascontiguousarray(oihw_to_hwio(w)))
        biases.append(np.asarray(b))
    return CollapsedParams(weights, biases)


def load_qat_add_bounds(task: str, reference_root: Optional[str] = None):
    """(union_lo, union_hi) of the QAT checkpoint's add_residual observers,
    which the fx trace freezes into the QuantAdd scale. sr_x4 and sr_x2
    load the float checkpoint, whose QuantAdd observers keep their initial
    zeros: (0.0, 0.0)."""
    if task not in QAT_CHECKPOINTS:
        raise ValueError(f"no QAT checkpoint mapping for task {task!r} "
                         f"(known: {sorted(QAT_CHECKPOINTS)})")
    name = QAT_CHECKPOINTS[task]
    if name is None:
        return 0.0, 0.0
    ck = torch.load(checkpoint_path(name, reference_root), map_location="cpu")
    lo = min(float(ck["add_residual.observer_res.min_val"]),
             float(ck["add_residual.observer_shortcut.min_val"]))
    hi = max(float(ck["add_residual.observer_res.max_val"]),
             float(ck["add_residual.observer_shortcut.max_val"]))
    return lo, hi


def load_collapsed_npz(task: str, path: str) -> CollapsedParams:
    """An already-collapsed checkpoint: exactly w_0..w_{L-1} (HWIO, k x k
    per the task's spec, w_0 with the task's input channels) and b_*."""
    spec = spec_for_task(task)
    L = spec.num_convs
    with np.load(path) as ck:
        missing = [k for i in range(L) for k in (f"w_{i}", f"b_{i}") if k not in ck]
        if missing or f"w_{L}" in ck:
            raise ValueError(f"{path} is not a collapsed {task} checkpoint (expected "
                             f"exactly w_0..w_{L - 1}/b_* HWIO; missing {missing})")
        ws = [ck[f"w_{i}"] for i in range(L)]
        bs = [ck[f"b_{i}"] for i in range(L)]
    for i, (w, k) in enumerate(zip(ws, spec.kernel_sizes)):
        if w.ndim != 4 or w.shape[0] != k or w.shape[1] != k:
            raise ValueError(f"{path}: w_{i} has shape {w.shape}, expected HWIO with "
                             f"kernel {k}x{k} for {task} (torch OIHW checkpoints go "
                             f"through the .pth loader)")
    if ws[0].shape[2] != spec.in_channels:
        raise ValueError(f"{path}: w_0 expects {ws[0].shape[2]} input channels but "
                         f"task {task} has {spec.in_channels}: wrong task?")
    return CollapsedParams(ws, bs)


def save_collapsed_npz(path: str, params: CollapsedParams) -> None:
    """Write collapsed weights as w_i (HWIO) / b_i to exactly ``path``
    (through an open file: ``np.savez`` given a name appends ``.npz`` to a
    path without that suffix)."""
    with open(path, "wb") as f:
        np.savez(f, **{f"w_{i}": np.asarray(w) for i, w in enumerate(params.weights)},
                 **{f"b_{i}": np.asarray(b) for i, b in enumerate(params.biases)})


def load_reference_checkpoint(task: str, path: Optional[str] = None,
                              reference_root: Optional[str] = None,
                              qat: bool = False) -> CollapsedParams:
    """Load and collapse the checkpoint of ``task``: ``path`` (a .pth, or a
    collapsed .npz), else the reference's own file under
    ``reference_root``. ``qat=True`` collapses the QAT checkpoint's weights
    through the fake-quant delta response (meaningless for an .npz, which
    is collapsed already)."""
    spec = spec_for_task(task)
    if path is not None and path.endswith(".npz"):
        if qat:
            raise ValueError("qat=True is meaningless for a .npz checkpoint: the "
                             "fake-quant delta composition happens at collapse time, "
                             "and an .npz is already collapsed")
        return load_collapsed_npz(task, path)
    if path is None:
        name = (QAT_CHECKPOINTS.get(task) if qat else None) or REFERENCE_CHECKPOINTS[task]
        path = checkpoint_path(name, reference_root)
    state = numpy_state_dict(path)
    return collapse_state_dict_qat(spec, state) if qat else collapse_state_dict(spec, state)
