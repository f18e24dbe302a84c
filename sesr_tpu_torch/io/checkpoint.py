"""Training checkpoints: save and resume the whole training state.

The counterpart of the JAX package's ``sesr_tpu/io/checkpoint.py``: the
expanded parameters, the QAT observer state, the optimizer's state and the
step counter go into one file, written to a temporary name and moved into
place with ``os.replace``, so a crash never leaves a half-written file.

The format is the port's own: ``torch.save`` of a dict of tensor lists,
the optimizer's ``state_dict()`` and the step, loaded back with
``weights_only=True`` (no code runs at load). The JAX package writes a
flax msgpack blob, which this module does not read, and the other way
round.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import torch

from sesr_tpu_torch.models.expanded import ExpandedParams
from sesr_tpu_torch.quant.qat import QATState


def tensor_leaves(tree) -> List[torch.Tensor]:
    """The tensors of a nest of tuples (named or not) and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for sub in tree for leaf in tensor_leaves(sub)]


def _rebuild(template, leaves):
    """``template``'s structure filled from the iterator ``leaves``; each
    tensor must have its template's shape and dtype."""
    if isinstance(template, torch.Tensor):
        leaf = next(leaves)
        if leaf.shape != template.shape or leaf.dtype != template.dtype:
            raise ValueError(f"checkpoint tensor {tuple(leaf.shape)} {leaf.dtype} does not "
                             f"fit the template's {tuple(template.shape)} {template.dtype}")
        return leaf.to(template.device)
    parts = [_rebuild(sub, leaves) for sub in template]
    if hasattr(template, "_fields"):
        return type(template)(*parts)
    return type(template)(parts)


def _rebuild_all(template, leaves: list):
    if len(leaves) != len(tensor_leaves(template)):
        raise ValueError(f"checkpoint holds {len(leaves)} tensors where the template has "
                         f"{len(tensor_leaves(template))}: another network or QAT config?")
    return _rebuild(template, iter(leaves))


def save_training_state(path: str, params: ExpandedParams, qstate: QATState,
                        opt_state: dict, step: int) -> None:
    """Write (params, qstate, the optimizer's ``state_dict()``, step) to
    ``path``, atomically."""
    state = {"params": [t.detach().cpu() for t in tensor_leaves(params)],
             "qstate": [t.detach().cpu() for t in tensor_leaves(qstate)],
             "opt_state": opt_state,
             "step": int(step)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(state, f)
    os.replace(tmp, path)


def load_training_state(path: str, params_like: ExpandedParams, qstate_like: QATState
                        ) -> Tuple[ExpandedParams, QATState, dict, int]:
    """(params, qstate, opt_state, step) from ``path``, the parameters and
    the observer state in the structure, shapes and devices of the
    templates; ``opt_state`` goes to the optimizer's ``load_state_dict``
    (which moves its tensors to the parameters' device)."""
    with open(path, "rb") as f:
        state = torch.load(f, map_location="cpu", weights_only=True)
    params = _rebuild_all(params_like, state["params"])
    qstate = _rebuild_all(qstate_like, state["qstate"])
    return params, qstate, state["opt_state"], int(state["step"])
