"""FLOPs, bytes and peak memory of a path: the counterpart of the JAX
package's ``profile`` (sesr_tpu/cli.py ``cmd_profile``, which reads XLA's
cost analysis of the compiled path).

    python -m sesr_tpu_torch profile --task sr_x2 --qparams QP.npz \
        [--path deployment|interpreter|float] [--height 540 --width 960]

- **deployment**: the forward ``deploy.py`` ``select_forward`` picks. Its
  work is counted from the shapes, because its kernels are launched
  through ctypes and no PyTorch counter sees them: FLOPs are 2 x the convs'
  MACs (``conv_flops``), bytes each operand once with the glue fused (the
  float32 input read once, the float32 or int8 output written once, the
  int8 weights and int32 biases read once; the few per-layer scalars are
  left out).
- **interpreter** (``integer_forward``, corrected) and **float**
  (``forward_float``): FLOPs counted by ``torch.utils.flop_counter``
  ``FlopCounterMode`` over one forward (its convs: the elementwise ops
  count none), bytes by a dispatch mode that sums the bytes of every aten
  op's tensor inputs and outputs: every op's operands, unfused.
- **peak memory**, on the card: one forward after a warm-up, between
  ``reset_peak_memory_stats`` and ``max_memory_allocated``; the
  temporaries are the peak above what was allocated before the call, less
  the output. Not measured on the CPU.

XLA counts more than the convs (the per-PE split convs' elementwise work
too), so the JAX package's numbers for a path are no smaller than these.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from sesr_tpu_torch.bench import KERNEL_OF, SHORT
from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.deploy import select_forward
from sesr_tpu_torch.models.sesr import CollapsedParams, forward_float
from sesr_tpu_torch.quant.integer import integer_forward
from sesr_tpu_torch.quant.params import QuantParams

PATHS = ("deployment", "interpreter", "float")


@dataclasses.dataclass
class Cost:
    label: str                      # the path, e.g. "deployment (fast, K2)"
    flops: int                      # per call
    bytes: int                      # per call
    flops_how: str                  # how each was counted
    bytes_how: str
    argument_bytes: int             # the input
    output_bytes: int
    peak_temp_bytes: Optional[int]  # None: not measured (cpu)


def conv_macs(spec: SESRSpec) -> int:
    """Multiply-accumulates per input pixel: sum over the convs of k^2 *
    C_in * C_out (every conv runs at the input's resolution)."""
    chans = [spec.in_channels] + [spec.num_channels] * (spec.num_convs - 1) \
        + [spec.conv_out_channels]
    return sum(k * k * chans[i] * chans[i + 1] for i, k in enumerate(spec.kernel_sizes))


def conv_flops(spec: SESRSpec, n: int, h: int, w: int) -> int:
    """2 x the convs' MACs over an (n, h, w) input."""
    return 2 * conv_macs(spec) * n * h * w


def deployment_bytes(spec: SESRSpec, qp: QuantParams, n: int, h: int, w: int,
                     out_dtype: str = "f32") -> int:
    """Bytes the deployment forward must move over an (n, h, w) input: the
    float32 input read once, the output written once (4 bytes a value, or
    1 for the int8 contract), the int8 weights and int32 biases read once."""
    px = n * h * w
    out = px * spec.conv_out_channels * (1 if out_dtype == "int8" else 4)
    weights = sum(int(np.size(wl)) for wl in qp.w_int)
    biases = sum(int(np.size(b)) for b in qp.bias_int)
    return px * spec.in_channels * 4 + out + weights + 4 * biases


class OperandBytes(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs."""

    def __init__(self):
        super().__init__()
        self.nbytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.nbytes += sum(t.numel() * t.element_size()
                           for t in tree_leaves((args, kwargs, out))
                           if isinstance(t, torch.Tensor))
        return out


def counted(fn: Callable[[], torch.Tensor]):
    """(FLOPs, bytes) of one call of fn: FlopCounterMode and OperandBytes."""
    with FlopCounterMode(display=False) as flops, OperandBytes() as nbytes:
        fn()
    return flops.get_total_flops(), nbytes.nbytes


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def peak_temp_bytes(fn: Callable[[], torch.Tensor], device: torch.device):
    """(peak temporaries, output bytes) of one call of fn on the card, after
    a warm-up call; (None, output bytes) on the CPU."""
    y = fn()
    if device.type != "cuda":
        return None, _nbytes(y)
    del y
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    before = torch.cuda.memory_allocated(device)
    y = fn()
    torch.cuda.synchronize(device)
    out = _nbytes(y)
    return max(torch.cuda.max_memory_allocated(device) - before - out, 0), out


def profile_path(spec: SESRSpec, path: str, height: int, width: int, device="cuda",
                 qp: Optional[QuantParams] = None,
                 params: Optional[CollapsedParams] = None) -> Cost:
    """The cost of one ``path`` forward over a (1, height, width) input
    made from ``np.random.default_rng(0)`` (``qp`` for deployment and
    interpreter, ``params`` for float)."""
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if (params if path == "float" else qp) is None:
        raise ValueError(f"path {path!r} needs {'params' if path == 'float' else 'qp'}")
    device = torch.device(device)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (1, height, width, spec.in_channels), dtype=np.float32)).to(device)
    if path == "deployment":
        mode, forward = select_forward(qp)
        fn = lambda: forward(spec, qp, x)                          # noqa: E731
        where = SHORT[KERNEL_OF[mode].symbol] if device.type == "cuda" else "plain version on cpu"
        label = f"deployment ({mode}, {where})"
        flops, nbytes = conv_flops(spec, 1, height, width), deployment_bytes(
            spec, qp, 1, height, width)
        how = ("2 x the convs' MACs, from the shapes",
               "each operand once, glue fused, from the shapes")
    else:
        if path == "interpreter":
            fn = lambda: integer_forward(spec, qp, x, corrected=True)[0]   # noqa: E731
            label = "integer interpreter (corrected)"
        else:
            fn = lambda: forward_float(spec, params, x)            # noqa: E731
            label = "float"
        with torch.no_grad():
            flops, nbytes = counted(fn)
        how = ("FlopCounterMode", "every op's operands, unfused")
    with torch.no_grad():
        temp, out = peak_temp_bytes(fn, device)
    return Cost(label, flops, nbytes, *how, _nbytes(x), out, temp)
