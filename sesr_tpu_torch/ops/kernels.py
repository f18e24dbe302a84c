"""ctypes wrappers of the three fused whole-network kernels of
``csrc/sesr_net.cu``, each with its launch counter.

``pe_exact_net``   replaces sesr_tpu/ops/pallas_pipeline.py build_pallas_forward
``fast_net``       replaces sesr_tpu/ops/pallas_packed.py build_pallas_packed_forward
``corrected_net``  replaces sesr_tpu/ops/packed.py _packed_exact_impl(corrected=True)
                   (XLA, no Pallas kernel: packed_hybrid_forward and
                   packed_exact_forward(corrected=True))

A wrapper takes the quantized int8 input on the card and returns the int8
output of the last conv (before the pixel shuffle); ``ops/pe_exact.py``,
``ops/fast.py`` and ``ops/corrected.py`` put the quantization,
dequantization and shuffle around it. The kernel is built (nvcc, at first
use) and launched on PyTorch's current stream; the wrapper raises if the
launch is refused.
"""

from __future__ import annotations

import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.convert import device_constants
from sesr_tpu_torch.ops import _build
from sesr_tpu_torch.ops.conv import pixel_shuffle_nhwc
from sesr_tpu_torch.quant.integer import dequantize_output, quantize_input
from sesr_tpu_torch.quant.params import QuantParams

# output tile (rows, columns) of one thread block: the fastest of the
# sweep in chip_smoke.py phase 5 for every kernel on the 5-conv networks;
# about 108 KB (K2) and 91 KB (K1) of shared memory for sr_x2, so two
# blocks share an SM (csrc/sesr_net.cu smem_plan)
TILE = (32, 32)
# nrdm_6's 8 convs widen the tile's halo: at 32x32 the corrected kernel
# needs 122 KB a block and an SM holds one; 24x32 (104 KB) keeps two, and
# was the fastest of the sweep for that network
CORRECTED_TILES = {8: (24, 32)}
OUT_DTYPES = ("f32", "int8")


class NetKernel:
    """One entry point of the kernels' library. ``launches`` counts the
    launches this wrapper made."""

    def __init__(self, symbol: str, datapath: str, tiles=None):
        self.symbol = symbol
        self.datapath = datapath
        self.tiles = tiles or {}
        self.launches = 0

    def tile(self, spec: SESRSpec) -> tuple:
        """The default output tile for ``spec``'s network."""
        return self.tiles.get(spec.num_convs, TILE)

    def __call__(self, spec: SESRSpec, qp: QuantParams, x_q: torch.Tensor,
                 tile=None, split=None) -> torch.Tensor:
        """x_q: int8 (N, H, W, C_in) contiguous on a CUDA device. Returns the
        int8 output (N, H, W, C_out) of the last conv. ``tile``: the output
        tile (rows, columns) of one thread block (default ``self.tile(spec)``).
        ``split`` (the corrected kernel only, and required there): one flag
        per layer, set where the layer runs one pass per PE
        (ops/corrected.py ``split_layers``)."""
        if x_q.device.type != "cuda":
            raise ValueError(f"{self.symbol} runs on a CUDA tensor, got {x_q.device}")
        if x_q.dtype != torch.int8 or x_q.dim() != 4 \
                or x_q.shape[3] != spec.in_channels or not x_q.is_contiguous():
            raise ValueError(f"{self.symbol} takes a contiguous int8 (N, H, W, "
                             f"{spec.in_channels}) tensor, got {x_q.dtype} "
                             f"{tuple(x_q.shape)}")
        if (split is None) != (self.datapath != "corrected"):
            raise ValueError(f"{self.symbol}: a split mask is "
                             f"{'required' if split is None else 'not taken'}")
        kc, weights, params = device_constants(spec, qp, self.datapath, x_q.device, split)
        n, h, w, _ = x_q.shape
        out = torch.empty((n, h, w, kc.out_channels), dtype=torch.int8,
                          device=x_q.device)
        if out.numel() == 0:
            return out
        extra = () if split is None else (sum(1 << i for i, f in enumerate(kc.pe_split) if f),)
        lib = _build.load("sesr_net")
        with torch.cuda.device(x_q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, self.symbol)(
                x_q.data_ptr(), out.data_ptr(), weights.data_ptr(),
                params.data_ptr(), n, h, w, kc.num_layers, kc.in_channels,
                kc.out_channels, *(tile or self.tile(spec)), *extra, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: "
                               f"{_build.error_string('sesr_net', err)} ({err})")
        self.launches += 1
        return out


pe_exact_net = NetKernel("sesr_pe_exact_net", "exact")
fast_net = NetKernel("sesr_fast_net", "fast")
corrected_net = NetKernel("sesr_corrected_net", "corrected", CORRECTED_TILES)
NET_KERNELS = (pe_exact_net, fast_net, corrected_net)


def reset_launch_counts() -> None:
    for k in NET_KERNELS:
        k.launches = 0


def run_net(kernel: NetKernel, spec: SESRSpec, qp: QuantParams,
            x: torch.Tensor, out_dtype: str = "f32", split=None) -> torch.Tensor:
    """Quantize x (NHWC float on a CUDA device), launch ``kernel`` (with
    ``split``, the corrected kernel's mask), and return the output in the
    ``out_dtype`` contract: dequantized float32 ("f32") or the raw int8
    image ("int8"), pixel-shuffled."""
    x_q = quantize_input(x, qp).to(torch.int8).contiguous()
    y = kernel(spec, qp, x_q, split=split)
    if out_dtype == "f32":
        y = dequantize_output(y, qp)
    if spec.has_pixel_shuffle:
        y = pixel_shuffle_nhwc(y, spec.scaling_factor)
    return y
