"""ctypes wrappers of the three fused whole-network kernels, each with its
launch counter.

``pe_exact_net``   csrc/sesr_net.cu, replaces sesr_tpu/ops/pallas_pipeline.py
                   build_pallas_forward
``fast_net``       csrc/sesr_net.cu, replaces sesr_tpu/ops/pallas_packed.py
                   build_pallas_packed_forward
``corrected_net``  csrc/sesr_corrected.cu, replaces sesr_tpu/ops/packed.py
                   _packed_exact_impl(corrected=True) (XLA, no Pallas kernel:
                   packed_hybrid_forward and packed_exact_forward(corrected=True))

A wrapper takes the quantized int8 input on the card and returns the int8
output of the last conv (before the pixel shuffle); ``ops/pe_exact.py``,
``ops/fast.py`` and ``ops/corrected.py`` put the quantization,
dequantization and shuffle around it. The kernel is built (nvcc, at first
use) and launched on PyTorch's current stream; the wrapper raises if the
launch is refused.
"""

from __future__ import annotations

import collections

import torch

from sesr_tpu_torch.config import SESRSpec
from sesr_tpu_torch.convert import PARAM_WORDS, device_constants, wgmma_geometry
from sesr_tpu_torch.ops import _build
from sesr_tpu_torch.ops.conv import pixel_shuffle_nhwc
from sesr_tpu_torch.quant.integer import dequantize_output, quantize_input
from sesr_tpu_torch.quant.params import QuantParams

# output tile (rows, columns) of one thread block of K1 and K2: the fastest
# of the sweep in chip_smoke.py phase 5 on the 5-conv networks; about 108 KB
# (K2) and 91 KB (K1) of shared memory for sr_x2, so two blocks share an SM
# (csrc/sesr_net.cu smem_plan)
TILE = (32, 32)
# the corrected kernel's tiles in order of preference (one block an SM, so
# a larger tile only cuts the halo's share): it takes the first whose
# shared memory (corrected_smem_bytes) fits a block. nr hybrid takes 48x48
# (230,032 B), nr pe-exact 32x64, nrdm_6 32x48 (chip_smoke.py phase 5 sweeps
# them); a network whose weights leave less room takes a smaller one
CORRECTED_TILES = ((48, 48), (32, 64), (32, 48), (32, 32), (24, 32), (16, 32), (16, 16), (8, 16))
SMEM_LIMIT = 232448                 # a block's shared memory on the H100
OUT_DTYPES = ("f32", "int8")


def _round_up(v: int, a: int) -> int:
    return -(-v // a) * a


def _ring(i: int, L: int) -> int:
    """sum of k // 2 over convs i..L-1 (5, 3, ..., 3, 5): csrc/sesr_common.cuh ring."""
    return 0 if i >= L else L + 2 if i == 0 else L + 1 - i


def corrected_smem_bytes(L: int, in_ch: int, out_ch: int, tile, split) -> int:
    """Shared memory of one block of the corrected kernel at ``tile``
    (csrc/sesr_corrected.cu smem_plan; chip_smoke.py checks the two agree):
    the parameter block, every layer's B, two ping-pong buffers of 16 bytes
    a pixel (each holding the pixels its layers' GEMMs read, past the extent
    too), the int16 shortcut of 32 bytes a pixel and 16 bytes of scratch."""
    th, tw = tile
    w_bytes, bufs = 0, [0, (th + 2 * _ring(0, L)) * (tw + 2 * _ring(0, L)) * 4]
    for i in range(L):
        last = i == L - 1
        k = 5 if i in (0, L - 1) else 3
        ic = in_ch if i == 0 else 16
        steps, _, n = wgmma_geometry(k, ic, out_ch if last else 16, bool(split[i]), last)
        w_bytes += steps * n * 32
        r = _ring(i, L)
        ih, iw = th + 2 * r, tw + 2 * r
        if i == 0:                  # the widened pixels of the last step's second half
            reach = 4 * iw + 4
        else:                       # tap k * k - 1, and a pad tap one pixel on
            reach = (k - 1) * (iw + 1) + (k * k) % 2
        cap = (_round_up((ih - k + 1) * iw, 64) + reach) * 16
        bufs[i % 2] = max(bufs[i % 2], cap)
    w_at = _round_up(PARAM_WORDS * 4, 128)
    x_at = _round_up(w_at + w_bytes, 128)
    y_at = _round_up(x_at + bufs[0], 128)
    sc_at = _round_up(y_at + bufs[1], 128)
    r_sc = _ring(L - 1, L)
    return sc_at + (th + 2 * r_sc) * (tw + 2 * r_sc) * 32 + 16     # + the scratch word


class NetKernel:
    """One entry point of a kernel library (``csrc/<library>.cu``).
    ``launches`` counts the launches this wrapper made, ``split_launches``
    the same launches by their per-layer split mask (the corrected kernel's
    modes; None for the other kernels)."""

    def __init__(self, symbol: str, datapath: str, library: str = "sesr_net"):
        self.symbol = symbol
        self.datapath = datapath
        self.library = library
        self.launches = 0
        self.split_launches = collections.Counter()

    def tile(self, spec: SESRSpec, split=None) -> tuple:
        """The default output tile for ``spec``'s network."""
        return TILE

    def check_tile(self, spec: SESRSpec, tile, split) -> None:
        """Raises ValueError for a tile the kernel does not take."""
        if not (1 <= tile[0] <= 1024 and 1 <= tile[1] <= 1024):
            raise ValueError(f"{self.symbol}: tile {tuple(tile)} outside 1..1024")

    def __call__(self, spec: SESRSpec, qp: QuantParams, x_q: torch.Tensor,
                 tile=None, split=None) -> torch.Tensor:
        """x_q: int8 (N, H, W, C_in) contiguous on a CUDA device. Returns the
        int8 output (N, H, W, C_out) of the last conv. ``tile``: the output
        tile (rows, columns) of one thread block (default ``self.tile(spec,
        split)``). ``split`` (the corrected kernel only, and required there):
        one flag per layer, set where the layer runs one pass per PE
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
        tile = tuple(tile or self.tile(spec, kc.pe_split))
        self.check_tile(spec, tile, kc.pe_split)
        n, h, w, _ = x_q.shape
        out = torch.empty((n, h, w, kc.out_channels), dtype=torch.int8,
                          device=x_q.device)
        if out.numel() == 0:
            return out
        extra = () if split is None else (sum(1 << i for i, f in enumerate(kc.pe_split) if f),)
        lib = _build.load(self.library)
        with torch.cuda.device(x_q.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = getattr(lib, self.symbol)(
                x_q.data_ptr(), out.data_ptr(), weights.data_ptr(),
                params.data_ptr(), n, h, w, kc.num_layers, kc.in_channels,
                kc.out_channels, *tile, *extra, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: "
                               f"{_build.error_string(self.library, err)} ({err})")
        self.launches += 1
        self.split_launches[None if split is None else tuple(kc.pe_split)] += 1
        return out


class CorrectedKernel(NetKernel):
    """The corrected kernel: its tile is the first of CORRECTED_TILES whose
    shared memory fits a block, and a tile that does not fit is refused
    before any launch."""

    def tile(self, spec: SESRSpec, split=None) -> tuple:
        split = split or (False,) * spec.num_convs
        for tile in CORRECTED_TILES:
            if self.smem_bytes(spec, tile, split) <= SMEM_LIMIT:
                return tile
        raise ValueError(f"{self.symbol}: no tile of {CORRECTED_TILES} fits {spec.name}")

    @staticmethod
    def smem_bytes(spec: SESRSpec, tile, split) -> int:
        return corrected_smem_bytes(spec.num_convs, spec.in_channels, spec.conv_out_channels,
                                    tile, split)

    def check_tile(self, spec: SESRSpec, tile, split) -> None:
        super().check_tile(spec, tile, split)
        need = self.smem_bytes(spec, tile, split)
        if need > SMEM_LIMIT:
            raise ValueError(f"{self.symbol}: tile {tuple(tile)} needs {need} B of shared "
                             f"memory for {spec.name}, more than a block's {SMEM_LIMIT}")


pe_exact_net = NetKernel("sesr_pe_exact_net", "exact")
fast_net = NetKernel("sesr_fast_net", "fast")
corrected_net = CorrectedKernel("sesr_corrected_net", "corrected", "sesr_corrected")
NET_KERNELS = (pe_exact_net, fast_net, corrected_net)


def reset_launch_counts() -> None:
    for k in NET_KERNELS:
        k.launches = 0
        k.split_launches.clear()


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
