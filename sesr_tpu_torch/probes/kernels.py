"""ctypes wrappers of the five probe kernels of ``csrc/probes.cu``, each with
its launch counter.

``probe_gemm``          replaces tools/bench_probe_pallas_int8.py:65 and the dots
                        of tools/bench_probe_pallas_conv.py:122 (mm variants)
``probe_conv_run``      replaces tools/bench_probe_pallas_conv.py:122 (all of
                        its steps in one launch)
``probe_bitcast_dot``   replaces tools/bench_probe_r3a.py:343 (its roll, bitcast
                        and dot in one launch)
``probe_unpack_words``  replaces the bitcast of tools/bench_probe_r3b.py:82
``probe_packed_dot``    replaces tools/bench_probe_r3b.py:147 and :164

A wrapper takes tensors on a CUDA device, checks their types, shapes and
16-byte alignment (TMA and the 16-byte stores need it), allocates its
outputs and launches on PyTorch's current stream. It refuses a CPU tensor,
or a view that does not start on a 16-byte boundary, with ValueError (the probe functions in ``conv.py``,
``int8_gemm.py`` and ``bitcast.py`` take the plain version, ``plain.py``,
for those) and raises RuntimeError when a launch is refused. ``launches``
counts the launches it made.
"""

from __future__ import annotations

import torch

from sesr_tpu_torch.ops import _build

K_BYTES = 64        # K * element bytes must be a multiple of this
N_TILE = 64         # the GEMM's narrowest block tile of N
ALIGN = 16          # bytes: every pointer a kernel takes
CONV_PATCH = 8      # probe_conv_run: a block's patch is 8 x 8 pixels ...
CONV_BN = 64        # ... by 64 output channels
CONV_RING = 4       # tap boxes in flight
STAGE_K = 128       # bytes of C a tap box holds
SMEM_LIMIT = 232448  # a block's shared memory on the H100
EPI_S32, EPI_F32, EPI_WB = 0, 1, 2
IN_TYPES = (torch.int8, torch.bfloat16)


class ProbeKernel:
    """One entry point of the probes' library."""

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0
        self._fn = None         # the ctypes function, looked up at the first launch

    def _launch(self, device: torch.device, *args) -> None:
        if self._fn is None:
            self._fn = getattr(_build.load("probes"), self.symbol)
        with torch.cuda.device(device):
            err = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: "
                               f"{_build.error_string('probes', err)} ({err})")
        self.launches += 1

    def _check(self, *tensors: torch.Tensor) -> torch.device:
        dev = tensors[0].device
        for t in tensors:
            if t.device.type != "cuda" or t.device != dev:
                raise ValueError(f"{self.symbol} runs on CUDA tensors of one device, "
                                 f"got {[str(u.device) for u in tensors]}")
            if not t.is_contiguous():
                raise ValueError(f"{self.symbol} takes contiguous tensors")
            if t.data_ptr() % ALIGN:
                raise ValueError(f"{self.symbol} takes tensors that start on a {ALIGN}-byte "
                                 f"boundary, got a view at {t.data_ptr():#x}")
        return dev


def _gemm_operands(kern: ProbeKernel, a: torch.Tensor, b: torch.Tensor):
    dev = kern._check(a, b)
    if a.dtype not in IN_TYPES or b.dtype != a.dtype or a.dim() != 2 or b.dim() != 2 \
            or a.shape[1] != b.shape[0]:
        raise ValueError(f"{kern.symbol} takes a (M, K) and b (K, N) of one type "
                         f"int8 or bfloat16, got {a.dtype} {tuple(a.shape)}, "
                         f"{b.dtype} {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if (k * a.element_size()) % K_BYTES or n % N_TILE:
        raise ValueError(f"{kern.symbol} needs K * element bytes % {K_BYTES} == 0 and "
                         f"N % {N_TILE} == 0, got K={k} N={n}")
    return dev, m, n, k


class ProbeGemm(ProbeKernel):
    def __call__(self, a: torch.Tensor, b: torch.Tensor,
                 out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
        """(M, N) a @ b in ``out_dtype``: int32 (int8 inputs only) or
        float32. int8 inputs are summed exactly in int32."""
        dev, m, n, k = _gemm_operands(self, a, b)
        if out_dtype not in (torch.int32, torch.float32) or \
                (out_dtype == torch.int32 and a.dtype != torch.int8):
            raise ValueError(f"{self.symbol}: out_dtype {out_dtype} for {a.dtype} inputs")
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
        self._launch(dev, a.data_ptr(), b.data_ptr(), out.data_ptr(), None, None, m, n, k,
                     int(a.dtype == torch.bfloat16),
                     EPI_S32 if out_dtype == torch.int32 else EPI_F32, 1)
        return out

    def write_back(self, a: torch.Tensor, b: torch.Tensor, rep: int,
                   out_x: torch.Tensor | None = None, f32: bool = False):
        """The conv probe's mm step: a @ b, written back as the probe does
        (int8: clip to [-128, 127]; bf16: acc * f32(1e-3) rounded to bf16),
        each result row to ``rep`` consecutive rows. Returns (x, f32 copy or
        None): x is (M * rep, N) in the input type, into ``out_x`` if given."""
        dev, m, n, k = _gemm_operands(self, a, b)
        if out_x is None:
            out_x = torch.empty((m * rep, n), dtype=a.dtype, device=dev)
        elif out_x.shape != (m * rep, n) or out_x.dtype != a.dtype:
            raise ValueError(f"{self.symbol}: out_x must be {a.dtype} {(m * rep, n)}")
        self._check(a, out_x)
        out_f = torch.empty((m * rep, n), dtype=torch.float32, device=dev) if f32 else None
        self._launch(dev, a.data_ptr(), b.data_ptr(), None, out_x.data_ptr(),
                     out_f.data_ptr() if f32 else None, m, n, k,
                     int(a.dtype == torch.bfloat16), EPI_WB, rep)
        return out_x, out_f


def conv_smem_bytes(c: int, element_size: int) -> int:
    """Shared memory of a ``probe_conv_run`` block (``conv::smem_bytes``):
    the resident weights, the ring, the staged C tile, alignment, barriers."""
    return 9 * c * CONV_BN * element_size + CONV_RING * 8192 + 64 * (CONV_BN + 8) * 4 \
        + 1024 + 8 * (2 * CONV_RING + 1)


def barrier_base_after(base: int, nblocks: int, iters: int) -> int:
    """The grid barrier's word after a launch that started at ``base``:
    ``iters`` barriers (the prologue's and one between each two steps), one
    arrival per block each, mod 2^32."""
    return (base + iters * nblocks) & 0xFFFFFFFF


class ProbeConvRun(ProbeKernel):
    def __init__(self, symbol: str):
        super().__init__(symbol)
        self._barriers = {}     # (device index, stream): [barrier word, its value]

    def __call__(self, x: torch.Tensor, w: torch.Tensor, iters: int):
        """``iters`` steps of the conv probe in one launch: x (E_H, E_W, C)
        int8 or bf16, w (9C, C), row (3 qy + qx) C + ci. Returns (x after
        ``iters`` steps, an (E_H, E_W, C) view into the kernel's padded
        buffer; its float32 copy). Needs E_H, E_W % 8 == 0, C % 64 == 0,
        C * element bytes % 128 == 0, the block's weights within shared
        memory (C <= 256 int8, <= 128 bf16) and a grid of (C / 64) (E_W /
        8) (E_H / 8) blocks no larger than the card's SMs."""
        if x.dtype not in IN_TYPES or w.dtype != x.dtype or x.dim() != 3:
            raise ValueError(f"{self.symbol} takes x (E_H, E_W, C) and w (9C, C) of one "
                             f"type int8 or bfloat16, got {x.dtype} {tuple(x.shape)}, "
                             f"{w.dtype} {tuple(w.shape)}")
        eh, ew, c = x.shape
        es = x.element_size()
        if tuple(w.shape) != (9 * c, c) or iters < 1:
            raise ValueError(f"{self.symbol} takes w (9C, C) and iters >= 1, got x "
                             f"{tuple(x.shape)}, w {tuple(w.shape)}, iters {iters}")
        if eh % CONV_PATCH or ew % CONV_PATCH or c % CONV_BN or (c * es) % STAGE_K \
                or min(eh, ew, c) < 1:
            raise ValueError(f"{self.symbol} needs E_H and E_W multiples of {CONV_PATCH}, C a "
                             f"multiple of {CONV_BN} and C * element bytes of {STAGE_K}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if conv_smem_bytes(c, es) > SMEM_LIMIT:
            raise ValueError(f"{self.symbol}: a block's {9 * c} x {CONV_BN} {x.dtype} weights "
                             f"do not fit in shared memory ({conv_smem_bytes(c, es)} > "
                             f"{SMEM_LIMIT} bytes) at C = {c}")
        dev = self._check(x, w)
        nblocks = (c // CONV_BN) * (ew // CONV_PATCH) * (eh // CONV_PATCH)
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        if nblocks > sms:
            raise ValueError(f"{self.symbol}: {nblocks} blocks at {tuple(x.shape)} cannot all "
                             f"be resident on {sms} SMs (one block per SM)")
        stream = torch.cuda.current_stream(dev).cuda_stream
        barrier = self._barriers.get((dev.index, stream))
        if barrier is None:
            barrier = [torch.zeros(1, dtype=torch.int32, device=dev), 0]
            self._barriers[(dev.index, stream)] = barrier
        bufs = torch.empty((2, eh + 2, ew + 2, c), dtype=x.dtype, device=dev)
        out_f = torch.empty((eh, ew, c), dtype=torch.float32, device=dev)
        self._launch(dev, x.data_ptr(), w.data_ptr(), bufs.data_ptr(), out_f.data_ptr(),
                     barrier[0].data_ptr(), barrier[1], eh, ew, c, iters,
                     int(x.dtype == torch.bfloat16))
        barrier[1] = barrier_base_after(barrier[1], nblocks, iters)
        return bufs[iters % 2, 1:-1, 1:-1], out_f


class ProbeUnpackWords(ProbeKernel):
    def __call__(self, words: torch.Tensor, roll: int = 0) -> torch.Tensor:
        """(4M, N) int8: row 4m + b holds byte b of words[m, (n - roll) mod N]."""
        dev = self._check(words)
        if words.dtype != torch.int32 or words.dim() != 2:
            raise ValueError(f"{self.symbol} takes int32 (M, N) words, got "
                             f"{words.dtype} {tuple(words.shape)}")
        m, n = words.shape
        out = torch.empty((4 * m, n), dtype=torch.int8, device=dev)
        if out.numel():
            self._launch(dev, words.data_ptr(), out.data_ptr(), m, n, roll)
        return out


class ProbeBitcastDot(ProbeKernel):
    def __call__(self, words: torch.Tensor, w: torch.Tensor, roll: int = 1) -> torch.Tensor:
        """(4M, P) int32, the exact dot of the unpacked words with w:
        out[4m + b, p] = sum over n of byte b of words[m, (n - roll) mod N]
        times w[n, p]; words int32 (M, N), w int8 (N, P), N and P multiples
        of 64. r3a's roll, bitcast and dot in one launch."""
        if words.dtype != torch.int32 or w.dtype != torch.int8 or words.dim() != 2 \
                or w.dim() != 2 or w.shape[0] != words.shape[1]:
            raise ValueError(f"{self.symbol} takes int32 words (M, N) and int8 w (N, P), got "
                             f"{words.dtype} {tuple(words.shape)}, {w.dtype} {tuple(w.shape)}")
        m, n = words.shape
        p = w.shape[1]
        if min(n, p) < 1 or n % N_TILE or p % N_TILE:
            raise ValueError(f"{self.symbol} needs N and P positive multiples of {N_TILE}, "
                             f"got N={n} P={p}")
        dev = self._check(words, w)
        out = torch.empty((4 * m, p), dtype=torch.int32, device=dev)
        if m:
            self._launch(dev, words.data_ptr(), w.data_ptr(), out.data_ptr(), m, n, p, roll % n)
        return out


class ProbePackedDot(ProbeKernel):
    def __call__(self, words: torch.Tensor, wb: torch.Tensor,
                 out_dtype: torch.dtype = torch.int32) -> torch.Tensor:
        """(M, N) exact sum over b of plane_b @ wb[b]: words int32 (M, K/4),
        plane_b[m, j] byte b of word (m, j), wb int8 (4, K/4, N); int32, or
        float32 (the probe's timed form)."""
        dev = self._check(words, wb)
        if words.dtype != torch.int32 or wb.dtype != torch.int8 or words.dim() != 2 \
                or wb.dim() != 3 or tuple(wb.shape[:2]) != (4, words.shape[1]):
            raise ValueError(f"{self.symbol} takes int32 words (M, K/4) and int8 byte-plane "
                             f"weights (4, K/4, N), got {words.dtype} {tuple(words.shape)}, "
                             f"{wb.dtype} {tuple(wb.shape)}")
        m, kw = words.shape
        n = wb.shape[2]
        if (4 * kw) % K_BYTES or n % N_TILE or out_dtype not in (torch.int32, torch.float32):
            raise ValueError(f"{self.symbol} needs K % {K_BYTES} == 0, N % {N_TILE} == 0 "
                             f"and an int32 or float32 output, got K={4 * kw} N={n} "
                             f"{out_dtype}")
        out = torch.empty((m, n), dtype=out_dtype, device=dev)
        self._launch(dev, words.data_ptr(), wb.data_ptr(), out.data_ptr(), m, kw, n,
                     int(out_dtype == torch.float32))
        return out


probe_gemm = ProbeGemm("probe_gemm")
probe_conv_run = ProbeConvRun("probe_conv_run")
probe_bitcast_dot = ProbeBitcastDot("probe_bitcast_dot")
probe_unpack_words = ProbeUnpackWords("probe_unpack_words")
probe_packed_dot = ProbePackedDot("probe_packed_dot")
PROBE_KERNELS = (probe_gemm, probe_conv_run, probe_bitcast_dot, probe_unpack_words,
                 probe_packed_dot)


def reset_launch_counts() -> None:
    for k in PROBE_KERNELS:
        k.launches = 0
