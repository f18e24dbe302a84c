// The TPU-compiler probes of the JAX package's tools/ as five kernels for
// Hopper (sm_90a). Each replaces the Pallas kernel(s) of one probe:
//
//   probe_gemm          <- tools/bench_probe_pallas_int8.py:65 (make_mm: a tiled
//                          GEMM, bf16 -> f32, int8 -> s32, int8 -> f32), and the
//                          dot of tools/bench_probe_pallas_conv.py:122's mm
//                          variants (its write-back is a store epilogue here)
//   probe_bitcast_dot   <- tools/bench_probe_r3a.py:343 (the roll of int32 words,
//                          their bitcast to int8 and the exact int8 dot, in one
//                          launch)
//   probe_conv_run      <- tools/bench_probe_pallas_conv.py:122 (make()'s kernel,
//                          all ITERS grid steps: a circular 3x3 C -> C conv of the
//                          (E_H, E_W, C) tile with its int8 / bf16 write-back, step
//                          after step, then f32 of the tile)
//   probe_unpack_words  <- the pltpu.bitcast int32 -> int8 of
//                          tools/bench_probe_r3b.py:82 (and, with a roll, of
//                          r3a.py:343 alone)
//   probe_packed_dot    <- tools/bench_probe_r3b.py:147 / :164 (the byte-plane dot
//                          of packed words with the byte-plane weights, and its
//                          timed form with the f32 cast)
//
// Their plain versions are sesr_tpu_torch/probes/plain.py.
//
// probe_gemm, probe_packed_dot and probe_bitcast_dot run the wgmma tile of
// wgmma_gemm.cuh (TMA loads, a producer warp and consumer warpgroups; its
// note says what bounds them and what the design does about it).
//
// probe_unpack_words moves bytes and computes nothing: its bound is 8 bytes
// of device memory a word (read 4, write 4), 40.1 us at (4096, 4096) words.
// Where n % 16 == 0 a thread takes a run of 16 consecutive output columns of
// one word row: it loads the run's 16 source words as 16-byte groups (4
// groups, or 5 when the roll leaves the run D = (-roll) mod 4 words into a
// group: a kernel per D, so that every register index is a constant; a
// group wraps at n whole, since n % 4 == 0), turns each four words into
// four 32-bit words of its four byte rows with six __byte_perm (byte_rows),
// and stores 16 bytes to each output row. Neighbouring threads take
// neighbouring runs, so a warp's stores are four runs of 512 contiguous
// bytes and its loads 2 KB contiguous. A grid of 8 blocks of 256 threads an
// SM strides over the runs. Widths that are no multiple of 16 take a word a
// thread and four byte stores.
//
// probe_conv_run runs every step of one probe call in one persistent,
// cooperative launch, as the TPU kernel runs its sequential grid in one
// pallas_call with the tile in VMEM scratch. The conv is an implicit GEMM
// (M = the tile's pixels, K = 9 taps x C, N = C) on wgmma, operation-bound
// (1.02e9 operations a step at 48 x 72 x 128: 0.515 us int8 at 1,979
// TOP/s, 1.03 us bf16 at 989 TFLOP/s). The design:
//   - one block per 8 x 8-pixel patch x 64 output channels (wgmma's M = 64,
//     one consumer warpgroup): 108 blocks for the probe's tile, one per SM,
//     all resident; a shape whose grid could not all be resident is refused;
//   - the block's 9C x 64 weight columns load once, by TMA, and stay in
//     shared memory for every step: bf16 as they lie (MN-major, read
//     transposed by the descriptor), int8 turned K-major once by
//     transpose_stage into swizzled 64 x 128-byte tiles;
//   - the tile ping-pongs between two padded buffers (E_H + 2, E_W + 2, C)
//     in device memory (L2-resident: 0.5 / 1.0 MB), whose border holds the
//     circular halo, so tap (qy, qx) of a patch is one in-bounds 3-D TMA box
//     (128 bytes of C, 8, 8) at (c0, w0 + qx, h0 + qy): 64 swizzled 128-byte
//     rows, wgmma's K-major A as it lands. A prologue writes x and its halo
//     into buffer 0; each step's epilogue writes a border pixel to its halo
//     copies as well (pad_src, halo_copy);
//   - a producer lane keeps kRing tap boxes in flight (full / empty
//     mbarriers whose phases run on across steps), the consumer warpgroup
//     issues m64n64k32 s8 (exact int32) or m64n64k16 bf16 -> f32, and its
//     epilogue stages the fragments in shared memory and writes back the
//     probe's way (write_back4) into the other buffer; the last step also
//     writes the f32 output;
//   - between steps a grid barrier: a word in device memory that only grows
//     (barrier_target); the writers fence their generic stores against the
//     async proxy (fence.proxy.async.global) before the block arrives with
//     a release, and the producer acquires, fences again, then issues the
//     next step's TMA loads. Step s reads buffer s % 2 and writes the other;
//     a block arrives only after its consumer has waited for every box of
//     step s, so no box of step s is in flight when any block passes the
//     barrier and overwrites buffer s % 2 in step s + 1.
// Shared memory per block: the resident B (9 C 64 bytes int8, twice that
// bf16), kRing stages of 8,192 B, the staged C tile of 18,432 B, 1,024 B
// to align the base and 72 B of barriers: at C = 128, 126,024 B int8 and
// 199,752 B bf16. The TPU probe's concat3 and dot9 forms differ only in
// how the TPU relayouts the rolled copies, so both run this kernel; their
// weights are (9C, C) reshapes of the probe's layouts. The write-back is
// the probe's: int8 clip(acc, -128, 127); bf16 bf16_rn(acc * f32(1e-3));
// with -fmad=false and an explicit __fmul_rn.
//
// probe_gemm with int8 inputs and f32 output accumulates in int32 and
// converts once. This equals the TPU probe's f32 accumulation wherever
// every partial sum is below 2^24 in magnitude, which holds for the
// probe's data: |a|, |b| <= 8 and K = 4096 give |sum| <= 2^18.
//
// probe_packed_dot takes the TPU probe's weights as they are, byte planes wb
// (4, K_words, N), and the packed words as the (M, 4 K_words) int8 A
// operand; the result is the exact s32 sum, the value of the TPU probe's
// four byte-plane dots.
//
// Built with route (b): nvcc into a shared library with a plain C
// interface, loaded with ctypes (sesr_tpu_torch/ops/_build.py). Each entry
// point returns cudaGetLastError() after its launch, and refuses
// (cudaErrorInvalidValue) a pointer that is not 16-byte aligned, which TMA
// and the 16-byte stores need.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "wgmma_gemm.cuh"

namespace {

constexpr int kKBytes = 64;  // probe_gemm / probe_packed_dot: K * element bytes % kKBytes == 0

// The GEMM tiles (wgmma_gemm.cuh): 128 x 256 with two consumer warpgroups
// where that still fills the card, else 64 x 64 with one.
using BigTile = wg::Tile<2, 256, 3>;    // int8: 3 stages + 2 K-major B tiles
using BigTileBf16 = wg::Tile<2, 256, 4>;
using SmallTile = wg::Tile<1, 64, 4>;
constexpr int kSms = 132;               // the H100's SMs

namespace conv {

constexpr int kPatch = 8;                     // a block's patch: 8 x 8 pixels, wgmma's M of 64
constexpr int kBn = 64;                       // output channels per block
constexpr int kRing = 4;                      // A stages in flight
constexpr int kStageBytes = 8192;             // an A stage, or a resident B tile: 64 x 128 bytes
constexpr int kCs = kBn + 8;                  // words per row of the staged C tile
constexpr int kCBytes = 64 * kCs * 4;
constexpr int kThreads = 256;                 // the producer warpgroup and one consumer warpgroup
constexpr int kSmemLimit = 232448;            // a block's shared memory on the H100

// The padded (haloed) tile: padded index hp of a dimension of n pixels
// holds pixel pad_src(hp, n); pixel h is also written to its halo copy
// halo_copy(h, n) (n + 1 for h = 0, 0 for h = n - 1, else -1: none).
__host__ __device__ __forceinline__ int pad_src(int hp, int n) { return (hp + n - 1) % n; }
__host__ __device__ __forceinline__ int halo_copy(int h, int n) {
  return (h == 0) * (n + 2) + (h == n - 1) - 1;
}
// Stage j of a step (cpt 128-byte chunks of C a tap): its tap 3 qy + qx and
// its chunk of C; it reads weight rows 128 / es * j onwards.
__host__ __device__ __forceinline__ int stage_tap(int j, int cpt) { return j / cpt; }
__host__ __device__ __forceinline__ int stage_chunk(int j, int cpt) { return j % cpt; }
// The grid barrier: a word in device memory that only grows (mod 2^32).
// Barrier b of a launch whose word started at base completes when every
// block has arrived at it: the word reads barrier_target(base, b, nblocks).
__host__ __device__ __forceinline__ unsigned barrier_target(unsigned base, unsigned b,
                                                            unsigned nblocks) {
  return base + (b + 1u) * nblocks;
}

__host__ __device__ constexpr int smem_bytes(int c, int es) {
  return 9 * c * kBn * es + kRing * kStageBytes + kCBytes + 1024 + 8 * (2 * kRing + 1);
}

struct Args {
  const int4* x;        // (eh, ew, c) input tile
  uint8_t* bufs;        // two padded tiles (eh + 2, ew + 2, c), one after the other
  float* out_f32;       // (eh, ew, c): f32 of the tile after the last step
  unsigned* count;      // the grid barrier's word
  unsigned base;        // its value when this launch starts
  int eh, ew, c, iters;
};

__device__ __forceinline__ void grid_arrive(unsigned* count) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(count) : "memory");
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
// Waits until the word has reached target (mod 2^32). Every block is
// resident (a cooperative launch), so a barrier that has not completed
// after two seconds never will: trap, as mbar_wait does.
__device__ __forceinline__ void grid_wait(const unsigned* count, unsigned target) {
  if (static_cast<int>(ld_acquire(count) - target) >= 0) return;
  const uint64_t t0 = wg::global_ns();
  while (static_cast<int>(ld_acquire(count) - target) < 0)
    if (wg::global_ns() - t0 > 2000000000ull) __trap();
}
// Generic-proxy stores to device memory, made visible to later TMA loads
// (the async proxy) of this or another block.
__device__ __forceinline__ void fence_proxy_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// All `iters` steps of the conv probe (concat3 / dot9): see the note above
// probe_conv_run.
template <bool BF16>
__global__ void __launch_bounds__(kThreads, 1)
    probe_conv_run_kernel(const __grid_constant__ CUtensorMap map_x0,
                          const __grid_constant__ CUtensorMap map_x1,
                          const __grid_constant__ CUtensorMap map_w, Args p) {
  using namespace wg;
  using AccT = typename std::conditional<BF16, float, int>::type;
  constexpr int es = BF16 ? 2 : 1, S = kRing;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int cpt = p.c * es / kStageK;  // 128-byte chunks of C a tap
  const int KT = 9 * cpt;              // stages a step, and resident B tiles
  uint8_t* bres = smem;                // B: tile j holds weight rows 128 / es * j onwards
  uint8_t* ring = bres + KT * kStageBytes;
  uint32_t* ct = reinterpret_cast<uint32_t*>(ring + S * kStageBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * kStageBytes + kCBytes);
  uint64_t* empty = full + S;
  uint64_t* wbar = empty + S;
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBn, w0 = blockIdx.y * kPatch, h0 = blockIdx.z * kPatch;
  const unsigned nblocks = gridDim.x * gridDim.y * gridDim.z;
  const size_t plane = static_cast<size_t>(p.eh + 2) * (p.ew + 2) * p.c * es;  // bytes a buffer

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 128);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // 1. the block's weight columns n0 .. n0 + 63, by TMA, once. bf16: as they
  // lie (MN-major, read transposed by the descriptor), straight into their
  // resident tiles. int8: rounds of S raw (128 k x 64 n) tiles through the
  // ring, each turned K-major into its resident tile below.
  auto load_w_round = [&](int r) {
    const int j0 = r * S, nj = min(S, KT - j0);
    mbar_expect_tx(wbar, nj * kStageBytes);
    for (int j = j0; j < j0 + nj; ++j)
      tma_2d(ring + (j - j0) * kStageBytes, &map_w, wbar, n0, kStageK * j);
  };
  if (tid == 0) {
    if constexpr (BF16) {
      mbar_expect_tx(wbar, KT * kStageBytes);
      for (int j = 0; j < KT; ++j) tma_2d(bres + j * kStageBytes, &map_w, wbar, n0, 64 * j);
    } else {
      load_w_round(0);
    }
  }

  // 2. the prologue, every block a share: buffer 0 <- x with its circular halo
  {
    const int chunks = p.c * es / 16, wp_n = p.ew + 2;
    const long long total = static_cast<long long>(p.eh + 2) * wp_n * chunks;
    const long long bid =
        blockIdx.x + gridDim.x * (blockIdx.y + static_cast<long long>(gridDim.y) * blockIdx.z);
    const long long step = static_cast<long long>(nblocks) * kThreads;
    int4* buf0 = reinterpret_cast<int4*>(p.bufs);
    for (long long i = bid * kThreads + tid; i < total; i += step) {
      const int ch = static_cast<int>(i % chunks);
      const long long pix = i / chunks;
      const int wp = static_cast<int>(pix % wp_n), hp = static_cast<int>(pix / wp_n);
      const long long src = static_cast<long long>(pad_src(hp, p.eh)) * p.ew + pad_src(wp, p.ew);
      buf0[i] = p.x[src * chunks + ch];
    }
    fence_proxy_global();
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    grid_arrive(p.count);  // barrier 0: buffer 0 is whole
  }

  // 3. int8: each raw weight tile -> its K-major resident tile (warps 0-2)
  if constexpr (!BF16) {
    for (int r = 0; r * S < KT; ++r) {
      if (r > 0 && tid == 0) load_w_round(r);  // the ring is free again (the __syncthreads below)
      mbar_wait(wbar, r & 1);
      if (tid < kTransposers)
        for (int j = r * S; j < min(KT, r * S + S); ++j)
          transpose_stage<kBn, false>(smem_u32(ring + (j - r * S) * kStageBytes),
                                      smem_u32(bres + j * kStageBytes), tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
  } else {
    mbar_wait(wbar, 0);
  }

  const int wgi = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  if (wgi == 0) {
    // 4. the producer: step s's tap boxes from buffer s % 2, once barrier s
    // (buffer s % 2 whole in every block) has completed
    if (tid == 0) {
      int it = 0;  // stages since the launch began: the ring's phases run on across steps
      for (int s = 0; s < p.iters; ++s) {
        grid_wait(p.count, barrier_target(p.base, s, nblocks));
        fence_proxy_global();
        const CUtensorMap* map = (s & 1) ? &map_x1 : &map_x0;
        for (int j = 0; j < KT; ++j, ++it) {
          const int slot = it % S, tap = stage_tap(j, cpt);
          mbar_wait(empty + slot, ((it / S) & 1) ^ 1);
          mbar_expect_tx(full + slot, kStageBytes);
          tma_3d(ring + slot * kStageBytes, map, full + slot, stage_chunk(j, cpt) * (kStageK / es),
                 w0 + tap % 3, h0 + tap / 3);
        }
      }
    }
    return;
  }

  // 5. the consumer warpgroup: wgmma on each landed tap box and its resident
  // B tile; the write-back into buffer (s + 1) % 2 and its halo; then
  // barrier s + 1
  const int ctid = tid - 128;
  int it = 0;
  uint32_t d[kBn / 2];
  for (int s = 0; s < p.iters; ++s) {
#pragma unroll
    for (int r = 0; r < kBn / 2; ++r) d[r] = 0;
    for (int j = 0; j < KT; ++j, ++it) {
      const int slot = it % S;
      mbar_wait(full + slot, (it / S) & 1);
      const uint64_t da = make_desc(ring + slot * kStageBytes, 16, kSbo);
      const uint64_t db = make_desc(bres + j * kStageBytes, BF16 ? kMnLbo : 16, kSbo);
      fence_acc(d);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kStageK / kKStep; ++ks)
        wgmma<kBn, BF16>(d, da + ((ks * kKStep) >> 4),
                         db + (((BF16 ? kMnKStep : kKStep) * ks) >> 4));
      wgmma_commit();
      fence_acc(d);
      wgmma_wait<1>();  // the group of stage it - 1 is done: hand that stage back
      fence_acc(d);
      if (j > 0) mbar_arrive(empty + (it - 1) % S);
    }
    wgmma_wait<0>();
    fence_acc(d);
    mbar_arrive(empty + (it - 1) % S);

#pragma unroll
    for (int j = 0; j < kBn / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 2 * h;
        *reinterpret_cast<uint2*>(ct + acc_row(warp, lane, i) * kCs + acc_col(j, lane, i)) =
            make_uint2(d[4 * j + i], d[4 * j + i + 1]);
      }
    asm volatile("bar.sync 1, 128;\n" ::: "memory");
    uint8_t* dst = p.bufs + ((s & 1) ? 0 : plane);  // step s writes buffer (s + 1) % 2
    const bool last = s + 1 == p.iters;
    for (int idx = ctid; idx < 64 * (kBn / 4); idx += 128) {
      const int r = idx / (kBn / 4), c4 = 4 * (idx % (kBn / 4));
      const int h = h0 + r / kPatch, w = w0 + r % kPatch;
      float f[4];
      uint2 x2;
      unsigned x1;
      write_back4<BF16>(reinterpret_cast<const AccT*>(ct + r * kCs + c4), f, x2, x1);
      const int hs[2] = {h + 1, halo_copy(h, p.eh)}, ws[2] = {w + 1, halo_copy(w, p.ew)};
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          if (hs[a] < 0 || ws[b] < 0) continue;
          const size_t o = (static_cast<size_t>(hs[a]) * (p.ew + 2) + ws[b]) * p.c + n0 + c4;
          if constexpr (BF16)
            *reinterpret_cast<uint2*>(dst + 2 * o) = x2;
          else
            *reinterpret_cast<unsigned*>(dst + o) = x1;
        }
      if (last)
        *reinterpret_cast<float4*>(p.out_f32 + (static_cast<size_t>(h) * p.ew + w) * p.c + n0 +
                                   c4) = make_float4(f[0], f[1], f[2], f[3]);
    }
    if (!last) {
      fence_proxy_global();
      asm volatile("bar.sync 1, 128;\n" ::: "memory");  // also: ct is free again
      if (ctid == 0) {
        __threadfence();
        grid_arrive(p.count);  // barrier s + 1: this block's part of buffer (s + 1) % 2 is written
      }
    }
  }
}

}  // namespace conv

namespace unpack {

constexpr int kThreads = 256;
constexpr int kRun = 16;         // output columns (words) a thread takes at once
constexpr int kBlocksPerSm = 8;

// The word column whose bytes land in output column c (roll in [0, n)).
__host__ __device__ __forceinline__ int src_col(int c, int roll, int n) {
  return c >= roll ? c - roll : c - roll + n;
}

// o[b] = byte b of x, y, z and w, in that order: a 32-bit word of output row b.
__device__ __forceinline__ void byte_rows(uint32_t x, uint32_t y, uint32_t z, uint32_t w,
                                          uint32_t (&o)[4]) {
  const uint32_t xy01 = __byte_perm(x, y, 0x5140), zw01 = __byte_perm(z, w, 0x5140);
  const uint32_t xy23 = __byte_perm(x, y, 0x7362), zw23 = __byte_perm(z, w, 0x7362);
  o[0] = __byte_perm(xy01, zw01, 0x5410);
  o[1] = __byte_perm(xy01, zw01, 0x7632);
  o[2] = __byte_perm(xy23, zw23, 0x5410);
  o[3] = __byte_perm(xy23, zw23, 0x7632);
}

// n % 16 == 0: runs of 16 columns (see the note above); D = (-roll) mod 4.
template <int D>
__global__ void __launch_bounds__(kThreads)
    probe_unpack_runs_kernel(const uint4* __restrict__ words, uint4* __restrict__ out, int m,
                             int n, int roll) {
  constexpr int G = D ? 5 : 4;  // 16-byte groups a run reads
  const int groups = n / 4, runs = n / kRun, total = m * runs;
  for (int u = blockIdx.x * kThreads + threadIdx.x; u < total; u += gridDim.x * kThreads) {
    const int r = u / runs, c0 = (u - r * runs) * kRun;
    const int q = src_col(c0, roll, n) / 4;  // the run's first group
    const uint4* row = words + static_cast<size_t>(r) * groups;
    uint32_t v[4 * G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const uint4 x = __ldg(row + (q + g < groups ? q + g : q + g - groups));
      v[4 * g] = x.x;
      v[4 * g + 1] = x.y;
      v[4 * g + 2] = x.z;
      v[4 * g + 3] = x.w;
    }
    uint32_t o[4][4];  // o[j][b]: columns c0 + 4 j .. c0 + 4 j + 3 of row 4 r + b
#pragma unroll
    for (int j = 0; j < 4; ++j)
      byte_rows(v[D + 4 * j], v[D + 4 * j + 1], v[D + 4 * j + 2], v[D + 4 * j + 3], o[j]);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[((4 * static_cast<size_t>(r) + b) * n + c0) / 16] =
          make_uint4(o[0][b], o[1][b], o[2][b], o[3][b]);
  }
}

// Any n: a word a thread, four byte stores.
__global__ void __launch_bounds__(kThreads)
    probe_unpack_words_kernel(const int* __restrict__ words, int8_t* __restrict__ out, int m,
                              int n, int roll) {
  const long long total = static_cast<long long>(m) * n;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int r = static_cast<int>(i / n), c = static_cast<int>(i - static_cast<long long>(r) * n);
    const unsigned w =
        static_cast<unsigned>(__ldg(words + static_cast<size_t>(r) * n + src_col(c, roll, n)));
#pragma unroll
    for (int b = 0; b < 4; ++b)
      out[(4 * static_cast<size_t>(r) + b) * n + c] = static_cast<int8_t>((w >> (8 * b)) & 0xffu);
  }
}

}  // namespace unpack

// Encodes the three tensor maps and launches probe_conv_run_kernel
// cooperatively: all blocks resident, or the launch is refused.
template <bool BF16>
cudaError_t launch_conv_run(const conv::Args& p, const void* w, cudaStream_t s) {
  constexpr int es = BF16 ? 2 : 1;
  const cuuint64_t c = static_cast<cuuint64_t>(p.c);
  const cuuint64_t dims[3] = {c, static_cast<cuuint64_t>(p.ew + 2),
                             static_cast<cuuint64_t>(p.eh + 2)};
  const cuuint64_t strides[2] = {c * es, c * es * (p.ew + 2)};
  const cuuint32_t box[3] = {wg::kStageK / es, conv::kPatch, conv::kPatch};
  const size_t plane = static_cast<size_t>(p.eh + 2) * (p.ew + 2) * p.c * es;
  CUtensorMap m0, m1, mw;
  bool ok = wg::encode(&m0, BF16, 3, p.bufs, dims, strides, box, true) &&
            wg::encode(&m1, BF16, 3, p.bufs + plane, dims, strides, box, true);
  const cuuint64_t w_dims[2] = {c, 9 * c}, w_strides[1] = {c * es};
  const cuuint32_t w_box[2] = {conv::kBn, BF16 ? 64u : static_cast<cuuint32_t>(wg::kStageK)};
  ok = ok && wg::encode(&mw, BF16, 2, w, w_dims, w_strides, w_box, BF16);
  if (!ok) return cudaErrorInvalidValue;
  const int bytes = conv::smem_bytes(p.c, es);
  // the shared-memory limit is set once per kernel (on the current device)
  static const cudaError_t attr =
      cudaFuncSetAttribute(conv::probe_conv_run_kernel<BF16>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, conv::kSmemLimit);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.c / conv::kBn, p.ew / conv::kPatch, p.eh / conv::kPatch);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv::probe_conv_run_kernel<BF16>,
                                                        conv::kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (static_cast<long long>(grid.x) * grid.y * grid.z > static_cast<long long>(per_sm) * sms)
    return cudaErrorInvalidValue;  // not every block could be resident
  conv::Args args = p;
  void* params[] = {&m0, &m1, &mw, &args};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(conv::probe_conv_run_kernel<BF16>), grid,
      dim3(conv::kThreads), params, bytes, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The 128 x 256 tile where it gives every SM a block, else 64 x 64.
bool use_big(const Args& p) {
  return p.n % BigTile::BN == 0 &&
         static_cast<long long>((p.m + BigTile::BM - 1) / BigTile::BM) * (p.n / BigTile::BN) >= kSms;
}

template <bool BF16, bool PLANES, int EPI>
cudaError_t gemm_launch(const Args& p, cudaStream_t s) {
  if (!use_big(p)) return wg::launch<SmallTile, BF16, PLANES, EPI>(p, s);
  if constexpr (BF16)
    return wg::launch<BigTileBf16, BF16, PLANES, EPI>(p, s);
  else
    return wg::launch<BigTile, BF16, PLANES, EPI>(p, s);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

extern "C" {

// a: (m, k), b: (k, n), both int8 (in_bf16 = 0) or bf16, row-major.
// epilogue 0: out = int32 (m, n) (int8 only); 1: out = float32 (m, n);
// 2: the conv probe's write-back, each result row to rep consecutive rows
// of out_x ((m * rep, n), the input type) and / or out_f32 (float32).
// Needs k * element bytes % 64 == 0, n % 64 == 0 and 16-byte aligned pointers.
int probe_gemm(const void* a, const void* b, void* out, void* out_x, void* out_f32, int m, int n,
               int k, int in_bf16, int epilogue, int rep, void* stream) {
  const int es = in_bf16 ? 2 : 1;
  if (m < 1 || n < 1 || k < 1 || (k * es) % kKBytes || n % SmallTile::BN || rep < 1 ||
      epilogue < EPI_S32 || epilogue > EPI_WB || (in_bf16 && epilogue == EPI_S32) ||
      (epilogue == EPI_WB ? !out_x && !out_f32 : !out) || !aligned16(a) || !aligned16(b) ||
      !aligned16(out) || !aligned16(out_x) || !aligned16(out_f32))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), m, n, k,
         out, out_x, static_cast<float*>(out_f32), rep};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (in_bf16)
    err = epilogue == EPI_F32 ? gemm_launch<true, false, EPI_F32>(p, s)
                              : gemm_launch<true, false, EPI_WB>(p, s);
  else
    err = epilogue == EPI_S32   ? gemm_launch<false, false, EPI_S32>(p, s)
          : epilogue == EPI_F32 ? gemm_launch<false, false, EPI_F32>(p, s)
                                : gemm_launch<false, false, EPI_WB>(p, s);
  return static_cast<int>(err);
}

// The conv probe, all `iters` steps in one launch: x (eh, ew, c) ->
// out_f32 (eh, ew, c), the tile after the last step in float32; bufs holds
// two padded tiles (eh + 2, ew + 2, c) of x's type, one after the other,
// and after the launch buffer iters % 2 holds that tile in x's type
// (interior [1:-1, 1:-1]). w: (9 c, c), row (3 qy + qx) c + ci. count is
// the grid barrier's word and base its value now; the launch adds
// iters * (c / 64) (ew / 8) (eh / 8) to it. Needs eh, ew % 8 == 0,
// c % 64 == 0, c * element bytes % 128 == 0, the weights resident
// (conv::smem_bytes <= 227 KB: c <= 256 int8, <= 128 bf16), every block
// resident, and 16-byte aligned pointers.
int probe_conv_run(const void* x, const void* w, void* bufs, void* out_f32, void* count,
                   unsigned base, int eh, int ew, int c, int iters, int in_bf16, void* stream) {
  const int es = in_bf16 ? 2 : 1;
  if (eh < conv::kPatch || ew < conv::kPatch || eh % conv::kPatch || ew % conv::kPatch ||
      c < conv::kBn || c % conv::kBn || (c * es) % wg::kStageK || iters < 1 ||
      conv::smem_bytes(c, es) > conv::kSmemLimit || !x || !w || !bufs || !out_f32 || !count ||
      !aligned16(x) || !aligned16(w) || !aligned16(bufs) || !aligned16(out_f32) ||
      (reinterpret_cast<uintptr_t>(count) & 3))
    return static_cast<int>(cudaErrorInvalidValue);
  conv::Args p{static_cast<const int4*>(x), static_cast<uint8_t*>(bufs),
               static_cast<float*>(out_f32), static_cast<unsigned*>(count), base, eh, ew, c,
               iters};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(in_bf16 ? launch_conv_run<true>(p, w, s)
                                  : launch_conv_run<false>(p, w, s));
}

// out[4 r + b, c] = byte b of words[r, (c - roll) mod n]: words (m, n) int32,
// out (4 m, n) int8. Needs m n < 2^31 and 16-byte aligned pointers.
int probe_unpack_words(const void* words, void* out, int m, int n, int roll, void* stream) {
  using namespace unpack;
  if (m < 1 || n < 1 || static_cast<long long>(m) * n > 0x7fffffffLL || !aligned16(words) ||
      !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  roll = ((roll % n) + n) % n;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool runs = n % kRun == 0;
  const long long work = static_cast<long long>(m) * (runs ? n / kRun : n);
  const int blocks =
      static_cast<int>(std::min<long long>((work + kThreads - 1) / kThreads, sms * kBlocksPerSm));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!runs) {
    probe_unpack_words_kernel<<<blocks, kThreads, 0, s>>>(static_cast<const int*>(words),
                                                          static_cast<int8_t*>(out), m, n, roll);
  } else {
    // the kernel of D = (-roll) mod 4
    void (*const by_d[4])(const uint4*, uint4*, int, int, int) = {
        probe_unpack_runs_kernel<0>, probe_unpack_runs_kernel<1>, probe_unpack_runs_kernel<2>,
        probe_unpack_runs_kernel<3>};
    by_d[(n - roll) % 4]<<<blocks, kThreads, 0, s>>>(static_cast<const uint4*>(words),
                                                      static_cast<uint4*>(out), m, n, roll);
  }
  return static_cast<int>(cudaGetLastError());
}

// P3 whole: out (4 m, p) int32, out[4 r + b, c] = sum over j of byte b of
// words[r, (j - roll) mod n] * w[j, c], exactly; words (m, n) int32, w (n,
// p) int8. Needs n % 64 == 0, p % 64 == 0, 4 m within the grid (4 m <=
// 64 x 65535) and 16-byte aligned pointers.
int probe_bitcast_dot(const void* words, const void* w, void* out, int m, int n, int p, int roll,
                      void* stream) {
  if (m < 1 || n < 1 || p < 1 || n % kKBytes || p % SmallTile::BN ||
      static_cast<long long>(m) * 4 > 64LL * 65535 || !out || !aligned16(words) ||
      !aligned16(w) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const uint8_t*>(words), static_cast<const uint8_t*>(w), 4 * m, p, n,
         out, nullptr, nullptr, 1, ((roll % n) + n) % n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(use_big(a) ? wg::launch_bitcast_dot<BigTile>(a, s)
                                     : wg::launch_bitcast_dot<SmallTile>(a, s));
}

// out (m, n) = sum over b of plane_b(words) * wb[b]: words (m, k_words)
// int32, plane_b[r, j] byte b of word (r, j); wb (4, k_words, n) int8; int32
// out, or float32 when out_f32. Needs 4 k_words % 64 == 0, n % 64 == 0 and
// 16-byte aligned pointers.
int probe_packed_dot(const void* words, const void* wb, void* out, int m, int k_words, int n,
                     int out_f32, void* stream) {
  if (m < 1 || n < 1 || k_words < 1 || (4 * k_words) % kKBytes || n % SmallTile::BN || !out ||
      !aligned16(words) || !aligned16(wb) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const uint8_t*>(words), static_cast<const uint8_t*>(wb), m, n, 4 * k_words,
         out, nullptr, nullptr, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? gemm_launch<false, true, EPI_F32>(p, s)
                                  : gemm_launch<false, true, EPI_S32>(p, s));
}

const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
