// The TPU-compiler probes of the JAX package's tools/ as four kernels for
// Hopper (sm_90a). Each replaces the Pallas kernel(s) of one probe:
//
//   probe_gemm          <- tools/bench_probe_pallas_int8.py:65 (make_mm: a tiled
//                          GEMM, bf16 -> f32, int8 -> s32, int8 -> f32), and the
//                          dot of tools/bench_probe_pallas_conv.py:122's mm
//                          variants (its write-back is a store epilogue here) and
//                          of tools/bench_probe_r3a.py:343
//   probe_conv_step     <- tools/bench_probe_pallas_conv.py:122 (one grid step of
//                          make()'s kernel: a circular 3x3 C -> C conv of the
//                          (E_H, E_W, C) tile with its int8 / bf16 write-back)
//   probe_unpack_words  <- the pltpu.bitcast int32 -> int8 of
//                          tools/bench_probe_r3b.py:82 and r3a.py:343 (with its roll)
//   probe_packed_dot    <- tools/bench_probe_r3b.py:147 / :164 (the byte-plane dot
//                          of packed words with the byte-plane weights, and its
//                          timed form with the f32 cast)
//
// Their plain versions are sesr_tpu_torch/probes/plain.py.
//
// probe_gemm and probe_packed_dot run the wgmma tile of wgmma_gemm.cuh (TMA
// loads, a producer warp and consumer warpgroups; its note says what bounds
// them and what the design does about it).
//
// probe_conv_step runs the mma.sync tile below (conv_tile). A block computes
// a BM x BN tile of the conv as an implicit GEMM: M = E_H * E_W pixels, K = 9
// taps x C channels (a 64-byte k slice lies inside one tap, so a row of A is
// 64 contiguous bytes of the source pixel (h + qy - 1, w + qx - 1), both mod
// the tile), N = C. 64 bytes of K per stage are staged into shared memory
// with cp.async, six stages in flight; each warp computes a 16 x 32 sub-tile
// with mma.sync on the tensor cores:
//   int8  m16n8k32.row.col.s32.s8.s8.s32   (exact int32 sums)
//   bf16  m16n8k16.row.col.f32.bf16.bf16.f32
// A's fragments come from shared memory by ldmatrix.x4 (the int8 and bf16
// fragments of a 32-byte k slice have the same word layout). B is kept as
// it lies in memory, (k, n) rows: a lane reads the words of consecutive k
// rows at one column word and transposes them in registers with byte_perm
// (4 x 4 bytes for int8, 2 x 2 halves for bf16). That makes n-tile t of a
// warp hold columns 4j + t (int8) or 16 (t / 2) + 2j + t % 2 (bf16),
// j = 0..7, which the epilogue undoes: it stages the C tile in shared
// memory and stores rows of 16 bytes. The conv step is operation-bound
// (1,979 int8 TOP/s, 989 bf16 TFLOP/s); mma.sync issues from sm_80 PTX and
// does not reach Hopper's full rate.
//
// One launch is one step; the caller ping-pongs two buffers in device memory
// (the 0.44 / 0.88 MB tile stays in L2, where the TPU kernel kept it in VMEM
// scratch). The TPU probe's concat3 and dot9 forms differ only in how the
// TPU relayouts the rolled copies, so both run this kernel; their weights
// are (9C, C) reshapes of the probe's layouts. The write-back is the
// probe's: int8 clip(acc, -128, 127); bf16 bf16_rn(acc * f32(1e-3)); with
// -fmad=false and an explicit __fmul_rn.
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

#include <type_traits>

#include "wgmma_gemm.cuh"

namespace {

constexpr int kKBytes = 64;                // bytes of K per pipeline stage
constexpr int kAStride = kKBytes / 4 + 4;  // words per A row: ldmatrix without bank conflicts

// WM x WN warps, each a (16 MT) x 32 tile of the output.
template <int MT_, int WM_, int WN_, int STAGES_>
struct Tiling {
  static constexpr int MT = MT_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int kThreads = 32 * WM * WN;
  static constexpr int BM = 16 * MT * WM;
  static constexpr int BN = 32 * WN;
};
// the conv step's tile: 32 x 64 with 6 stages, 216 blocks for the 48 x 72 x 128
// tile (a 64 x 64 tile gives 108 and was slower on the H100)
using ConvTile = Tiling<1, 2, 2, 6>;

// Shared memory of one block, in 32-bit words.
template <class TL, bool BF16>
struct Smem {
  static constexpr int es = BF16 ? 2 : 1;                 // bytes per element
  static constexpr int KB = kKBytes / es;                 // k rows of B per stage
  static constexpr int BS = TL::BN * es / 4 + 4;          // words per B row
  static constexpr int A_WORDS = TL::BM * kAStride;
  static constexpr int STAGE_WORDS = A_WORDS + KB * BS;
  static constexpr int CS = TL::BN + 4;                   // words per row of the C tile
  static constexpr int PIPE_WORDS = STAGE_WORDS * TL::STAGES;
  static constexpr int C_WORDS = TL::BM * CS;
  static constexpr int WORDS = PIPE_WORDS > C_WORDS ? PIPE_WORDS : C_WORDS;
};

// The GEMM tiles (wgmma_gemm.cuh): 128 x 256 with two consumer warpgroups
// where that still fills the card, else 64 x 64 with one.
using BigTile = wg::Tile<2, 256, 3>;    // int8: 3 stages + 2 K-major B tiles
using BigTileBf16 = wg::Tile<2, 256, 4>;
using SmallTile = wg::Tile<1, 64, 4>;
constexpr int kSms = 132;               // the H100's SMs

// 16 bytes from device to shared memory; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const int* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// c += A (16x32 s8, row) * B (32x8 s8, col), exact in int32.
__device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A (16x16 bf16, row) * B (16x8 bf16, col), in float32.
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One stage: A (BM rows x 64 bytes, the conv's circular taps) and B (KB rows
// x BN columns) of k slice kt.
template <class TL, bool BF16>
__device__ __forceinline__ void load_stage(int* st, const Args& p, int m0, int n0, int kt) {
  using S = Smem<TL, BF16>;
  const int kb = kt * kKBytes;  // byte offset along k
  for (int i = threadIdx.x; i < TL::BM * 4; i += TL::kThreads) {
    const int r = i >> 2, ch = i & 3;
    const int m = m0 + r;
    const bool ok = m < p.m;
    const uint8_t* src = p.a;
    if (ok) {
      // pixel m reads tap (qy, qx) at ((h + qy - 1) mod eh, (w + qx - 1) mod ew)
      const int cb = p.c * S::es;
      const int tap = kb / cb;
      const int h = m / p.ew, w = m - h * p.ew;
      int sh = h + tap / 3 - 1, sw = w + tap % 3 - 1;
      sh += sh < 0 ? p.eh : (sh >= p.eh ? -p.eh : 0);
      sw += sw < 0 ? p.ew : (sw >= p.ew ? -p.ew : 0);
      src = p.a + (static_cast<size_t>(sh) * p.ew + sw) * cb + (kb - tap * cb) + 16 * ch;
    }
    cp_async16(st + r * kAStride + 4 * ch, src, ok);
  }
  constexpr int CPR = TL::BN * S::es / 16;  // 16-byte chunks per B row
  const size_t ldb = static_cast<size_t>(p.n) * S::es;
  const uint8_t* b0 = p.b + static_cast<size_t>(kt) * S::KB * ldb + static_cast<size_t>(n0) * S::es;
  int* sb = st + S::A_WORDS;
  for (int i = threadIdx.x; i < S::KB * CPR; i += TL::kThreads) {
    const int r = i / CPR, ch = i - r * CPR;
    cp_async16(sb + r * S::BS + 4 * ch, b0 + r * ldb + 16 * ch, true);
  }
}

// B registers (b0, b1) of this lane for the warp's four n-tiles, 32-byte k
// step ks. int8: words of rows 4 tq + i (i = 0..3) at column word g,
// transposed 4 x 4 by bytes; byte t of word i is column 4g + t at k 4 tq + i.
// bf16: words of rows 2 tq, 2 tq + 1 at column words g and 8 + g, transposed
// 2 x 2 by halves.
template <bool BF16>
__device__ __forceinline__ void load_b(unsigned (&b)[4][2], const int* sb, int bs, int ks, int wn,
                                       int g, int tq) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if constexpr (!BF16) {
      const int* p = sb + (ks * 32 + 16 * half + 4 * tq) * bs + wn * 8 + g;
      const unsigned w0 = p[0], w1 = p[bs], w2 = p[2 * bs], w3 = p[3 * bs];
      const unsigned x01 = __byte_perm(w0, w1, 0x5140), x23 = __byte_perm(w2, w3, 0x5140);
      const unsigned y01 = __byte_perm(w0, w1, 0x7362), y23 = __byte_perm(w2, w3, 0x7362);
      b[0][half] = __byte_perm(x01, x23, 0x5410);
      b[1][half] = __byte_perm(x01, x23, 0x7632);
      b[2][half] = __byte_perm(y01, y23, 0x5410);
      b[3][half] = __byte_perm(y01, y23, 0x7632);
    } else {
#pragma unroll
      for (int grp = 0; grp < 2; ++grp) {
        const int* p = sb + (ks * 16 + 8 * half + 2 * tq) * bs + wn * 16 + grp * 8 + g;
        const unsigned w0 = p[0], w1 = p[bs];
        b[2 * grp][half] = __byte_perm(w0, w1, 0x5410);
        b[2 * grp + 1][half] = __byte_perm(w0, w1, 0x7632);
      }
    }
  }
}

// The column, within the warp's 32, of logical column lc of n-tile t.
template <bool BF16>
__device__ __forceinline__ int real_col(int t, int lc) {
  return BF16 ? 16 * (t >> 1) + 2 * lc + (t & 1) : 4 * lc + t;
}

// The conv step: C tile (BM x BN) of the implicit GEMM, with the write-back.
template <class TL, bool BF16>
__device__ __forceinline__ void conv_tile(const Args& p) {
  using S = Smem<TL, BF16>;
  using AccT = typename std::conditional<BF16, float, int>::type;
  extern __shared__ int4 smem4[];
  int* smem = reinterpret_cast<int*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / TL::WN, wn = warp % TL::WN;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = blockIdx.y * TL::BM, n0 = blockIdx.x * TL::BN;
  const int KT = p.k * S::es / kKBytes;

  AccT acc[TL::MT][4][4];
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0;

#pragma unroll
  for (int s = 0; s < TL::STAGES - 1; ++s) {
    if (s < KT) load_stage<TL, BF16>(smem + s * S::STAGE_WORDS, p, m0, n0, s);
    cp_commit();
  }
  // ldmatrix row of this lane: matrices (rows 0-7 | 8-15) x (bytes 0-15 | 16-31)
  const int a_row = wm * TL::MT * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_col = 4 * (lane >> 4);
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<TL::STAGES - 2>();
    __syncthreads();  // stage kt has landed, and every warp is done with kt - 1
    const int nk = kt + TL::STAGES - 1;
    if (nk < KT) load_stage<TL, BF16>(smem + (nk % TL::STAGES) * S::STAGE_WORDS, p, m0, n0, nk);
    cp_commit();
    const int* st = smem + (kt % TL::STAGES) * S::STAGE_WORDS;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      unsigned a[TL::MT][4];
#pragma unroll
      for (int mt = 0; mt < TL::MT; ++mt)
        ldmatrix_x4(a[mt], st + (a_row + 16 * mt) * kAStride + 8 * ks + a_col);
      unsigned b[4][2];
      load_b<BF16>(b, st + S::A_WORDS, S::BS, ks, wn, g, tq);
#pragma unroll
      for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }
  cp_wait<0>();
  __syncthreads();

  // epilogue: fragments -> C tile in shared memory -> rows of 16 bytes
  AccT* ct = reinterpret_cast<AccT*>(smem);
#pragma unroll
  for (int mt = 0; mt < TL::MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = wm * TL::MT * 16 + 16 * mt + g + 8 * (i >> 1);
        const int col = wn * 32 + real_col<BF16>(nt, 2 * tq + (i & 1));
        ct[row * S::CS + col] = acc[mt][nt][i];
      }
  __syncthreads();
  for (int i = threadIdx.x; i < TL::BM * TL::BN / 4; i += TL::kThreads) {
    const int r = i / (TL::BN / 4), c4 = 4 * (i - r * (TL::BN / 4));
    if (m0 + r < p.m) store4<BF16, EPI_WB>(p, m0 + r, n0 + c4, ct + r * S::CS + c4);
  }
}

template <class TL, bool BF16>
__global__ void __launch_bounds__(TL::kThreads) probe_conv_step_kernel(Args p) {
  conv_tile<TL, BF16>(p);
}

__global__ void __launch_bounds__(256)
probe_unpack_words_kernel(const int* __restrict__ words, int8_t* __restrict__ out, int m, int n,
                          int roll) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m * n) return;
  const int r = i / n, c = i - r * n;
  const int src = c >= roll ? c - roll : c - roll + n;  // roll in [0, n)
  const unsigned w = static_cast<unsigned>(__ldg(words + static_cast<size_t>(r) * n + src));
#pragma unroll
  for (int b = 0; b < 4; ++b)
    out[(4 * static_cast<size_t>(r) + b) * n + c] = static_cast<int8_t>((w >> (8 * b)) & 0xffu);
}

template <bool BF16>
cudaError_t launch_conv(const Args& p, cudaStream_t s) {
  const size_t bytes = sizeof(int) * static_cast<size_t>(Smem<ConvTile, BF16>::WORDS);
  cudaError_t err = cudaFuncSetAttribute(probe_conv_step_kernel<ConvTile, BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n / ConvTile::BN, (p.m + ConvTile::BM - 1) / ConvTile::BM);
  probe_conv_step_kernel<ConvTile, BF16><<<grid, ConvTile::kThreads, bytes, s>>>(p);
  return cudaGetLastError();
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
  Args p{static_cast<const uint8_t*>(a), static_cast<const uint8_t*>(b), m, n, k, 0, 0, 0,
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

// One step of the conv probe: x (eh, ew, c) -> its write-back into out_x
// (same shape and type) and / or out_f32; w: (9 c, c), row (3 qy + qx) c + ci.
// out_x must not alias x. Needs c * element bytes % 64 == 0 and c % 64 == 0.
int probe_conv_step(const void* x, const void* w, void* out_x, void* out_f32, int eh, int ew,
                    int c, int in_bf16, void* stream) {
  const int es = in_bf16 ? 2 : 1;
  if (eh < 1 || ew < 1 || c < 1 || (c * es) % kKBytes || c % ConvTile::BN ||
      (!out_x && !out_f32) || out_x == x)
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w), eh * ew, c, 9 * c, eh, ew,
         c, nullptr, out_x, static_cast<float*>(out_f32), 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(in_bf16 ? launch_conv<true>(p, s) : launch_conv<false>(p, s));
}

// out[4 r + b, c] = byte b of words[r, (c - roll) mod n]: words (m, n) int32,
// out (4 m, n) int8.
int probe_unpack_words(const void* words, void* out, int m, int n, int roll, void* stream) {
  if (m < 1 || n < 1 || static_cast<long long>(m) * n > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  roll = ((roll % n) + n) % n;
  const int threads = 256;
  const int blocks = static_cast<int>((static_cast<long long>(m) * n + threads - 1) / threads);
  probe_unpack_words_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(words), static_cast<int8_t*>(out), m, n, roll);
  return static_cast<int>(cudaGetLastError());
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
         0, 0, 0, out, nullptr, nullptr, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? gemm_launch<false, true, EPI_F32>(p, s)
                                  : gemm_launch<false, true, EPI_S32>(p, s));
}

const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
