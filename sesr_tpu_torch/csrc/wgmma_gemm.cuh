// The probes' GEMM tile for Hopper (sm_90a): wgmma on shared-memory operands
// that TMA loads into a ring of stages, one producer warp and one or two
// consumer warpgroups per block. It replaces these TPU kernels:
//
//   P2      tools/bench_probe_pallas_int8.py:65 (make_mm: a tiled GEMM, bf16 -> f32,
//           int8 -> s32, int8 -> f32), through probe_gemm
//   P1 mm   the dot of tools/bench_probe_pallas_conv.py:122's mm variants, with
//           the probe's write-back as an epilogue (EPI_WB), through probe_gemm
//   P3      tools/bench_probe_r3a.py:343 (a roll of int32 words, their bitcast
//           to int8 rows and an exact int8 dot), whole, through
//           probe_bitcast_dot (words_tile)
//   P5, P6  tools/bench_probe_r3b.py:147 / :164 (the byte-plane dot of packed
//           words, and its timed form with the f32 cast), through probe_packed_dot
//
// What bounds them on the H100: at 4096^3 the operations (1,979 int8 TOP/s,
// 989 bf16 TFLOP/s); on the small dots (P1 mm 384 x 1152 x 128, P3 1024 x 128 x
// 256, P5 1024 x 512 x 128) a launch: their bytes take a third of a
// microsecond. Only wgmma reaches the tensor cores' full rate on this card, and
// it reads its operands from shared memory through a descriptor, so the design
// is: a block computes a BM x BN tile of C = A * B, BM = 64 per consumer
// warpgroup; warp 0 (one lane) keeps TMA loads of 128 bytes of K per stage in
// flight, completing on "full" mbarriers; the consumers issue wgmma
// (m64nBNk32.s32.s8.s8, exact in int32; m64nBNk16.f32.bf16.bf16) on a stage
// once it has landed, keep one group of them in flight, and hand the stage
// back through its "empty" mbarrier. Tiles by shape (probes.cu): 128 x 256 with
// two consumer warpgroups where that still fills the card's 132 SMs (4096^3:
// 512 blocks), else 64 x 64 with one (P5: 32 blocks; P3: 64; the mm step: 12).
//
// Operands in shared memory, each 128 bytes of K (or of N) a row in the
// 128-byte swizzle that TMA writes and the descriptors read (swizzle128):
//   A      (BM rows, K-major): TMA box (128 bytes of K, BM rows).
//   B bf16 B is (K, N) row-major, N-major: TMA boxes (64 columns, 64 k rows),
//          one per 64 columns; the descriptor reads it transposed (MN-major:
//          LBO = one box between 64-column groups, SBO = 8 k rows).
//   B int8 wgmma takes 8-bit operands K-major only, and ldmatrix.trans is b16
//          only. So B lands unswizzled as it lies, (128 k rows, BN bytes),
//          and warps 1-3 turn each stage into the K-major tile (BN rows of
//          128 bytes of K) the descriptor reads: a thread reads 8 bytes of 16
//          k rows, transposes them 4 x 4 by bytes with __byte_perm, and
//          stores the 16 k bytes of each of its 8 columns as one 16-byte
//          chunk (item_kc keeps the stores free of bank conflicts); then
//          fence.proxy.async before wgmma reads it. That tile has its own
//          ring (TRING stages, "tfull" / "tempty" barriers). The pass moves
//          each B byte through shared memory twice more, and at 4096^3 it
//          costs 40 % of the time (the tile without it, wrong but timed:
//          0.119 against 0.165 ms on the H100); shared memory's bandwidth,
//          not the instructions, bounds it.
//   planes probe_packed_dot's B is the byte planes wb (4, K / 4, N): row
//          k = 4 j + b of B is row j of plane b. A 3-D box (BN, 32, 4) loads
//          the stage's rows of all four planes; the transposing pass reads
//          row k from plane b (b_row), so four plane rows j at one column
//          make one 32-bit word of K-major B. The packed words are, unchanged,
//          the int8 A operand (byte b of word j is k = 4 j + b).
//   words  probe_bitcast_dot (words_tile) computes P3 in one launch:
//          out[4 m + b, p] = sum_n byte b of words[m, (n - roll) mod N] *
//          w[n, p] = sum_j byte b of words[m, j] * w[(j + roll) mod N, p].
//          So K is the word column j, A row 4 m + b holds byte b of word
//          row m, and the roll moves onto B's rows (b_src_row): no rolled or
//          unpacked copy of either operand exists. The unpack through device
//          memory that it replaces (probe_unpack_words, then probe_gemm)
//          wrote and read A, four bytes for each word byte: 128 MiB more at
//          (4096, 4096) words.
//          A: TMA lands each stage's words as four boxes of 32 words (128
//          bytes, BM / 4 word rows, swizzled): box ks is the k32 step ks.
//          The consumers take A from registers (wgmma's A may lie there),
//          not through a K-major A tile in shared memory: a transposing pass
//          like B's costs two more trips of every byte through shared memory,
//          and B's pass already bounds the tile. The rows of a 64-row wgmma
//          tile are ours to order (the epilogue puts them back): fragment
//          row g (+ 8 h) of warp w holds word row a_word_row(w, g) and byte
//          a_word_byte(w, h), so a thread's two rows are two bytes of one
//          word row, and each of its 16-byte loads of four words gives two
//          registers after four __byte_perm (load_a_words). a_word_row puts
//          a quarter warp's two word rows four swizzle chunks apart: its
//          16-byte loads are free of bank conflicts. Each k32 step loads its
//          registers, fences, issues its wgmma and waits for the previous
//          one, two register sets in turn, so that at most two wgmmas are in
//          flight a warpgroup and none of their registers is rewritten.
//          B: the box of stage i lands from w's row b_src_row(128 i, roll,
//          N); rows past N come zero-filled, and the transposing pass reads
//          those (the wrap, in one stage) from device memory instead
//          (b_src_row again). k32 steps past N (N % 128 == 64) are skipped.
//          What the A/B (python -m sesr_tpu_torch.probes.tile_ab --tile
//          bitcast, H100 80GB HBM3 at 700 W, words (4096, 4096) x w (4096,
//          1024)) found: 0.196 ms, against 0.166 for probe_gemm on the
//          unpacked operand. The 128 x 256 tile's 168 registers a thread
//          leave too few beside its 128 accumulators, and ptxas serializes
//          its wgmmas (C7512): one register set times the same (0.197), and
//          setmaxnreg (208 a consumer thread) leaves the serialization and
//          gains 1.5 % (0.193), so it is not used; 128 x 128 tiles, with no
//          such shortage, take 0.260 (A's loads per operation double). A
//          test for the wrap on every row, not once a stage, kept the
//          pass's row loads from issuing together: 0.358. A K-major A tile
//          in shared memory (the descriptor path) would add two trips of
//          every A byte through shared memory, which B's pass and wgmma's B
//          reads already bound.
// gemm_tile does not use setmaxnreg: 384 threads leave each 168
// registers, and its consumers need 156 with their 128 accumulators.
// TMA zero-fills rows past M and K; the epilogue masks rows past M. The
// accumulator fragments go to shared memory (acc_row / acc_col), then rows
// of 16 bytes to device memory in one of three epilogues: s32, f32, or the
// conv probe's write-back (int8 clip(acc, -128, 127); bf16 bf16_rn(acc *
// f32(1e-3)) with an explicit __fmul_rn under -fmad=false), each result row
// to rep consecutive rows.
//
// The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
// reached through cudaGetDriverEntryPoint (no -lcuda), cached by what they
// encode (encode), and passed as __grid_constant__ kernel parameters.
// tests/test_torch_wgmma_layout.py models swizzle128, the descriptors'
// addressing, the transposing pass, b_row, the fragment map and the words
// tile's A fragments, rows and rolled B rows in numpy, reading them from
// this file.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <type_traits>

namespace {

enum Epi { EPI_S32 = 0, EPI_F32 = 1, EPI_WB = 2 };

struct Args {
  const uint8_t* a;   // (m, k) row-major; words_tile: the words (m / 4, k) int32
  const uint8_t* b;   // (k, n) row-major; probe_packed_dot: wb (4, k / 4, n)
  int m, n, k;        // in elements
  void* out;          // EPI_S32 / EPI_F32: (m, n)
  void* out_x;        // EPI_WB: (m * rep, n) in the input type, or null
  float* out_f32;     // EPI_WB: (m * rep, n) float copy, or null
  int rep;            // EPI_WB: each result row goes to rep consecutive rows
  int roll = 0;       // words_tile: B row of k = j is w's row (j + roll) mod k, roll in [0, k)
};

__device__ __forceinline__ float to_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float to_f32(float v) { return v; }

// The conv probe's write-back of four consecutive results: their values in
// x's type as bytes (bf16: x2; int8: x1) and as floats (f).
template <bool BF16, class AccT>
__device__ __forceinline__ void write_back4(const AccT* v, float (&f)[4], uint2& x2, unsigned& x1) {
  x2 = make_uint2(0, 0);
  x1 = 0;
  if constexpr (BF16) {
    unsigned short h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16 q = __float2bfloat16_rn(__fmul_rn(v[j], 1e-3f));
      f[j] = __bfloat162float(q);
      h[j] = __bfloat16_as_ushort(q);
    }
    x2 = make_uint2(h[0] | (static_cast<unsigned>(h[1]) << 16),
                    h[2] | (static_cast<unsigned>(h[3]) << 16));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = min(max(v[j], -128), 127);
      f[j] = static_cast<float>(q);
      x1 |= (static_cast<unsigned>(q) & 0xffu) << (8 * j);
    }
  }
}

// Four consecutive results (row m, columns n .. n + 3) to device memory.
template <bool BF16, int EPI, class AccT>
__device__ __forceinline__ void store4(const Args& p, int m, int n, const AccT* v) {
  if constexpr (EPI == EPI_S32) {
    *reinterpret_cast<int4*>(static_cast<int*>(p.out) + static_cast<size_t>(m) * p.n + n) =
        make_int4(v[0], v[1], v[2], v[3]);
  } else if constexpr (EPI == EPI_F32) {
    *reinterpret_cast<float4*>(static_cast<float*>(p.out) + static_cast<size_t>(m) * p.n + n) =
        make_float4(to_f32(v[0]), to_f32(v[1]), to_f32(v[2]), to_f32(v[3]));
  } else {
    // the probe's write-back, then each result row to rep consecutive rows
    float f[4];
    uint2 x2;
    unsigned x1;
    write_back4<BF16>(v, f, x2, x1);
    for (int r = 0; r < p.rep; ++r) {
      const size_t o = (static_cast<size_t>(m) * p.rep + r) * p.n + n;
      if (p.out_x) {
        if constexpr (BF16)
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out_x) + o) = x2;
        else
          *reinterpret_cast<unsigned*>(static_cast<int8_t*>(p.out_x) + o) = x1;
      }
      if (p.out_f32) *reinterpret_cast<float4*>(p.out_f32 + o) = make_float4(f[0], f[1], f[2], f[3]);
    }
  }
}

namespace wg {

constexpr int kStageK = 128;    // bytes of K per stage (one 128-byte swizzle row)
constexpr int kSbo = 1024;      // descriptor SBO: 8 rows of 128 bytes
constexpr int kKStep = 32;      // K-major: bytes of K per wgmma (k32 int8, k16 bf16)
constexpr int kMnLbo = 8192;    // MN-major bf16 B: one (64 k x 64 n) box per 64 columns
constexpr int kMnKStep = 2048;  // MN-major: 16 k rows of 128 bytes per wgmma
constexpr int kTransposers = 96;  // warps 1-3 of the producer warpgroup (int8)

// Byte offset of 16-byte chunk `chunk` of 128-byte row `row` in a tile whose
// base is 1024-byte aligned: TMA's CU_TENSOR_MAP_SWIZZLE_128B and the
// descriptors' 128-byte swizzle (address bits 4-6 ^= bits 7-9).
__host__ __device__ __forceinline__ int swizzle128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// The row of an int8 B stage as it lands that holds k (0..127) of the stage:
// dense (k, n) rows, or the 3-D box (4 planes x 32 rows) of the byte planes.
__host__ __device__ __forceinline__ int b_row_dense(int k) { return k; }
__host__ __device__ __forceinline__ int b_row_planes(int k) { return (k & 3) * 32 + (k >> 2); }

// The 16-row k chunk of a stage that the transposing item (kq, c2) takes:
// rotated by its column group c2, so that eight neighbouring lanes store to
// eight distinct chunks of the swizzle (no bank conflicts); its loads stay
// conflict-free, since a landed row is a whole number of 128-byte lines.
__host__ __device__ __forceinline__ int item_kc(int kq, int c2) { return (kq + c2) & 7; }

// wgmma's m64nN accumulator fragment: register 4 j + i of lane `lane` of warp
// `warp` (of the warpgroup) holds C[acc_row][acc_col].
__host__ __device__ __forceinline__ int acc_row(int warp, int lane, int i) {
  return 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1);
}
__host__ __device__ __forceinline__ int acc_col(int j, int lane, int i) {
  return 8 * j + 2 * (lane & 3) + (i & 1);
}

// words_tile's A (see the note above): fragment row g (lane / 4) of warp
// `warp` holds word row a_word_row(warp, g) of the warpgroup's 16, and its
// row g + 8 h byte a_word_byte(warp, h); a_sel(warp) is the __byte_perm
// selector that takes those two bytes of two words. Staged accumulator row
// r (acc_row) is output row words_out_row(r) of the warpgroup's 64.
__host__ __device__ __forceinline__ int a_word_row(int warp, int g) {
  return 8 * (warp >> 1) + ((g >> 1) | ((g & 1) << 2));
}
__host__ __device__ __forceinline__ int a_word_byte(int warp, int h) { return 2 * (warp & 1) + h; }
__host__ __device__ __forceinline__ int a_sel(int warp) { return 0x5140 + 0x2222 * (warp & 1); }
__host__ __device__ __forceinline__ int words_out_row(int r) {
  return 4 * a_word_row(r >> 4, r & 7) + a_word_byte(r >> 4, (r >> 3) & 1);
}
// The row of w that B row j pairs with (roll in [0, n)).
__host__ __device__ __forceinline__ int b_src_row(int j, int roll, int n) { return (j + roll) % n; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A wgmma shared-memory descriptor with the 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(const void* tile, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}
// Waits until the phase of parity `parity` has completed; on a fresh barrier
// parity 1 counts as completed, so a producer's first pass does not wait. A
// phase that has not completed after two seconds never will (the longest
// launch takes a millisecond): the launch traps, and the caller gets an
// error instead of a card that hangs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 2000000000ull) __trap();
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                       int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator registers while wgmma owns them
template <int R>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WG_D8(i)                                                                          \
  "+r"(d[(i)]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3]), "+r"(d[(i) + 4]), \
      "+r"(d[(i) + 5]), "+r"(d[(i) + 6]), "+r"(d[(i) + 7])
#define WG_D32 WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
#define WG_D64 WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
#define WG_D128                                                                             \
  WG_D32, WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56), WG_D8(64), WG_D8(72), WG_D8(80),     \
      WG_D8(88), WG_D8(96), WG_D8(104), WG_D8(112), WG_D8(120)
#define WG_R32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_R64                                                                                \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "     \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define WG_R128                                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "     \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, " \
  "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, " \
  "%55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, " \
  "%73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, " \
  "%91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "     \
  "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, " \
  "%122, %123, %124, %125, %126, %127}"

// d += A (64 x k, K-major, desc a) * B (k x N, desc b): int8 k32 (B K-major)
// or bf16 k16 (B MN-major, the transpose bit set). d holds N / 2 registers,
// float bits for bf16.
template <int N, bool BF16>
__device__ __forceinline__ void wgmma(uint32_t (&d)[N / 2], uint64_t a, uint64_t b) {
  static_assert(N == 64 || N == 256, "the tiles use m64n64 and m64n256");
  if constexpr (N == 64 && BF16) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
                 ", %32, %33, p, 1, 1, 0, 1;\n}\n"
                 : WG_D32
                 : "l"(a), "l"(b), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WG_R32 ", %32, %33, p;\n}\n"
                 : WG_D32
                 : "l"(a), "l"(b), "r"(1));
  } else if constexpr (BF16) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_R128
                 ", %128, %129, p, 1, 1, 0, 1;\n}\n"
                 : WG_D128
                 : "l"(a), "l"(b), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " WG_R128
                 ", %128, %129, p;\n}\n"
                 : WG_D128
                 : "l"(a), "l"(b), "r"(1));
  }
}

// d += A (64 x 32, int8, wgmma's register fragment a) * B (32 x N, K-major,
// desc b), exact in int32.
template <int N>
__device__ __forceinline__ void wgmma_rs(uint32_t (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 64 || N == 128 || N == 256, "m64n64, m64n128 or m64n256");
  if constexpr (N == 64) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " WG_R32
                 ", {%32, %33, %34, %35}, %36, p;\n}\n"
                 : WG_D32
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else if constexpr (N == 128) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " WG_R64
                 ", {%64, %65, %66, %67}, %68, p;\n}\n"
                 : WG_D64
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 " WG_R128
                 ", {%128, %129, %130, %131}, %132, p;\n}\n"
                 : WG_D128
                 : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
}

#undef WG_D8
#undef WG_D32
#undef WG_D64
#undef WG_D128
#undef WG_R32
#undef WG_R64
#undef WG_R128

// NWG consumer warpgroups, each 64 rows of a BM x BN tile; STAGES stages of
// A and B in flight; int8 B's K-major copies in a ring of TRING.
template <int NWG_, int BN_, int STAGES_>
struct Tile {
  static constexpr int NWG = NWG_, BN = BN_, STAGES = STAGES_, TRING = 2;
  static constexpr int BM = 64 * NWG;
  static constexpr int kThreads = 128 * (NWG + 1);
  static constexpr int A_BYTES = BM * kStageK;
  static constexpr int B_BYTES = BN * kStageK;  // int8: 128 k x BN; bf16: 64 k x BN x 2
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int CS = BN + 8;             // words per row of the staged C tile
  static constexpr int C_BYTES = BM * CS * 4;
  template <bool BF16>
  __host__ __device__ static constexpr int ring_bytes() {
    return STAGES * STAGE_BYTES + (BF16 ? 0 : TRING * B_BYTES);
  }
  template <bool BF16>
  __host__ __device__ static constexpr int smem_bytes() {  // + 1024 to align the base, + the barriers
    return (ring_bytes<BF16>() > C_BYTES ? ring_bytes<BF16>() : C_BYTES) + 1024 +
           8 * 2 * (STAGES + TRING);
  }
};

__device__ __forceinline__ uint2 lds64(uint32_t addr) {
  uint2 v;
  asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(addr) : "memory");
  return v;
}
__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint32_t x, uint32_t y, uint32_t z,
                                       uint32_t w) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(x), "r"(y), "r"(z),
               "r"(w)
               : "memory");
}

// One int8 B stage, 128 k rows of BN bytes, whose 8 bytes at k and column
// group c2 row(k, c2) reads -> the K-major swizzled tile (BN rows of 128
// bytes of K, at shared address bt). Thread tt of the kTransposers takes
// items of 16 k rows x 8 columns: it reads 8 bytes of each row, transposes
// the 4 x 4 byte blocks with __byte_perm, and stores each column's 16 k
// bytes as one chunk.
template <int BN, class Row>
__device__ __forceinline__ void transpose_rows(Row row, uint32_t bt, int tt) {
  constexpr int PAIRS = BN / 8;  // 8-byte column groups per landed row
  for (int it = tt; it < (kStageK / 16) * PAIRS; it += kTransposers) {
    const int c2 = it % PAIRS, kc = item_kc(it / PAIRS, c2);
    uint32_t ow[8][4];  // ow[t][g]: column 8 c2 + t, k = 16 kc + 4 g .. 16 kc + 4 g + 3
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint2 w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = row(16 * kc + 4 * g + i, c2);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // byte t of word h of row i is column 8 c2 + 4 h + t at k + i
        const uint32_t w0 = h ? w[0].y : w[0].x, w1 = h ? w[1].y : w[1].x;
        const uint32_t w2 = h ? w[2].y : w[2].x, w3 = h ? w[3].y : w[3].x;
        const uint32_t x01 = __byte_perm(w0, w1, 0x5140), x23 = __byte_perm(w2, w3, 0x5140);
        const uint32_t y01 = __byte_perm(w0, w1, 0x7362), y23 = __byte_perm(w2, w3, 0x7362);
        ow[4 * h + 0][g] = __byte_perm(x01, x23, 0x5410);
        ow[4 * h + 1][g] = __byte_perm(x01, x23, 0x7632);
        ow[4 * h + 2][g] = __byte_perm(y01, y23, 0x5410);
        ow[4 * h + 3][g] = __byte_perm(y01, y23, 0x7632);
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
      sts128(bt + swizzle128(8 * c2 + t, kc), ow[t][0], ow[t][1], ow[t][2], ow[t][3]);
  }
}

// One int8 B stage as it landed by TMA (128 k rows by b_row, BN bytes each,
// at shared address raw) -> its K-major tile at bt.
template <int BN, bool PLANES>
__device__ __forceinline__ void transpose_stage(uint32_t raw, uint32_t bt, int tt) {
  transpose_rows<BN>(
      [raw](int k, int c2) {
        return lds64(raw + (PLANES ? b_row_planes(k) : b_row_dense(k)) * BN + 8 * c2);
      },
      bt, tt);
}

// words_tile's A fragment of one k32 step (box: the step's box of landed
// words; row: the thread's word row in it; t: lane % 4): byte sel picks of
// the words of 16-byte chunks t (k 4 t ..) and 4 + t (k 16 + 4 t ..) into
// wgmma's m64k32 registers (rows g and g + 8, k 4 t .. and 16 + 4 t ..).
__device__ __forceinline__ void load_a_words(uint32_t (&a)[4], uint32_t box, int row, int t,
                                             uint32_t sel) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint4 q = lds128(box + swizzle128(row, 4 * half + t));
    const uint32_t xy = __byte_perm(q.x, q.y, sel), zw = __byte_perm(q.z, q.w, sel);
    a[2 * half] = __byte_perm(xy, zw, 0x5410);
    a[2 * half + 1] = __byte_perm(xy, zw, 0x7632);
  }
}

// A block's shared memory: the ring of stages on a 1024-byte boundary (the
// swizzle's period; kept a pointer into shared memory so that its accesses
// compile to LDS / STS), int8 B's K-major tiles after it, and the four
// barrier arrays after the larger of the ring and the staged C tile,
// initialised before the block goes on.
template <class TL, bool BF16>
struct Ring {
  uint8_t* smem;
  uint8_t* bt_ring;
  uint64_t *full, *empty, *tfull, *tempty;

  __device__ __forceinline__ Ring() {
    extern __shared__ uint8_t smem_raw[];
    constexpr int S = TL::STAGES, T = TL::TRING;
    constexpr int RING = TL::template ring_bytes<BF16>();
    smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    bt_ring = smem + S * TL::STAGE_BYTES;
    full = reinterpret_cast<uint64_t*>(smem + (RING > TL::C_BYTES ? RING : TL::C_BYTES));
    empty = full + S;
    tfull = empty + S;
    tempty = tfull + T;
    if (threadIdx.x == 0) {
      for (int s = 0; s < S; ++s) {
        mbar_init(full + s, 1);
        mbar_init(empty + s, 128 * TL::NWG);
      }
      for (int t = 0; t < T; ++t) {
        mbar_init(tfull + t, kTransposers);
        mbar_init(tempty + t, 128 * TL::NWG);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }
};

// The epilogue, once every consumer's wgmmas are done, so that the ring's
// shared memory holds the C tile: fragments -> staged rows -> 16-byte
// stores, rows past M masked. Staged row r (acc_row) of consumer cw goes to
// output row m0 + 64 cw + out_row(r).
template <class TL, bool BF16, int EPI, class OutRow>
__device__ __forceinline__ void store_tile(const uint32_t (&d)[TL::BN / 2], uint8_t* smem,
                                           const Args& p, int m0, int n0, int cw, int warp,
                                           int lane, OutRow out_row) {
  using AccT = typename std::conditional<BF16, float, int>::type;
  constexpr int BN = TL::BN;
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * TL::NWG) : "memory");
  uint32_t* ct = reinterpret_cast<uint32_t*>(smem) + cw * 64 * TL::CS;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = 2 * h;
      *reinterpret_cast<uint2*>(ct + acc_row(warp, lane, i) * TL::CS + acc_col(j, lane, i)) =
          make_uint2(d[4 * j + i], d[4 * j + i + 1]);
    }
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + cw) : "memory");
  for (int idx = threadIdx.x & 127; idx < 64 * (BN / 4); idx += 128) {
    const int r = idx / (BN / 4), c4 = 4 * (idx - r * (BN / 4));
    const int m = m0 + cw * 64 + out_row(r);
    if (m < p.m)
      store4<BF16, EPI>(p, m, n0 + c4, reinterpret_cast<const AccT*>(ct + r * TL::CS + c4));
  }
}

template <class TL, bool BF16, bool PLANES, int EPI>
__device__ __forceinline__ void gemm_tile(const CUtensorMap* tma_a, const CUtensorMap* tma_b,
                                          const Args& p) {
  constexpr int S = TL::STAGES, T = TL::TRING, BN = TL::BN;
  const Ring<TL, BF16> ring;
  uint8_t *smem = ring.smem, *bt_ring = ring.bt_ring;
  uint64_t *full = ring.full, *empty = ring.empty, *tfull = ring.tfull, *tempty = ring.tempty;
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * TL::BM, n0 = blockIdx.x * BN;
  const int es = BF16 ? 2 : 1;
  const int KT = (p.k * es + kStageK - 1) / kStageK;

  if (wgi == 0) {
    // the producer warpgroup
    if (warp == 0) {
      if (lane == 0) {
        for (int i = 0; i < KT; ++i) {
          const int s = i % S;
          mbar_wait(empty + s, ((i / S) & 1) ^ 1);
          mbar_expect_tx(full + s, TL::STAGE_BYTES);
          uint8_t* st = smem + s * TL::STAGE_BYTES;
          tma_2d(st, tma_a, full + s, i * (kStageK / es), m0);
          if constexpr (BF16) {
#pragma unroll
            for (int q = 0; q < BN / 64; ++q)
              tma_2d(st + TL::A_BYTES + q * kMnLbo, tma_b, full + s, n0 + 64 * q, 64 * i);
          } else if constexpr (PLANES) {
            tma_3d(st + TL::A_BYTES, tma_b, full + s, n0, (kStageK / 4) * i, 0);
          } else {
            tma_2d(st + TL::A_BYTES, tma_b, full + s, n0, kStageK * i);
          }
        }
      }
    } else if constexpr (!BF16) {
      // warps 1-3: each landed int8 B stage -> its K-major copy
      const int tt = threadIdx.x - 32;
      for (int i = 0; i < KT; ++i) {
        const int s = i % S, t = i % T;
        mbar_wait(full + s, (i / S) & 1);
        mbar_wait(tempty + t, ((i / T) & 1) ^ 1);
        transpose_stage<BN, PLANES>(smem_u32(smem + s * TL::STAGE_BYTES + TL::A_BYTES),
                                    smem_u32(bt_ring + t * TL::B_BYTES), tt);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(tfull + t);
      }
    }
    return;
  }

  // the consumer warpgroups
  const int cw = wgi - 1;
  uint32_t d[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) d[r] = 0;
  for (int i = 0; i < KT; ++i) {
    const int s = i % S;
    mbar_wait(full + s, (i / S) & 1);
    const uint8_t* st = smem + s * TL::STAGE_BYTES;
    const uint64_t da = make_desc(st + cw * 64 * kStageK, 16, kSbo);
    uint64_t db;
    if constexpr (BF16) {
      db = make_desc(st + TL::A_BYTES, kMnLbo, kSbo);
    } else {
      mbar_wait(tfull + i % T, (i / T) & 1);
      db = make_desc(bt_ring + (i % T) * TL::B_BYTES, 16, kSbo);
    }
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kStageK / kKStep; ++ks)
      wgmma<BN, BF16>(d, da + ((ks * kKStep) >> 4),
                      db + (((BF16 ? kMnKStep : kKStep) * ks) >> 4));
    wgmma_commit();
    fence_acc(d);
    wgmma_wait<1>();  // the group of stage i - 1 is done: hand that stage back
    fence_acc(d);
    if (i > 0) {
      mbar_arrive(empty + (i - 1) % S);
      if constexpr (!BF16) mbar_arrive(tempty + (i - 1) % T);
    }
  }
  wgmma_wait<0>();
  fence_acc(d);
  store_tile<TL, BF16, EPI>(d, smem, p, m0, n0, cw, warp, lane, [](int r) { return r; });
}

// probe_bitcast_dot's tile: P3 whole, out (p.m = 4 x word rows, p.n) int32
// from the words p.a (p.m / 4, p.k) and w p.b (p.k, p.n) with p.roll (the
// "words" entry of the note above). The skeleton is gemm_tile's; A comes
// from registers (load_a_words), B's rows are rolled (b_src_row), and the
// epilogue puts the A rows back in order (words_out_row).
template <class TL>
__device__ __forceinline__ void words_tile(const CUtensorMap* tma_a, const CUtensorMap* tma_b,
                                           const Args& p) {
  constexpr int S = TL::STAGES, T = TL::TRING, BN = TL::BN;
  constexpr int BOX = TL::BM / 4 * kStageK;  // a box of 32 words of the stage's word rows
  const Ring<TL, false> ring;
  uint8_t *smem = ring.smem, *bt_ring = ring.bt_ring;
  uint64_t *full = ring.full, *empty = ring.empty, *tfull = ring.tfull, *tempty = ring.tempty;
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * TL::BM, n0 = blockIdx.x * BN;
  const int KT = (p.k + kStageK - 1) / kStageK;

  if (wgi == 0) {
    if (warp == 0) {
      // the producer: a stage's word boxes up to column p.k, and w's rows
      // from b_src_row on
      if (lane == 0) {
        for (int i = 0; i < KT; ++i) {
          const int s = i % S, boxes = min(kStageK, p.k - kStageK * i) / kKStep;
          mbar_wait(empty + s, ((i / S) & 1) ^ 1);
          mbar_expect_tx(full + s, boxes * BOX + TL::B_BYTES);
          uint8_t* st = smem + s * TL::STAGE_BYTES;
          for (int q = 0; q < boxes; ++q)
            tma_2d(st + q * BOX, tma_a, full + s, 4 * (kStageK * i + kKStep * q), m0 / 4);
          tma_2d(st + TL::A_BYTES, tma_b, full + s, n0, b_src_row(kStageK * i, p.roll, p.k));
        }
      }
    } else {
      // warps 1-3: each landed B stage -> its K-major copy; in the stage
      // that wraps at p.k, the rows past the wrap from device memory (a
      // branch a row there only: the other stages' row loads stay free to
      // issue together)
      const int tt = threadIdx.x - 32;
      for (int i = 0; i < KT; ++i) {
        const int s = i % S, t = i % T;
        const int wrap = p.k - b_src_row(kStageK * i, p.roll, p.k);
        const uint32_t raw = smem_u32(smem + s * TL::STAGE_BYTES + TL::A_BYTES);
        const uint32_t bt = smem_u32(bt_ring + t * TL::B_BYTES);
        mbar_wait(full + s, (i / S) & 1);
        mbar_wait(tempty + t, ((i / T) & 1) ^ 1);
        if (wrap >= kStageK) {
          transpose_rows<BN>([raw](int k, int c2) { return lds64(raw + k * BN + 8 * c2); }, bt,
                             tt);
        } else {
          transpose_rows<BN>(
              [&](int k, int c2) {
                if (k < wrap) return lds64(raw + k * BN + 8 * c2);
                const int row = b_src_row(kStageK * i + k, p.roll, p.k);
                return __ldg(reinterpret_cast<const uint2*>(p.b + static_cast<size_t>(row) * p.n +
                                                           n0 + 8 * c2));
              },
              bt, tt);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(tfull + t);
      }
    }
    return;
  }

  // the consumer warpgroups: per k32 step its A registers, then its wgmma
  const int cw = wgi - 1, row = 16 * cw + a_word_row(warp, lane >> 2), t4 = lane & 3;
  const uint32_t sel = a_sel(warp);
  uint32_t d[BN / 2];
#pragma unroll
  for (int r = 0; r < BN / 2; ++r) d[r] = 0;
  for (int i = 0; i < KT; ++i) {
    const int s = i % S, steps = min(kStageK, p.k - kStageK * i) / kKStep;
    mbar_wait(full + s, (i / S) & 1);
    mbar_wait(tfull + i % T, (i / T) & 1);
    const uint32_t words = smem_u32(smem + s * TL::STAGE_BYTES);
    const uint64_t db = make_desc(bt_ring + (i % T) * TL::B_BYTES, 16, kSbo);
    uint32_t a[2][4];  // two register sets in turn: step ks's stay untouched while it runs
#pragma unroll
    for (int ks = 0; ks < kStageK / kKStep; ++ks) {
      if (ks < steps) {
        uint32_t(&ak)[4] = a[ks & 1];
        load_a_words(ak, words + ks * BOX, row, t4, sel);
        fence_acc(ak);
        fence_acc(d);
        wgmma_fence();
        wgmma_rs<BN>(d, ak, db + ((ks * kKStep) >> 4));
        wgmma_commit();
        fence_acc(d);
        wgmma_wait<1>();  // step ks - 1 is done
        fence_acc(d);
        if (ks == 0 && i > 0) mbar_arrive(tempty + (i - 1) % T);  // stage i - 1's B is read
      }
    }
    mbar_arrive(empty + s);  // stage i's words are in registers and its B is transposed
  }
  wgmma_wait<0>();
  fence_acc(d);
  store_tile<TL, false, EPI_S32>(d, smem, p, m0, n0, cw, warp, lane,
                                 [](int r) { return words_out_row(r); });
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda link flag).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// Everything a tensor map encodes; zero-filled first, so that two keys of
// equal fields are equal bytes.
struct MapKey {
  const void* base;
  cuuint64_t dims[3], strides[2];
  cuuint32_t box[3];
  int rank, bf16, swizzle;
};

// A tensor map of `rank` (<= 3) dims (innermost first), strides in bytes of
// dims 1... Maps are cached by everything they encode (kMapCache of them,
// the oldest replaced first), so a launch on the same buffers and shapes
// as an earlier one skips cuTensorMapEncodeTiled; ctypes drops the GIL
// during a call, hence the lock.
constexpr int kMapCache = 64;
inline bool encode(CUtensorMap* map, bool bf16, int rank, const void* base, const cuuint64_t* dims,
                   const cuuint64_t* strides, const cuuint32_t* box, bool swizzle) {
  MapKey key;
  memset(&key, 0, sizeof(key));
  key.base = base;
  for (int i = 0; i < rank; ++i) {
    key.dims[i] = dims[i];
    key.box[i] = box[i];
    if (i > 0) key.strides[i - 1] = strides[i - 1];
  }
  key.rank = rank;
  key.bf16 = bf16;
  key.swizzle = swizzle;
  static std::mutex lock;
  static MapKey keys[kMapCache];
  static CUtensorMap maps[kMapCache];
  static int used = 0, next = 0;
  std::lock_guard<std::mutex> guard(lock);
  for (int i = 0; i < used; ++i)
    if (memcmp(&keys[i], &key, sizeof(key)) == 0) {
      *map = maps[i];
      return true;
    }
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  if (fn(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
         static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides, box, ones,
         CU_TENSOR_MAP_INTERLEAVE_NONE,
         swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  keys[next] = key;
  maps[next] = *map;
  next = (next + 1) % kMapCache;
  used = used < kMapCache ? used + 1 : used;
  return true;
}

}  // namespace wg

template <class TL, bool BF16, int EPI>
__global__ void __launch_bounds__(TL::kThreads, 1)
    probe_gemm_kernel(const __grid_constant__ CUtensorMap tma_a,
                      const __grid_constant__ CUtensorMap tma_b, Args p) {
  wg::gemm_tile<TL, BF16, false, EPI>(&tma_a, &tma_b, p);
}

template <class TL, int EPI>
__global__ void __launch_bounds__(TL::kThreads, 1)
    probe_packed_dot_kernel(const __grid_constant__ CUtensorMap tma_a,
                            const __grid_constant__ CUtensorMap tma_b, Args p) {
  wg::gemm_tile<TL, false, true, EPI>(&tma_a, &tma_b, p);
}

template <class TL>
__global__ void __launch_bounds__(TL::kThreads, 1)
    probe_bitcast_dot_kernel(const __grid_constant__ CUtensorMap tma_a,
                             const __grid_constant__ CUtensorMap tma_b, Args p) {
  wg::words_tile<TL>(&tma_a, &tma_b, p);
}

namespace wg {

// Encodes both tensor maps and launches the tile: probe_packed_dot_kernel
// when PLANES, else probe_gemm_kernel.
template <class TL, bool BF16, bool PLANES, int EPI>
cudaError_t launch(const Args& p, cudaStream_t s) {
  const cuuint64_t es = BF16 ? 2 : 1;
  const cuuint64_t m = static_cast<cuuint64_t>(p.m), n = static_cast<cuuint64_t>(p.n),
                   k = static_cast<cuuint64_t>(p.k);
  CUtensorMap ta, tb;
  const cuuint64_t a_dims[2] = {k, m}, a_strides[1] = {k * es};
  const cuuint32_t a_box[2] = {static_cast<cuuint32_t>(kStageK / es), TL::BM};
  bool ok = encode(&ta, BF16, 2, p.a, a_dims, a_strides, a_box, true);
  if (BF16) {
    const cuuint64_t dims[2] = {n, k}, strides[1] = {n * 2};
    const cuuint32_t box[2] = {64, 64};
    ok = ok && encode(&tb, true, 2, p.b, dims, strides, box, true);
  } else if (PLANES) {
    const cuuint64_t dims[3] = {n, k / 4, 4}, strides[2] = {n, n * (k / 4)};
    const cuuint32_t box[3] = {TL::BN, kStageK / 4, 4};
    ok = ok && encode(&tb, false, 3, p.b, dims, strides, box, false);
  } else {
    const cuuint64_t dims[2] = {n, k}, strides[1] = {n};
    const cuuint32_t box[2] = {TL::BN, kStageK};
    ok = ok && encode(&tb, false, 2, p.b, dims, strides, box, false);
  }
  if (!ok) return cudaErrorInvalidValue;
  constexpr int bytes = TL::template smem_bytes<BF16>();
  const dim3 grid(p.n / TL::BN, (p.m + TL::BM - 1) / TL::BM);
  // the shared-memory limit is set once per kernel (on the current device)
  if constexpr (PLANES) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        probe_packed_dot_kernel<TL, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return attr;
    probe_packed_dot_kernel<TL, EPI><<<grid, TL::kThreads, bytes, s>>>(ta, tb, p);
  } else {
    static const cudaError_t attr = cudaFuncSetAttribute(
        probe_gemm_kernel<TL, BF16, EPI>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (attr != cudaSuccess) return attr;
    probe_gemm_kernel<TL, BF16, EPI><<<grid, TL::kThreads, bytes, s>>>(ta, tb, p);
  }
  return cudaGetLastError();
}

// Encodes both tensor maps and launches probe_bitcast_dot_kernel: the words
// as bytes (4 p.k, p.m / 4) in swizzled boxes of 32 words, w as it lies.
template <class TL>
cudaError_t launch_bitcast_dot(const Args& p, cudaStream_t s) {
  const cuuint64_t rows = static_cast<cuuint64_t>(p.m / 4), n = static_cast<cuuint64_t>(p.n),
                   k = static_cast<cuuint64_t>(p.k);
  CUtensorMap ta, tb;
  const cuuint64_t a_dims[2] = {4 * k, rows}, a_strides[1] = {4 * k};
  const cuuint32_t a_box[2] = {kStageK, TL::BM / 4};
  const cuuint64_t b_dims[2] = {n, k}, b_strides[1] = {n};
  const cuuint32_t b_box[2] = {TL::BN, kStageK};
  if (!encode(&ta, false, 2, p.a, a_dims, a_strides, a_box, true) ||
      !encode(&tb, false, 2, p.b, b_dims, b_strides, b_box, false))
    return cudaErrorInvalidValue;
  constexpr int bytes = TL::template smem_bytes<false>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      probe_bitcast_dot_kernel<TL>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(p.n / TL::BN, (p.m + TL::BM - 1) / TL::BM);
  probe_bitcast_dot_kernel<TL><<<grid, TL::kThreads, bytes, s>>>(ta, tb, p);
  return cudaGetLastError();
}

}  // namespace wg
}  // namespace
