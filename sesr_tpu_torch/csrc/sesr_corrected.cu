// The corrected datapath's fused whole-network kernel for Hopper (sm_90a),
// on wgmma: one thread block runs every conv of the collapsed network over
// one output tile at a time, with every intermediate in shared memory.
//
// Replaces the XLA lowering of the JAX package's corrected deployment modes:
//   sesr_corrected_net <- sesr_tpu/ops/packed.py _packed_exact_impl(corrected=True),
//                         behind packed_hybrid_forward and
//                         packed_exact_forward(corrected=True)
// Its plain version is sesr_tpu_torch/quant/integer.py integer_forward(
// corrected=True), with fast_layers in the hybrid mode: per layer, either one
// pass per PE, each PE's partial conv(q - z_eff) clamped to pe_acc_bits
// (18 shipped) before the PEs' partials are added (the layers the caller
// flags: the hybrid mode's unstamped ones, the PE-exact mode's where
// convert.py cannot rule that clamp out), or one pass over all channels;
// the sum clamped to pe_add_bits (20 shipped) where that clamp can fire;
// then the clipped bias, the float32 requantization, ReLU, the int16
// residual shortcut and the int8 output. Networks of 3 to 16 convs (a
// deeper one runs in layer groups, sesr_corrected_group.cu) at
// hidden width 16 (the shipped tasks, SESR-M11) or 32 (SESR-XL), C a
// template parameter; a narrower network runs padded to the next; a last
// conv of 1 to 48 output channels (16 in the shipped instantiation). Any
// HardwareConfig with 1 to 16 PEs and 2- to 8-bit activations runs: the
// 4-PE int8 artifacts whose sums stay below 2^22 in the shipped
// instantiation (<4, false, C>), every other in a general one (<4, true, C>
// up to four PEs, <8, true, C> up to eight, <16, true, C> past them), which
// clamps every sum to pe_add_bits and clips activations to the artifact's
// [-2^(b-1), 2^(b-1) - 1]; where a sum may pass 2^22 the general
// instantiation's wide form (sesr_corrected_wide_kernel, and
// sesr_corrected_audit_wide_kernel counting) keeps it a plain int32,
// converted once by __int2float_rn.
//
// Its counting form, sesr_corrected_audit (sesr_corrected_audit_kernel, an
// instantiation of the same body with COUNT set, at each <G, GEN, C>), is
// the runtime audit's shadow run: the PE-exact mode's output, and per split
// layer the PE partials that the 18-bit clamp changed (the plain version's
// overflow_18; a layer convert.py leaves unsplit cannot fire the clamp).
// Each tile counts the outputs of its own core, inside the image and a
// count region (count_lo, count_hi), since it recomputes a ring of halo on
// every layer; a warp sums its counts and adds them with one 64-bit atomic
// a layer. The served kernel has no branch of it.
//
// What bounds it on this card: operations. nr needs 9,312 int8 MACs per
// pixel against 6 bytes of device traffic, far above the H100's ratio of
// int8 tensor-core rate to memory rate. The design:
//   - every conv is an implicit GEMM on wgmma (m64nNk32 s8 x s8 -> s32, exact
//     int32 sums), both operands read from shared memory by descriptor: no
//     operand passes through registers. Activations lie pixel-major, 16 int8
//     channels = 16 bytes a pixel (at width 32, two planes: channels 0-15,
//     then 16-31 in a second plane). A layer's output is computed over rows of
//     its input extent's width iw (the "wide" GEMM: the K - 1 columns past
//     each output row are computed and dropped), so output row r of tap
//     (dy, dx) reads input pixel r + dy iw + dx: for 64 consecutive rows that
//     is 64 consecutive 16-byte pixels, a K-major A operand without swizzle
//     (core matrices of 8 rows x 16 bytes, SBO = 128 bytes). A k32 step takes
//     two taps: its start moves by the first tap's offset, and LBO (the
//     distance between the two 16-byte halves of k) is the second tap's
//     offset from the first, so the two halves' core matrices may overlap
//     (16 bytes apart for horizontal neighbours). half_off gives both. At
//     width 32 a step is one tap: both halves are the same pixel, one in
//     each plane, LBO the distance between the planes (a_lbo): 9 steps for a
//     3x3 layer, where width 16 takes 5;
//   - layer 0 reads <= 4 channels a pixel. Its input is widened once per
//     tile: entry p holds the words of pixels p .. p + 3, so one 16-byte
//     half is four horizontal taps and a step is one kernel row (taps 0-3,
//     then 4-7 at LBO = 64 bytes, 5-7 against zero weights): 5 steps for the
//     5x5 conv, where 25 taps of 4 bytes need 100 of its 160 bytes of k;
//   - each PE's partial in its own accumulator columns: a split layer is one
//     pass with N = G x OC columns, G = pe_groups(pe) (4, 8 past four PEs,
//     16 past eight; layer 0: min(in_ch, pe) x C), column (p, o) holding W[o] on PE
//     p's channel bytes (c % pe == p) and zero elsewhere, a group past the
//     PEs all zero (convert.py _wgmma_b_words). A is read once, not once
//     per PE; the epilogue adds -z_eff * sum(W_p) (pe_zero_terms) to each
//     group, clamps it to pe_acc_bits and adds the groups. The tensor cores
//     do G x the MACs on a split layer, which they have room for. N past
//     kMaxN (a split hidden layer at width 32 past four PEs or at width 16
//     past eight: 256 or 512 columns, more accumulators than a thread has
//     registers; a split last layer of 32 or 48 columns a group) runs as
//     chunks of whole PE groups (chunk_groups: at most kMaxN columns, an N
//     wgmma takes for s8), one after another over the same A, each chunk's
//     clamped partials folded into the rows' sums before the next;
//   - the last layer's columns a PE group (OCP): out_cols of its channels,
//     8 or 16, and 32 or 48 (an RGB network of scale 3 or 4) in general
//     instantiations of their own (OW: sesr_corrected_wideout_kernel), so
//     that the others' registers stay as they were; past C channels its
//     bias and zero terms are rows of their own at the end of the
//     parameter block (R_ROWS);
//   - at width 16 up to four PEs every layer's B (K-major, no swizzle:
//     b_byte) and the parameter block are loaded into shared memory once per
//     block; the grid is persistent (one block per SM, the blocks walk the
//     tiles), so that happens once per SM. At width 32 no tile holds every
//     layer's B (SESR-XL's 13 convs need 119 to 929 KB), and at 16 PE groups
//     a split 5x5 layer's alone is 53-104 KB (at 8 past 16 output channels
//     up to 160 KB), so there (staged_b) B is staged a layer at a time with
//     cp.async: into two regions, even and
//     odd layers, the next layer's B loaded while a layer computes, where
//     the plan has room; else into one, loaded after the layer's barrier
//     (smem_plan, w_bufs). Where not even one layer's B fits (SESR-XL at 16
//     PEs with a split conv: conv 12's B is 204,800 bytes), the general
//     instantiation with piece forms (PF, piece_kernel) stages a split
//     layer's B in pieces of at most
//     kPieceMax bytes (conv_pieces, which runs every split layer of
//     piece_form: piece_steps k32 steps of a chunk), the warpgroups taking
//     their m-tiles in rounds, all on one piece at a time, with the next
//     piece staged while one computes where two regions fit; each round
//     stages the layer's B anew;
//   - four warpgroups take a layer's 64-row m-tiles in turn, each m-tile
//     one commit group of wgmmas and then its epilogue on the CUDA cores:
//     one warpgroup's epilogue runs while the others' wgmmas do. Everything
//     is inlined into the kernel (ptxas serializes every wgmma of a pipeline
//     that crosses a function call), and the warpgroup's index is made
//     uniform with a shuffle. A second accumulator set per warpgroup, to
//     overlap its own epilogue with its next m-tile, was serialized by
//     ptxas too (the epilogue's divergent paths; without them, the
//     registers: 512 threads leave 128 each), and was slower. The epilogue
//     has no branch that depends on the row (stores that are not made go
//     to a scratch word), which ptxas schedules better;
//   - the epilogue writes the next layer's pixel row directly: B's columns
//     are permuted (col_chan) so that the four values a thread holds for one
//     row (acc_row / acc_col) are channels 4 tq .. 4 tq + 3 of that pixel,
//     one 32-bit store, eight rows of a warp 128 contiguous bytes (width 32:
//     eight values, channels 4 tq .. 4 tq + 3 and 16 + 4 tq .. 19 + 4 tq, a
//     store to each plane). Positions
//     outside the image get z_eff in every byte, so conv(q, pads = z_eff) =
//     conv(q - z_eff) + z_eff * sum(W): a one-pass layer subtracts z_eff *
//     sum(W), a split layer's PE p z_eff * sum(W_p). This needs -128 <= z_eff
//     <= 127, which the host checks. Generic stores are read by wgmma
//     through the async proxy: fence.proxy.async and a barrier between
//     layers;
//   - the residual shortcut round(s) (conv 0's ReLU output, 0 <= round(s)
//     <= 32767, convert.py shortcut_bound) is kept as int16, 2 C bytes a
//     pixel of the last conv's input extent.
// Shared memory per block (smem_plan): the parameter block, B (every
// layer's at width 16: 23,552 bytes for nr hybrid; one or two layers' at
// width 32), two ping-pong activation buffers (C bytes a pixel, with the rows
// the last m-tile reads past the extent), the shortcut and a 16-byte scratch
// word: 213,008 bytes for nr at 32x64.
// What is left: the epilogue. Without it the kernel takes about a sixth of
// its time on nr's frame, without the wgmmas about three quarters (python
// -m sesr_tpu_torch.corrected_ab --variants no_epilogue,no_mma); the tensor
// cores run 3.1x the network's MACs (halo, wide rows, padded k, 4 x N on
// split layers) and are still mostly idle. At width 32 SESR-XL takes 16x16
// tiles (3.51x its MACs in halo alone), and ptxas spills 44-516 bytes in
// the width-32 instantiations; loading the PE zero terms into the
// accumulators, which removes the shipped one's spills, serializes its
// wgmmas and is slower, and so are chunks of 64 columns (corrected_ab
// --variants start_in_acc,chunk_64 --family).
//
// Numerics: requantization is (y * m) * 2^-n, two float32 multiplies in the
// plain version; the kernel rounds y * (m * 2^-n) once, which is the same
// float whenever every product is a normal float (convert.py refuses
// exponents where it might not be). Rounding is half-to-even, every other
// float op is one __fadd_rn or __fmul_rn in the order of the plain version,
// built with -fmad=false, and int <-> float conversions go through kMagic
// (sesr_common.cuh).
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (sesr_tpu_torch/ops/_build.py). The entry point returns
// cudaGetLastError() after its launch. tests/test_torch_corrected.py models
// the descriptors' addressing, B's layout and the accumulator map in numpy,
// reading tap_of, tap_pix, half_off, a_lbo, steps_of, b_byte, col_chan,
// acc_row, acc_col, chunk_groups, piece_count, piece_steps and piece_src
// from this file.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "sesr_common.cuh"

namespace {

constexpr int kWarpgroups = 4;              // a block's warpgroups, all of them consumers
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kRows = 64;                   // wgmma's M: output rows of an m-tile
constexpr int kPix = 16;                    // bytes of one pixel of a plane: 16 int8 channels
constexpr int kSboA = 128;                  // A: bytes between core matrices along M (8 pixels)
constexpr int kLboB = 128;                  // B: bytes between the two 16-byte halves of k
constexpr int kSboB = 256;                  // B: bytes between 8-column core matrices
constexpr int kAlign = 128;                 // alignment of each shared-memory region
constexpr int kScratch = 16;                // bytes that the epilogue's stores not made go to
constexpr int kSmemLimit = 232448;          // a block's shared memory on the H100
constexpr int kLoadBatch = 8;               // input pixels per thread in flight
constexpr int kMaxN = 128;                  // most columns of a wgmma: a wider layer runs in chunks
constexpr int kPieceMax = 53248;            // most bytes of a piece of a layer's B staged in pieces
constexpr int kWholeMax = 106496;           // most bytes of a split layer's B that conv_layer runs

// PE column groups of a split hidden layer: 4 up to four PEs, 8 up to eight,
// else 16 (convert.py pe_groups); the groups past the PE count hold zero
// weights.
__host__ __device__ constexpr int pe_groups(int pe) { return 4 + 4 * (pe > 4) + 8 * (pe > 8); }

// Whether B is staged a layer at a time (width 32, 16 PE groups, whose
// split layers' B is 16 times a one-pass layer's, and 8 in the
// instantiations of a last layer past 16 channels, OW, whose split B no
// block holds beside the others) rather than resident for every layer.
__host__ __device__ constexpr bool staged_b(int G, int C, bool OW) { return C == 32 || G == 16 || (OW && G == 8); }

// Whether a launch takes the instantiations with piece forms (PF:
// conv_pieces for the split layers of piece_form, and B staged in pieces
// where the plan needs it): general, past 16 output channels (OW), or at
// width 32 and 16 PE groups with a split layer past layer 0. Kept apart,
// so that the others' registers stay as they were.
__host__ __device__ constexpr bool piece_kernel(int G, int C, bool gen, bool ow, int split) { return gen && (ow || (G == 16 && C == 32 && (split >> 1) != 0)); }

// PE groups of a chunk of a layer of NG groups of OCP columns: all of them
// where they fit a wgmma (kMaxN), else kMaxN / OCP, a power of two that
// divides NG (OCP 8, 16, 32 or 48; NG 4, 8 or 16 there), so that a chunk
// is whole groups and its N one that wgmma takes.
__host__ __device__ constexpr int chunk_groups(int NG, int OCP) { return (NG * OCP <= kMaxN) * NG + (NG * OCP > kMaxN) * (kMaxN / OCP); }

// K32 steps of a piece of a chunk of NC columns and S k32 steps (S 5, 9,
// 13 or 25; NC <= kMaxN): the whole chunk where it fits kPieceMax, else
// five (S 25: a 5x5 layer at width 32), so that the pieces divide the
// steps; and the pieces of a chunk.
__host__ __device__ constexpr int piece_steps(int S, int NC) { return (S * NC * 32 <= kPieceMax) * S + (S * NC * 32 > kPieceMax) * 5; }
__host__ __device__ constexpr int piece_count(int S, int NC) { return S / piece_steps(S, NC); }
// Whether a split layer (not layer 0) of B bytes and NG PE groups at width
// C runs conv_pieces: its B past kWholeMax, or every split layer at width 32
// and 16 groups (SESR-XL at 16 PEs: even its 4-output last conv's 102,400
// bytes fit no tile whole).
__host__ __device__ constexpr bool piece_form(int B, int NG, int C) { return B > kWholeMax || (C == 32 && NG == 16); }
// Byte of a layer's B of N columns that 16-byte unit i of its piece (steps s0
// .., chunk hc of NC columns) holds: each step's NC columns after the last's.
__host__ __device__ constexpr int piece_src(int i, int s0, int hc, int N, int NC) { return (s0 + i / (2 * NC)) * N * 32 + hc * NC * 32 + i % (2 * NC) * 16; }

// k32 steps of a K x K layer of input width C: one per kernel row for layer 0
// (its pixels widened to four horizontal neighbours), else 32 / C taps a step.
__host__ __device__ constexpr int steps_of(int K, int wide, int C) { return wide * K + (1 - wide) * ((K * K + 32 / C - 1) / (32 / C)); }

// Tap of half h (k bytes 16 h .. 16 h + 15) of step s of a hidden layer of
// width C: 2 s + h at width 16; s at width 32, whose halves are the planes.
__host__ __device__ constexpr int tap_of(int s, int h, int C) { return 32 / C * s + (32 / C - 1) * h; }

// Pixel offset of tap t of a K x K layer over an input of width iw; a pad tap
// past K * K reads one pixel past tap K * K - 1, against zero weights.
__host__ __device__ constexpr int tap_pix(int t, int K, int iw) { return (t - (t >= K * K)) / K * iw + (t - (t >= K * K)) % K + (t >= K * K); }

// Pixel offset, from the output row it serves, of half h of step s of a K x K
// layer over an input of width iw. Layer 0 (wide): row s, columns 4 h .. 4 h +
// 3; a hidden layer: its tap.
__host__ __device__ __forceinline__ int half_off(int s, int h, int K, int iw, int wide, int C) { return wide * (s * iw + 4 * h) + (1 - wide) * tap_pix(tap_of(s, h, C), K, iw); }

// A's LBO in bytes, the distance from half 0 (pixel offset o0) to half 1 (o1):
// their pixels' distance, and at width 32 the planes' (plane bytes apart).
__host__ __device__ __forceinline__ int a_lbo(int o0, int o1, int wide, int C, int plane) { return (o1 - o0) * kPix + (1 - wide) * (C / 16 - 1) * plane; }

// Byte of (step s, GEMM column n, k byte kb) in a layer's B of N columns:
// K-major, no swizzle, core matrices of 8 columns x 16 bytes of k.
__host__ __device__ __forceinline__ int b_byte(int s, int n, int kb, int N) { return s * N * 32 + (n >> 3) * kSboB + (kb >> 4) * kLboB + (n & 7) * 16 + (kb & 15); }

// Output channel of column n (0 .. C - 1) of a PE group: the last layer's in
// order; a hidden layer's permuted, so that the four a thread holds for one
// row in n-tiles 2 w and 2 w + 1 (columns 8 j + 2 tq + e, j - 2 w and e in
// {0, 1}) are channels 16 w + 4 tq + 2 (j - 2 w) + e: word tq of plane w.
__host__ __device__ __forceinline__ int col_chan(int n, int last) { return last * n + (1 - last) * ((n >> 4) * 16 + ((n >> 1) & 3) * 4 + ((n >> 3) & 1) * 2 + (n & 1)); }

// wgmma's m64nN accumulator fragment: register 4 j + i of lane `lane` of warp
// `warp` (of the warpgroup) holds C[acc_row][acc_col].
__host__ __device__ __forceinline__ int acc_row(int warp, int lane, int i) { return 16 * warp + (lane >> 2) + 8 * ((i >> 1) & 1); }
__host__ __device__ __forceinline__ int acc_col(int j, int lane, int i) { return 8 * j + 2 * (lane & 3) + (i & 1); }

// The counting form's window [count_lo, count_hi) along one axis of a
// layer's output extent, which starts r before the tile's core [o0, o0 + t):
// the core's outputs inside the image [0, E) and the count region [g0, g1).
// Every output lies in one tile's core, so the tiles count each once.
__device__ __forceinline__ int count_lo(int o0, int r, int g0) { return max(o0, g0) - o0 + r; }
__device__ __forceinline__ int count_hi(int o0, int t, int r, int E, int g1) { return min(min(o0 + t, E), g1) - o0 + r; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int G>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(G) : "memory");
}
// keeps the compiler from moving accumulator registers while wgmma owns them
template <int R>
__device__ __forceinline__ void fence_acc(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// generic-proxy stores to shared memory, made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

#define D4(i) "+r"(d[(i)]), "+r"(d[(i) + 1]), "+r"(d[(i) + 2]), "+r"(d[(i) + 3])

// d (+)= A (64 x 32 bytes, desc a) * B (32 bytes x N, desc b), s8 x s8 ->
// s32; d is overwritten where acc is 0.
template <int N>
__device__ __forceinline__ void wgmma(uint32_t (&d)[N / 2], uint64_t a, uint64_t b, int acc) {
  static_assert(N == 8 || N == 16 || N == 32 || N == 48 || N == 64 || N == 96 || N == 128,
                "the layers use these widths");
  if constexpr (N == 8) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n8k32.s32.s8.s8 "
                 "{%0, %1, %2, %3}, %4, %5, p;\n}\n"
                 : D4(0)
                 : "l"(a), "l"(b), "r"(acc));
  } else if constexpr (N == 16) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p;\n}\n"
                 : D4(0), D4(4)
                 : "l"(a), "l"(b), "r"(acc));
  } else if constexpr (N == 32) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                 "%16, %17, p;\n}\n"
                 : D4(0), D4(4), D4(8), D4(12)
                 : "l"(a), "l"(b), "r"(acc));
  } else if constexpr (N == 48) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n48k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p;\n}\n"
                 : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20)
                 : "l"(a), "l"(b), "r"(acc));
  } else if constexpr (N == 64) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
                 "%31}, %32, %33, p;\n}\n"
                 : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28)
                 : "l"(a), "l"(b), "r"(acc));
  } else if constexpr (N == 96) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
                 "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
                 "%46, %47}, %48, %49, p;\n}\n"
                 : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28), D4(32), D4(36),
                   D4(40), D4(44)
                 : "l"(a), "l"(b), "r"(acc));
  } else {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
                 "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, "
                 "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
                 "%61, %62, %63}, %64, %65, p;\n}\n"
                 : D4(0), D4(4), D4(8), D4(12), D4(16), D4(20), D4(24), D4(28), D4(32), D4(36),
                   D4(40), D4(44), D4(48), D4(52), D4(56), D4(60)
                 : "l"(a), "l"(b), "r"(acc));
  }
}

#undef D4

__host__ __device__ inline int round_up(int v, int a) { return (v + a - 1) / a * a; }

// Bytes of conv `layer`'s B at hidden width C: steps x N columns x 32 bytes
// of k, N = the PE groups (split: min(in_ch, pe) for layer 0, else
// pe_groups(pe); one pass: 1) x the columns of a group (C; a last layer
// out_cols(ocl)).
__host__ __device__ inline int layer_b_bytes(int layer, int L, int in_ch, int ocl, int split,
                                             int pe, int C) {
  const int sp = (split >> layer) & 1;
  if (layer == 0) return steps_of(5, 1, C) * 32 * C * (sp ? (in_ch < pe ? in_ch : pe) : 1);
  const int last = layer == L - 1;
  const int ocp = last ? out_cols(ocl) : C;
  return steps_of(last ? 5 : 3, 0, C) * 32 * ocp * (sp ? pe_groups(pe) : 1);
}

// Where B is staged in pieces: (pieces a round, bytes of the largest) of
// conv `layer`: a split hidden or last layer that runs conv_pieces
// (piece_form) its chunks of chunk_groups groups each in piece_count
// pieces; any other layer one piece, its whole B (ops/kernels.py
// layer_pieces).
__host__ __device__ inline int2 layer_pieces(int layer, int L, int in_ch, int ocl, int split,
                                             int pe, int C) {
  const int b = layer_b_bytes(layer, L, in_ch, ocl, split, pe, C);
  if (layer == 0 || !((split >> layer) & 1) || !piece_form(b, pe_groups(pe), C))
    return make_int2(1, b);
  const int ocp = layer == L - 1 ? out_cols(ocl) : C, g = pe_groups(pe);
  const int s = steps_of(layer == L - 1 ? 5 : 3, 0, C), nc = chunk_groups(g, ocp) * ocp;
  return make_int2(g * ocp / nc * piece_count(s, nc), piece_steps(s, nc) * nc * 32);
}

// Pixels of a plane of conv `layer`'s input buffer that its GEMM reads: the
// rows of its last m-tile at its last step's second half, past the input
// extent.
__host__ __device__ inline int layer_cap(int layer, int L, int th, int tw, int C) {
  const int r = ring(layer, L), ih = th + 2 * r, iw = tw + 2 * r;
  const int K = (layer == 0 || layer == L - 1) ? 5 : 3, wide = layer == 0;
  return round_up((ih - K + 1) * iw, kRows) + half_off(steps_of(K, wide, C) - 1, 1, K, iw, wide, C);
}

// Bytes from the first plane of conv `layer`'s input to the second at width
// 32 (A's LBO); 0 where the input is one plane (width 16, layer 0).
__host__ __device__ inline int in_plane(int layer, int L, int th, int tw, int C) {
  return layer > 0 && C == 32 ? round_up(layer_cap(layer, L, th, tw, C) * kPix, kAlign) : 0;
}

struct Plan {
  int w_at, w_bytes;   // B: every layer's (resident), or w_bufs regions of one layer's
  int w_bufs;          // staged: 2 (layer i's B in region i % 2) or 1; resident: 0
  int w_odd;           // staged, two regions: the odd layers' region, from w_at
  bool pieces;         // staged: the split layers' B in pieces (layer_pieces)
  int x_at, y_at;      // the ping-pong buffers: layer i reads x (even i) or y (odd i)
  int sc_at;           // the shortcut
  int scratch_at;      // kScratch bytes
  int bytes;
};

// Shared memory of one block: the parameter block (param_words(L, C, pe)
// and, past 16 output channels, out_rows), B (resident: every layer's;
// staged, staged_b: two regions, the even layers' and the odd layers',
// where that fits a block, else one region of the largest layer's; where
// not even that fits, in the instantiations with piece forms (pf,
// piece_kernel), the split layers' B in pieces, two regions of the largest
// piece or layer where they fit, else one; G: the instantiation's PE
// column groups, pe_groups(pe); OW: its last layer is past 16 channels),
// the buffers (y also
// holds layer 0's input as one word a pixel while it is widened into x; at
// width 32 a layer's input is two planes of in_plane bytes), the shortcut
// and the scratch word.
__host__ __device__ inline Plan smem_plan(int G, bool gen, bool ow, bool pf, int split, int pe,
                                          int L, int in_ch, int ocl, int th, int tw, int C) {
  Plan p;
  p.w_at = round_up((param_words(L, C, pe) + (ow ? out_rows(ocl, C, pe) : 0)) * 4, kAlign);
  int all = 0, even = 0, odd = 0, unit = 0;
  for (int i = 0; i < L; ++i) {
    const int b = layer_b_bytes(i, L, in_ch, ocl, split, pe, C);
    int& big = (i % 2) ? odd : even;
    all += b;
    big = big > b ? big : b;
    if (pf && staged_b(G, C, ow)) {
      const int u = layer_pieces(i, L, in_ch, ocl, split, pe, C).y;
      unit = unit > u ? unit : u;
    }
  }
  int x = 0, y = extent(0, L, th, tw) * 4;
  for (int i = 0; i < L; ++i) {
    const int b =
        C == 32 && i > 0 ? 2 * in_plane(i, L, th, tw, C) : layer_cap(i, L, th, tw, C) * kPix;
    int& dst = (i % 2) ? y : x;
    dst = dst > b ? dst : b;
  }
  const int r_sc = ring(L - 1, L);
  const bool staged = staged_b(G, C, ow);
  const bool in_pieces = gen && pf && staged;
  p.w_bufs = staged ? 2 : 0;
  p.w_odd = staged ? round_up(even, kAlign) : 0;
  p.w_bytes = staged ? p.w_odd + odd : all;
  p.pieces = false;
  for (;;) {
    p.x_at = round_up(p.w_at + p.w_bytes, kAlign);
    p.y_at = round_up(p.x_at + x, kAlign);
    p.sc_at = round_up(p.y_at + y, kAlign);
    p.scratch_at = p.sc_at + (th + 2 * r_sc) * (tw + 2 * r_sc) * 2 * C;
    p.bytes = p.scratch_at + kScratch;
    if (!staged || p.bytes <= kSmemLimit || (p.w_bufs == 1 && (p.pieces || !in_pieces)))
      return p;
    if (p.w_bufs == 2) {                  // one region of the largest layer's, or piece's
      p.w_bufs = 1;
      p.w_odd = 0;
      p.w_bytes = p.pieces ? unit : even > odd ? even : odd;
    } else {                              // in pieces: two regions of the largest piece
      p.pieces = true;
      p.w_bufs = 2;
      p.w_odd = round_up(unit, kAlign);
      p.w_bytes = p.w_odd + unit;
    }
  }
}

// What every layer of one tile shares.
struct Net {
  Tile t;
  int frame, L, oc;    // oc: the last conv's output channels
  int pe;              // the datapath's PEs
  const int* prm;      // the parameter block, in shared memory
  uint2* sc;           // the shortcut: round(s) as int16, a pixel's C channels in C / 4 uint2
  int* scratch;        // kScratch bytes that the epilogue's stores not made go to
  int sc_w, sc_h;      // its extent: the last conv's input extent
  int8_t* out;         // (n, H, W, OC) int8
  // the counting form: per layer, the PE partials its 18-bit clamp
  // changed, over the count region [cy0, cy1) x [cx0, cx1) in image pixels
  unsigned long long* counts;
  int cy0, cy1, cx0, cx1;
  // the layer-group form (sesr_corrected_group.cu): the group's layer that
  // adds the shortcut (-1: none), and the shortcut's offset from layer 1's
  // input extent
  int prelast, sc_off;
};

// One conv layer.
struct Layer {
  const uint8_t* in;   // input extent ih x iw, kPix bytes a pixel (layer 0: widened)
  int ih, iw;
  int plane;           // width 32: bytes between the input's two planes (in_plane)
  const uint8_t* w;    // B (b_byte)
  int* next;           // FIRST / MID: the next layer's input, 4 words a pixel and plane
  int next_plane;      // words between its planes
  int layer;
  // B staged in pieces (conv_pieces): its B in device memory, and the
  // regions the pieces go to (w_bufs of them, w_odd bytes apart)
  bool pieces;
  const int* wg;
  uint8_t* regions;
  int w_odd, w_bufs;
};

// A thread's view of conv `ly.layer` in one form: NG PE groups of columns,
// each PE's partial clamped to pe_acc_bits (SPLIT), or one group; the sum
// clamped to pe_add_bits where CLAMP. GEN: the general instantiation (any
// PE count, NG past it padded with zero groups; activations in [-half, half
// - 1], quant_half); WIDE (GEN only): the sum a plain int32, converted to
// float32 once, for sums that may pass 2^22. C: the hidden width. GRP: a
// group of the layer-group form, whose shortcut layer and offset are the
// Net's (prelast, sc_off); PAIR (FIRST, the two-conv group of
// sesr_corrected_group.cu): the first conv is also the one before the
// last, so its epilogue writes the last conv's domain-in, the residual add
// of its own ReLU output to itself (the shortcut), and keeps no shortcut.
// Everything a warpgroup's m-tile needs is held here, and issue / epilogue
// are inlined, so the accumulators stay in registers; past four groups, and
// at width 32, the PE zero terms are read from shared memory in the
// epilogue; at width 32 a hidden layer's A descriptors are formed in issue,
// and a split layer's adder bounds in the epilogue. COUNT (a split layer of
// the counting form): each thread counts the partials the 18-bit clamp
// changes at the outputs of its count window.
template <Kind KIND, int K, int OCP, int NG, bool SPLIT, bool CLAMP, bool GEN, int C,
          bool COUNT = false, bool WIDE_SUM = false, bool GRP = false, bool PAIR = false>
struct Form {
  static_assert(GEN || !WIDE_SUM, "the wide form is the general instantiation's");
  static_assert(!PAIR || KIND == FIRST, "a pair's pre-last conv is its first");
  static constexpr int WIDE = KIND == FIRST;
  static constexpr int J = OCP / 8;                              // 8-column tiles of a group
  static constexpr int N = NG * OCP;                             // the layer's columns
  static constexpr int GC = chunk_groups(NG, OCP);               // PE groups of a chunk
  static constexpr int NH = NG / GC;                             // chunks, one after another
  static constexpr int NC = GC * OCP;                            // columns of a chunk
  static constexpr int R = NC / 2;                               // accumulator registers
  static constexpr int S = steps_of(K, WIDE, C < 32 ? C : 32);   // width 64: FormKS's own steps
  static constexpr int V = 2 * J;                                // values a thread holds per row
  // a last layer past C channels: its bias and zero terms in its own rows (R_ROWS)
  static constexpr bool ROWS = KIND == LAST && OCP > C;
  // in registers: the PE zero terms, A's descriptor per step, the adder clamp's bounds
  static constexpr bool START_REGS = NG <= 4 && C == 16 && OCP <= 16;
  static constexpr bool A_REGS = C == 16 || WIDE;
  static constexpr bool BOUNDS_REGS = !SPLIT || (C == 16 && OCP <= 16);

  int warp, lane, tq, layer, oc, iw, oh, ow, oy0, ox0, H, W, acc_hi, add_hi, frame, L, pe;
  unsigned iw_magic;
  float rq_s, rq_c;
  float half_;           // GEN: the activations' half range (quant_half)
  float z_next, res_s;   // the next layer's domain-in zero (z_out for LAST); s_1 / s_{L-1}
  int pad_next;          // a pad word of the next layer's input
  bool prelast;
  int* next;
  int next_plane;
  uint2* sc;
  int* scratch;          // where a store that is not made goes
  int sc_w, sc_h, sc_off;
  int8_t* out;
  int base[V], lo[BOUNDS_REGS ? V : 1], hi[BOUNDS_REGS ? V : 1], start[START_REGS ? NG : 1][V];
  int zc0;               // else: PE 0's zero terms, this thread's first word
  int rows;              // ROWS: the last layer's bias row in the block
  int plane;             // width 32: bytes between the input's two planes
  const int* prm;
  uint32_t a_lo[A_REGS ? S : 1], b_lo;
  int cy0, cy1, cx0, cx1;  // COUNT: the count window in the output extent

  __device__ __forceinline__ Form(const Layer& ly, const Net& net) {
    prm = net.prm;
    const int tid = threadIdx.x & 127;
    warp = tid >> 5;
    lane = tid & 31;
    tq = lane & 3;
    layer = ly.layer;
    oc = KIND == LAST ? net.oc : C;
    iw = ly.iw;
    oh = ly.ih - K + 1;
    ow = iw - K + 1;
    const int r_out = (oh - net.t.th) / 2;              // ring of this output frame
    oy0 = net.t.oy0 - r_out;
    ox0 = net.t.ox0 - r_out;
    H = net.t.H;
    W = net.t.W;
    frame = net.frame;
    L = net.L;
    pe = GEN ? net.pe : 4;
    iw_magic = 0xffffffffu / iw + 1;                    // r / iw == umulhi(r, iw_magic)
    acc_hi = prm[P_ACC_HI];
    add_hi = prm[P_ADD_HI];
    // (y * m) * 2^-n == y * (m * 2^-n) in float32 (see the note); with y
    // read as the float kMagic + y, one FFMA: fl(a * s - kMagic * s)
    rq_s = __fmul_rn(as_f32(prm[p_at(layer, R_RQM, C)]), as_f32(prm[p_at(layer, R_RQP, C)]));
    rq_c = -kMagic * rq_s;
    if constexpr (GEN) half_ = quant_half(prm);
    if constexpr (GRP) prelast = KIND == MID && layer == net.prelast;
    else prelast = KIND == MID && layer == L - 2;
    z_next = as_f32(prm[KIND == LAST ? P_ZOUT : p_at(layer + 1, R_ZIN, C)]);
    res_s = __fmul_rn(as_f32(prm[P_RESM]), as_f32(prm[P_RESP]));
    pad_next = KIND == LAST ? 0 : pad_word(prm[p_at(layer + 1, R_ZEFF, C)]);
    next = ly.next;
    next_plane = ly.next_plane;
    sc = net.sc;
    scratch = net.scratch;
    if constexpr (GRP) sc_off = net.sc_off;
    else sc_off = ring(1, L) - ring(L - 1, L);
    sc_w = net.sc_w;
    sc_h = net.sc_h;
    out = net.out;
    // value v = 2 j + e of a group is column acc_col(j, lane, e): a row's sum
    // ends as kMagicBits + y_int (WIDE_SUM: y_int). A one-pass layer adds
    // base = bias + kMagicBits - z_eff * sum(W) (its adder clamp, where it
    // runs, shifted by bias + kMagicBits); a split layer adds bias +
    // kMagicBits to the sum of its PEs' clamped partials, PE p's started
    // from -z_eff * sum(W_p) (0 for a group past the PEs). A split layer's
    // z_eff * sum(W) words are 0 (convert.py), so there base is bias +
    // kMagicBits. WIDE_SUM leaves kMagicBits out of each. The rows are the
    // record's, C words each, or (ROWS) the last layer's own, oc words each.
    rows = ROWS ? prm[p_at(layer, R_ROWS, C)] : p_at(layer, R_BIAS, C);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int o = col_chan(acc_col(v >> 1, lane, v & 1), KIND == LAST);
      const bool ok = o < oc;
      const int b = (ok ? prm[rows + o] : 0) + (WIDE_SUM ? 0 : kMagicBits);
      base[v] = b - (ok ? prm[rows + row_words() + o] : 0);
      if constexpr (BOUNDS_REGS) {
        lo[v] = b - add_hi - 1;
        hi[v] = b + add_hi;
      }
      if constexpr (START_REGS) {
#pragma unroll
        for (int p = 0; p < NG; ++p)
          start[p][v] = ok && p < pe ? -prm[zcp_at(L, C, pe, layer, p) + o] : 0;
      }
    }
    // this thread's value v is channel (2 or 4) tq + col_chan(acc_col(v / 2,
    // 0, v % 2)); words past OC hold 0
    zc0 = (ROWS ? rows + 2 * oc : zcp_at(L, C, pe, layer, 0)) + (KIND == LAST ? 2 : 4) * tq;
    // descriptors: A's start and LBO per step (m-tile 0), or at width 32 of
    // step 0 (a step s adds its tap's pixel offset); B's start
    const uint32_t in_s = smem_u32(ly.in);
#pragma unroll
    for (int s = 0; s < (A_REGS ? S : 1); ++s) {
      const int o0 = half_off(s, 0, K, iw, WIDE, C), o1 = half_off(s, 1, K, iw, WIDE, C);
      a_lo[s] = (((in_s + o0 * kPix) & 0x3FFFF) >> 4) |
                ((static_cast<uint32_t>(a_lbo(o0, o1, WIDE, C, ly.plane)) >> 4) << 16);
    }
    b_lo = ((smem_u32(ly.w) & 0x3FFFF) >> 4) | ((kLboB >> 4) << 16);
    plane = ly.plane;
    if constexpr (COUNT) {
      cy0 = count_lo(net.t.oy0, r_out, net.cy0);
      cy1 = count_hi(net.t.oy0, net.t.th, r_out, H, net.cy1);
      cx0 = count_lo(net.t.ox0, r_out, net.cx0);
      cx1 = count_hi(net.t.ox0, net.t.tw, r_out, W, net.cx1);
    }
  }

  // words of a row of the layer's bias, zero terms and each PE's
  __device__ __forceinline__ int row_words() const {
    if constexpr (ROWS) return oc;
    else return C;
  }

  // the activations' half range and qn_bits's clip bounds: int8's but in GEN
  __device__ __forceinline__ float half() const {
    if constexpr (GEN) return half_;
    else return 128.f;
  }
  __device__ __forceinline__ float q_lo() const { return kMagic - half(); }
  __device__ __forceinline__ float q_hi() const { return kMagic + (half() - 1.f); }

  // m-tile mt's wgmmas over chunk hc of the columns, one commit group
  __device__ __forceinline__ void issue(uint32_t (&d)[R], int mt, int hc) const {
    constexpr uint64_t a_hi = static_cast<uint64_t>(kSboA >> 4) << 32;
    constexpr uint64_t b_hi = static_cast<uint64_t>(kSboB >> 4) << 32;
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < S; ++s) {
      uint32_t a;
      if constexpr (A_REGS) a = a_lo[s];
      else a = a_lo[0] + (half_off(s, 0, K, iw, WIDE, C) * kPix >> 4);
      wgmma<NC>(d, a_hi | (a + mt * (kRows * kPix >> 4)),
                b_hi | (b_lo + (b_byte(s, hc * NC, 0, N) >> 4)), s);
    }
    wgmma_commit();
  }

  // conv_pieces: m-tile mt's SP wgmmas over steps s0 .. s0 + SP - 1 of a
  // chunk, whose B lies at `piece`, `cols` columns a step from one step to
  // the next (b_byte: a piece's NC, or the layer's N where its B is whole),
  // one commit group; d carries over the chunk's pieces. The steps are
  // run-time values, so A's descriptor is formed here (its LBO from the
  // step's two halves, half_off / a_lbo).
  template <int SP>
  __device__ __forceinline__ void issue_piece(uint32_t (&d)[R], int mt, const uint8_t* piece,
                                              int s0, int cols) const {
    constexpr uint64_t a_hi = static_cast<uint64_t>(kSboA >> 4) << 32;
    constexpr uint64_t b_hi = static_cast<uint64_t>(kSboB >> 4) << 32;
    const uint32_t bp = ((smem_u32(piece) & 0x3FFFF) >> 4) | ((kLboB >> 4) << 16);
    __syncwarp();
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < SP; ++i) {
      const int s = s0 + i;
      const int o0 = half_off(s, 0, K, iw, WIDE, C), o1 = half_off(s, 1, K, iw, WIDE, C);
      const uint32_t a = ((a_lo[0] & 0xFFFFu) + (o0 * kPix >> 4)) |
                         ((static_cast<uint32_t>(a_lbo(o0, o1, WIDE, C, plane)) >> 4) << 16);
      const uint64_t ad = a_hi | (a + mt * (kRows * kPix >> 4));
      wgmma<NC>(d, ad, b_hi | (bp + (b_byte(i, 0, 0, cols) >> 4)), s);
    }
    wgmma_commit();
  }

  // PE group p's zero term for value v
  __device__ __forceinline__ int start_of(int p, int v) const {
    if constexpr (START_REGS) return start[p][v];
    else return p < pe ? -prm[zc0 + col_chan(acc_col(v >> 1, 0, v & 1), KIND == LAST) + p * row_words()] : 0;
  }

  // COUNT: whether row half h of m-tile mt is an output of the count window
  __device__ __forceinline__ bool owned(int mt, int h) const {
    const int r = mt * kRows + acc_row(warp, lane, 2 * h);
    const int y = static_cast<int>(__umulhi(static_cast<unsigned>(r), iw_magic));
    const int x = r - y * iw;
    return y >= cy0 && y < cy1 && x >= cx0 && x < cx1;
  }

  // the clamped partials of chunk hc's PE groups for row h, value v; COUNT:
  // where `own`, n counts those of the real PEs and channels the clamp changed
  __device__ __forceinline__ int partials(const uint32_t (&d)[R], int hc, int h, int v, bool own,
                                          int& n) const {
    int sum = 0;
#pragma unroll
    for (int p = 0; p < GC; ++p) {
      const int t = static_cast<int>(d[4 * (p * J + (v >> 1)) + 2 * h + (v & 1)]) +
                    start_of(hc * GC + p, v);
      const int c = min(max(t, -acc_hi - 1), acc_hi);
      if constexpr (COUNT)
        n += own && hc * GC + p < pe && col_chan(acc_col(v >> 1, lane, v & 1), KIND == LAST) < oc &&
             t != c;
      sum += c;
    }
    return sum;
  }

  // a split layer's chunks before the last: their clamped partials, per row
  // half h and value v, into carry
  __device__ __forceinline__ void fold(const uint32_t (&d)[R], int mt, int hc,
                                       int (&carry)[2][V], int& n) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool own = COUNT && owned(mt, h);
#pragma unroll
      for (int v = 0; v < V; ++v)
        carry[h][v] = (hc ? carry[h][v] : 0) + partials(d, hc, h, v, own, n);
    }
  }

  // m-tile mt's rows of this thread, from the last chunk's accumulators and
  // (NH > 1) the carry of the chunks before: the next layer's input (FIRST,
  // MID), the shortcut (FIRST) or the int8 output (LAST). Without a branch
  // that depends on the row, which ptxas schedules better: a store that is
  // not made goes to the block's scratch word.
  __device__ __forceinline__ void epilogue(const uint32_t (&d)[R], int mt,
                                           const int (&carry)[2][V], int& n) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * kRows + acc_row(warp, lane, 2 * h);
      const int y = static_cast<int>(__umulhi(static_cast<unsigned>(r), iw_magic));
      const int x = r - y * iw;
      const bool kept = y < oh && x < ow;          // else past the extent, or a wide row's tail
      const int gy = oy0 + y, gx = ox0 + x;
      const bool inside = kept && gy >= 0 && gy < H && gx >= 0 && gx < W;
      const bool own = COUNT && y >= cy0 && y < cy1 && x >= cx0 && x < cx1;
      // (y_int * m) * 2^-n
      float hq[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = 2 * h + (v & 1);
        int yi;
        if constexpr (SPLIT) {
          yi = base[v] + partials(d, NH - 1, h, v, own, n);
          if constexpr (NH > 1) yi += carry[h][v];
          if constexpr (CLAMP && BOUNDS_REGS) yi = min(max(yi, lo[v]), hi[v]);
          if constexpr (CLAMP && !BOUNDS_REGS)
            yi = min(max(yi, base[v] - add_hi - 1), base[v] + add_hi);
        } else {
          yi = static_cast<int>(d[4 * (v >> 1) + i]) + base[v];
          if constexpr (CLAMP) yi = min(max(yi, lo[v]), hi[v]);
        }
        hq[v] = WIDE_SUM ? __fmul_rn(__int2float_rn(yi), rq_s)
                         : __fmaf_rn(__int_as_float(yi), rq_s, rq_c);
      }
      if constexpr (KIND == LAST) {
        int8_t* dst = out + ((static_cast<size_t>(frame) * H + gy) * W + gx) * oc;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int o = 8 * j + 2 * tq;
          const int v0 = qn_bits(__fadd_rn(hq[2 * j], z_next), q_lo(), q_hi());
          const int v1 = qn_bits(__fadd_rn(hq[2 * j + 1], z_next), q_lo(), q_hi());
          if ((oc & 1) == 0) {
            uint16_t* p = inside && o < oc ? reinterpret_cast<uint16_t*>(dst + o)
                                           : reinterpret_cast<uint16_t*>(scratch);
            *p = static_cast<uint16_t>(__byte_perm(v0, v1, 0x0040));
          } else {
            int8_t* p0 = inside && o < oc ? dst + o : reinterpret_cast<int8_t*>(scratch);
            int8_t* p1 = inside && o + 1 < oc ? dst + o + 1 : reinterpret_cast<int8_t*>(scratch);
            *p0 = static_cast<int8_t>(v0);
            *p1 = static_cast<int8_t>(v1);
          }
        }
      } else {
        int v[V];                                   // plane w (of C / 16): values 4 w .. 4 w + 3
        if (KIND == FIRST || prelast) {
#pragma unroll
          for (int j = 0; j < V; ++j) hq[j] = fmaxf(hq[j], 0.f);    // ReLU
        }
        if constexpr (PAIR) {
          // the last conv's domain-in from this conv's ReLU output h, which
          // is the shortcut too: round(s) + round(h) with s = h, rescaled
          // as below
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float r = rintf(hq[j]);
            v[j] = qn_bits(__fadd_rn(__fmul_rn(__fadd_rn(r, r), res_s), z_next), q_lo(), q_hi());
          }
        } else if (prelast) {
          // the last conv's domain-in: the integer residual add, rescaled
          // by s_1 / s_{L-1}, into domain L-1 (this frame is the shortcut's)
#pragma unroll
          for (int w = 0; w < C / 16; ++w) {
            const uint2 s2 = sc[kept ? (y * sc_w + x) * (C / 4) + 4 * w + tq : 4 * w + tq];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int s = static_cast<int16_t>((j < 2 ? s2.x : s2.y) >> (16 * (j & 1)));
              const float tr = __fadd_rn(magic_to_f32(s + kMagicBits), rintf(hq[4 * w + j]));
              v[4 * w + j] = qn_bits(__fadd_rn(__fmul_rn(tr, res_s), z_next), q_lo(), q_hi());
            }
          }
        } else if (KIND == FIRST) {
#pragma unroll
          for (int j = 0; j < V; ++j) v[j] = qn_bits(__fadd_rn(hq[j], z_next), q_lo(), q_hi());
        } else {
          // ReLU folded into the low bound: fl(max(h, 0) + z) = max(fl(h + z), z)
          // and rounding is monotone, so clip(rint(.), max(z, -half), half - 1)
          const float lo_q = kMagic + fmaxf(z_next, -half());
#pragma unroll
          for (int j = 0; j < V; ++j)
            v[j] = __float_as_int(
                fminf(fmaxf(__fadd_rn(__fadd_rn(hq[j], z_next), kMagic), lo_q), q_hi()));
        }
        // this thread's word of the pixel in each plane, channels 16 w + 4 tq
        // .. 16 w + 4 tq + 3; z_eff in every byte outside the frame
#pragma unroll
        for (int w = 0; w < C / 16; ++w) {
          int* word = kept ? next + w * next_plane + (y * ow + x) * 4 + tq : scratch;
          *word = inside ? pack_bytes(v[4 * w], v[4 * w + 1], v[4 * w + 2], v[4 * w + 3]) : pad_next;
        }
        if (KIND == FIRST && !PAIR) {
          // the residual shortcut, as the last conv's domain-in consumes it:
          // round(s) as int16 (0 <= round(s) <= 32767, convert.py
          // shortcut_bound), the low half of kMagicBits + round(s); the
          // last conv never reads it outside the frame
          const int sy = y - sc_off, sx = x - sc_off;
          const bool in_sc = kept && sy >= 0 && sy < sc_h && sx >= 0 && sx < sc_w;
#pragma unroll
          for (int w = 0; w < C / 16; ++w) {
            int b[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = __float_as_int(__fadd_rn(hq[4 * w + j], kMagic));
            uint2* sp = in_sc ? sc + (sy * sc_w + sx) * (C / 4) + 4 * w + tq
                              : reinterpret_cast<uint2*>(scratch);
            *sp = make_uint2(__byte_perm(b[0], b[1], 0x5410), __byte_perm(b[2], b[3], 0x5410));
          }
        }
      }
    }
  }
};

// Conv `ly.layer` over its output extent (ih - K + 1) x (iw - K + 1) in the
// form of Form<...>. The warpgroup takes m-tiles wgi, wgi + kWarpgroups, ...,
// each one commit group of wgmmas a chunk of columns, then its epilogue: one
// warpgroup's epilogue runs while the others' wgmmas do. (Two or four
// m-tiles a group, their epilogues after it, need more registers than 128 a
// thread beside the epilogue's, and ptxas serializes the wgmmas.) Inlined
// into the kernel: ptxas serializes every wgmma of a pipeline that crosses a
// function call.
template <Kind KIND, int K, int OCP, int NG, bool SPLIT, bool CLAMP, bool GEN, int C,
          bool COUNT = false, bool WIDE_SUM = false, bool GRP = false, bool PAIR = false>
__device__ __forceinline__ void conv_layer(const Layer& ly, const Net& net) {
  using F = Form<KIND, K, OCP, NG, SPLIT, CLAMP, GEN, C, COUNT, WIDE_SUM, GRP, PAIR>;
  const F f(ly, net);
  const int nmt = (f.oh * f.iw + kRows - 1) / kRows;
  // the warpgroup's index, uniform to the compiler as well
  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  uint32_t d[F::R];
  int carry[2][F::V];
  int n = 0;                                       // COUNT: this thread's counted partials
  for (int mt = wgi; mt < nmt; mt += kWarpgroups) {
    if constexpr (OCP > 16) {              // a 32- or 48-column last layer's chunks: a loop
#pragma unroll 1
      for (int hc = 0; hc < F::NH - 1; ++hc) {
        f.issue(d, mt, hc);
        wgmma_wait<0>();
        fence_acc(d);
        f.fold(d, mt, hc, carry, n);
      }
    } else {
#pragma unroll
      for (int hc = 0; hc < F::NH - 1; ++hc) {
        f.issue(d, mt, hc);
        wgmma_wait<0>();
        fence_acc(d);
        f.fold(d, mt, hc, carry, n);
      }
    }
    f.issue(d, mt, F::NH - 1);
    wgmma_wait<0>();
    fence_acc(d);
    f.epilogue(d, mt, carry, n);
  }
  if constexpr (COUNT) {
    // the warp's counts summed, then one 64-bit atomic a warp and layer
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
    if ((threadIdx.x & 31) == 0 && n != 0)
      atomicAdd(net.counts + ly.layer, static_cast<unsigned long long>(n));
  }
}

// cp.async of one piece of a layer's B of N columns (b_byte), the SP steps
// from s0 of chunk hc (NC columns), into `dst`, each step's NC columns
// after the last's, as one commit group
template <int N, int NC, int SP>
__device__ __forceinline__ void stage_piece(uint8_t* dst, const int* __restrict__ src, int hc,
                                            int s0) {
  for (int i = threadIdx.x; i < SP * 2 * NC; i += kThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst + 16 * i)),
                 "l"(src + piece_src(i, s0, hc, N, NC) / 4) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void b_wait();

// A split layer of piece_form (no configuration served before the pieces
// runs one) runs here and not in conv_layer: its chunks' B whole (in the
// layer's region, Layer::w: each chunk one commit group, as conv_layer
// issues it) or, where the plan stages B in
// pieces (Layer::pieces: not even one layer's B fits beside the buffers),
// in pieces of piece_steps k32 steps of a chunk, staged into the layer's
// regions in turn. With pieces the warpgroups take their m-tiles in
// rounds, all of them on one piece at a time (a block barrier between
// pieces), each m-tile's accumulators carried over its chunk's pieces;
// with two regions the next piece is staged while one computes, with one
// after it, and every round stages the layer's B anew. Whole, each
// warpgroup runs its rounds on its own, as in conv_layer.
template <Kind KIND, int K, int OCP, int NG, bool SPLIT, bool CLAMP, bool GEN, int C,
          bool COUNT = false, bool WIDE_SUM = false, bool GRP = false>
__device__ __forceinline__ void conv_pieces(const Layer& ly, const Net& net) {
  using F = Form<KIND, K, OCP, NG, SPLIT, CLAMP, GEN, C, COUNT, WIDE_SUM, GRP>;
  const F f(ly, net);
  constexpr int SP = piece_steps(F::S, F::NC), P = piece_count(F::S, F::NC);
  static_assert(P * SP == F::S, "the pieces divide the steps");
  constexpr int U = F::NH * P;                         // pieces a round
  const int nmt = (f.oh * f.iw + kRows - 1) / kRows;
  const int rounds = (nmt + kWarpgroups - 1) / kWarpgroups;
  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const bool pieces = ly.pieces;
  // piece q of the layer (round q / U) lies in region q % w_bufs
  auto region = [&](int q) { return ly.regions + (q & 1) * ly.w_odd; };
  auto stage = [&](int q) {
    stage_piece<F::N, F::NC, SP>(region(q), ly.wg, q % U / P, q % P * SP);
  };
  const int total = rounds * U;
  uint32_t d[F::R];
  int carry[2][F::V];
  int n = 0;                                       // COUNT: this thread's counted partials
  int q = 0;
  if (pieces) stage(0);
  for (int rd = 0; rd < rounds; ++rd) {
    const int mt = rd * kWarpgroups + wgi;
    const bool active = mt < nmt;
#pragma unroll 1
    for (int hc = 0; hc < F::NH; ++hc) {
      if (!pieces && active) {
        f.template issue_piece<F::S>(d, mt, ly.w + b_byte(0, hc * F::NC, 0, F::N), 0, F::N);
        wgmma_wait<0>();
        fence_acc(d);
      }
#pragma unroll 1
      for (int pc = 0; pieces && pc < P; ++pc, ++q) {
        b_wait();
        fence_proxy_async();
        __syncthreads();
        if (ly.w_bufs == 2 && q + 1 < total) stage(q + 1);     // into the region piece q - 1 read
        if (active) {
          f.template issue_piece<SP>(d, mt, region(q), pc * SP, F::NC);
          wgmma_wait<0>();
          fence_acc(d);
        }
        if (ly.w_bufs == 1 && q + 1 < total) {
          __syncthreads();
          stage(q + 1);
        }
      }
      if (active) {
        if (hc < F::NH - 1) f.fold(d, mt, hc, carry, n);
        else f.epilogue(d, mt, carry, n);
      }
    }
  }
  if constexpr (COUNT) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
    if ((threadIdx.x & 31) == 0 && n != 0)
      atomicAdd(net.counts + ly.layer, static_cast<unsigned long long>(n));
  }
}

// conv `ly.layer` in its form: one pass per PE where its split bit is set
// (layer 0: one group per PE that owns an input channel, min(in_ch, pe);
// else G groups), else one pass, clamped to pe_add_bits where its clamp bit
// is set; OCP columns a group (a last layer's out_cols: 8 or 16, and 32 or
// 48 in GEN; C for a hidden layer). The general instantiation (GEN) clamps
// every layer's sum to pe_add_bits, the identity where that clamp cannot
// fire, and runs a split layer's B in pieces where the plan says so
// (PF: conv_pieces, a split layer of piece_form); WIDE_SUM: its wide
// form. COUNT: the
// counting form of the split layers (a one-pass layer has no 18-bit clamp
// to count). GRP: a group of the layer-group form; PAIR (FIRST): its
// two-conv group (Form).
template <Kind KIND, int K, int OCP, int G, bool GEN, int C, bool COUNT, bool WIDE_SUM,
          bool PF, bool GRP = false, bool PAIR = false>
__device__ __forceinline__ void conv_form(const Layer& ly, const Net& net, int in_ch) {
  const int* prm = net.prm;
  constexpr bool W = WIDE_SUM;
  if ((prm[P_SPLIT] >> ly.layer) & 1) {
    if constexpr (KIND == FIRST) {
      constexpr bool P = PAIR;
      switch (GEN ? min(in_ch, net.pe) : in_ch) {
        case 1: conv_layer<KIND, K, OCP, 1, true, GEN, GEN, C, COUNT, W, GRP, P>(ly, net); return;
        case 2: conv_layer<KIND, K, OCP, 2, true, GEN, GEN, C, COUNT, W, GRP, P>(ly, net); return;
        case 3: conv_layer<KIND, K, OCP, 3, true, GEN, GEN, C, COUNT, W, GRP, P>(ly, net); return;
        default: conv_layer<KIND, K, OCP, 4, true, GEN, GEN, C, COUNT, W, GRP, P>(ly, net); return;
      }
    } else {
      using F = Form<KIND, K, OCP, G, true, GEN, GEN, C, COUNT, W, GRP>;
      if constexpr (PF && piece_form(F::S * F::N * 32, G, C))
        conv_pieces<KIND, K, OCP, G, true, GEN, GEN, C, COUNT, W, GRP>(ly, net);
      else
        conv_layer<KIND, K, OCP, G, true, GEN, GEN, C, COUNT, W, GRP>(ly, net);
      return;
    }
  }
  if (GEN || ((prm[P_CLAMP] >> ly.layer) & 1)) {
    conv_layer<KIND, K, OCP, 1, false, true, GEN, C, false, W, GRP, PAIR>(ly, net);
    return;
  }
  conv_layer<KIND, K, OCP, 1, false, false, GEN, C, false, W, GRP, PAIR>(ly, net);
}

// cp.async of `bytes` (a multiple of 16) from device memory into shared
// memory, as one commit group; b_wait() waits for the thread's groups.
__device__ __forceinline__ void stage_b(uint8_t* dst, const int* __restrict__ src, int bytes) {
  for (int i = threadIdx.x * 16; i < bytes; i += kThreads * 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst + i)),
                 "l"(src + i / 4) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void b_wait() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// The last conv past 16 channels (the OW instantiations, general): 32 or
// 48 columns a PE group.
template <int G, bool GEN, int C, bool COUNT, bool WIDE_SUM, bool OW, bool PF>
__device__ __forceinline__ void last_past_16(const Layer& ly, const Net& net, int in_ch) {
  if constexpr (OW) {
    if (net.oc <= 32)
      conv_form<LAST, 5, 32, G, GEN, C, COUNT, WIDE_SUM, PF>(ly, net, in_ch);
    else
      conv_form<LAST, 5, 48, G, GEN, C, COUNT, WIDE_SUM, PF>(ly, net, in_ch);
  }
}

// The whole network over every tile, the body of every kernel. G: PE groups
// of a split hidden layer (pe_groups); GEN: the general instantiation (any
// PE count and widths, convert.py KernelConstants.general); C: the hidden
// width, 16 or 32; COUNT: the counting form, which adds to counts[i] the PE
// partials the 18-bit clamp changed on split layer i at the outputs in the
// count region [cy0, cy1) x [cx0, cx1); WIDE_SUM (GEN only,
// KernelConstants.wide): every sum a plain int32, for sums past 2^22; OW
// (GEN only): the last conv has more than 16 output channels, and its
// forms of 32 and 48 columns a group are compiled here instead of 8 and
// 16 (apart, so that they leave the other instantiations' registers as
// they were); PF (GEN only): the piece forms (piece_kernel).
template <int G, bool GEN, int C, bool COUNT, bool WIDE_SUM, bool OW = false, bool PF = false>
__device__ __forceinline__ void run_tiles(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                          const int* __restrict__ weights,
                                          const int* __restrict__ params, int n, int H, int W,
                                          int L, int in_ch, int out_ch, int th, int tw, int split,
                                          int pe, unsigned long long* counts, int cy0, int cy1,
                                          int cx0, int cx1) {
  extern __shared__ __align__(128) uint8_t smem[];
  const Plan pl = smem_plan(G, GEN, OW, PF, split, pe, L, in_ch, out_ch, th, tw, C);
  int* prm = reinterpret_cast<int*>(smem);
  uint8_t* wsm = smem + pl.w_at;
  uint8_t* bx = smem + pl.x_at;
  uint8_t* by = smem + pl.y_at;

  // the parameter block and (resident B) every layer's B, once per block
  constexpr bool kStaged = staged_b(G, C, OW);
  constexpr bool kPieces = PF && kStaged;            // a split layer's B may be staged in pieces
  const int words = param_words(L, C, pe) + (OW ? out_rows(out_ch, C, pe) : 0);
  for (int i = threadIdx.x; i < words; i += kThreads) prm[i] = __ldg(params + i);
  if constexpr (!kStaged) {
    const int4* w4 = reinterpret_cast<const int4*>(weights);
    for (int i = threadIdx.x; i < pl.w_bytes / 16; i += kThreads)
      reinterpret_cast<int4*>(wsm)[i] = __ldg(w4 + i);
    fence_proxy_async();
  }
  __syncthreads();
  // staged B: where layer i's B is staged, and from where
  auto b_region = [&](int i) { return wsm + (i % 2) * pl.w_odd; };
  auto stage_layer = [&](int i) {
    stage_b(b_region(i), weights + prm[p_at(i, R_WOFF, C)],
            layer_b_bytes(i, L, in_ch, out_ch, split, pe, C));
  };
  // whether conv i's B is staged in pieces, by the layer itself (conv_pieces)
  auto in_pieces = [&](int i) {
    return kPieces && pl.pieces && layer_pieces(i, L, in_ch, out_ch, split, pe, C).x > 1;
  };

  const int r0 = ring(0, L), r_sc = ring(L - 1, L);
  const int ih0 = th + 2 * r0, iw0 = tw + 2 * r0, n0 = ih0 * iw0;
  const int cap0 = layer_cap(0, L, th, tw, C);
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  const int per_frame = tiles_x * tiles_y;
  const int pad0 = pad_word(prm[p_at(0, R_ZEFF, C)]);
  Net net;
  net.t.th = th;
  net.t.tw = tw;
  net.t.H = H;
  net.t.W = W;
  net.L = L;
  net.oc = out_ch;
  net.pe = pe;
  net.prm = prm;
  net.sc = reinterpret_cast<uint2*>(smem + pl.sc_at);
  net.scratch = reinterpret_cast<int*>(smem + pl.scratch_at);
  net.sc_w = tw + 2 * r_sc;
  net.sc_h = th + 2 * r_sc;
  net.out = out;
  net.counts = counts;
  net.cy0 = cy0;
  net.cy1 = cy1;
  net.cx0 = cx0;
  net.cx1 = cx1;

  // a persistent grid: block b takes tiles b, b + gridDim.x, ...
  for (int tile = blockIdx.x; tile < n * per_frame; tile += gridDim.x) {
    net.frame = tile / per_frame;
    const int rem = tile - net.frame * per_frame;
    net.t.oy0 = (rem / tiles_x) * th;
    net.t.ox0 = (rem % tiles_x) * tw;
    if constexpr (kStaged) stage_layer(0);           // while the input loads

    // layer 0's input, one word a pixel (channel c in byte c; z_eff outside
    // the frame), into y; kLoadBatch pixels per thread at a time, their
    // loads issued together
    int* raw = reinterpret_cast<int*>(by);
    for (int i0 = threadIdx.x; i0 < n0; i0 += kLoadBatch * kThreads) {
      int v[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * kThreads;
        const int yy = i / iw0, xx = i - yy * iw0;
        const int gy = net.t.oy0 - r0 + yy, gx = net.t.ox0 - r0 + xx;
        v[u] = pad0;
        if (i < n0 && gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const int8_t* p = x + ((static_cast<size_t>(net.frame) * H + gy) * W + gx) * in_ch;
          v[u] = 0;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (c < in_ch) v[u] |= (static_cast<int>(__ldg(p + c)) & 0xff) << (8 * c);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u)
        if (i0 + u * kThreads < n0) raw[i0 + u * kThreads] = v[u];
    }
    __syncthreads();
    // widened into x: entry p holds the words of pixels p .. p + 3, so that
    // a 16-byte half of k is four horizontal taps (entries past the extent
    // repeat its last pixel: only rows that are dropped read them)
    int4* wide = reinterpret_cast<int4*>(bx);
    for (int p = threadIdx.x; p < cap0; p += kThreads)
      wide[p] = make_int4(raw[min(p, n0 - 1)], raw[min(p + 1, n0 - 1)], raw[min(p + 2, n0 - 1)],
                          raw[min(p + 3, n0 - 1)]);
    if constexpr (kStaged) b_wait();
    fence_proxy_async();
    __syncthreads();

    uint8_t* cur = bx;
    uint8_t* nxt = by;
    for (int i = 0; i < L; ++i) {
      // staged B, two regions: the next layer's B into the region the layer
      // before this one read (not where either stages its B in pieces)
      if (kStaged && pl.w_bufs == 2 && i + 1 < L && !in_pieces(i) && !in_pieces(i + 1))
        stage_layer(i + 1);
      Layer ly;
      const int r = ring(i, L);
      ly.in = cur;
      ly.ih = th + 2 * r;
      ly.iw = tw + 2 * r;
      ly.plane = in_plane(i, L, th, tw, C);
      ly.w = kStaged ? b_region(i) : wsm + 4 * prm[p_at(i, R_WOFF, C)];
      ly.next = reinterpret_cast<int*>(nxt);
      ly.next_plane = in_plane(i + 1, L, th, tw, C) / 4;
      ly.layer = i;
      ly.pieces = in_pieces(i);
      ly.wg = weights + prm[p_at(i, R_WOFF, C)];
      ly.regions = wsm;
      ly.w_odd = pl.w_odd;
      ly.w_bufs = pl.w_bufs;
      if (i == 0)
        conv_form<FIRST, 5, C, G, GEN, C, COUNT, WIDE_SUM, PF>(ly, net, in_ch);
      else if (i < L - 1)
        conv_form<MID, 3, C, G, GEN, C, COUNT, WIDE_SUM, PF>(ly, net, in_ch);
      else if (OW)
        last_past_16<G, GEN, C, COUNT, WIDE_SUM, OW, PF>(ly, net, in_ch);
      else if (out_ch <= 8)
        conv_form<LAST, 5, 8, G, GEN, C, COUNT, WIDE_SUM, PF>(ly, net, in_ch);
      else
        conv_form<LAST, 5, 16, G, GEN, C, COUNT, WIDE_SUM, PF>(ly, net, in_ch);
      if constexpr (kStaged) b_wait();
      fence_proxy_async();
      __syncthreads();
      // staged B, one region (or after a layer staged in pieces): the next
      // layer's B once this one is done
      if (kStaged && i + 1 < L && !in_pieces(i + 1) && (pl.w_bufs == 1 || in_pieces(i))) {
        stage_layer(i + 1);
        b_wait();
        fence_proxy_async();
        __syncthreads();
      }
      uint8_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
}

#ifndef SESR_CORRECTED_BODY_ONLY
// (sesr_corrected_group.cu includes this file for the body alone: the
// kernels and entry points below are this library's.)

// The served kernel; the shipped artifacts run <4, false, 16>.
template <int G, bool GEN, int C>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                      const int* __restrict__ weights, const int* __restrict__ params,
                      int n, int H, int W, int L, int in_ch, int out_ch, int th, int tw,
                      int split, int pe) {
  run_tiles<G, GEN, C, false, false>(x, out, weights, params, n, H, W, L, in_ch, out_ch, th, tw,
                                     split, pe, nullptr, 0, 0, 0, 0);
}

// The counting form (the runtime audit's shadow run): the served kernel's
// output, and its 18-bit events counted per layer.
template <int G, bool GEN, int C>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_audit_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                            const int* __restrict__ weights, const int* __restrict__ params,
                            int n, int H, int W, int L, int in_ch, int out_ch, int th, int tw,
                            int split, int pe, unsigned long long* counts, int cy0, int cy1,
                            int cx0, int cx1) {
  run_tiles<G, GEN, C, true, false>(x, out, weights, params, n, H, W, L, in_ch, out_ch, th, tw,
                                    split, pe, counts, cy0, cy1, cx0, cx1);
}

// The general instantiation's wide forms (KernelConstants.wide), served and
// counting.
template <int G, int C>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_wide_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                           const int* __restrict__ weights, const int* __restrict__ params,
                           int n, int H, int W, int L, int in_ch, int out_ch, int th, int tw,
                           int split, int pe) {
  run_tiles<G, true, C, false, true>(x, out, weights, params, n, H, W, L, in_ch, out_ch, th, tw,
                                     split, pe, nullptr, 0, 0, 0, 0);
}

template <int G, int C>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_audit_wide_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                 const int* __restrict__ weights, const int* __restrict__ params,
                                 int n, int H, int W, int L, int in_ch, int out_ch, int th,
                                 int tw, int split, int pe, unsigned long long* counts, int cy0,
                                 int cy1, int cx0, int cx1) {
  run_tiles<G, true, C, true, true>(x, out, weights, params, n, H, W, L, in_ch, out_ch, th, tw,
                                    split, pe, counts, cy0, cy1, cx0, cx1);
}

// The shipped instantiation takes 4 PEs and a last conv of at most 16
// channels; the general ones 1-16 PEs and 1-48 channels.
// The general instantiations of a last conv past 16 channels (OW), served
// and counting, WS: the wide form.
template <int G, int C, bool WS>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_wideout_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                              const int* __restrict__ weights, const int* __restrict__ params,
                              int n, int H, int W, int L, int in_ch, int out_ch, int th, int tw,
                              int split, int pe) {
  run_tiles<G, true, C, false, WS, true, true>(x, out, weights, params, n, H, W, L, in_ch, out_ch,
                                               th, tw, split, pe, nullptr, 0, 0, 0, 0);
}

template <int G, int C, bool WS>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_audit_wideout_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                    const int* __restrict__ weights,
                                    const int* __restrict__ params, int n, int H, int W, int L,
                                    int in_ch, int out_ch, int th, int tw, int split, int pe,
                                    unsigned long long* counts, int cy0, int cy1, int cx0,
                                    int cx1) {
  run_tiles<G, true, C, true, WS, true, true>(x, out, weights, params, n, H, W, L, in_ch, out_ch,
                                              th, tw, split, pe, counts, cy0, cy1, cx0, cx1);
}

// The general instantiations at width 32 and 16 PE groups with a split
// layer past layer 0 (piece_kernel), served and counting, WS: the wide
// form.
template <bool WS>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_pieces_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                             const int* __restrict__ weights, const int* __restrict__ params,
                             int n, int H, int W, int L, int in_ch, int out_ch, int th, int tw,
                             int split, int pe) {
  run_tiles<16, true, 32, false, WS, false, true>(x, out, weights, params, n, H, W, L, in_ch,
                                                  out_ch, th, tw, split, pe, nullptr, 0, 0, 0, 0);
}

template <bool WS>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_audit_pieces_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                   const int* __restrict__ weights,
                                   const int* __restrict__ params, int n, int H, int W, int L,
                                   int in_ch, int out_ch, int th, int tw, int split, int pe,
                                   unsigned long long* counts, int cy0, int cy1, int cx0,
                                   int cx1) {
  run_tiles<16, true, 32, true, WS, false, true>(x, out, weights, params, n, H, W, L, in_ch,
                                                 out_ch, th, tw, split, pe, counts, cy0, cy1, cx0,
                                                 cx1);
}

bool takes(int L, int in_ch, int out_ch, int th, int tw, int split, int pe, int general,
           int width) {
  return L >= 3 && L <= kMaxL && in_ch >= 1 && in_ch <= 4 && out_ch >= 1 && out_ch <= kMaxOut &&
         th >= 1 && tw >= 1 && th <= 1024 && tw <= 1024 && (split >> L) == 0 && pe >= 1 &&
         pe <= kMaxPE && general >= 0 && general <= 2 && (general || (pe == 4 && out_ch <= 16)) &&
         (width == 16 || width == kMaxC) &&
         smem_plan(general ? pe_groups(pe) : 4, general != 0, out_cols(out_ch) > 16,
                   piece_kernel(general ? pe_groups(pe) : 4, width, general != 0,
                                out_cols(out_ch) > 16, split),
                   split, pe, L, in_ch, out_ch, th, tw, width)
                 .bytes <= kSmemLimit;
}

// The count region and counters of a launch of the counting form; counts
// null: the served kernel.
struct Count {
  unsigned long long* counts;
  int y0, y1, x0, x1;
};

// The served kernel and the counting form of instantiation GK: 0 shipped,
// 1 general, 2 general and wide; OW: the last conv past 16 channels; PF:
// the piece forms at width 32 and 16 PE groups.
template <int G, int GK, int C, bool OW, bool PF>
auto kernels_of() {
  if constexpr (PF && !OW)
    return std::make_pair(&sesr_corrected_pieces_kernel<GK == 2>,
                          &sesr_corrected_audit_pieces_kernel<GK == 2>);
  else if constexpr (OW)
    return std::make_pair(&sesr_corrected_wideout_kernel<G, C, GK == 2>,
                          &sesr_corrected_audit_wideout_kernel<G, C, GK == 2>);
  else if constexpr (GK == 2)
    return std::make_pair(&sesr_corrected_wide_kernel<G, C>,
                          &sesr_corrected_audit_wide_kernel<G, C>);
  else
    return std::make_pair(&sesr_corrected_kernel<G, GK == 1, C>,
                          &sesr_corrected_audit_kernel<G, GK == 1, C>);
}

template <int G, int GK, int C, bool OW = false, bool PF = false>
cudaError_t launch(const int8_t* x, int8_t* out, const int* w, const int* prm, int n, int h,
                   int wd, int L, int in_ch, int out_ch, int th, int tw, int split, int pe,
                   const Count& cnt, cudaStream_t stream) {
  const int bytes = smem_plan(G, GK != 0, OW, PF, split, pe, L, in_ch, out_ch, th, tw, C).bytes;
  const auto pair = kernels_of<G, GK, C, OW, PF>();
  auto* kernel = pair.first;
  auto* audit = pair.second;
  const void* fn = cnt.counts ? reinterpret_cast<const void*>(audit)
                              : reinterpret_cast<const void*>(kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = static_cast<long long>(n) * ((h + th - 1) / th) * ((wd + tw - 1) / tw);
  const int grid = static_cast<int>(tiles < sms * per_sm ? tiles : sms * per_sm);
  if (cnt.counts)
    audit<<<grid, kThreads, bytes, stream>>>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th, tw,
                                             split, pe, cnt.counts, cnt.y0, cnt.y1, cnt.x0,
                                             cnt.x1);
  else
    kernel<<<grid, kThreads, bytes, stream>>>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th, tw,
                                              split, pe);
  return cudaGetLastError();
}

// the general instantiation GK (1, or 2 wide) of width C at 4, 8 or 16 PE
// groups; OW: the last conv past 16 channels
template <int GK, int C, bool OW>
cudaError_t launch_groups(const int8_t* x, int8_t* out, const int* w, const int* prm, int n,
                          int h, int wd, int L, int in_ch, int out_ch, int th, int tw, int split,
                          int pe, const Count& cnt, cudaStream_t s) {
  if (pe_groups(pe) == 4)
    return launch<4, GK, C, OW, OW>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th, tw, split, pe,
                                    cnt, s);
  if (pe_groups(pe) == 8)
    return launch<8, GK, C, OW, OW>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th, tw, split, pe,
                                    cnt, s);
  if constexpr (C == 32 && !OW) {
    if (piece_kernel(16, C, true, false, split))
      return launch<16, GK, C, false, true>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th, tw,
                                            split, pe, cnt, s);
  }
  return launch<16, GK, C, OW, OW>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th, tw, split, pe,
                                   cnt, s);
}

// the instantiation of width C: shipped, or general (1), or its wide form (2)
template <int C>
cudaError_t launch_width(const int8_t* x, int8_t* out, const int* w, const int* prm, int n,
                         int h, int wd, int L, int in_ch, int out_ch, int th, int tw, int split,
                         int pe, int general, const Count& cnt, cudaStream_t s) {
  if (!general)
    return launch<4, 0, C>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th, tw, split, pe, cnt, s);
  if (out_cols(out_ch) > 16)
    return general == 1 ? launch_groups<1, C, true>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th,
                                                    tw, split, pe, cnt, s)
                        : launch_groups<2, C, true>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th,
                                                    tw, split, pe, cnt, s);
  if (general == 1)
    return launch_groups<1, C, false>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th, tw, split, pe,
                                      cnt, s);
  return launch_groups<2, C, false>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th, tw, split, pe,
                                    cnt, s);
}

int launch_net(const void* x, void* out, const void* weights, const void* params, int n, int h,
               int w, int num_layers, int in_ch, int out_ch, int tile_h, int tile_w, int split,
               int pe, int general, int width, const Count& cnt, void* stream) {
  if (!takes(num_layers, in_ch, out_ch, tile_h, tile_w, split, pe, general, width) ||
      (reinterpret_cast<uintptr_t>(weights) & 15))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* oi = static_cast<int8_t*>(out);
  const int* wi = static_cast<const int*>(weights);
  const int* pi = static_cast<const int*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      width == 16 ? launch_width<16>(xi, oi, wi, pi, n, h, w, num_layers, in_ch, out_ch, tile_h,
                                     tile_w, split, pe, general, cnt, s)
                  : launch_width<kMaxC>(xi, oi, wi, pi, n, h, w, num_layers, in_ch, out_ch,
                                        tile_h, tile_w, split, pe, general, cnt, s);
  return static_cast<int>(err);
}

#endif  // SESR_CORRECTED_BODY_ONLY

}  // namespace

#ifndef SESR_CORRECTED_BODY_ONLY

extern "C" {

// x: int8 (n, h, w, in_ch) quantized input; out: int8 (n, h, w, out_ch);
// weights / params: int32 device arrays built by sesr_tpu_torch/convert.py
// (weights 16-byte aligned); split: bit i set where conv i runs one pass per
// PE, the params' pe_split word (B's size depends on it); pe: the
// datapath's PEs; general: the instantiation, 0 the shipped one, 1 the one
// for any PE count and widths (KernelConstants.general; required where pe
// != 4), 2 its wide form (KernelConstants.wide); width: the hidden
// width the network runs at, 16 or 32 (KernelConstants.width).
int sesr_corrected_net(const void* x, void* out, const void* weights, const void* params,
                       int n, int h, int w, int num_layers, int in_ch, int out_ch,
                       int tile_h, int tile_w, int split, int pe, int general, int width,
                       void* stream) {
  return launch_net(x, out, weights, params, n, h, w, num_layers, in_ch, out_ch, tile_h, tile_w,
                    split, pe, general, width, Count{nullptr, 0, 0, 0, 0}, stream);
}

// The counting form of sesr_corrected_net (the same arguments, then the
// counters and the count region): the same output, and counts[i] (a device
// array of num_layers unsigned 64-bit words, 8-byte aligned) increased by
// the PE partials that the 18-bit clamp changed on split layer i at the
// outputs (y, x) with y0 <= y < y1 and x0 <= x < x1 of every frame; one
// 64-bit atomic a warp and split layer of each tile.
int sesr_corrected_audit(const void* x, void* out, const void* weights, const void* params,
                         int n, int h, int w, int num_layers, int in_ch, int out_ch, int tile_h,
                         int tile_w, int split, int pe, int general, int width, void* counts,
                         int y0, int y1, int x0, int x1, void* stream) {
  if (counts == nullptr || (reinterpret_cast<uintptr_t>(counts) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_net(x, out, weights, params, n, h, w, num_layers, in_ch, out_ch, tile_h, tile_w,
                    split, pe, general, width,
                    Count{static_cast<unsigned long long*>(counts), y0, y1, x0, x1}, stream);
}

// Shared memory of one block of sesr_corrected_net in bytes, or 0 where it
// refuses the network, the tile, the split mask, the PE count, the
// instantiation (general) or the width.
int sesr_corrected_smem(int num_layers, int in_ch, int out_ch, int tile_h, int tile_w, int split,
                        int pe, int general, int width) {
  if (!takes(num_layers, in_ch, out_ch, tile_h, tile_w, split, pe, general, width)) return 0;
  const int G = general ? pe_groups(pe) : 4;
  const bool ow = out_cols(out_ch) > 16;
  return smem_plan(G, general != 0, ow, piece_kernel(G, width, general != 0, ow, split), split, pe,
                   num_layers, in_ch, out_ch, tile_h, tile_w, width)
      .bytes;
}

const char* sesr_corrected_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#endif  // SESR_CORRECTED_BODY_ONLY
