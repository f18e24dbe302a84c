// Fused whole-network SESR inference on Hopper (sm_90a): one thread block
// runs every conv of the collapsed network over one output tile of one
// frame, with all intermediates in shared memory. Device memory sees one
// int8 read of the input tile (with its halo), the weights, and one int8
// write of the output tile.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   sesr_pe_exact_net  <- sesr_tpu/ops/pallas_pipeline.py build_pallas_forward
//                         (the reference-exact 4-PE datapath, K1)
//   sesr_fast_net      <- sesr_tpu/ops/pallas_packed.py build_pallas_packed_forward
//                         (the certified fast deployment datapath, K2)
// Their plain version is sesr_tpu_torch/quant/integer.py integer_forward
// (corrected=False / compute="fast" with corrected=True). The corrected
// datapath's kernel (the hybrid and corrected PE-exact modes) is
// sesr_corrected.cu, on wgmma.
//
// Networks of 3 to 16 convs (kMaxL; a deeper one, or one whose plan fits
// no tile, runs in layer groups: sesr_net_group.cu) at hidden width 16 or
// 32 (C, a template parameter; a narrower network runs padded to the next): the
// shipped tasks and SESR-M11 at 16, SESR-XL at 32. The last conv has 1 to 48
// output channels (kMaxOut): the shipped instantiations template on the
// count (OCL = 3, 12 or 16), the general ones on the padded count out_cols
// (OCL = -8, -16, -32, -48: 1, 2, 4 or 6 n-tiles), the count read from the
// last conv's record (R_OUT).
//
// What bounds it on this card: operations. sr_x2 needs 12,912 int8 MACs per
// input pixel against 15 bytes of device traffic (SESR-M11 31,344, SESR-XL
// 113,376), far above the H100's ratio of int8 tensor-core rate to memory
// rate, so the floor is the int8 tensor-core rate. What the design does
// about the bound:
//   - every conv is an implicit GEMM on the int8 tensor cores
//     (mma.sync.m16n8k32 s8 x s8 -> s32, exact int32 sums): a row of A is
//     one pixel of the layer's output extent (the extent flattened and cut
//     into sixteens, the tail masked), k runs over (tap, input byte), n
//     over output channels. Padded taps carry zero weights;
//   - two forms of a layer. One pass over all channels, k = (tap, word,
//     byte), 2 taps per k32 chunk at C = 16, 1 at C = 32: K2 everywhere, and K1 wherever convert.py
//     proves from the weights that no PE's accumulator clamp (18 bits
//     shipped) can fire (then the sum of the clamped PE sums is the full
//     sum). One pass per PE, each PE's sum clamped before adding: K1 on the
//     other layers; at 4 PEs k = (tap, byte of PE p's words p (and p + 4 at
//     C = 32)), 8 (4) taps per chunk, at 8, 12 or 16 PEs the same over PE
//     p's words p % 4 (and p % 4 + 4), whose other bytes meet zero weights,
//     at any other PE count k as in the one-pass form with B zero outside
//     the PE's channels (c % pe == p). Layer 0 (one word of <= 4 channels)
//     takes 8 taps per chunk, once per PE that owns an input channel when
//     split. The adder clamp (20 bits shipped) runs only where it can fire
//     (K2), or on every layer in the general instantiation that any other
//     HardwareConfig runs (K1 off 4 PEs; a K1 or K2 whose adder clamp can
//     fire, whose activations are not int8 or whose sums may pass 2^22),
//     which clips activations to the artifact's [-2^(b-1), 2^(b-1) - 1];
//   - activations stay int8 from layer to layer, packed four channels to a
//     32-bit word: word w of a pixel holds channels w % 4 + 16 (w / 4) + 4 j
//     (16 channels: word p holds p, p+4, p+8, p+12; 32 channels: eight
//     words, PE p's channels in words p and p + 4 at 4 PEs). An A register
//     is one such word, loaded from a buffer with no repacking; convert.py
//     orders the weights into B fragments (pass, chunk, lane, n-tile, reg)
//     and permutes the output channels so that the values a lane holds for
//     a pixel are words t (and t + 4) of the next layer's input: the
//     epilogue stores C / 16 words per lane and pixel;
//   - the zero shift q - z_eff is never materialized: positions outside
//     the image hold z_eff instead of 0, so conv(q, pads = z_eff) equals
//     conv(q - z_eff) + z_eff * sum(W). Per PE that sum is exactly the
//     reference's zero-restored partial (K1); the corrected datapath starts
//     its accumulator from -z_eff * sum(W) (K2). This needs -128 <= z_eff <=
//     127, which the host checks. The accumulator also starts from the bias
//     plus kMagicBits, so requantization is one FFMA on its bits (the
//     general instantiation's wide form, for sums that may pass 2^22: from
//     the bias alone, the clamped int32 converted once, __int2float_rn);
//   - extents shrink by k/2 per layer (a tile recomputes its halo on every
//     layer: MACs computed over MACs needed 1.29 for sr_x2 at 32x32, 1.98
//     for SESR-M11 at 32x32, 2.48 for SESR-XL at 24x24); a layer's weights
//     are held in registers over its whole extent (at C = 32 past layer 0,
//     72 registers a lane for a 3x3 layer, they are read from shared memory
//     a chunk at a time instead), and the next layer's weights are staged
//     with cp.async while the current layer computes (K1's general
//     instantiation at width 32 keeps one weight buffer where two do not
//     fit a block at the tile, and stages them after the layer: smem_plan);
//     the residual shortcut
//     is kept as int8 (K1: clip(round(s - 128))) or int16 (K2: round(s),
//     its range proven by convert.py) so that 32x32 tiles fit at C = 16.
//     The tile is the largest of ops/kernels.py NET_TILES whose plan
//     (smem_plan) fits a block: 32x32 but for SESR-XL (K1 24x24, K2 16x32).
// What is left: the CUDA-core epilogue (requantization and the int8 clamp of
// every value, half of it on the half-rate ALU pipe) takes more of a layer's
// time than its MMAs and loads; the mma.sync forms reach the tensor cores
// from sm_80 PTX, and Hopper's full int8 rate needs wgmma (64-row warpgroup
// tiles, A and B in shared memory in its K-major layout) with TMA loads.
//
// Numerics: requantization is (y * m) * 2^-n, two float32 multiplies in the
// plain version; the kernel rounds y * (m * 2^-n) once, which is the same
// float whenever every product is a normal float (a power-of-two scale is
// exact; convert.py refuses exponents where it might not be, and
// tests/test_torch_kernels.py holds both forms to the plain version's two
// roundings for the shipped and edge (m, n) on the CPU). Rounding is
// half-to-even, every other float op of the datapath is one __fadd_rn or
// __fmul_rn in the order of the plain version, built with -fmad=false, and
// int <-> float conversions go through kMagic (exact in their range; the
// wide form's sums past it by __int2float_rn, which rounds as the plain
// version's int32 -> float32 cast does).
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (sesr_tpu_torch/ops/_build.py). Each entry point
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sesr_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLoadBatch = 9;   // input pixels per thread in flight: a 32x32 tile's 46x46 in one round

// The datapath of a kernel: K1's reference numerics or K2's certified
// one-pass corrected datapath.
enum Datapath { REFERENCE = 0, FAST = 1 };

// c += A (16x32 s8, row) * B (32x8 s8, col), exact in int32.
__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3,
                                       int b0, int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A lane's B registers of one (pass, chunk): FW = 2 per n-tile.
template <int FW>
__device__ __forceinline__ void load_frag(int (&b)[FW], const int* p) {
  if constexpr (FW == 12) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    const int4 u = *reinterpret_cast<const int4*>(p + 4);
    const int4 t = *reinterpret_cast<const int4*>(p + 8);
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
    b[4] = u.x; b[5] = u.y; b[6] = u.z; b[7] = u.w;
    b[8] = t.x; b[9] = t.y; b[10] = t.z; b[11] = t.w;
  } else if constexpr (FW == 8) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    const int4 u = *reinterpret_cast<const int4*>(p + 4);
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
    b[4] = u.x; b[5] = u.y; b[6] = u.z; b[7] = u.w;
  } else if constexpr (FW == 4) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    b[0] = v.x; b[1] = v.y; b[2] = v.z; b[3] = v.w;
  } else {
    const int2 v = *reinterpret_cast<const int2*>(p);
    b[0] = v.x; b[1] = v.y;
  }
}

// k32 chunks of a K x K layer whose pass reads `wpt` words a tap: 8 / wpt
// taps a chunk. A pass reads one word a tap on layer 0 (<= 4 channels), C /
// 16 on a split layer at 4, 8, 12 or 16 PEs (PE p's channels are words p % 4
// and p % 4 + 4), and all C / 4 words otherwise.
__host__ __device__ constexpr int chunks_of(int k, int wpt) { return (k * k * wpt + 7) / 8; }

// Words of one layer's B fragments at hidden width C: passes x chunks x 32
// lanes x n-tiles x 2 (convert.py _fragment_words builds them in this
// order), with one pass per PE (split) or one pass over all channels. A
// split layer's passes: layer 0 one per PE that owns an input channel,
// min(in_ch, pe); a hidden layer at a PE count that is a multiple of four
// one per PE over its C / 16 words; at any other PE count one per PE over
// all C / 4 words (the other PEs' weights zero).
__host__ __device__ inline int layer_words(bool split, int layer, int L, int in_ch, int ocl,
                                           int pe, int C) {
  if (layer == 0) return (split ? (in_ch < pe ? in_ch : pe) : 1) * chunks_of(5, 1) * 32 * (C / 4);
  const int k = layer < L - 1 ? 3 : 5;
  const int chunks = split ? pe * chunks_of(k, pe % 4 == 0 ? C / 16 : C / 4)
                           : chunks_of(k, C / 4);
  return chunks * 32 * (layer < L - 1 ? C / 4 : out_cols(ocl) / 4);
}

__device__ __forceinline__ bool pe_split(const int* prm, int layer) {
  return (prm[P_SPLIT] >> layer) & 1;
}

// Whether conv i runs one pass per PE (its B fragments are the per-PE ones)
template <int DP>
__device__ __forceinline__ bool split_of(const int* prm, int layer) {
  return DP == REFERENCE && pe_split(prm, layer);
}

// The pass forms of a layer: one pass over all channels (ONE); one pass per
// PE, each PE's sum clamped to pe_acc_bits before the sums are added: up to
// four unrolled (FOUR: layer 0, whose passes read one word a pixel, and a
// hidden layer at 4 PEs, pass p reading PE p's words p and p + 4), a loop
// over the PEs each reading its words p % 4 and p % 4 + 4 (WORDS: 8, 12 or
// 16 PEs), or a loop over the PEs each reading all C / 4 words against B zero
// outside the PE's channels (MASKED: any other PE count).
enum Passes { ONE = 0, FOUR = 1, WORDS = 2, MASKED = 3 };

// One conv layer over the output extent eh x ew (in this layer's output
// frame, which is the next layer's input frame), as an implicit GEMM. `in`
// holds the input extent (eh + K - 1) x (ew + K - 1): one word per pixel
// (FIRST) or C / 4 planes `in_ps` words apart; `w` the layer's B fragments.
// A split form (PS, K1) runs `npass` passes, one per PE; ONE, which K1
// takes where convert.py proves the accumulator clamp cannot fire, one pass
// over all channels. CLAMP (K2, and K1's general instantiation) clamps the
// sum to pe_add_bits. GEN: the general instantiation, whose activations lie
// in [-half, half - 1] (quant_half; int8's otherwise); WIDE (GEN only): the
// sum is a plain int32, converted to float32 once, for sums that may pass
// 2^22. The epilogue writes the next layer's input planes (FIRST, MID), the
// shortcut terms (FIRST) or the output (LAST). OC: the layer's output
// channels, or (OC < 0, the general instantiations' last conv) -OC padded
// columns, the count read from the layer's record; past C channels its bias
// and z_eff * sum(W) rows are read from the block in device memory, gprm
// (R_ROWS). STAGE (a looped split form of the layer-group kernels,
// sesr_net_group.cu): B a pass at a time, pass q of the layer's rounds of
// m-tiles in buffer w (q even, or one buffer: w_alt == w) or w_alt, staged
// from wg (the layer's B in device memory) while the pass before computes
// (two buffers) or after it (one); every warp takes part in each round.
// PAIR (FIRST, the two-conv group of sesr_net_group.cu): the first conv is
// also the one before the last, so its epilogue writes the last conv's
// domain-in, the residual add of its own ReLU output to itself (the
// shortcut), and keeps no shortcut.
__device__ __forceinline__ void stage_async(int* dst, const int* __restrict__ src, int words);
__device__ __forceinline__ void wait_staged();

template <int DP, int PS, bool CLAMP, bool GEN, bool WIDE, int K, Kind KIND, int OC, int C,
          bool STAGE = false, bool PAIR = false>
__device__ __forceinline__ void conv_layer(
    const int* __restrict__ in, int in_ps, const int* __restrict__ w, int npass,
    int eh, int ew, const Tile& t, int layer, bool prelast,
    const int* __restrict__ prm, const int* __restrict__ gprm, int* __restrict__ next,
    int next_ps, int* __restrict__ sc, int sc_ps, int sc_off, int sc_w, int sc_h,
    int8_t* __restrict__ out, int frame, int* w_alt = nullptr,
    const int* __restrict__ wg = nullptr) {
  constexpr int KK = K * K;
  constexpr int NT = (OC > 0 ? OC + 7 : -OC) / 8;    // n-tiles of 8 channels
  constexpr bool ROWS = OC < -C;                     // the last conv's rows past the record's
  static_assert(OC > 0 || KIND == LAST, "a count read at run time is the last conv's");
  const int ocn = OC > 0 ? OC : prm[p_at(layer, R_OUT, C)];
  constexpr int FW = 2 * NT;                         // B registers per (pass, chunk)
  constexpr int NV = 2 * NT;                         // values a lane holds per pixel
  static_assert((PS != WORDS && PS != MASKED) || KIND != FIRST,
                "a looped pass is a split hidden layer's");
  static_assert(C == 16 || C == 32, "the hidden widths are 16 and 32");
  static_assert(GEN || !WIDE, "the wide form is the general instantiation's");
  static_assert(!PAIR || KIND == FIRST, "a pair's pre-last conv is its first");
  constexpr bool SPLIT = PS != ONE;
  constexpr bool TAPS = PS == FOUR || PS == WORDS || KIND == FIRST;   // a pass reads its own words
  // k-slot s of chunk c is word s % WPT of the pass's words (TAPS: its
  // word p % 4 + 4 j is j; else word j) at tap TPC c + s / WPT
  constexpr int WPT = KIND == FIRST ? 1 : (TAPS ? C / 16 : C / 4);
  constexpr int TPC = 8 / WPT;
  constexpr int NCH = chunks_of(K, WPT);
  constexpr int NP = PS == FOUR ? 4 : 1;             // passes unrolled (FIRST: up to 4)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int iw = ew + K - 1;
  const int npix = eh * ew;
  const unsigned ew_magic = 0xffffffffu / ew + 1;    // r / ew == umulhi(r, ew_magic)
  const int r_out = (eh - t.th) / 2;   // ring of this output frame
  const int acc_hi = prm[P_ACC_HI];
  const int add_hi = prm[P_ADD_HI];
  // (y * m) * 2^-n == y * (m * 2^-n) in float32: scaling by a power of two
  // is exact, so both round the same real product (convert.py keeps every
  // product normal). With y read as the float kMagic + y, one FFMA:
  // fl(a * s - kMagic * s) for s = m * 2^-n (kMagic * s is exact).
  const float rq_s = __fmul_rn(as_f32(prm[p_at(layer, R_RQM, C)]),
                               as_f32(prm[p_at(layer, R_RQP, C)]));
  const float rq_c = -kMagic * rq_s;
  // the activations' range [-half, half - 1], and its clip bounds for
  // qn_bits (int8's, in the shipped instantiation)
  const float half = GEN ? quant_half(prm) : 128.f;
  const float q_lo = kMagic - half, q_hi = kMagic + (half - 1.f);
  // accumulator (n, i) of this lane is channel chan(2n + (i & 1)): the last
  // layer's columns are in order (channels 8n + 2tq, 8n + 2tq + 1), a
  // hidden layer's permuted (channel tq + 4j, byte j & 3 of word tq + 4 (j >>
  // 2)). It starts from bias + kMagicBits - z_eff * sum(W) (K1: that term
  // is 0), so it ends as kMagicBits + y_int (WIDE: from bias - z_eff *
  // sum(W), ending as y_int); the 20-bit clamp of conv(q - z_eff), where it
  // runs, is shifted by the same constant.
  auto chan = [&](int j) { return KIND == LAST ? 8 * (j >> 1) + 2 * tq + (j & 1) : tq + 4 * j; };
  const int* rows = ROWS ? gprm + prm[p_at(layer, R_ROWS, C)] : prm + p_at(layer, R_BIAS, C);
  const int zc_at = ROWS ? ocn : C;                  // the z_eff * sum(W) row, from the bias row
  int init[NV], lo_c[NV], hi_c[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int o = chan(j);
    const int b = (o < ocn ? rows[o] : 0) + (WIDE ? 0 : kMagicBits);
    init[j] = b - (o < ocn ? rows[zc_at + o] : 0);
    lo_c[j] = b - add_hi - 1;
    hi_c[j] = b + add_hi;
  }

  // input offsets of this lane's k-slots tq (a0, a1) and tq + 4 (a2, a3),
  // from the pass's first word: slot tq + 4 is 4 / WPT taps on in the same
  // word, or (WPT = 8) word tq + 4 of the same tap. Written so, the
  // compiler sees the two share their plane (a form that hid it made K2's
  // layer-0 loop 14 % longer). A padded tap reads tap 0 against zero
  // weights.
  const int pa = (TAPS ? 4 : 1) * (tq % WPT) * in_ps, pb = pa + 4 % WPT * in_ps;
  int oa[NCH], ob[NCH];
#pragma unroll
  for (int c = 0; c < NCH; ++c) {
    const int ta = TPC * c + tq / WPT, tb = ta + 4 / WPT;
    oa[c] = pa + (ta < KK ? (ta / K) * iw + ta % K : 0);
    ob[c] = pb + (tb < KK ? (tb / K) * iw + tb % K : 0);
  }
  // the layer's B fragments are held in registers, except K1's layer 0
  // (up to 4 passes), its looped passes (up to 16) and every layer past
  // layer 0 at width 32, which read them from shared memory per chunk
  constexpr bool WSMEM = (SPLIT && (KIND == FIRST || PS == WORDS || PS == MASKED)) ||
                         (C > 16 && KIND != FIRST) || NT > 2;
  constexpr int WP = WSMEM ? 1 : NP, WC = WSMEM ? 1 : NCH;
  int wr[WP][WC][FW];
  if constexpr (!WSMEM) {
#pragma unroll
    for (int p = 0; p < WP; ++p)
#pragma unroll
      for (int c = 0; c < WC; ++c) load_frag<FW>(wr[p][c], w + ((p * NCH + c) * 32 + lane) * FW);
  }

  static_assert(!STAGE || PS == WORDS || PS == MASKED, "a staged layer loops over its passes");
  constexpr int PW = NCH * 32 * FW;                  // words of one pass's B
  const int rounds = (npix + 16 * kWarps - 1) / (16 * kWarps);
  int q = 0;                                         // STAGE: passes computed so far
  for (int mt = warp; STAGE ? mt < rounds * kWarps : mt * 16 < npix; mt += kWarps) {
    int ys[2], xs[2], bases[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = min(mt * 16 + g + 8 * h, npix - 1);
      ys[h] = static_cast<int>(__umulhi(static_cast<unsigned>(r), ew_magic));
      xs[h] = r - ys[h] * ew;
      bases[h] = r + ys[h] * (K - 1);
    }
    int tot[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[n][i] = init[2 * n + (i & 1)];

    if constexpr (PS == ONE) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int a0 = in[bases[0] + oa[c]], a1 = in[bases[1] + oa[c]];
        const int a2 = in[bases[0] + ob[c]], a3 = in[bases[1] + ob[c]];
        if constexpr (WSMEM) {
          int b[FW];
          load_frag<FW>(b, w + (c * 32 + lane) * FW);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_s8(tot[n], a0, a1, a2, a3, b[2 * n], b[2 * n + 1]);
        } else {
#pragma unroll
          for (int n = 0; n < NT; ++n)
            mma_s8(tot[n], a0, a1, a2, a3, wr[0][c][2 * n], wr[0][c][2 * n + 1]);
        }
      }
    } else if constexpr (KIND == FIRST) {
      // one input word per pixel: every PE's pass reads the same A
      int acc[NP][NT][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[p][n][i] = 0;   // the pads restore the zero
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int a0 = in[bases[0] + oa[c]], a1 = in[bases[1] + oa[c]];
        const int a2 = in[bases[0] + ob[c]], a3 = in[bases[1] + ob[c]];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if (p < npass) {
            int b[FW];
            load_frag<FW>(b, w + ((p * NCH + c) * 32 + lane) * FW);
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_s8(acc[p][n], a0, a1, a2, a3, b[2 * n], b[2 * n + 1]);
          }
        }
      }
#pragma unroll
      for (int p = 0; p < NP; ++p)
        if (p < npass)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) tot[n][i] += min(max(acc[p][n][i], -acc_hi - 1), acc_hi);
    } else if constexpr (PS == WORDS || PS == MASKED) {
      // PE p's pass reads its words p % 4 + 4 j (WORDS) or all C / 4 words
      // (MASKED) of each tap, against B holding its channels only
      for (int p = 0; p < npass; ++p) {
        int acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] = 0;
        const int* src = in + (PS == WORDS ? (p & 3) * in_ps : 0);
        const int* wp = w;                   // STAGE: the buffer pass q lies in
        if constexpr (STAGE) {
          // pass q's B has landed and every warp is done with pass q - 1's
          wait_staged();
          __syncthreads();
          const bool two = w_alt != w;
          if (two && q + 1 < rounds * npass)
            stage_async((q & 1) ? const_cast<int*>(w) : w_alt, wg + (q + 1) % npass * PW, PW);
          wp = two && (q & 1) ? w_alt : w;
        }
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int a0 = src[bases[0] + oa[c]], a1 = src[bases[1] + oa[c]];
          const int a2 = src[bases[0] + ob[c]], a3 = src[bases[1] + ob[c]];
          int b[FW];
          if constexpr (STAGE) load_frag<FW>(b, wp + (c * 32 + lane) * FW);
          else load_frag<FW>(b, w + ((p * NCH + c) * 32 + lane) * FW);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_s8(acc[n], a0, a1, a2, a3, b[2 * n], b[2 * n + 1]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) tot[n][i] += min(max(acc[n][i], -acc_hi - 1), acc_hi);
        if constexpr (STAGE) {
          if (w_alt == w && q + 1 < rounds * npass) {
            __syncthreads();
            stage_async(const_cast<int*>(w), wg + (q + 1) % npass * PW, PW);
          }
          ++q;
        }
      }
    } else {
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        int acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] = 0;
        const int* src = in + p * in_ps;               // PE p reads its words from word p
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          const int a0 = src[bases[0] + oa[c]], a1 = src[bases[1] + oa[c]];
          const int a2 = src[bases[0] + ob[c]], a3 = src[bases[1] + ob[c]];
          if constexpr (WSMEM) {
            int b[FW];
            load_frag<FW>(b, w + ((p * NCH + c) * 32 + lane) * FW);
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_s8(acc[n], a0, a1, a2, a3, b[2 * n], b[2 * n + 1]);
          } else {
#pragma unroll
            for (int n = 0; n < NT; ++n)
              mma_s8(acc[n], a0, a1, a2, a3, wr[p][c][2 * n], wr[p][c][2 * n + 1]);
          }
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) tot[n][i] += min(max(acc[n][i], -acc_hi - 1), acc_hi);
      }
    }

    // ---- epilogue: this lane holds rows g (c0, c1) and g + 8 (c2, c3) ----
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = mt * 16 + g + 8 * h;
      if (r >= npix) continue;
      const int y = ys[h], x = xs[h];
      const int gy = t.oy0 - r_out + y;
      const int gx = t.ox0 - r_out + x;
      const bool inside = gy >= 0 && gy < t.H && gx >= 0 && gx < t.W;
      // (y_int * m) * 2^-n
      float hq[NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        int yi = tot[j >> 1][2 * h + (j & 1)];
        if constexpr (CLAMP) yi = min(max(yi, lo_c[j]), hi_c[j]);
        hq[j] = WIDE ? __fmul_rn(__int2float_rn(yi), rq_s)
                     : __fmaf_rn(__int_as_float(yi), rq_s, rq_c);
      }
      if constexpr (KIND == LAST) {
        if (!inside || y >= t.th || x >= t.tw) continue;
        const float z_out = as_f32(prm[P_ZOUT]);
        int8_t* dst = out + ((static_cast<size_t>(frame) * t.H + gy) * t.W + gx) * ocn;
        const bool pairs = OC > 0 ? OC % 2 == 0 : (ocn & 1) == 0;   // a pixel's row even: 2-byte stores
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int o = 8 * n + 2 * tq;
          const int v0 = qn_bits(__fadd_rn(hq[2 * n], z_out), q_lo, q_hi);
          const int v1 = qn_bits(__fadd_rn(hq[2 * n + 1], z_out), q_lo, q_hi);
          if (pairs) {
            if (o < ocn)
              *reinterpret_cast<uint16_t*>(dst + o) = static_cast<uint16_t>(__byte_perm(v0, v1, 0x0040));
          } else {
            if (o < ocn) dst[o] = static_cast<int8_t>(v0);
            if (o + 1 < ocn) dst[o + 1] = static_cast<int8_t>(v1);
          }
        }
      } else {
        // this lane's words of the pixel: tq + 4 m holds values 4 m .. 4 m + 3
        if (!inside) {
          const int pad = pad_word(prm[p_at(layer + 1, R_ZEFF, C)]);
#pragma unroll
          for (int m = 0; m < NV / 4; ++m) next[(tq + 4 * m) * next_ps + r] = pad;
          continue;
        }
        const float z_next = as_f32(prm[p_at(layer + 1, R_ZIN, C)]);
        int v[NV];
        if (KIND == FIRST || prelast) {
#pragma unroll
          for (int j = 0; j < NV; ++j) hq[j] = fmaxf(hq[j], 0.f);    // ReLU
        }
        if constexpr (PAIR) {
          // the last conv's domain-in from this conv's ReLU output h, which
          // is the shortcut too: s + h with s = h, rescaled as below
          const float res_s = __fmul_rn(as_f32(prm[P_RESM]), as_f32(prm[P_RESP]));
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            float tr;
            if constexpr (DP == REFERENCE) {
              const float c = magic_to_f32(qn_bits(__fsub_rn(hq[j], half), q_lo, q_hi));
              tr = __fadd_rn(__fadd_rn(c, c), 2.f * half);
            } else {
              const float c = rintf(hq[j]);
              tr = __fadd_rn(c, c);
            }
            v[j] = qn_bits(__fadd_rn(__fmul_rn(tr, res_s), z_next), q_lo, q_hi);
          }
        } else if (KIND == MID && prelast) {
          // the last conv's domain-in: the integer residual add, rescaled
          // by s_1 / s_{L-1}, into domain L-1 (this frame is the shortcut's)
          const float res_s = __fmul_rn(as_f32(prm[P_RESM]), as_f32(prm[P_RESP]));
#pragma unroll
          for (int j = 0; j < NV; ++j) {
            float tr;
            if constexpr (DP == REFERENCE) {
              const int s = static_cast<int8_t>(sc[(tq + 4 * (j >> 2)) * sc_ps + r] >> (8 * (j & 3)));
              const float c = magic_to_f32(qn_bits(__fsub_rn(hq[j], half), q_lo, q_hi));
              tr = __fadd_rn(__fadd_rn(magic_to_f32(s + kMagicBits), c), 2.f * half);
            } else {
              const int s = static_cast<int16_t>(sc[(tq + 4 * (j >> 1)) * sc_ps + r] >> (16 * (j & 1)));
              tr = __fadd_rn(magic_to_f32(s + kMagicBits), rintf(hq[j]));
            }
            v[j] = qn_bits(__fadd_rn(__fmul_rn(tr, res_s), z_next), q_lo, q_hi);
          }
        } else if (KIND == FIRST) {
#pragma unroll
          for (int j = 0; j < NV; ++j) v[j] = qn_bits(__fadd_rn(hq[j], z_next), q_lo, q_hi);
        } else {
          // ReLU folded into the low bound: fl(max(h, 0) + z) = max(fl(h + z), z)
          // and rounding is monotone, so clip(rint(.), max(z, -half), half - 1)
          const float lo = kMagic + fmaxf(z_next, -half);
#pragma unroll
          for (int j = 0; j < NV; ++j)
            v[j] = __float_as_int(
                fminf(fmaxf(__fadd_rn(__fadd_rn(hq[j], z_next), kMagic), lo), q_hi));
        }
#pragma unroll
        for (int m = 0; m < NV / 4; ++m)
          next[(tq + 4 * m) * next_ps + r] = pack_bytes(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
        if (KIND == FIRST && !PAIR) {
          // the residual shortcut, as the last conv's domain-in consumes it:
          // reference: clip(round(s - half)) as int8, plane tq + 4 m holding
          // values 4 m .. 4 m + 3; K2: round(s) as int16 (0 <= round(s) <=
          // 32767, convert.py shortcut_bound), plane tq + 4 m values 2 m and
          // 2 m + 1
          const int sy = y - sc_off, sx = x - sc_off;
          if (sy >= 0 && sy < sc_h && sx >= 0 && sx < sc_w) {
            const int sp = sy * sc_w + sx;
            if constexpr (DP == REFERENCE) {
              int b[NV];
#pragma unroll
              for (int j = 0; j < NV; ++j) b[j] = qn_bits(__fsub_rn(hq[j], half), q_lo, q_hi);
#pragma unroll
              for (int m = 0; m < NV / 4; ++m)
                sc[(tq + 4 * m) * sc_ps + sp] = pack_bytes(b[4 * m], b[4 * m + 1], b[4 * m + 2], b[4 * m + 3]);
            } else {
              int b[NV];
#pragma unroll
              for (int j = 0; j < NV; ++j) b[j] = __float_as_int(__fadd_rn(hq[j], kMagic));
#pragma unroll
              for (int m = 0; m < NV / 2; ++m)
                sc[(tq + 4 * m) * sc_ps + sp] = static_cast<int>(__byte_perm(b[2 * m], b[2 * m + 1], 0x5410));
            }
          }
        }
      }
    }
  }
}

// cp.async of `words` (a multiple of 4) int32 from device memory into
// shared memory, as one commit group; wait_staged() waits for all groups.
__device__ __forceinline__ void stage_async(int* dst, const int* __restrict__ src, int words) {
  for (int i = threadIdx.x * 4; i < words; i += blockDim.x * 4) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src + i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// plane stride of a planar buffer: >= n and 8 mod 32 words, so that the
// lanes (g, tq) of a warp, touching word tq of 8 consecutive pixels, hit 32
// distinct banks
__host__ __device__ inline int plane_stride(int n) { return ((n + 23) & ~31) + 8; }

constexpr int kSmemLimit = 232448;          // a block's shared memory on the H100

struct Smem {
  int prm_words, w_words, w_bufs, a_words, b_words, sc_words;
};

// Shared memory of one block at hidden width C: room for the parameter
// block's words that K1 and K2 read at the deepest network (net_words(kMaxL,
// C); a fixed offset keeps the buffers' addresses as the compiler had them
// before the depth was raised, and a shallower network copies fewer), the
// weight buffers (each the size of the largest layer's fragments: every
// layer split for K1 at 4 PEs, the split layers of the mask `split` in K1's
// general instantiation; two, the next layer's staged while a layer
// computes, but one for K1's general instantiation at width 32 where two
// do not fit a block at the tile, its passes past four PEs making a split
// layer's fragments up to pe times a one-pass layer's, and the next layer's
// are then staged after the layer's barrier), the ping-pong
// activation buffers (C / 4 planes) and the shortcut (C / 4 planes of int8
// for K1, C / 2 of int16 pairs for K2). ops/kernels.py net_smem_bytes
// mirrors it.
__host__ __device__ inline Smem smem_plan(int dp, bool gen, int split, int pe, int L, int in_ch,
                                          int ocl, int th, int tw, int C) {
  Smem s;
  s.prm_words = net_words(kMaxL, C);
  s.w_words = 0;                         // a split layer's fragments are the larger
  for (int i = 0; i < L; ++i) {
    const bool sp = gen ? (split >> i) & 1 : dp == REFERENCE;
    const int lw = layer_words(sp, i, L, in_ch, ocl, pe, C);
    s.w_words = s.w_words > lw ? s.w_words : lw;
  }
  // layer i's input: buf_b for even i (layer 0: one word per pixel), buf_a for odd
  s.a_words = 0;
  s.b_words = (extent(0, L, th, tw) + 3) & ~3;
  for (int i = 1; i < L; ++i) {
    const int words = C / 4 * plane_stride(extent(i, L, th, tw));
    int& dst = (i % 2) ? s.a_words : s.b_words;
    dst = dst > words ? dst : words;
  }
  s.sc_words = (dp == REFERENCE ? C / 4 : C / 2) * plane_stride(extent(L - 1, L, th, tw));
  const int two = s.prm_words + 2 * s.w_words + s.a_words + s.b_words + s.sc_words;
  s.w_bufs = gen && dp == REFERENCE && C == 32 && 4 * two > kSmemLimit ? 1 : 2;
  return s;
}

// conv `layer` in its form: one pass per PE where its split bit is set (K1;
// `npass` passes), else one pass, clamped to pe_add_bits where its clamp bit
// is set (K2 from conv 1 on, where convert.py proves conv 0's idle). The
// general instantiation (GEN: any PE count, widths and activation width)
// clamps every layer's sum to pe_add_bits, the identity where that clamp
// cannot fire; WIDE: its wide form; PAIR: conv_layer's. The arguments are
// conv_layer's.
template <int DP, bool GEN, int K, Kind KIND, int OC, int C, bool WIDE, bool PAIR = false>
__device__ __forceinline__ void conv_form(
    const int* __restrict__ in, int in_ps, const int* __restrict__ w, int npass,
    int eh, int ew, const Tile& t, int layer, bool prelast,
    const int* __restrict__ prm, const int* __restrict__ gprm, int* __restrict__ next,
    int next_ps, int* __restrict__ sc, int sc_ps, int sc_off, int sc_w, int sc_h,
    int8_t* __restrict__ out, int frame) {
  if constexpr (DP == REFERENCE) {
    if (pe_split(prm, layer)) {
      if (KIND == FIRST || npass == 4) {
        conv_layer<DP, FOUR, GEN, GEN, WIDE, K, KIND, OC, C, false, PAIR>(
            in, in_ps, w, npass, eh, ew, t, layer, prelast, prm, gprm, next, next_ps, sc, sc_ps,
            sc_off, sc_w, sc_h, out, frame);
      } else if constexpr (GEN && KIND != FIRST) {
        if (npass % 4 == 0)
          conv_layer<DP, WORDS, true, true, WIDE, K, KIND, OC, C>(in, in_ps, w, npass, eh, ew, t,
                                                                  layer, prelast, prm, gprm, next,
                                                                  next_ps, sc, sc_ps, sc_off,
                                                                  sc_w, sc_h, out, frame);
        else
          conv_layer<DP, MASKED, true, true, WIDE, K, KIND, OC, C>(in, in_ps, w, npass, eh, ew,
                                                                   t, layer, prelast, prm, gprm, next,
                                                                   next_ps, sc, sc_ps, sc_off,
                                                                   sc_w, sc_h, out, frame);
      }
      return;
    }
  }
  if constexpr (GEN || (DP == FAST && KIND != FIRST)) {
    if (GEN || ((prm[P_CLAMP] >> layer) & 1)) {
      conv_layer<DP, ONE, true, GEN, WIDE, K, KIND, OC, C, false, PAIR>(
          in, in_ps, w, 1, eh, ew, t, layer, prelast, prm, gprm, next, next_ps, sc, sc_ps, sc_off,
          sc_w, sc_h, out, frame);
      return;
    }
  }
  conv_layer<DP, ONE, false, GEN, WIDE, K, KIND, OC, C, false, PAIR>(
      in, in_ps, w, 1, eh, ew, t, layer, prelast, prm, gprm, next, next_ps, sc, sc_ps, sc_off,
      sc_w, sc_h, out, frame);
}

// The whole network over one tile, the body of both kernels. GEN: the
// instantiation for any PE count, widths and activation width (convert.py
// KernelConstants.general: K1 off 4 PEs or where an adder clamp can fire,
// K2 where its conv 0's can, both off int8 activations or where a sum may
// pass 2^22); the shipped artifacts run the other, at 4 PEs. WIDE (GEN
// only; KernelConstants.wide): every sum a plain int32, for sums that may
// pass 2^22. C: the hidden width, 16 (the shipped networks, SESR-M11) or
// 32 (SESR-XL); a narrower network runs padded to the next.
template <int DP, int OCL, bool GEN, int C, bool WIDE>
__device__ __forceinline__ void net_tile(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                         const int* __restrict__ weights,
                                         const int* __restrict__ params, int H, int W, int L,
                                         int in_ch, int th, int tw, int split, int pe_in) {
  extern __shared__ int4 smem4[];
  const int pe = GEN ? pe_in : 4;
  constexpr int OCW = OCL > 0 ? OCL : -OCL;     // the last conv's count, or its padded count
  const Smem plan = smem_plan(DP, GEN, split, pe, L, in_ch, OCW, th, tw, C);
  int* prm = reinterpret_cast<int*>(smem4);
  int* wbuf = prm + plan.prm_words;     // plan.w_bufs weight buffers of plan.w_words
  int* buf_a = wbuf + plan.w_bufs * plan.w_words;
  // one weight buffer: layer i + 1's fragments staged after layer i's barrier
  const bool single = plan.w_bufs == 1;
  int* buf_b = buf_a + plan.a_words;
  int* sc = buf_b + plan.b_words;

  Tile t;
  t.oy0 = blockIdx.y * th;
  t.ox0 = blockIdx.x * tw;
  t.th = th;
  t.tw = tw;
  t.H = H;
  t.W = W;
  const int frame = blockIdx.z;

  stage_async(wbuf, weights + params[p_at(0, R_WOFF, C)],
              layer_words(split_of<DP>(params, 0), 0, L, in_ch, OCW, pe, C));
  for (int i = threadIdx.x; i < net_words(L, C); i += blockDim.x) prm[i] = params[i];

  // layer-0 input: one word per pixel, channel c in byte c; z_eff outside
  const int r0 = ring(0, L);
  const int ih0 = th + 2 * r0, iw0 = tw + 2 * r0;
  const int pad0 = pad_word(params[p_at(0, R_ZEFF, C)]);
  // kLoadBatch pixels per thread at a time, their loads issued together
  for (int i0 = threadIdx.x; i0 < ih0 * iw0; i0 += kLoadBatch * blockDim.x) {
    int v[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const int yy = i / iw0, xx = i - yy * iw0;
      const int gy = t.oy0 - r0 + yy, gx = t.ox0 - r0 + xx;
      v[u] = pad0;
      if (i < ih0 * iw0 && gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int8_t* p = x + ((static_cast<size_t>(frame) * H + gy) * W + gx) * in_ch;
        v[u] = 0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (c < in_ch) v[u] |= (static_cast<int>(__ldg(p + c)) & 0xff) << (8 * c);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u)
      if (i0 + u * blockDim.x < ih0 * iw0) buf_b[i0 + u * blockDim.x] = v[u];
  }
  wait_staged();
  __syncthreads();

  const int r_sc = ring(L - 1, L);
  const int sc_h = th + 2 * r_sc, sc_w = tw + 2 * r_sc;
  const int sc_ps = plane_stride(sc_h * sc_w);
  // each layer stages the next one's weights into the other buffer while it
  // computes (or, with one buffer, after its barrier), per PE only where the
  // layer is split
  auto stage_next = [&](int i) {
    stage_async(wbuf + (single ? 0 : ((i + 1) & 1) * plan.w_words),
                weights + prm[p_at(i + 1, R_WOFF, C)],
                layer_words(split_of<DP>(prm, i + 1), i + 1, L, in_ch, OCW, pe, C));
  };
  if (!single) stage_next(0);
  {
    const int r1 = ring(1, L);
    const int ps1 = plane_stride(extent(1, L, th, tw));
    conv_form<DP, GEN, 5, FIRST, C, C, WIDE>(buf_b, 0, wbuf, min(in_ch, pe), th + 2 * r1,
                                             tw + 2 * r1, t, 0, false, prm, params, buf_a, ps1, sc,
                                             sc_ps,
                                             r1 - r_sc, sc_w, sc_h, nullptr, frame);
  }
  wait_staged();
  __syncthreads();
  if (single) {
    stage_next(0);
    wait_staged();
    __syncthreads();
  }

  int* cur = buf_a;
  int* nxt = buf_b;
  for (int i = 1; i <= L - 2; ++i) {
    if (!single) stage_next(i);
    const int r = ring(i + 1, L);
    const int* w = wbuf + (single ? 0 : (i & 1) * plan.w_words);
    const int ps_in = plane_stride(extent(i, L, th, tw));
    const int ps_out = plane_stride(extent(i + 1, L, th, tw));
    conv_form<DP, GEN, 3, MID, C, C, WIDE>(cur, ps_in, w, pe, th + 2 * r, tw + 2 * r, t, i,
                                           i == L - 2, prm, params, nxt, ps_out, sc, sc_ps, 0, sc_w,
                                           sc_h,
                                           nullptr, frame);
    wait_staged();
    __syncthreads();
    if (single) {
      stage_next(i);
      wait_staged();
      __syncthreads();
    }
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  const int* w_last = wbuf + (single ? 0 : ((L - 1) & 1) * plan.w_words);
  const int ps_last = plane_stride(extent(L - 1, L, th, tw));
  conv_form<DP, GEN, 5, LAST, OCL, C, WIDE>(cur, ps_last, w_last, pe, th, tw, t, L - 1, false,
                                            prm, params, nullptr, 0, sc, sc_ps, 0, sc_w, sc_h, out,
                                            frame);
}

#ifndef SESR_NET_BODY_ONLY
// (sesr_net_group.cu includes this file for the body alone: the kernels
// and entry points below are this library's.)

// The served kernels: the shipped instantiation and the general one, and
// the general one's wide form (sums past 2^22).
template <int DP, int OCL, bool GEN, int C>
__global__ void __launch_bounds__(kThreads, 2)
sesr_net_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                const int* __restrict__ weights, const int* __restrict__ params,
                int H, int W, int L, int in_ch, int th, int tw, int split, int pe_in) {
  net_tile<DP, OCL, GEN, C, false>(x, out, weights, params, H, W, L, in_ch, th, tw, split, pe_in);
}

template <int DP, int OCL, int C>
__global__ void __launch_bounds__(kThreads, 2)
sesr_net_wide_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                     const int* __restrict__ weights, const int* __restrict__ params,
                     int H, int W, int L, int in_ch, int th, int tw, int split, int pe_in) {
  net_tile<DP, OCL, true, C, true>(x, out, weights, params, H, W, L, in_ch, th, tw, split, pe_in);
}

// The kernel of instantiation GK: 0 shipped, 1 general, 2 general and wide.
template <int DP, int OCL, int GK, int C>
auto net_kernel() {
  if constexpr (GK == 2) return &sesr_net_wide_kernel<DP, OCL, C>;
  else return &sesr_net_kernel<DP, OCL, GK == 1, C>;
}

size_t shared_bytes(int dp, bool gen, int split, int pe, int L, int in_ch, int ocl, int th,
                    int tw, int C) {
  const Smem plan = smem_plan(dp, gen, split, pe, L, in_ch, ocl, th, tw, C);
  return sizeof(int) * (static_cast<size_t>(plan.prm_words) + plan.w_bufs * plan.w_words +
                        plan.a_words + plan.b_words + plan.sc_words);
}

template <int DP, int OCL, int GK, int C>
cudaError_t launch_one(const int8_t* x, int8_t* out, const int* w, const int* prm,
                       int n, int h, int wd, int L, int in_ch, int th, int tw, int split,
                       int pe, cudaStream_t stream) {
  const size_t bytes = shared_bytes(DP, GK != 0, split, pe, L, in_ch, OCL > 0 ? OCL : -OCL, th,
                                    tw, C);
  const auto kernel = net_kernel<DP, OCL, GK, C>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((wd + tw - 1) / tw, (h + th - 1) / th, n);
  kernel<<<grid, kThreads, bytes, stream>>>(x, out, w, prm, h, wd, L, in_ch, th, tw, split, pe);
  return cudaGetLastError();
}

// The shipped counts 3, 12 and 16, each in an instantiation of its own;
// in the general ones every count at its padded count (out_cols), the count
// read from the record.
template <int DP, int GK, int C>
cudaError_t launch_oc(const int8_t* x, int8_t* out, const int* w, const int* prm, int n, int h,
                      int wd, int L, int in_ch, int out_ch, int th, int tw, int split, int pe,
                      cudaStream_t s) {
  if constexpr (GK == 0) {
    switch (out_ch) {
      case 3: return launch_one<DP, 3, GK, C>(x, out, w, prm, n, h, wd, L, in_ch, th, tw, split, pe, s);
      case 12: return launch_one<DP, 12, GK, C>(x, out, w, prm, n, h, wd, L, in_ch, th, tw, split, pe, s);
      case 16: return launch_one<DP, 16, GK, C>(x, out, w, prm, n, h, wd, L, in_ch, th, tw, split, pe, s);
      default: return cudaErrorInvalidValue;
    }
  } else {
    switch (out_cols(out_ch)) {
      case 8: return launch_one<DP, -8, GK, C>(x, out, w, prm, n, h, wd, L, in_ch, th, tw, split, pe, s);
      case 16: return launch_one<DP, -16, GK, C>(x, out, w, prm, n, h, wd, L, in_ch, th, tw, split, pe, s);
      case 32: return launch_one<DP, -32, GK, C>(x, out, w, prm, n, h, wd, L, in_ch, th, tw, split, pe, s);
      default: return launch_one<DP, -48, GK, C>(x, out, w, prm, n, h, wd, L, in_ch, th, tw, split, pe, s);
    }
  }
}

bool takes(int L, int in_ch, int out_ch, int th, int tw, int split, int pe, int gen, int width) {
  return L >= 3 && L <= kMaxL && in_ch >= 1 && in_ch <= 4 && out_ch >= 1 && out_ch <= kMaxOut &&
         (gen || out_ch == 3 || out_ch == 12 || out_ch == 16) && th >= 1 && tw >= 1 &&
         th <= 1024 && tw <= 1024 && pe >= 1 && pe <= kMaxPE && (split >> L) == 0 && gen >= 0 &&
         gen <= 2 && (gen || pe == 4) && (width == 16 || width == kMaxC);
}

template <int DP, int C>
cudaError_t launch_gen(const int8_t* x, int8_t* out, const int* w, const int* prm, int n, int h,
                       int wd, int L, int in_ch, int out_ch, int th, int tw, int split, int pe,
                       int gen, cudaStream_t s) {
  switch (gen) {
    case 0: return launch_oc<DP, 0, C>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th, tw, split, pe, s);
    case 1: return launch_oc<DP, 1, C>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th, tw, split, pe, s);
    default: return launch_oc<DP, 2, C>(x, out, w, prm, n, h, wd, L, in_ch, out_ch, th, tw, split, pe, s);
  }
}

// Each kernel has the shipped instantiation (gen = 0; K1 at 4 PEs), the
// general one (1) and its wide form (2), each at hidden width 16 and 32.
template <int DP>
int launch(const void* x, void* out, const void* weights, const void* params, int n,
           int h, int w, int L, int in_ch, int out_ch, int th, int tw, int split, int pe,
           int gen, int width, void* stream) {
  if (!takes(L, in_ch, out_ch, th, tw, split, pe, gen, width))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* oi = static_cast<int8_t*>(out);
  const int* wi = static_cast<const int*>(weights);
  const int* pi = static_cast<const int*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      width == 16 ? launch_gen<DP, 16>(xi, oi, wi, pi, n, h, w, L, in_ch, out_ch, th, tw, split,
                                       pe, gen, s)
                  : launch_gen<DP, kMaxC>(xi, oi, wi, pi, n, h, w, L, in_ch, out_ch, th, tw,
                                          split, pe, gen, s));
}

#endif  // SESR_NET_BODY_ONLY

}  // namespace

#ifndef SESR_NET_BODY_ONLY

extern "C" {

// x: int8 (n, h, w, in_ch) quantized input; out: int8 (n, h, w, out_ch);
// weights / params: int32 device arrays built by sesr_tpu_torch/convert.py;
// split: bit i set where conv i runs one pass per PE (the params' pe_split
// word); pe: the datapath's PEs; general: the instantiation, 0 the shipped
// one, 1 the one for any PE count and widths (KernelConstants.general; K1
// needs it where pe != 4), 2 its wide form (KernelConstants.wide);
// width: the hidden width the network runs at, 16 or 32
// (KernelConstants.width).
int sesr_pe_exact_net(const void* x, void* out, const void* weights, const void* params,
                      int n, int h, int w, int num_layers, int in_ch, int out_ch,
                      int tile_h, int tile_w, int split, int pe, int general, int width,
                      void* stream) {
  return launch<REFERENCE>(x, out, weights, params, n, h, w, num_layers, in_ch, out_ch,
                           tile_h, tile_w, split, pe, general, width, stream);
}

int sesr_fast_net(const void* x, void* out, const void* weights, const void* params,
                  int n, int h, int w, int num_layers, int in_ch, int out_ch,
                  int tile_h, int tile_w, int general, int width, void* stream) {
  return launch<FAST>(x, out, weights, params, n, h, w, num_layers, in_ch, out_ch,
                      tile_h, tile_w, 0, 4, general, width, stream);
}

// Shared memory of one block of K1 (exact = 1) or K2 (exact = 0) in bytes,
// or 0 where the entry point refuses the arguments (K2 takes split 0 and
// pe 4).
int sesr_net_smem(int exact, int num_layers, int in_ch, int out_ch, int tile_h, int tile_w,
                  int split, int pe, int general, int width) {
  if (!takes(num_layers, in_ch, out_ch, tile_h, tile_w, split, pe, general, width)) return 0;
  return static_cast<int>(shared_bytes(exact ? REFERENCE : FAST, general != 0, split, pe,
                                       num_layers, in_ch, out_ch, tile_h, tile_w, width));
}

const char* sesr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#endif  // SESR_NET_BODY_ONLY
