// K1 and K2 (sesr_net.cu) for networks of other conv sizes on Hopper
// (sm_90a): a network whose convs are not 5x5 / 3x3 ... / 5x5, each of any
// odd size from 1 to 9 (the first conv, the block convs and the last conv
// chosen on their own), goes as a chain of launches of the layer-group form
// (sesr_net_group.cu; convert.py layer_groups: one group where its plan
// fits a block), each a launch of sesr_net_ksize_kernel (or, for a
// two-conv network, sesr_net_ksize_pair_kernel) over the whole batch.
//
// Replaces, with sesr_net.cu, the same two Pallas TPU kernels of the JAX
// package, whose convs take any size:
//   sesr_net_ksize(exact = 1) <- sesr_tpu/ops/pallas_pipeline.py build_pallas_forward (K1)
//   sesr_net_ksize(exact = 0) <- sesr_tpu/ops/pallas_packed.py build_pallas_packed_forward (K2)
// Its plain version, group by group, is sesr_tpu_torch/quant/integer.py
// group_forward; the chain's is integer_forward.
//
// A group runs as sesr_net_group.cu's group_tile runs one (group_tile_ks),
// but each conv's size is its record's (R_K), read at run time by
// conv_layer_ks, conv_layer's general wide form with the chunks a loop
// whose taps' offsets are formed chunk by chunk and B read from shared
// memory a chunk at a time; the extents follow from the sizes the host
// passes (ks, sesr_common.cuh ks_at: four bits a conv). K1 stages every
// split conv past layer 0 off 4 PEs a pass at a time (a 9x9 conv's B at 16
// PEs is up to 344 KB), and both keep one B buffer where two do not fit a
// block (ks_group_plan). The forms are their own functions, so that the
// shipped kernels' code is untouched (their ptxas lines stay the parent's).
//
// What bounds it on this card: operations, as sesr_net.cu. A conv of size
// k recomputes a ring of k/2 on every layer before it.
//
// Instantiations: sesr_net_ksize_kernel<DP, OCL, C> and
// sesr_net_ksize_pair_kernel<DP, OCL, C>, DP K1 / K2, the last conv's padded
// columns (OCL -8, -16, -32, -48), width 16 or 32: 32, each the general
// instantiation's wide form (a plain int32 sum, exact for every sum the
// other form holds too). The forms also take width 64 (a one-pass tap two
// k32 chunks, 8 n-tiles of B a hidden conv, load_frag_ks), instantiated in
// sesr_net_w64.cu, which includes this file for its bodies alone
// (SESR_NET_KSIZE_BODY_ONLY leaves out the entry points).
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (sesr_tpu_torch/ops/_build.py), its own nvcc process.
// Each entry point returns cudaGetLastError() after its launch.

#define SESR_NET_GROUP_BODY_ONLY
#include "sesr_net_group.cu"

namespace {

// Width 64: a conv past layer 0 whose B no block holds beside the buffers
// goes in pieces of at most kPieceWords, staged one at a time (every split
// one of K1, each PE pass in pieces; a one-pass one whose B passes
// kWholeWords: conv_layer_ks's PIECES form, w64_piecewise).
constexpr int PIECES = 4;             // Passes: one pass, its B in pieces
constexpr int kPieceWords = 13312;    // most words of a piece (53,248 B)
constexpr int kWholeWords = 26624;    // most words of a one-pass conv's B staged whole
// Chunks of a piece of B of fw words a lane and chunk.
__host__ __device__ constexpr int piece_chunks(int fw) { return kPieceWords / (32 * fw); }

// load_frag (sesr_net.cu) up to 8 n-tiles: a hidden layer at width 64 holds
// 16 B registers a (pass, chunk).
template <int FW>
__device__ __forceinline__ void load_frag_ks(int (&b)[FW], const int* p) {
  if constexpr (FW == 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int4 v = *reinterpret_cast<const int4*>(p + 4 * i);
      b[4 * i] = v.x;
      b[4 * i + 1] = v.y;
      b[4 * i + 2] = v.z;
      b[4 * i + 3] = v.w;
    }
  } else {
    load_frag<FW>(b, p);
  }
}

// conv_layer of a conv whose size is its record's (R_K), in the general
// instantiation's wide form (every sum clamped to pe_add_bits, a plain
// int32 converted once): its chunks are a loop whose taps' offsets are
// formed chunk by chunk, and its B is read from shared memory a chunk at a
// time. PS: ONE, FOUR (layer 0's passes, or a hidden layer's at 4 PEs), or
// WORDS / MASKED, staged a pass at a time (conv_layer's STAGE). The
// arguments are conv_layer's.
template <int DP, int PS, Kind KIND, int OC, int C, bool PAIR = false>
__device__ __forceinline__ void conv_layer_ks(
    const int* __restrict__ in, int in_ps, const int* __restrict__ w, int npass,
    int eh, int ew, const Tile& t, int layer, bool prelast,
    const int* __restrict__ prm, const int* __restrict__ gprm, int* __restrict__ next,
    int next_ps, int* __restrict__ sc, int sc_ps, int sc_off, int sc_w, int sc_h,
    int8_t* __restrict__ out, int frame, int* w_alt = nullptr,
    const int* __restrict__ wg = nullptr) {
  const int k = prm[p_at(layer, R_K, C)];
  constexpr int NT = (OC > 0 ? OC + 7 : -OC) / 8;    // n-tiles of 8 channels
  constexpr bool ROWS = OC < -C;                     // the last conv's rows past the record's
  static_assert(OC > 0 || KIND == LAST, "a count read at run time is the last conv's");
  const int ocn = OC > 0 ? OC : prm[p_at(layer, R_OUT, C)];
  constexpr int FW = 2 * NT;                         // B registers per (pass, chunk)
  constexpr int NV = 2 * NT;                         // values a lane holds per pixel
  constexpr bool STAGE = PS == WORDS || PS == MASKED;
  static_assert(!STAGE || KIND != FIRST, "a looped pass is a split hidden layer's");
  static_assert(PS != PIECES || (C == 64 && KIND != FIRST), "pieces are width 64's");
  constexpr bool ROUNDS = STAGE || PS == PIECES;     // every warp in each round
  static_assert(C == 16 || C == 32 || C == 64, "the hidden widths are 16, 32 and 64");
  static_assert(!PAIR || KIND == FIRST, "a pair's pre-last conv is its first");
  constexpr bool TAPS = PS == FOUR || PS == WORDS || KIND == FIRST;   // a pass reads its own words
  // k-slot s of chunk c is word s % WPT of the pass's words (TAPS: its
  // word p % 4 + 4 j is j; else word j) at tap TPC c + s / WPT; past 8
  // words a tap (width 64, one pass over all 16 words) a tap is WPT / 8
  // chunks, chunk c its words 8 (c % (WPT / 8)) .. of tap c / (WPT / 8)
  constexpr int WPT = KIND == FIRST ? 1 : (TAPS ? C / 16 : C / 4);
  constexpr int TPC = 8 / WPT;
  const int nch = chunks_of(k, WPT);
  constexpr int NP = PS == FOUR ? 4 : 1;             // passes unrolled (FIRST: up to 4)
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int iw = ew + k - 1;
  const int npix = eh * ew;
  const unsigned ew_magic = 0xffffffffu / ew + 1;    // r / ew == umulhi(r, ew_magic)
  const int r_out = (eh - t.th) / 2;   // ring of this output frame
  const int acc_hi = prm[P_ACC_HI];
  const int add_hi = prm[P_ADD_HI];
  // (y * m) * 2^-n == y * (m * 2^-n) in float32 (conv_layer's note), the
  // sum a plain int32 converted once
  const float rq_s = __fmul_rn(as_f32(prm[p_at(layer, R_RQM, C)]),
                               as_f32(prm[p_at(layer, R_RQP, C)]));
  const float half = quant_half(prm);
  const float q_lo = kMagic - half, q_hi = kMagic + (half - 1.f);
  // accumulator (n, i) of this lane is channel chan(2n + (i & 1)) (conv_layer's),
  // started from bias - z_eff * sum(W) (K1: that term is 0)
  auto chan = [&](int j) { return KIND == LAST ? 8 * (j >> 1) + 2 * tq + (j & 1) : tq + 4 * j; };
  const int* rows = ROWS ? gprm + prm[p_at(layer, R_ROWS, C)] : prm + p_at(layer, R_BIAS, C);
  const int zc_at = ROWS ? ocn : C;                  // the z_eff * sum(W) row, from the bias row
  int init[NV], lo_c[NV], hi_c[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int o = chan(j);
    const int b = o < ocn ? rows[o] : 0;
    init[j] = b - (o < ocn ? rows[zc_at + o] : 0);
    lo_c[j] = b - add_hi - 1;
    hi_c[j] = b + add_hi;
  }

  // input offsets of this lane's k-slots tq (a0, a1) and tq + 4 (a2, a3) of
  // chunk c, from the pass's first word (conv_layer's); a padded tap reads
  // tap 0 against zero weights
  const int pa = (TAPS ? 4 : 1) * (tq % WPT) * in_ps, pb = pa + 4 % WPT * in_ps;
  auto tap_pix = [&](int tap) { return tap < k * k ? (tap / k) * iw + tap % k : 0; };
  auto offs = [&](int c, int& a, int& b) {
    if constexpr (WPT > 8) {
      const int at = tap_pix(c / (WPT / 8)) + 8 * (c % (WPT / 8)) * in_ps;
      a = pa + at;
      b = pb + at;
    } else {
      const int ta = TPC * c + tq / WPT;
      a = pa + tap_pix(ta);
      b = pb + tap_pix(ta + 4 / WPT);
    }
  };
  const int pw = nch * 32 * FW;                      // words of one pass's B
  const int rounds = (npix + 16 * kWarps - 1) / (16 * kWarps);
  int q = 0;                                         // STAGE: passes computed so far
  for (int mt = warp; ROUNDS ? mt < rounds * kWarps : mt * 16 < npix; mt += kWarps) {
    int ys[2], xs[2], bases[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = min(mt * 16 + g + 8 * h, npix - 1);
      ys[h] = static_cast<int>(__umulhi(static_cast<unsigned>(r), ew_magic));
      xs[h] = r - ys[h] * ew;
      bases[h] = r + ys[h] * (k - 1);
    }
    int tot[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) tot[n][i] = init[2 * n + (i & 1)];

    if constexpr (PS == ONE) {
      for (int c = 0; c < nch; ++c) {
        int xa, xb;
        offs(c, xa, xb);
        const int a0 = in[bases[0] + xa], a1 = in[bases[1] + xa];
        const int a2 = in[bases[0] + xb], a3 = in[bases[1] + xb];
        int b[FW];
        load_frag_ks<FW>(b, w + (c * 32 + lane) * FW);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_s8(tot[n], a0, a1, a2, a3, b[2 * n], b[2 * n + 1]);
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
      for (int c = 0; c < nch; ++c) {
        int xa, xb;
        offs(c, xa, xb);
        const int a0 = in[bases[0] + xa], a1 = in[bases[1] + xa];
        const int a2 = in[bases[0] + xb], a3 = in[bases[1] + xb];
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          if (p < npass) {
            int b[FW];
            load_frag_ks<FW>(b, w + ((p * nch + c) * 32 + lane) * FW);
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
    } else if constexpr (C == 64 && ROUNDS) {
      // width 64: PE p's pass (WORDS, MASKED) or the one pass (PIECES), its
      // chunks in pieces of piece_chunks (the last one shorter), staged one
      // at a time from wg as the STAGE form below stages a pass: piece q of
      // the layer's rounds in buffer w (q even, or one buffer) or w_alt; a
      // pass's sum clamped once, at its end (split)
      constexpr int CPP = piece_chunks(FW);
      const int units = (nch + CPP - 1) / CPP;          // pieces a pass
      const int np = PS == PIECES ? 1 : npass;
      const int total = rounds * np * units;
      // piece i of a round: pass i / units, its chunks from (i % units) CPP
      auto stage_piece = [&](int qq, int* dst) {
        const int i = qq % (np * units), c0 = i % units * CPP;
        stage_async(dst, wg + (i / units * nch + c0) * 32 * FW, min(CPP, nch - c0) * 32 * FW);
      };
      for (int p = 0; p < np; ++p) {
        int acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] = 0;
        const int* src = in + (PS == WORDS ? (p & 3) * in_ps : 0);
        for (int u = 0; u < units; ++u) {
          wait_staged();
          __syncthreads();
          const bool two = w_alt != w;
          if (two && q + 1 < total) stage_piece(q + 1, (q & 1) ? const_cast<int*>(w) : w_alt);
          const int* wp = two && (q & 1) ? w_alt : w;
          for (int c = u * CPP; c < min(nch, (u + 1) * CPP); ++c) {
            int xa, xb;
            offs(c, xa, xb);
            const int a0 = src[bases[0] + xa], a1 = src[bases[1] + xa];
            const int a2 = src[bases[0] + xb], a3 = src[bases[1] + xb];
            int b[FW];
            load_frag_ks<FW>(b, wp + ((c - u * CPP) * 32 + lane) * FW);
#pragma unroll
            for (int n = 0; n < NT; ++n) mma_s8(acc[n], a0, a1, a2, a3, b[2 * n], b[2 * n + 1]);
          }
          if (!two && q + 1 < total) {
            __syncthreads();
            stage_piece(q + 1, const_cast<int*>(w));
          }
          ++q;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            tot[n][i] += PS == PIECES ? acc[n][i] : min(max(acc[n][i], -acc_hi - 1), acc_hi);
      }
    } else if constexpr (STAGE) {
      // PE p's pass reads its words p % 4 + 4 j (WORDS) or all C / 4 words
      // (MASKED) of each tap, against B holding its channels only, staged a
      // pass at a time (conv_layer's STAGE)
      for (int p = 0; p < npass; ++p) {
        int acc[NT][4];
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] = 0;
        const int* src = in + (PS == WORDS ? (p & 3) * in_ps : 0);
        // pass q's B has landed and every warp is done with pass q - 1's
        wait_staged();
        __syncthreads();
        const bool two = w_alt != w;
        if (two && q + 1 < rounds * npass)
          stage_async((q & 1) ? const_cast<int*>(w) : w_alt, wg + (q + 1) % npass * pw, pw);
        const int* wp = two && (q & 1) ? w_alt : w;
        for (int c = 0; c < nch; ++c) {
          int xa, xb;
          offs(c, xa, xb);
          const int a0 = src[bases[0] + xa], a1 = src[bases[1] + xa];
          const int a2 = src[bases[0] + xb], a3 = src[bases[1] + xb];
          int b[FW];
          load_frag_ks<FW>(b, wp + (c * 32 + lane) * FW);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_s8(acc[n], a0, a1, a2, a3, b[2 * n], b[2 * n + 1]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) tot[n][i] += min(max(acc[n][i], -acc_hi - 1), acc_hi);
        if (w_alt == w && q + 1 < rounds * npass) {
          __syncthreads();
          stage_async(const_cast<int*>(w), wg + (q + 1) % npass * pw, pw);
        }
        ++q;
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
        for (int c = 0; c < nch; ++c) {
          int xa, xb;
          offs(c, xa, xb);
          const int a0 = src[bases[0] + xa], a1 = src[bases[1] + xa];
          const int a2 = src[bases[0] + xb], a3 = src[bases[1] + xb];
          int b[FW];
          load_frag_ks<FW>(b, w + ((p * nch + c) * 32 + lane) * FW);
#pragma unroll
          for (int n = 0; n < NT; ++n) mma_s8(acc[n], a0, a1, a2, a3, b[2 * n], b[2 * n + 1]);
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
        yi = min(max(yi, lo_c[j]), hi_c[j]);
        hq[j] = __fmul_rn(__int2float_rn(yi), rq_s);
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

// conv_form (sesr_net.cu) of conv_layer_ks: one pass per PE where the
// conv's split bit is set (K1: layer 0's passes, or a hidden layer's at 4
// PEs; group_conv_ks stages the others), else one pass. The arguments are
// conv_layer's.
template <int DP, Kind KIND, int OC, int C, bool PAIR = false>
__device__ __forceinline__ void conv_form_ks(
    const int* __restrict__ in, int in_ps, const int* __restrict__ w, int npass,
    int eh, int ew, const Tile& t, int layer, bool prelast,
    const int* __restrict__ prm, const int* __restrict__ gprm, int* __restrict__ next,
    int next_ps, int* __restrict__ sc, int sc_ps, int sc_off, int sc_w, int sc_h,
    int8_t* __restrict__ out, int frame) {
  if constexpr (DP == REFERENCE) {
    if (pe_split(prm, layer)) {
      conv_layer_ks<DP, FOUR, KIND, OC, C, PAIR>(in, in_ps, w, npass, eh, ew, t, layer, prelast,
                                                 prm, gprm, next, next_ps, sc, sc_ps, sc_off,
                                                 sc_w, sc_h, out, frame);
      return;
    }
  }
  conv_layer_ks<DP, ONE, KIND, OC, C, PAIR>(in, in_ps, w, 1, eh, ew, t, layer, prelast, prm, gprm,
                                            next, next_ps, sc, sc_ps, sc_off, sc_w, sc_h, out,
                                            frame);
}

// A conv past layer 0 (KIND MID or LAST): conv_form_ks, or where it is
// `staged` (K1, split, off 4 PEs; at width 64 any split one) its passes a
// pass at a time from wg (two buffers w and w_alt, or one; at width 64 in
// pieces), or where it goes in `pieces` (width 64, one pass:
// w64_piecewise) its one pass in pieces. The arguments are conv_layer's.
template <int DP, int OC, int C, Kind KIND>
__device__ __forceinline__ void group_conv_ks(bool staged, const int* __restrict__ in, int in_ps,
                                              const int* w, int* w_alt,
                                              const int* __restrict__ wg, int npass, int eh,
                                              int ew, const Tile& t, int layer, bool prelast,
                                              const int* __restrict__ prm,
                                              const int* __restrict__ gprm,
                                              int* __restrict__ next, int next_ps,
                                              int* __restrict__ sc, int sc_ps, int sc_w, int sc_h,
                                              int8_t* __restrict__ out, int frame,
                                              bool pieces = false) {
  if constexpr (C == 64) {
    if (pieces) {
      conv_layer_ks<DP, PIECES, KIND, OC, C>(in, in_ps, w, 1, eh, ew, t, layer, prelast, prm, gprm,
                                             next, next_ps, sc, sc_ps, 0, sc_w, sc_h, out, frame,
                                             w_alt, wg);
      return;
    }
  }
  if constexpr (DP == REFERENCE) {
    if (staged) {
      if (npass % 4 == 0)
        conv_layer_ks<DP, WORDS, KIND, OC, C>(in, in_ps, w, npass, eh, ew, t, layer, prelast, prm,
                                              gprm, next, next_ps, sc, sc_ps, 0, sc_w, sc_h, out,
                                              frame, w_alt, wg);
      else
        conv_layer_ks<DP, MASKED, KIND, OC, C>(in, in_ps, w, npass, eh, ew, t, layer, prelast, prm,
                                               gprm, next, next_ps, sc, sc_ps, 0, sc_w, sc_h, out,
                                               frame, w_alt, wg);
      return;
    }
  }
  conv_form_ks<DP, KIND, OC, C>(in, in_ps, w, npass, eh, ew, t, layer, prelast, prm, gprm, next,
                                next_ps, sc, sc_ps, 0, sc_w, sc_h, out, frame);
}

// layer_words (sesr_net.cu) of a conv of kind `kind` (FIRST, MID or LAST)
// and size k, with one pass per PE (split) or one pass over all channels.
__host__ __device__ inline int conv_words(bool split, int kind, int k, int in_ch, int ocl, int pe,
                                          int C) {
  if (kind == FIRST) return (split ? (in_ch < pe ? in_ch : pe) : 1) * chunks_of(k, 1) * 32 * (C / 4);
  const int chunks = split ? pe * chunks_of(k, pe % 4 == 0 ? C / 16 : C / 4) : chunks_of(k, C / 4);
  return chunks * 32 * (kind == MID ? C / 4 : out_cols(ocl) / 4);
}

// Whether conv j of a group (kind `kind`, split bit sp) runs staged a pass
// at a time (K1, a split conv past layer 0 off 4 PEs).
__host__ __device__ inline bool ks_staged(int dp, bool sp, int kind, int pe) {
  return dp == REFERENCE && sp && kind != FIRST && pe != 4;
}

// group_plan (sesr_net_group.cu) of a group of n convs of sizes ks: the
// extents from its sizes (ks_ring), a staged conv's B one pass, and one B
// buffer where two do not fit a block, for K1 and K2 (kernels.py
// net_group_smem_bytes mirrors it).
__host__ __device__ inline Smem ks_group_plan(int dp, int split, int pe, int n, int fl, int in_ch,
                                              int ocl, int th, int tw, int C, long long ks) {
  Smem s;
  s.prm_words = net_words(kMaxL + 1, C);
  s.w_words = 0;
  for (int j = 0; j < n; ++j) {
    const int kind = group_kind(j, n, fl);
    const bool sp = (split >> j) & 1;
    const int lw = conv_words(sp, kind, ks_at(ks, j), in_ch, ocl, pe, C);
    const int words = ks_staged(dp, sp, kind, pe) ? lw / pe : lw;
    s.w_words = s.w_words > words ? s.w_words : words;
  }
  // layer j's input: buf_b for even j, buf_a for odd; the group's output
  // (before the last conv) is "layer n's input"
  auto ext = [&](int j) {
    const int r = ks_ring(j, n, ks);
    return (th + 2 * r) * (tw + 2 * r);
  };
  s.a_words = 0;
  s.b_words = (fl & G_FIRST) ? (ext(0) + 3) & ~3 : 0;
  for (int j = (fl & G_FIRST) ? 1 : 0; j <= n - ((fl & G_LAST) ? 1 : 0); ++j) {
    const int words = C / 4 * plane_stride(ext(j));
    int& dst = (j % 2) ? s.a_words : s.b_words;
    dst = dst > words ? dst : words;
  }
  const int rs = ks_sc_ring(n, fl, ks);
  s.sc_words = (fl & (G_FIRST | G_LAST)) && !pair_group(n, fl)
                   ? (dp == REFERENCE ? C / 4 : C / 2) * plane_stride((th + 2 * rs) * (tw + 2 * rs))
                   : 0;
  const int two = s.prm_words + 2 * s.w_words + s.a_words + s.b_words + s.sc_words;
  s.w_bufs = 4 * two > kSmemLimit ? 1 : 2;
  return s;
}

// Width 64 (sesr_net_w64.cu): K1 stages every split conv past layer 0 a
// pass at a time, at any PE count, and a one-pass conv whose B (lw words)
// passes kWholeWords goes in pieces (PIECES: w64_piecewise); a staged or
// piecewise conv's B is staged a piece of at most kPieceWords at a time
// (w64_unit_words: the words staged first; ocl the last conv's padded
// columns).
__host__ __device__ inline bool w64_staged(int dp, bool sp, int kind) {
  return dp == REFERENCE && sp && kind != FIRST;
}

__host__ __device__ inline bool w64_piecewise(bool staged, int kind, int lw) {
  return !staged && kind != FIRST && lw > kWholeWords;
}

__host__ __device__ inline int w64_unit_words(int dp, bool sp, int kind, int pe, int ocl,
                                              int lw) {
  const bool st = w64_staged(dp, sp, kind);
  const int words = st ? lw / pe : lw;
  if (!st && !w64_piecewise(st, kind, lw)) return words;
  const int fw = 2 * ((kind == LAST ? out_cols(ocl) : 64) / 8);
  const int unit = piece_chunks(fw) * 32 * fw;
  return words < unit ? words : unit;
}

// ks_group_plan at width 64: a conv's B staged w64_unit_words at a time.
__host__ __device__ inline Smem w64_group_plan(int dp, int split, int pe, int n, int fl, int in_ch,
                                               int ocl, int th, int tw, long long ks) {
  constexpr int C = 64;
  Smem s;
  s.prm_words = net_words(kMaxL + 1, C);
  s.w_words = 0;
  for (int j = 0; j < n; ++j) {
    const int kind = group_kind(j, n, fl);
    const bool sp = (split >> j) & 1;
    const int lw = conv_words(sp, kind, ks_at(ks, j), in_ch, ocl, pe, C);
    const int words = w64_unit_words(dp, sp, kind, pe, ocl, lw);
    s.w_words = s.w_words > words ? s.w_words : words;
  }
  // layer j's input: buf_b for even j, buf_a for odd; the group's output
  // (before the last conv) is "layer n's input"
  auto ext = [&](int j) {
    const int r = ks_ring(j, n, ks);
    return (th + 2 * r) * (tw + 2 * r);
  };
  s.a_words = 0;
  s.b_words = (fl & G_FIRST) ? (ext(0) + 3) & ~3 : 0;
  for (int j = (fl & G_FIRST) ? 1 : 0; j <= n - ((fl & G_LAST) ? 1 : 0); ++j) {
    const int words = C / 4 * plane_stride(ext(j));
    int& dst = (j % 2) ? s.a_words : s.b_words;
    dst = dst > words ? dst : words;
  }
  const int rs = ks_sc_ring(n, fl, ks);
  s.sc_words = (fl & (G_FIRST | G_LAST)) && !pair_group(n, fl)
                   ? (dp == REFERENCE ? C / 4 : C / 2) * plane_stride((th + 2 * rs) * (tw + 2 * rs))
                   : 0;
  const int two = s.prm_words + 2 * s.w_words + s.a_words + s.b_words + s.sc_words;
  s.w_bufs = 4 * two > kSmemLimit ? 1 : 2;
  return s;
}

// The plan at width C as group_tile_ks reads it (ks_group_plan at widths
// 16 and 32, w64_group_plan at 64), and at a width known at run time.
template <int C>
__host__ __device__ __forceinline__ Smem group_plan_c(int dp, int split, int pe, int n, int fl,
                                                      int in_ch, int ocl, int th, int tw,
                                                      long long ks) {
  if constexpr (C == 64) return w64_group_plan(dp, split, pe, n, fl, in_ch, ocl, th, tw, ks);
  else return ks_group_plan(dp, split, pe, n, fl, in_ch, ocl, th, tw, C, ks);
}

inline Smem group_plan_at(int dp, int split, int pe, int n, int fl, int in_ch, int ocl, int th,
                          int tw, int C, long long ks) {
  return C == 64 ? w64_group_plan(dp, split, pe, n, fl, in_ch, ocl, th, tw, ks)
                 : ks_group_plan(dp, split, pe, n, fl, in_ch, ocl, th, tw, C, ks);
}

size_t ks_group_bytes(int dp, int split, int pe, int n, int fl, int in_ch, int ocl, int th, int tw,
                      int C, long long ks) {
  const Smem p = group_plan_at(dp, split, pe, n, fl, in_ch, ocl, th, tw, C, ks);
  return sizeof(int) * (static_cast<size_t>(p.prm_words) + p.w_bufs * p.w_words + p.a_words +
                        p.b_words + p.sc_words);
}

// group_tile (sesr_net_group.cu) of a group of n convs of sizes ks (each
// conv's also in its record): each conv in conv_layer_ks's forms, a staged
// conv's next B staged after it. PAIR: the two-conv group.
template <int DP, int OCL, int C, bool PAIR = false>
__device__ __forceinline__ void group_tile_ks(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                              const int* __restrict__ weights,
                                              const int* __restrict__ params,
                                              void* __restrict__ scg, int H, int W, int n, int fl,
                                              int in_ch, int th, int tw, int split, int pe,
                                              long long ks) {
  extern __shared__ int4 smem4[];
  constexpr int OCW = -OCL;
  const bool first = fl & G_FIRST, last = fl & G_LAST;
  const Smem plan = group_plan_c<C>(DP, split, pe, n, fl, in_ch, OCW, th, tw, ks);
  int* prm = reinterpret_cast<int*>(smem4);
  int* wbuf = prm + plan.prm_words;
  int* buf_a = wbuf + plan.w_bufs * plan.w_words;
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
  auto staged = [&](const int* p, int j) {
    if constexpr (C == 64) {
      // K1's split conv past layer 0 a pass at a time, or a one-pass conv
      // in pieces: its B staged in turn while it runs (both buffers)
      const int kind = group_kind(j, n, fl);
      const bool st = w64_staged(DP, DP == REFERENCE && pe_split(p, j), kind);
      return st || w64_piecewise(st, kind, conv_words(false, kind, ks_at(ks, j), in_ch, OCW, pe,
                                                      C));
    } else {
      return ks_staged(DP, DP == REFERENCE && pe_split(p, j), group_kind(j, n, fl), pe);
    }
  };
  // width 64: a one-pass conv whose B goes in pieces (w64_piecewise)
  auto pieces_of = [&](const int* p, int j) {
    if constexpr (C == 64) {
      const int kind = group_kind(j, n, fl);
      return !(DP == REFERENCE && pe_split(p, j)) &&
             w64_piecewise(false, kind, conv_words(false, kind, ks_at(ks, j), in_ch, OCW, pe, C));
    } else {
      return false;
    }
  };
  // the words of layer j's B to stage: a staged conv's first pass (at width
  // 64 its first piece)
  auto words_of = [&](const int* p, int j) {
    const int lw = conv_words(DP == REFERENCE && pe_split(p, j), group_kind(j, n, fl),
                              ks_at(ks, j), in_ch, OCW, pe, C);
    if constexpr (C == 64)
      return w64_unit_words(DP, DP == REFERENCE && pe_split(p, j), group_kind(j, n, fl), pe, OCW,
                            lw);
    else
      return staged(p, j) ? lw / pe : lw;
  };
  auto ext = [&](int j) { return (th + 2 * ks_ring(j, n, ks)) * (tw + 2 * ks_ring(j, n, ks)); };

  stage_async(wbuf, weights + params[p_at(0, R_WOFF, C)], words_of(params, 0));
  for (int i = threadIdx.x; i < net_words(group_records(n, fl), C); i += blockDim.x)
    prm[i] = params[i];

  const int r0 = ks_ring(0, n, ks);
  const int ih0 = th + 2 * r0, iw0 = tw + 2 * r0;
  const int pad0 = pad_word(params[p_at(0, R_ZEFF, C)]);
  const int ps0 = plane_stride(ih0 * iw0);
  if (first) {
    // one word per pixel, channel c in byte c; z_eff outside
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
  } else {
    // the activation the group before wrote: C channels a pixel in order,
    // into C / 4 planes; z_eff outside the image
    for (int i = threadIdx.x; i < ih0 * iw0; i += blockDim.x) {
      const int yy = i / iw0, xx = i - yy * iw0;
      const int gy = t.oy0 - r0 + yy, gx = t.ox0 - r0 + xx;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        planes_from<C>(buf_b + i, ps0, x + ((static_cast<size_t>(frame) * H + gy) * W + gx) * C);
      else
#pragma unroll
        for (int w = 0; w < C / 4; ++w) buf_b[w * ps0 + i] = pad0;
    }
  }
  const int r_sc = ks_sc_ring(n, fl, ks);
  const int sc_h = th + 2 * r_sc, sc_w = tw + 2 * r_sc;
  const int sc_ps = plane_stride(sc_h * sc_w);
  if (!PAIR && last && !first) {
    // the shortcut the first group wrote, over the last conv's input
    // extent (0 outside the image, where the last conv never reads it)
    for (int i = threadIdx.x; i < sc_h * sc_w; i += blockDim.x) {
      const int yy = i / sc_w, xx = i - yy * sc_w;
      const int gy = t.oy0 - r_sc + yy, gx = t.ox0 - r_sc + xx;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const size_t at = ((static_cast<size_t>(frame) * H + (in ? gy : 0)) * W + (in ? gx : 0)) * C;
      if constexpr (DP == REFERENCE) {
        if (in) planes_from<C>(sc + i, sc_ps, static_cast<const int8_t*>(scg) + at);
        else
#pragma unroll
          for (int w = 0; w < C / 4; ++w) sc[w * sc_ps + i] = 0;
      } else {
        if (in) pairs_from<C>(sc + i, sc_ps, static_cast<const int16_t*>(scg) + at);
        else
#pragma unroll
          for (int w = 0; w < C / 2; ++w) sc[w * sc_ps + i] = 0;
      }
    }
  }
  wait_staged();
  __syncthreads();

  // each layer stages the next one's B into the other buffer while it
  // computes; with one buffer, or after a staged conv (which uses both),
  // after its barrier
  auto stage_next = [&](int j) {
    stage_async(wbuf + (single ? 0 : ((j + 1) & 1) * plan.w_words),
                weights + prm[p_at(j + 1, R_WOFF, C)], words_of(prm, j + 1));
  };
  auto after = [&](int j) {
    wait_staged();
    __syncthreads();
    if ((single || staged(prm, j)) && j + 1 < n) {
      stage_next(j);
      wait_staged();
      __syncthreads();
    }
  };
  int* cur = buf_b;
  int* nxt = buf_a;
  int j = 0;
  if (first) {
    if (!single && n > 1) stage_next(0);
    const int r1 = ks_ring(1, n, ks);
    conv_form_ks<DP, FIRST, C, C, PAIR>(buf_b, 0, wbuf, min(in_ch, pe), th + 2 * r1, tw + 2 * r1,
                                        t, 0, PAIR, prm, params, buf_a, plane_stride(ext(1)), sc,
                                        sc_ps, r1 - r_sc, sc_w, sc_h, nullptr, frame);
    after(0);
    cur = buf_a;
    nxt = buf_b;
    j = 1;
  }
  for (; !PAIR && j < n - (last ? 1 : 0); ++j) {
    if (!single && j + 1 < n && !staged(prm, j)) stage_next(j);
    const int r = ks_ring(j + 1, n, ks);
    int* w = wbuf + (single ? 0 : (j & 1) * plan.w_words);
    int* w_alt = single ? w : wbuf + ((j + 1) & 1) * plan.w_words;
    group_conv_ks<DP, C, C, MID>(staged(prm, j), cur, plane_stride(ext(j)), w, w_alt,
                                 weights + prm[p_at(j, R_WOFF, C)], pe, th + 2 * r, tw + 2 * r, t,
                                 j, last && j == n - 2, prm, params, nxt, plane_stride(ext(j + 1)),
                                 sc, sc_ps, sc_w, sc_h, nullptr, frame, pieces_of(prm, j));
    after(j);
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (PAIR || last) {
    const int jl = n - 1;
    int* w_last = wbuf + (single ? 0 : (jl & 1) * plan.w_words);
    int* w_alt = single ? w_last : wbuf + ((jl + 1) & 1) * plan.w_words;
    group_conv_ks<DP, OCL, C, LAST>(staged(prm, jl), cur, plane_stride(ext(jl)), w_last, w_alt,
                                    weights + prm[p_at(jl, R_WOFF, C)], pe, t.th, t.tw, t, jl,
                                    false, prm, params, nullptr, 0, sc, sc_ps, sc_w, sc_h, out,
                                    frame, pieces_of(prm, jl));
    return;
  }
  // the group's output, the tile's core: C channels a pixel in order
  const int ps_out = plane_stride(th * tw);
  for (int i = threadIdx.x; i < th * tw; i += blockDim.x) {
    const int yy = i / tw, xx = i - yy * tw;
    const int gy = t.oy0 + yy, gx = t.ox0 + xx;
    if (gy < H && gx < W) {
      const size_t at = ((static_cast<size_t>(frame) * H + gy) * W + gx) * C;
      planes_to<C>(out + at, cur + i, ps_out);
      if (first) {
        if constexpr (DP == REFERENCE)
          planes_to<C>(static_cast<int8_t*>(scg) + at, sc + i, sc_ps);
        else
          pairs_to<C>(static_cast<int16_t*>(scg) + at, sc + i, sc_ps);
      }
    }
  }
}

template <int DP, int OCL, int C>
__global__ void __launch_bounds__(kThreads, C > 32 ? 1 : 2)
sesr_net_ksize_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                      const int* __restrict__ weights, const int* __restrict__ params, void* sc,
                      int H, int W, int n, int fl, int in_ch, int th, int tw, int split, int pe,
                      long long ks) {
  group_tile_ks<DP, OCL, C>(x, out, weights, params, sc, H, W, n, fl, in_ch, th, tw, split, pe,
                            ks);
}

template <int DP, int OCL, int C>
__global__ void __launch_bounds__(kThreads, C > 32 ? 1 : 2)
sesr_net_ksize_pair_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                           const int* __restrict__ weights, const int* __restrict__ params, int H,
                           int W, int in_ch, int th, int tw, int split, int pe, long long ks) {
  group_tile_ks<DP, OCL, C, true>(x, out, weights, params, nullptr, H, W, 2, G_FIRST | G_LAST,
                                  in_ch, th, tw, split, pe, ks);
}

// Whether ks holds an odd size from 1 to 9 for each of the n convs, and
// nothing past them.
bool sizes_take(int n, long long ks) {
  for (int j = 0; j < n; ++j)
    if (ks_at(ks, j) % 2 == 0 || ks_at(ks, j) > 9) return false;
  return n >= 16 || (ks >> (4 * n)) == 0;
}

template <int DP, int OCL, int C>
cudaError_t launch_ksize(const int8_t* x, int8_t* out, const int* w, const int* prm, void* sc,
                         int nb, int h, int wd, int n, int fl, int in_ch, int th, int tw,
                         int split, int pe, long long ks, cudaStream_t stream) {
  const size_t bytes = ks_group_bytes(DP, split, pe, n, fl, in_ch, -OCL, th, tw, C, ks);
  const dim3 grid((wd + tw - 1) / tw, (h + th - 1) / th, nb);
  if (pair_group(n, fl)) {
    const auto kernel = &sesr_net_ksize_pair_kernel<DP, OCL, C>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(x, out, w, prm, h, wd, in_ch, th, tw, split, pe, ks);
    return cudaGetLastError();
  }
  const auto kernel = &sesr_net_ksize_kernel<DP, OCL, C>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(x, out, w, prm, sc, h, wd, n, fl, in_ch, th, tw, split,
                                            pe, ks);
  return cudaGetLastError();
}

template <int DP, int C>
cudaError_t launch_ksize_cols(const int8_t* x, int8_t* out, const int* w, const int* prm,
                              void* sc, int nb, int h, int wd, int n, int fl, int in_ch,
                              int out_ch, int th, int tw, int split, int pe, long long ks,
                              cudaStream_t s) {
  switch (out_cols(out_ch)) {
    case 8: return launch_ksize<DP, -8, C>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, th, tw, split, pe, ks, s);
    case 16: return launch_ksize<DP, -16, C>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, th, tw, split, pe, ks, s);
    case 32: return launch_ksize<DP, -32, C>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, th, tw, split, pe, ks, s);
    default: return launch_ksize<DP, -48, C>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, th, tw, split, pe, ks, s);
  }
}

template <int DP, int C>
cudaError_t launch_ksize_dp(const void* x, void* out, const void* weights, const void* params,
                            void* sc, int nb, int h, int w, int n, int fl, int in_ch, int out_ch,
                            int th, int tw, int split, int pe, long long ks, cudaStream_t s) {
  return launch_ksize_cols<DP, C>(static_cast<const int8_t*>(x), static_cast<int8_t*>(out),
                                  static_cast<const int*>(weights), static_cast<const int*>(params),
                                  sc, nb, h, w, n, fl, in_ch, out_ch, th, tw, split, pe, ks, s);
}

// One group's launch at hidden width C (sesr_net_ksize's arguments, the
// width C), or cudaErrorInvalidValue for arguments the forms refuse.
template <int C>
int launch_ksize_width(int exact, const void* x, void* out, const void* weights,
                       const void* params, void* sc, int nb, int h, int w, int n, int flags,
                       int in_ch, int out_ch, int tile_h, int tile_w, int split, int pe,
                       int general, long long ks, void* stream) {
  // (group_takes at width 16: the caller checks the width)
  if (!group_takes(n, flags, in_ch, out_ch, tile_h, tile_w, split, pe, general, 16) ||
      !sizes_take(n, ks) || (!exact && split != 0) ||
      (flags != (G_FIRST | G_LAST) && sc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      exact ? launch_ksize_dp<REFERENCE, C>(x, out, weights, params, sc, nb, h, w, n, flags,
                                            in_ch, out_ch, tile_h, tile_w, split, pe, ks, s)
            : launch_ksize_dp<FAST, C>(x, out, weights, params, sc, nb, h, w, n, flags, in_ch,
                                       out_ch, tile_h, tile_w, split, pe, ks, s));
}

// Shared memory of one block of a group at hidden width C in bytes, or 0
// where the entry point refuses the arguments.
int ksize_smem(int exact, int n, int flags, int in_ch, int out_ch, int tile_h, int tile_w,
               int split, int pe, int width, long long ks) {
  if (!group_takes(n, flags, in_ch, out_ch, tile_h, tile_w, split, pe, 1, 16) ||
      !sizes_take(n, ks))
    return 0;
  return static_cast<int>(ks_group_bytes(exact ? REFERENCE : FAST, split, pe, n, flags, in_ch,
                                         out_cols(out_ch), tile_h, tile_w, width, ks));
}

}  // namespace

#ifndef SESR_NET_KSIZE_BODY_ONLY
// (sesr_net_w64.cu includes this file for its bodies alone: the entry
// points below are this library's, at widths 16 and 32.)

extern "C" {

// One group's launch: sesr_net_group's arguments, then ks, the group's conv
// sizes (four bits a conv, conv j in bits 4 j .. 4 j + 3; each odd, 1 to 9).
// general: 1 or 2, both run the wide form.
int sesr_net_ksize(int exact, const void* x, void* out, const void* weights, const void* params,
                   void* sc, int nb, int h, int w, int n, int flags, int in_ch, int out_ch,
                   int tile_h, int tile_w, int split, int pe, int general, int width,
                   long long ks, void* stream) {
  if (width != 16 && width != kMaxC) return static_cast<int>(cudaErrorInvalidValue);
  return width == 16 ? launch_ksize_width<16>(exact, x, out, weights, params, sc, nb, h, w, n,
                                              flags, in_ch, out_ch, tile_h, tile_w, split, pe,
                                              general, ks, stream)
                     : launch_ksize_width<kMaxC>(exact, x, out, weights, params, sc, nb, h, w, n,
                                                 flags, in_ch, out_ch, tile_h, tile_w, split, pe,
                                                 general, ks, stream);
}

// Shared memory of one block of a group in bytes, or 0 where the entry
// point refuses the arguments.
int sesr_net_ksize_smem(int exact, int n, int flags, int in_ch, int out_ch, int tile_h, int tile_w,
                        int split, int pe, int width, long long ks) {
  if (width != 16 && width != kMaxC) return 0;
  return ksize_smem(exact, n, flags, in_ch, out_ch, tile_h, tile_w, split, pe, width, ks);
}

const char* sesr_net_ksize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#endif  // SESR_NET_KSIZE_BODY_ONLY
