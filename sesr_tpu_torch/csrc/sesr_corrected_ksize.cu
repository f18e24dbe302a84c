// The corrected kernel (sesr_corrected.cu) and its counting form for
// networks of other conv sizes on Hopper (sm_90a): a network whose convs
// are not 5x5 / 3x3 ... / 5x5, each of any odd size from 1 to 9 (the first
// conv, the block convs and the last conv chosen on their own), goes as a
// chain of launches of the layer-group form (sesr_corrected_group.cu;
// convert.py layer_groups: one group where its plan fits a block), each a
// persistent launch of sesr_corrected_ksize_kernel (or, counting,
// sesr_corrected_ksize_audit_kernel) over the whole batch.
//
// Replaces, with sesr_corrected.cu, the XLA lowering of the JAX package's
// corrected modes and the audit's jitted interpreter, whose convs take any
// size:
//   sesr_corrected_ksize       <- sesr_tpu/ops/packed.py _packed_exact_impl(corrected=True)
//   sesr_corrected_ksize_audit <- integer_forward(corrected=True, collect_dumps=True)
//                                 behind sesr_tpu/quant/audit.py:96
// Its plain version, group by group, is sesr_tpu_torch/quant/integer.py
// group_forward; the chain's is integer_forward(corrected=True).
//
// A group runs as sesr_corrected_group.cu's run_group runs a tail group
// (run_group_ks: the last conv at 8 to 48 columns a PE group, the two-conv
// group's PAIR first conv, the piece forms), each conv in FormKS: Form with
// the conv's size its record's (R_K), read at run time, its k32 steps a
// loop whose A descriptors are formed as they issue (issue_run); every
// split conv past layer 0 runs in conv_pieces_ks, its pieces piece_span's
// (the largest divisor of the steps whose piece fits: 41 steps of a 9x9
// conv at width 16 go one at a time); layer 0's pixels are widened as for a
// 5x5 conv, a 9x9 conv's rows two k32 steps each (ks_steps_of,
// ks_half_off); every layer's B is staged a layer at a time; the extents
// follow from the sizes the host passes (ks, sesr_common.cuh ks_at: four
// bits a conv). The forms are their own functions, so that the shipped
// kernels' code is untouched (their ptxas lines stay the parent's).
//
// What bounds it on this card: operations, as sesr_corrected.cu; a conv of
// size k recomputes a ring of k/2 on every layer before it.
//
// Instantiations: sesr_corrected_ksize_kernel<G, C>, G 4 / 8 / 16 PE groups,
// width 16 or 32: 6, each the general instantiation's wide form (a plain
// int32 sum, exact for every sum the other form holds too); its counting
// form sesr_corrected_ksize_audit_kernel<G, C> in sesr_corrected_ksize_audit.cu
// and width 64 (w64_steps_of, w64_half_off: four planes, two k32 steps a
// tap) in sesr_corrected_w64.cu and sesr_corrected_w64_audit.cu, each of
// which includes this file for its bodies alone
// (SESR_CORRECTED_KSIZE_BODY_ONLY leaves out the entry points), so that
// each library is an nvcc process of its own.
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (sesr_tpu_torch/ops/_build.py), its own nvcc process.
// Each entry point returns cudaGetLastError() after its launch.
// tests/test_torch_ksizes.py models a layer's GEMM with ks_steps_of,
// ks_half_off, w64_steps_of and w64_half_off read from this file (keep them
// one-liners).

#define SESR_CORRECTED_GROUP_BODY_ONLY
#include "sesr_corrected_group.cu"

namespace {

// steps_of and half_off of a conv of size K, up to 9: layer 0 (wide) takes a
// k32 step a kernel row up to eight columns, two past them (row s / 2,
// columns 8 (s % 2) + 4 h ..); a hidden layer as steps_of / half_off.
__host__ __device__ constexpr int ks_steps_of(int K, int wide, int C) { return wide * K * ((K + 7) / 8) + (1 - wide) * ((K * K + 32 / C - 1) / (32 / C)); }
__host__ __device__ __forceinline__ int ks_half_off(int s, int h, int K, int iw, int wide, int C) { return wide * (s / ((K + 7) / 8) * iw + s % ((K + 7) / 8) * 8 + 4 * h) + (1 - wide) * tap_pix(tap_of(s, h, C), K, iw); }

// At width 64 (sesr_corrected_w64.cu) a hidden layer's input is four
// planes of 16 bytes a pixel, plane bytes apart, and each tap two k32
// steps: step s is tap s / 2 over planes 2 (s % 2) (k bytes 0-15, half 0)
// and 2 (s % 2) + 1 (half 1), A's LBO the planes' distance. w64_steps_of
// and w64_half_off (in 16-byte units from the first plane) are steps_of and
// half_off there; layer 0 as at any width.
__host__ __device__ constexpr int w64_steps_of(int K, int wide) { return wide * K * ((K + 7) / 8) + (1 - wide) * 2 * K * K; }
__host__ __device__ __forceinline__ int w64_half_off(int s, int h, int K, int iw, int wide, int plane) { return wide * (s / ((K + 7) / 8) * iw + s % ((K + 7) / 8) * 8 + 4 * h) + (1 - wide) * (s / 2 / K * iw + s / 2 % K + (2 * (s % 2) + h) * (plane / kPix)); }

// PE groups of a split layer 0 whose input channels m PEs own: m, but 4 for
// 3 at width 64, whose chunks are two 64-column groups (kMaxN; the fourth
// group's weights and zero terms are 0).
__host__ __device__ constexpr int first_groups(int m, int C) { return m + (C == 64 && m == 3); }

// K32 steps of a piece of a chunk of NC columns and S steps (piece_steps'
// rule for any S, 1 to 81): the whole chunk where it fits kPieceMax, else
// the largest divisor of S whose piece fits (five at S 25), so that the
// pieces divide the steps (ops/kernels.py pieces).
__host__ __device__ inline int piece_span(int S, int NC) {
  int sp = S;
  while (sp * NC * 32 > kPieceMax || S % sp != 0) --sp;
  return sp;
}

// layer_b_bytes and layer_pieces of a conv of kind `kind` (FIRST, MID or
// LAST) and size k, split (sp) or not.
__host__ __device__ inline int ks_conv_b_bytes(int kind, int k, int in_ch, int ocl, bool sp, int pe,
                                               int C) {
  const int groups = sp ? (kind == FIRST ? (in_ch < pe ? in_ch : pe) : pe_groups(pe)) : 1;
  return ks_steps_of(k, kind == FIRST, C) * 32 * (kind == LAST ? out_cols(ocl) : C) * groups;
}

__host__ __device__ inline int2 ks_conv_pieces(int kind, int k, int in_ch, int ocl, bool sp,
                                               int pe, int C) {
  const int b = ks_conv_b_bytes(kind, k, in_ch, ocl, sp, pe, C);
  if (kind == FIRST || !sp || !piece_form(b, pe_groups(pe), C)) return make_int2(1, b);
  const int ocp = kind == LAST ? out_cols(ocl) : C, g = pe_groups(pe);
  const int s = ks_steps_of(k, 0, C), nc = chunk_groups(g, ocp) * ocp, per = piece_span(s, nc);
  return make_int2(g * ocp / nc * (s / per), per * nc * 32);
}

// ks_conv_b_bytes and ks_conv_pieces at width 64: a split layer 0 has
// first_groups groups; a one-pass conv past layer 0 whose B passes
// kWholeMax (a 7x7 or 9x9 conv) goes in pieces of piece_span steps, run by
// conv_pieces_ks as a split conv's, and so does a split layer 0's (a 9x9
// conv at three or four groups), in chunks of two groups.
__host__ __device__ inline int w64_conv_b_bytes(int kind, int k, int in_ch, int ocl, bool sp,
                                                int pe) {
  const int groups = sp ? (kind == FIRST ? first_groups(in_ch < pe ? in_ch : pe, 64)
                                         : pe_groups(pe)) : 1;
  return w64_steps_of(k, kind == FIRST) * 32 * (kind == LAST ? out_cols(ocl) : 64) * groups;
}

__host__ __device__ inline int2 w64_conv_pieces(int kind, int k, int in_ch, int ocl, bool sp,
                                                int pe) {
  const int b = w64_conv_b_bytes(kind, k, in_ch, ocl, sp, pe);
  const int ocp = kind == LAST ? out_cols(ocl) : 64;
  if (sp != (kind == FIRST)) {                  // split past layer 0, or a one-pass layer 0
    if (kind == FIRST || !piece_form(b, pe_groups(pe), 64)) return make_int2(1, b);
    const int g = pe_groups(pe);
    const int s = w64_steps_of(k, 0), nc = chunk_groups(g, ocp) * ocp, per = piece_span(s, nc);
    return make_int2(g * ocp / nc * (s / per), per * nc * 32);
  }
  if (!piece_form(b, 1, 64)) return make_int2(1, b);
  if (!sp) {                                    // one pass past layer 0
    const int s = w64_steps_of(k, 0), per = piece_span(s, ocp);
    return make_int2(s / per, per * ocp * 32);
  }
  const int g = first_groups(in_ch < pe ? in_ch : pe, 64), nc = chunk_groups(g, 64) * 64;
  const int s = w64_steps_of(k, 1), per = piece_span(s, nc);   // a split layer 0
  return make_int2(g * 64 / nc * (s / per), per * nc * 32);
}

// Form (sesr_corrected.cu) of a conv whose size is its record's (R_K), in
// the general instantiation's wide form of a group (GEN, WIDE_SUM, GRP;
// CLAMP where not split is GEN's): Form's members, its extents, output
// window and count window from the conv's own size, and its k32 steps a
// run-time loop (issue, issue_run). The base is Form's instantiation at
// K = 1, whose one step sets A's start (a_lo[0]).
template <Kind KIND, int OCP, int NG, bool SPLIT, int C, bool COUNT = false, bool PAIR = false>
struct FormKS : Form<KIND, 1, OCP, NG, SPLIT, true, true, C, COUNT, true, true, PAIR> {
  using Base = Form<KIND, 1, OCP, NG, SPLIT, true, true, C, COUNT, true, true, PAIR>;
  int k, steps;          // the conv's size and its k32 steps

  __device__ __forceinline__ FormKS(const Layer& ly, const Net& net) : Base(ly, net) {
    k = this->prm[p_at(this->layer, R_K, C)];
    if constexpr (C == 64)
      steps = w64_steps_of(k, Base::WIDE);
    else
      steps = ks_steps_of(k, Base::WIDE, C);
    this->oh = ly.ih - k + 1;
    this->ow = this->iw - k + 1;
    const int r_out = (this->oh - net.t.th) / 2;          // ring of this output frame
    this->oy0 = net.t.oy0 - r_out;
    this->ox0 = net.t.ox0 - r_out;
    if constexpr (COUNT) {
      this->cy0 = count_lo(net.t.oy0, r_out, net.cy0);
      this->cy1 = count_hi(net.t.oy0, net.t.th, r_out, this->H, net.cy1);
      this->cx0 = count_lo(net.t.ox0, r_out, net.cx0);
      this->cx1 = count_hi(net.t.ox0, net.t.tw, r_out, this->W, net.cx1);
    }
  }

  // m-tile mt's wgmmas over chunk hc of the columns, one commit group
  __device__ __forceinline__ void issue(uint32_t (&d)[Base::R], int mt, int hc) const {
    issue_run(d, mt, this->b_lo + (b_byte(0, hc * Base::NC, 0, Base::N) >> 4), 0, steps, Base::N);
  }

  // the wgmmas of `count` steps from s0 of a chunk whose B starts at
  // descriptor start bp, `cols` columns a step (issue_piece's, the count and
  // the steps run-time values), one commit group
  __device__ __forceinline__ void issue_run(uint32_t (&d)[Base::R], int mt, uint32_t bp, int s0,
                                            int count, int cols) const {
    constexpr uint64_t a_hi = static_cast<uint64_t>(kSboA >> 4) << 32;
    constexpr uint64_t b_hi = static_cast<uint64_t>(kSboB >> 4) << 32;
    __syncwarp();
    wgmma_fence();
    for (int i = 0; i < count; ++i) {
      const int s = s0 + i;
      if constexpr (C == 64) {         // the planes' distance as A's LBO
        const int o0 = w64_half_off(s, 0, k, this->iw, Base::WIDE, this->plane);
        const int o1 = w64_half_off(s, 1, k, this->iw, Base::WIDE, this->plane);
        const uint32_t a = ((this->a_lo[0] & 0xFFFFu) + (o0 * kPix >> 4)) |
                           ((static_cast<uint32_t>((o1 - o0) * kPix) >> 4) << 16);
        const uint64_t ad = a_hi | (a + mt * (kRows * kPix >> 4));
        wgmma<Base::NC>(d, ad, b_hi | (bp + (b_byte(i, 0, 0, cols) >> 4)), s);
      } else {
        const int o0 = ks_half_off(s, 0, k, this->iw, Base::WIDE, C);
        const int o1 = ks_half_off(s, 1, k, this->iw, Base::WIDE, C);
        const uint32_t a = ((this->a_lo[0] & 0xFFFFu) + (o0 * kPix >> 4)) |
                           ((static_cast<uint32_t>(a_lbo(o0, o1, Base::WIDE, C, this->plane)) >> 4)
                            << 16);
        const uint64_t ad = a_hi | (a + mt * (kRows * kPix >> 4));
        wgmma<Base::NC>(d, ad, b_hi | (bp + (b_byte(i, 0, 0, cols) >> 4)), s);
      }
    }
    wgmma_commit();
  }
};

// conv_layer (sesr_corrected.cu) in FormKS.
template <Kind KIND, int OCP, int NG, bool SPLIT, int C, bool COUNT = false, bool PAIR = false>
__device__ __forceinline__ void conv_layer_ks(const Layer& ly, const Net& net) {
  using F = FormKS<KIND, OCP, NG, SPLIT, C, COUNT, PAIR>;
  const F f(ly, net);
  const int nmt = (f.oh * f.iw + kRows - 1) / kRows;
  // the warpgroup's index, uniform to the compiler as well
  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  uint32_t d[F::R];
  int carry[2][F::V];
  int n = 0;                                       // COUNT: this thread's counted partials
  for (int mt = wgi; mt < nmt; mt += kWarpgroups) {
#pragma unroll 1
    for (int hc = 0; hc < F::NH - 1; ++hc) {
      f.issue(d, mt, hc);
      wgmma_wait<0>();
      fence_acc(d);
      f.fold(d, mt, hc, carry, n);
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

// stage_piece (sesr_corrected.cu) of sp steps, a run-time count.
template <int N, int NC>
__device__ __forceinline__ void stage_piece_ks(uint8_t* dst, const int* __restrict__ src, int hc,
                                               int s0, int sp) {
  for (int i = threadIdx.x; i < sp * 2 * NC; i += kThreads)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst + 16 * i)),
                 "l"(src + piece_src(i, s0, hc, N, NC) / 4) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// conv_pieces (sesr_corrected.cu) in FormKS: every split conv past layer
// 0, its B whole (Layer::pieces false) or in pieces of piece_span steps;
// at width 64 a one-pass conv (SPLIT false, NG 1) whose B goes in pieces.
template <Kind KIND, int OCP, int NG, int C, bool COUNT = false, bool SPLIT = true,
          bool PAIR = false>
__device__ __forceinline__ void conv_pieces_ks(const Layer& ly, const Net& net) {
  using F = FormKS<KIND, OCP, NG, SPLIT, C, COUNT, PAIR>;
  const F f(ly, net);
  const int SP = piece_span(f.steps, F::NC), P = f.steps / SP;
  const int U = F::NH * P;                             // pieces a round
  const int nmt = (f.oh * f.iw + kRows - 1) / kRows;
  const int rounds = (nmt + kWarpgroups - 1) / kWarpgroups;
  const int wgi = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x >> 7), 0);
  const bool pieces = ly.pieces;
  // piece q of the layer (round q / U) lies in region q % w_bufs
  auto region = [&](int q) { return ly.regions + (q & 1) * ly.w_odd; };
  auto stage = [&](int q) { stage_piece_ks<F::N, F::NC>(region(q), ly.wg, q % U / P, q % P * SP, SP); };
  // B's descriptor start at p
  auto desc = [](const uint8_t* p) { return ((smem_u32(p) & 0x3FFFF) >> 4) | ((kLboB >> 4) << 16); };
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
        f.issue_run(d, mt, desc(ly.w + b_byte(0, hc * F::NC, 0, F::N)), 0, f.steps, F::N);
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
          f.issue_run(d, mt, desc(region(q)), pc * SP, SP, F::NC);
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

// conv_form (sesr_corrected.cu) in FormKS: layer 0 split one group per PE
// that owns an input channel (min(in_ch, pe); first_groups), any other
// split conv in conv_pieces_ks (G groups), else one pass (at width 64 in
// conv_pieces_ks where its B goes in pieces); PAIR: the two-conv group's
// first conv.
template <Kind KIND, int OCP, int G, int C, bool COUNT, bool PAIR = false>
__device__ __forceinline__ void conv_form_ks(const Layer& ly, const Net& net, int in_ch) {
  if ((net.prm[P_SPLIT] >> ly.layer) & 1) {
    if constexpr (KIND == FIRST && C == 64) {
      if (ly.pieces) {                     // a split layer 0 whose B goes in pieces
        switch (min(in_ch, net.pe)) {
          case 1: conv_pieces_ks<KIND, OCP, 1, C, COUNT, true, PAIR>(ly, net); return;
          case 2: conv_pieces_ks<KIND, OCP, 2, C, COUNT, true, PAIR>(ly, net); return;
          default: conv_pieces_ks<KIND, OCP, 4, C, COUNT, true, PAIR>(ly, net); return;
        }
      }
    }
    if constexpr (KIND == FIRST) {
      switch (min(in_ch, net.pe)) {
        case 1: conv_layer_ks<KIND, OCP, 1, true, C, COUNT, PAIR>(ly, net); return;
        case 2: conv_layer_ks<KIND, OCP, 2, true, C, COUNT, PAIR>(ly, net); return;
        case 3: conv_layer_ks<KIND, OCP, first_groups(3, C), true, C, COUNT, PAIR>(ly, net); return;
        default: conv_layer_ks<KIND, OCP, 4, true, C, COUNT, PAIR>(ly, net); return;
      }
    } else {
      conv_pieces_ks<KIND, OCP, G, C, COUNT>(ly, net);
      return;
    }
  }
  if constexpr (C == 64 && KIND != FIRST) {
    if (ly.pieces) {                       // a one-pass conv whose B goes in pieces
      conv_pieces_ks<KIND, OCP, 1, C, false, false>(ly, net);
      return;
    }
  }
  conv_layer_ks<KIND, OCP, 1, false, C, false, PAIR>(ly, net);
}

// The group helpers of sesr_corrected_group.cu for a group of sizes ks: layer
// j sized as a conv of its kind and size.
__host__ __device__ inline int ks_group_b_bytes(int j, int n, int fl, int in_ch, int ocl, int split,
                                                int pe, int C, long long ks) {
  return ks_conv_b_bytes(group_kind(j, n, fl), ks_at(ks, j), in_ch, ocl, (split >> j) & 1, pe, C);
}

__host__ __device__ inline int2 ks_group_pieces(int j, int n, int fl, int in_ch, int ocl, int split,
                                                int pe, int C, long long ks) {
  return ks_conv_pieces(group_kind(j, n, fl), ks_at(ks, j), in_ch, ocl, (split >> j) & 1, pe, C);
}

__host__ __device__ inline int ks_group_cap(int j, int n, int fl, int th, int tw, int C,
                                            long long ks) {
  const int r = ks_ring(j, n, ks), ih = th + 2 * r, iw = tw + 2 * r;
  const int K = ks_at(ks, j), wide = group_kind(j, n, fl) == 0;
  return round_up((ih - K + 1) * iw, kRows) +
         ks_half_off(ks_steps_of(K, wide, C) - 1, 1, K, iw, wide, C);
}

__host__ __device__ inline int ks_group_plane(int j, int n, int fl, int th, int tw, int C,
                                              long long ks) {
  if (C != 32 || (j == 0 && (fl & G_FIRST))) return 0;
  return round_up((j < n ? ks_group_cap(j, n, fl, th, tw, C, ks) : th * tw) * kPix, kAlign);
}

__host__ __device__ inline int ks_group_buf(int j, int n, int fl, int th, int tw, int C,
                                            long long ks) {
  if (C == 32 && !(j == 0 && (fl & G_FIRST))) return 2 * ks_group_plane(j, n, fl, th, tw, C, ks);
  return (j < n ? ks_group_cap(j, n, fl, th, tw, C, ks) : th * tw) * kPix;
}

// group_plan (sesr_corrected_group.cu) of a group of sizes ks in the tail
// instantiations' forms at pe_groups(pe) PE groups, B always staged: two
// regions, else one, else in pieces (kernels.py corrected_group_plan
// mirrors it).
__host__ __device__ inline Plan ks_group_plan(int split, int pe, int n, int fl, int in_ch, int ocl,
                                              int th, int tw, int C, long long ks) {
  Plan p;
  const int words = param_words(group_records(n, fl), C, pe) +
                    ((fl & G_LAST) ? out_rows(ocl, C, pe) : 0);
  p.w_at = round_up(words * 4, kAlign);
  int even = 0, odd = 0, unit = 0;
  for (int j = 0; j < n; ++j) {
    const int b = ks_group_b_bytes(j, n, fl, in_ch, ocl, split, pe, C, ks);
    int& big = (j % 2) ? odd : even;
    big = big > b ? big : b;
    const int u = ks_group_pieces(j, n, fl, in_ch, ocl, split, pe, C, ks).y;
    unit = unit > u ? unit : u;
  }
  const int r0 = ks_ring(0, n, ks);
  int x = 0, y = (fl & G_FIRST) ? (th + 2 * r0) * (tw + 2 * r0) * 4 : 0;
  for (int j = 0; j <= n - ((fl & G_LAST) ? 1 : 0); ++j) {
    const int b = ks_group_buf(j, n, fl, th, tw, C, ks);
    int& dst = (j % 2) ? y : x;
    dst = dst > b ? dst : b;
  }
  const int rs = ks_sc_ring(n, fl, ks);
  const bool pair = n == 2 && fl == (G_FIRST | G_LAST);
  const int sc_bytes = fl && !pair ? (th + 2 * rs) * (tw + 2 * rs) * 2 * C : 0;
  p.w_bufs = 2;
  p.w_odd = round_up(even, kAlign);
  p.w_bytes = p.w_odd + odd;
  p.pieces = false;
  for (;;) {
    p.x_at = round_up(p.w_at + p.w_bytes, kAlign);
    p.y_at = round_up(p.x_at + x, kAlign);
    p.sc_at = round_up(p.y_at + y, kAlign);
    p.scratch_at = p.sc_at + sc_bytes;
    p.bytes = p.scratch_at + kScratch;
    if (p.bytes <= kSmemLimit || (p.w_bufs == 1 && p.pieces)) return p;
    if (p.w_bufs == 2) {
      p.w_bufs = 1;
      p.w_odd = 0;
      p.w_bytes = p.pieces ? unit : even > odd ? even : odd;
    } else {
      p.pieces = true;
      p.w_bufs = 2;
      p.w_odd = round_up(unit, kAlign);
      p.w_bytes = p.w_odd + unit;
    }
  }
}

// The group helpers above at width 64 (sesr_corrected_w64.cu): a hidden
// layer's input is four planes, each laid out as a width-32 layer's plane.
__host__ __device__ inline int w64_group_b_bytes(int j, int n, int fl, int in_ch, int ocl,
                                                 int split, int pe, long long ks) {
  return w64_conv_b_bytes(group_kind(j, n, fl), ks_at(ks, j), in_ch, ocl, (split >> j) & 1, pe);
}

__host__ __device__ inline int2 w64_group_pieces(int j, int n, int fl, int in_ch, int ocl,
                                                 int split, int pe, long long ks) {
  return w64_conv_pieces(group_kind(j, n, fl), ks_at(ks, j), in_ch, ocl, (split >> j) & 1, pe);
}

__host__ __device__ inline int w64_group_cap(int j, int n, int fl, int th, int tw, long long ks) {
  const int r = ks_ring(j, n, ks), ih = th + 2 * r, iw = tw + 2 * r;
  const int K = ks_at(ks, j), wide = group_kind(j, n, fl) == 0;
  return round_up((ih - K + 1) * iw, kRows) +
         ks_half_off(ks_steps_of(K, wide, 32) - 1, 1, K, iw, wide, 32);
}

__host__ __device__ inline int w64_group_plane(int j, int n, int fl, int th, int tw,
                                               long long ks) {
  if (j == 0 && (fl & G_FIRST)) return 0;
  return round_up((j < n ? w64_group_cap(j, n, fl, th, tw, ks) : th * tw) * kPix, kAlign);
}

__host__ __device__ inline int w64_group_buf(int j, int n, int fl, int th, int tw, long long ks) {
  if (!(j == 0 && (fl & G_FIRST))) return 4 * w64_group_plane(j, n, fl, th, tw, ks);
  return (j < n ? w64_group_cap(j, n, fl, th, tw, ks) : th * tw) * kPix;
}

__host__ __device__ inline Plan w64_group_plan(int split, int pe, int n, int fl, int in_ch, int ocl,
                                               int th, int tw, long long ks) {
  constexpr int C = 64;
  Plan p;
  const int words = param_words(group_records(n, fl), C, pe) +
                    ((fl & G_LAST) ? out_rows(ocl, C, pe) : 0);
  p.w_at = round_up(words * 4, kAlign);
  int even = 0, odd = 0, unit = 0;
  for (int j = 0; j < n; ++j) {
    const int b = w64_group_b_bytes(j, n, fl, in_ch, ocl, split, pe, ks);
    int& big = (j % 2) ? odd : even;
    big = big > b ? big : b;
    const int u = w64_group_pieces(j, n, fl, in_ch, ocl, split, pe, ks).y;
    unit = unit > u ? unit : u;
  }
  const int r0 = ks_ring(0, n, ks);
  int x = 0, y = (fl & G_FIRST) ? (th + 2 * r0) * (tw + 2 * r0) * 4 : 0;
  for (int j = 0; j <= n - ((fl & G_LAST) ? 1 : 0); ++j) {
    const int b = w64_group_buf(j, n, fl, th, tw, ks);
    int& dst = (j % 2) ? y : x;
    dst = dst > b ? dst : b;
  }
  const int rs = ks_sc_ring(n, fl, ks);
  const bool pair = n == 2 && fl == (G_FIRST | G_LAST);
  const int sc_bytes = fl && !pair ? (th + 2 * rs) * (tw + 2 * rs) * 2 * C : 0;
  p.w_bufs = 2;
  p.w_odd = round_up(even, kAlign);
  p.w_bytes = p.w_odd + odd;
  p.pieces = false;
  for (;;) {
    p.x_at = round_up(p.w_at + p.w_bytes, kAlign);
    p.y_at = round_up(p.x_at + x, kAlign);
    p.sc_at = round_up(p.y_at + y, kAlign);
    p.scratch_at = p.sc_at + sc_bytes;
    p.bytes = p.scratch_at + kScratch;
    if (p.bytes <= kSmemLimit || (p.w_bufs == 1 && p.pieces)) return p;
    if (p.w_bufs == 2) {
      p.w_bufs = 1;
      p.w_odd = 0;
      p.w_bytes = p.pieces ? unit : even > odd ? even : odd;
    } else {
      p.pieces = true;
      p.w_bufs = 2;
      p.w_odd = round_up(unit, kAlign);
      p.w_bytes = p.w_odd + unit;
    }
  }
}

// The group helpers at width C, as run_group_ks calls them: ks_group_* at
// widths 16 and 32, w64_group_* at 64; group_plan_at: the plan at a
// width known at run time (the host's).
template <int C>
__host__ __device__ __forceinline__ Plan group_plan_c(int split, int pe, int n, int fl,
                                                      int in_ch, int ocl, int th, int tw,
                                                      long long ks) {
  if constexpr (C == 64) return w64_group_plan(split, pe, n, fl, in_ch, ocl, th, tw, ks);
  else return ks_group_plan(split, pe, n, fl, in_ch, ocl, th, tw, C, ks);
}

template <int C>
__host__ __device__ __forceinline__ int group_b_bytes_c(int j, int n, int fl, int in_ch, int ocl,
                                                        int split, int pe, long long ks) {
  if constexpr (C == 64) return w64_group_b_bytes(j, n, fl, in_ch, ocl, split, pe, ks);
  else return ks_group_b_bytes(j, n, fl, in_ch, ocl, split, pe, C, ks);
}

template <int C>
__host__ __device__ __forceinline__ int2 group_pieces_c(int j, int n, int fl, int in_ch, int ocl,
                                                        int split, int pe, long long ks) {
  if constexpr (C == 64) return w64_group_pieces(j, n, fl, in_ch, ocl, split, pe, ks);
  else return ks_group_pieces(j, n, fl, in_ch, ocl, split, pe, C, ks);
}

template <int C>
__host__ __device__ __forceinline__ int group_cap_c(int j, int n, int fl, int th, int tw,
                                                    long long ks) {
  if constexpr (C == 64) return w64_group_cap(j, n, fl, th, tw, ks);
  else return ks_group_cap(j, n, fl, th, tw, C, ks);
}

template <int C>
__host__ __device__ __forceinline__ int group_plane_c(int j, int n, int fl, int th, int tw,
                                                      long long ks) {
  if constexpr (C == 64) return w64_group_plane(j, n, fl, th, tw, ks);
  else return ks_group_plane(j, n, fl, th, tw, C, ks);
}

inline Plan group_plan_at(int split, int pe, int n, int fl, int in_ch, int ocl, int th, int tw,
                          int C, long long ks) {
  return C == 64 ? w64_group_plan(split, pe, n, fl, in_ch, ocl, th, tw, ks)
                 : ks_group_plan(split, pe, n, fl, in_ch, ocl, th, tw, C, ks);
}

// run_group (sesr_corrected_group.cu) of a group of sizes ks: its tail
// instantiations' forms for every group, in FormKS, B always staged.
template <int G, int C, bool COUNT>
__device__ __forceinline__ void run_group_ks(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                             const int* __restrict__ weights,
                                             const int* __restrict__ params, int16_t* scg, int nb,
                                             int H, int W, int n, int fl, int in_ch, int out_ch,
                                             int th, int tw, int split, int pe,
                                             unsigned long long* counts, int cy0, int cy1, int cx0,
                                             int cx1, long long ks) {
  extern __shared__ __align__(128) uint8_t smem[];
  const bool first = fl & G_FIRST, last = fl & G_LAST;
  const Plan pl = group_plan_c<C>(split, pe, n, fl, in_ch, out_ch, th, tw, ks);
  const int R = group_records(n, fl);
  int* prm = reinterpret_cast<int*>(smem);
  uint8_t* wsm = smem + pl.w_at;
  uint8_t* bx = smem + pl.x_at;
  uint8_t* by = smem + pl.y_at;

  const int words = param_words(R, C, pe) + (last ? out_rows(out_ch, C, pe) : 0);
  for (int i = threadIdx.x; i < words; i += kThreads) prm[i] = __ldg(params + i);
  __syncthreads();
  auto b_region = [&](int j) { return wsm + (j % 2) * pl.w_odd; };
  auto stage_layer = [&](int j) {
    stage_b(b_region(j), weights + prm[p_at(j, R_WOFF, C)],
            group_b_bytes_c<C>(j, n, fl, in_ch, out_ch, split, pe, ks));
  };
  auto in_pieces = [&](int j) {
    return pl.pieces && group_pieces_c<C>(j, n, fl, in_ch, out_ch, split, pe, ks).x > 1;
  };

  const int r0 = ks_ring(0, n, ks), r_sc = ks_sc_ring(n, fl, ks);
  const int ih0 = th + 2 * r0, iw0 = tw + 2 * r0, n0 = ih0 * iw0;
  const int cap0 = group_cap_c<C>(0, n, fl, th, tw, ks);
  const int plane0 = group_plane_c<C>(0, n, fl, th, tw, ks);
  const int tiles_x = (W + tw - 1) / tw, tiles_y = (H + th - 1) / th;
  const int per_frame = tiles_x * tiles_y;
  const int pad0 = pad_word(prm[p_at(0, R_ZEFF, C)]);
  Net net;
  net.t.th = th;
  net.t.tw = tw;
  net.t.H = H;
  net.t.W = W;
  net.L = R;
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
  net.prelast = last ? n - 2 : -1;
  net.sc_off = ks_ring(1, n, ks) - r_sc;

  for (int tile = blockIdx.x; tile < nb * per_frame; tile += gridDim.x) {
    net.frame = tile / per_frame;
    const int rem = tile - net.frame * per_frame;
    net.t.oy0 = (rem / tiles_x) * th;
    net.t.ox0 = (rem % tiles_x) * tw;
    if (!in_pieces(0)) stage_layer(0);          // (conv_pieces_ks stages a layer in pieces)
    if (first) {
      // layer 0's input, one word a pixel, into y, widened into x
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
      int4* wide = reinterpret_cast<int4*>(bx);
      for (int p = threadIdx.x; p < cap0; p += kThreads)
        wide[p] = make_int4(raw[min(p, n0 - 1)], raw[min(p + 1, n0 - 1)],
                            raw[min(p + 2, n0 - 1)], raw[min(p + 3, n0 - 1)]);
    } else {
      // the activation the group before wrote, C bytes a pixel in order:
      // plane w's 16 bytes at plane0 w; z_eff outside the image
      const int4 pad4 = make_int4(pad0, pad0, pad0, pad0);
      for (int i = threadIdx.x; i < n0; i += kThreads) {
        const int yy = i / iw0, xx = i - yy * iw0;
        const int gy = net.t.oy0 - r0 + yy, gx = net.t.ox0 - r0 + xx;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const int4* src = reinterpret_cast<const int4*>(
            x + ((static_cast<size_t>(net.frame) * H + (in ? gy : 0)) * W + (in ? gx : 0)) * C);
#pragma unroll
        for (int w = 0; w < C / 16; ++w)
          reinterpret_cast<int4*>(bx + w * plane0)[i] = in ? __ldg(src + w) : pad4;
      }
      if (last) {
        // the shortcut the first group wrote, over the last conv's input
        // extent (0 outside the image, where the last conv never reads it)
        const int sw = net.sc_w, sh = net.sc_h;
        for (int i = threadIdx.x; i < sw * sh; i += kThreads) {
          const int yy = i / sw, xx = i - yy * sw;
          const int gy = net.t.oy0 - r_sc + yy, gx = net.t.ox0 - r_sc + xx;
          const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
          const int4* src = reinterpret_cast<const int4*>(
              scg + ((static_cast<size_t>(net.frame) * H + (in ? gy : 0)) * W + (in ? gx : 0)) * C);
#pragma unroll
          for (int m = 0; m < C / 8; ++m)
            reinterpret_cast<int4*>(net.sc)[i * (C / 8) + m] =
                in ? __ldg(src + m) : make_int4(0, 0, 0, 0);
        }
      }
    }
    b_wait();
    fence_proxy_async();
    __syncthreads();

    uint8_t* cur = bx;
    uint8_t* nxt = by;
    for (int j = 0; j < n; ++j) {
      if (pl.w_bufs == 2 && j + 1 < n && !in_pieces(j) && !in_pieces(j + 1)) stage_layer(j + 1);
      Layer ly;
      const int r = ks_ring(j, n, ks);
      ly.in = cur;
      ly.ih = th + 2 * r;
      ly.iw = tw + 2 * r;
      ly.plane = group_plane_c<C>(j, n, fl, th, tw, ks);
      ly.w = b_region(j);
      ly.next = reinterpret_cast<int*>(nxt);
      ly.next_plane = group_plane_c<C>(j + 1, n, fl, th, tw, ks) / 4;
      ly.layer = j;
      ly.pieces = in_pieces(j);
      ly.wg = weights + prm[p_at(j, R_WOFF, C)];
      ly.regions = wsm;
      ly.w_odd = pl.w_odd;
      ly.w_bufs = pl.w_bufs;
      const int kind = group_kind(j, n, fl);
      if (kind == 0 && n == 2 && last)
        conv_form_ks<FIRST, C, G, C, COUNT, true>(ly, net, in_ch);
      else if (kind == 0)
        conv_form_ks<FIRST, C, G, C, COUNT>(ly, net, in_ch);
      else if (kind == 1)
        conv_form_ks<MID, C, G, C, COUNT>(ly, net, in_ch);
      else if (out_ch <= 8)
        conv_form_ks<LAST, 8, G, C, COUNT>(ly, net, in_ch);
      else if (out_ch <= 16)
        conv_form_ks<LAST, 16, G, C, COUNT>(ly, net, in_ch);
      else if (out_ch <= 32)
        conv_form_ks<LAST, 32, G, C, COUNT>(ly, net, in_ch);
      else
        conv_form_ks<LAST, 48, G, C, COUNT>(ly, net, in_ch);
      b_wait();
      fence_proxy_async();
      __syncthreads();
      if (j + 1 < n && !in_pieces(j + 1) && (pl.w_bufs == 1 || in_pieces(j))) {
        stage_layer(j + 1);
        b_wait();
        fence_proxy_async();
        __syncthreads();
      }
      uint8_t* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    if (!last) {
      // the group's output, the tile's core, C bytes a pixel in order (and
      // the first group's shortcut, 2 C bytes)
      const int pn = group_plane_c<C>(n, n, fl, th, tw, ks);
      for (int i = threadIdx.x; i < th * tw; i += kThreads) {
        const int yy = i / tw, xx = i - yy * tw;
        const int gy = net.t.oy0 + yy, gx = net.t.ox0 + xx;
        if (gy >= H || gx >= W) continue;
        const size_t at = (static_cast<size_t>(net.frame) * H + gy) * W + gx;
        int4* dst = reinterpret_cast<int4*>(out + at * C);
#pragma unroll
        for (int w = 0; w < C / 16; ++w) dst[w] = reinterpret_cast<const int4*>(cur + w * pn)[i];
        if (first) {
          int4* sdst = reinterpret_cast<int4*>(scg + at * C);
#pragma unroll
          for (int m = 0; m < C / 8; ++m)
            sdst[m] = reinterpret_cast<const int4*>(net.sc)[i * (C / 8) + m];
        }
      }
      __syncthreads();
    }
  }
}

template <int G, int C>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_ksize_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                            const int* __restrict__ weights, const int* __restrict__ params,
                            int16_t* sc, int nb, int H, int W, int n, int fl, int in_ch,
                            int out_ch, int th, int tw, int split, int pe, long long ks) {
  run_group_ks<G, C, false>(x, out, weights, params, sc, nb, H, W, n, fl, in_ch, out_ch, th, tw,
                            split, pe, nullptr, 0, 0, 0, 0, ks);
}

template <int G, int C>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_ksize_audit_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                  const int* __restrict__ weights,
                                  const int* __restrict__ params, int16_t* sc, int nb, int H,
                                  int W, int n, int fl, int in_ch, int out_ch, int th, int tw,
                                  int split, int pe, unsigned long long* counts, int cy0, int cy1,
                                  int cx0, int cx1, long long ks) {
  run_group_ks<G, C, true>(x, out, weights, params, sc, nb, H, W, n, fl, in_ch, out_ch, th, tw,
                           split, pe, counts, cy0, cy1, cx0, cx1, ks);
}

// Whether ks holds an odd size from 1 to 9 for each of the n convs, and
// nothing past them.
bool sizes_take(int n, long long ks) {
  for (int j = 0; j < n; ++j)
    if (ks_at(ks, j) % 2 == 0 || ks_at(ks, j) > 9) return false;
  return n >= 16 || (ks >> (4 * n)) == 0;
}

// Whether a group's launch is taken at width 16, 32 or 64 (each library
// checks that the width is one of its own).
bool ksize_takes(int n, int fl, int in_ch, int out_ch, int th, int tw, int split, int pe,
                 int general, int width, long long ks) {
  if (!(n >= 2 && n <= kMaxL && fl >= 0 && fl <= 3 && in_ch >= 1 && in_ch <= 4 && out_ch >= 1 &&
        out_ch <= kMaxOut && th >= 1 && tw >= 1 && th <= 1024 && tw <= 1024 &&
        (split >> n) == 0 && pe >= 1 && pe <= kMaxPE && (general == 1 || general == 2) &&
        (width == 16 || width == 32 || width == 64) && sizes_take(n, ks)))
    return false;
  return group_plan_at(split, pe, n, fl, in_ch, out_ch, th, tw, width, ks).bytes <= kSmemLimit;
}

// One launch of sesr_corrected_ksize_kernel<G, C> or (COUNT) its counting
// form.
template <int G, int C, bool COUNT>
cudaError_t launch_ksize(const int8_t* x, int8_t* out, const int* w, const int* prm, int16_t* sc,
                         int nb, int h, int wd, int n, int fl, int in_ch, int out_ch, int th,
                         int tw, int split, int pe, long long ks, const GroupCount& cnt,
                         cudaStream_t stream) {
  const int bytes = group_plan_c<C>(split, pe, n, fl, in_ch, out_ch, th, tw, ks).bytes;
  const void* fn;                      // (each library holds one of the two forms)
  if constexpr (COUNT)
    fn = reinterpret_cast<const void*>(&sesr_corrected_ksize_audit_kernel<G, C>);
  else
    fn = reinterpret_cast<const void*>(&sesr_corrected_ksize_kernel<G, C>);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads, bytes);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long tiles = static_cast<long long>(nb) * ((h + th - 1) / th) * ((wd + tw - 1) / tw);
  const int grid = static_cast<int>(tiles < sms * per_sm ? tiles : sms * per_sm);
  if constexpr (COUNT)
    sesr_corrected_ksize_audit_kernel<G, C><<<grid, kThreads, bytes, stream>>>(
        x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, out_ch, th, tw, split, pe, cnt.counts,
        cnt.y0, cnt.y1, cnt.x0, cnt.x1, ks);
  else
    sesr_corrected_ksize_kernel<G, C><<<grid, kThreads, bytes, stream>>>(
        x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, out_ch, th, tw, split, pe, ks);
  return cudaGetLastError();
}

template <int C, bool COUNT>
cudaError_t launch_ksize_pe(const int8_t* x, int8_t* out, const int* w, const int* prm,
                            int16_t* sc, int nb, int h, int wd, int n, int fl, int in_ch,
                            int out_ch, int th, int tw, int split, int pe, long long ks,
                            const GroupCount& cnt, cudaStream_t s) {
  switch (pe_groups(pe)) {
    case 4: return launch_ksize<4, C, COUNT>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, out_ch, th, tw, split, pe, ks, cnt, s);
    case 8: return launch_ksize<8, C, COUNT>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, out_ch, th, tw, split, pe, ks, cnt, s);
    default: return launch_ksize<16, C, COUNT>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, out_ch, th, tw, split, pe, ks, cnt, s);
  }
}

// One group's launch at width C, served or (COUNT) counting, or
// cudaErrorInvalidValue for arguments the forms refuse.
template <int C, bool COUNT>
int launch_ksize_group(const void* x, void* out, const void* weights, const void* params,
                       void* sc, int nb, int h, int w, int n, int fl, int in_ch, int out_ch,
                       int th, int tw, int split, int pe, int general, long long ks,
                       const GroupCount& cnt, void* stream) {
  if (!ksize_takes(n, fl, in_ch, out_ch, th, tw, split, pe, general, C, ks) ||
      (reinterpret_cast<uintptr_t>(weights) & 15) || (fl != (G_FIRST | G_LAST) && sc == nullptr) ||
      (COUNT && (cnt.counts == nullptr || (reinterpret_cast<uintptr_t>(cnt.counts) & 7))))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_ksize_pe<C, COUNT>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(out), static_cast<const int*>(weights),
      static_cast<const int*>(params), static_cast<int16_t*>(sc), nb, h, w, n, fl, in_ch, out_ch,
      th, tw, split, pe, ks, cnt, static_cast<cudaStream_t>(stream)));
}

// Shared memory of one block of a group in bytes, or 0 where the entry
// point refuses it.
int ksize_smem(int n, int flags, int in_ch, int out_ch, int tile_h, int tile_w, int split, int pe,
               int width, long long ks) {
  if (!ksize_takes(n, flags, in_ch, out_ch, tile_h, tile_w, split, pe, 1, width, ks)) return 0;
  return group_plan_at(split, pe, n, flags, in_ch, out_ch, tile_h, tile_w, width, ks).bytes;
}

}  // namespace

#ifndef SESR_CORRECTED_KSIZE_BODY_ONLY
// (sesr_corrected_ksize_audit.cu and the width-64 sources include this file
// for its bodies alone: the entry points below are this library's, the
// served kernels at widths 16 and 32.)

extern "C" {

// One group's launch: sesr_corrected_group's arguments but the stream, then
// ks, the group's conv sizes (four bits a conv, conv j in bits 4 j .. 4 j +
// 3; each odd, 1 to 9), then the stream. general: 1 or 2, both run the wide
// form; width 16 or 32.
int sesr_corrected_ksize(const void* x, void* out, const void* weights, const void* params,
                         void* sc, int nb, int h, int w, int n, int flags, int in_ch, int out_ch,
                         int tile_h, int tile_w, int split, int pe, int general, int width,
                         long long ks, void* stream) {
  const GroupCount none{nullptr, 0, 0, 0, 0};
  if (width == 16)
    return launch_ksize_group<16, false>(x, out, weights, params, sc, nb, h, w, n, flags, in_ch,
                                         out_ch, tile_h, tile_w, split, pe, general, ks, none,
                                         stream);
  if (width == kMaxC)
    return launch_ksize_group<kMaxC, false>(x, out, weights, params, sc, nb, h, w, n, flags,
                                            in_ch, out_ch, tile_h, tile_w, split, pe, general, ks,
                                            none, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory of one block of a group in bytes, or 0 where the entry
// point refuses it (the counting form's is the same).
int sesr_corrected_ksize_smem(int n, int flags, int in_ch, int out_ch, int tile_h, int tile_w,
                              int split, int pe, int width, long long ks) {
  if (width != 16 && width != kMaxC) return 0;
  return ksize_smem(n, flags, in_ch, out_ch, tile_h, tile_w, split, pe, width, ks);
}

const char* sesr_corrected_ksize_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#endif  // SESR_CORRECTED_KSIZE_BODY_ONLY
