// The layer-group form of K1 and K2 (sesr_net.cu) on Hopper (sm_90a): a
// network that no single launch of sesr_net_kernel runs (more than 16
// convs, or no tile of its plan fits a block) goes as a chain of launches,
// one per group of consecutive convs (convert.py layer_groups), each a
// launch of sesr_net_group_kernel over the whole batch.
//
// Replaces, with sesr_net.cu, the same two Pallas TPU kernels of the JAX
// package, which loop over any number of convs:
//   sesr_net_group(exact = 1) <- sesr_tpu/ops/pallas_pipeline.py build_pallas_forward (K1)
//   sesr_net_group(exact = 0) <- sesr_tpu/ops/pallas_packed.py build_pallas_packed_forward (K2)
// Its plain version, group by group, is sesr_tpu_torch/quant/integer.py
// group_forward; the chain's is integer_forward.
//
// A group runs its convs over one output tile as sesr_net_kernel runs a
// whole network (conv_form and conv_layer of sesr_net.cu, the general
// instantiation's forms), its extents from its own kernel sizes
// (group_ring: 3x3 layers but for the network's first and last). What
// crosses a boundary is the plain interpreter's: the int8 activation
// input.{e + 1} the group's last conv produces, (n, H, W, C) in device
// memory with the channels in order, each tile writing its core and the
// next group reading its halo ring (z_eff outside the image, as every
// layer's pads); and the residual shortcut, which the first group writes
// for the last one in the form the last conv's domain-in consumes: K1
// clip(round(s - half)) as int8, K2 round(s) as int16, (n, H, W, C) each.
// A split last conv whose B no block holds beside the buffers runs in the
// staged form (conv_layer's STAGE: B one PE pass at a time, two buffers
// where they fit): SESR-XL x4 RGB at 5-16 PEs in K1, one group.
// A network of two convs (num_lblocks 0) is one group, G_FIRST | G_LAST,
// its first conv also the one before the last: it runs in a kernel of its
// own, sesr_net_pair_kernel, whose first conv's epilogue writes the last
// conv's domain-in, the residual add of its ReLU output to itself
// (conv_layer's PAIR), with no shortcut kept in shared or device memory.
//
// What bounds it on this card: operations, as sesr_net.cu; a group's tile
// recomputes only its own ring, so a deep network's halo stays that of a
// 9- to 16-conv one, and each boundary adds one int8 write and one read of
// C channels a pixel (and the shortcut's) to device memory.
//
// Instantiations: sesr_net_group_kernel<DP, OCL, C, WIDE>, DP K1 / K2, the
// last conv's padded columns as in the general sesr_net_kernel (OCL -8,
// -16, -32, -48), width 16 or 32, wide sums or not: 32, each general (every
// sum clamped to pe_add_bits, activations in [-half, half - 1]). A chain
// takes one of them for all its groups (G_FIRST / G_LAST are run-time
// flags). The two-conv group: sesr_net_pair_kernel<DP, OCL, C>, 16, each
// the wide form (a plain int32 sum, exact for every sum the other form
// holds too), so that a network of almost no work costs no more
// instantiations than that; the entry point takes it for n = 2, G_FIRST |
// G_LAST.
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (sesr_tpu_torch/ops/_build.py), beside sesr_net.cu's
// library. Each entry point returns cudaGetLastError() after its launch.

#define SESR_NET_BODY_ONLY
#include "sesr_net.cu"

namespace {

// Shared memory of one block of a group of n convs (flags fl) at hidden
// width C: sesr_net.cu smem_plan with the group's extents, room for
// kMaxL + 1 records (a group of 16 convs and the next conv's record), the
// layer-0 input of a group past conv 0 as C / 4 planes, the output of a
// group before the last conv as C / 4 planes of the tile, the shortcut where
// the group writes (the tile) or reads it (the last conv's input extent),
// and a staged split last conv's B one pass (kernels.py
// net_group_smem_bytes mirrors it). pair: the two-conv group, which keeps
// no shortcut.
__host__ __device__ inline Smem group_plan(int dp, int split, int pe, int n, int fl, int in_ch,
                                           int ocl, int th, int tw, int C, bool pair = false) {
  Smem s;
  s.prm_words = net_words(kMaxL + 1, C);
  s.w_words = 0;
  for (int j = 0; j < n; ++j) {
    const int kind = group_kind(j, n, fl);
    const bool sp = (split >> j) & 1;
    int lw = layer_words(sp, kind, 3, in_ch, ocl, pe, C);
    if (kind == 2 && sp && dp == REFERENCE && pe != 4) lw /= pe;    // staged a pass at a time
    s.w_words = s.w_words > lw ? s.w_words : lw;
  }
  // layer j's input: buf_b for even j, buf_a for odd; the group's output
  // (before the last conv) is "layer n's input"
  s.a_words = 0;
  s.b_words = (fl & G_FIRST) ? (group_extent(0, n, fl, th, tw) + 3) & ~3 : 0;
  for (int j = (fl & G_FIRST) ? 1 : 0; j <= n - ((fl & G_LAST) ? 1 : 0); ++j) {
    const int words = C / 4 * plane_stride(group_extent(j, n, fl, th, tw));
    int& dst = (j % 2) ? s.a_words : s.b_words;
    dst = dst > words ? dst : words;
  }
  const int rs = group_sc_ring(fl);
  s.sc_words = (fl & (G_FIRST | G_LAST)) && !pair ? (dp == REFERENCE ? C / 4 : C / 2) *
                                               plane_stride((th + 2 * rs) * (tw + 2 * rs))
                                         : 0;
  const int two = s.prm_words + 2 * s.w_words + s.a_words + s.b_words + s.sc_words;
  s.w_bufs = dp == REFERENCE && C == 32 && 4 * two > kSmemLimit ? 1 : 2;
  return s;
}

// Whether a group is the two-conv group (sesr_net_pair_kernel).
__host__ __device__ constexpr bool pair_group(int n, int fl) {
  return n == 2 && fl == (G_FIRST | G_LAST);
}

size_t group_bytes(int dp, int split, int pe, int n, int fl, int in_ch, int ocl, int th, int tw,
                   int C) {
  const Smem p = group_plan(dp, split, pe, n, fl, in_ch, ocl, th, tw, C, pair_group(n, fl));
  return sizeof(int) * (static_cast<size_t>(p.prm_words) + p.w_bufs * p.w_words + p.a_words +
                        p.b_words + p.sc_words);
}

// C / 4 words of a pixel in planes `ps` apart (word w: channels w % 4 +
// 16 (w / 4) + 4 j) from / to C bytes in order in device memory.
template <int C>
__device__ __forceinline__ void planes_from(int* dst, int ps, const int8_t* src) {
#pragma unroll
  for (int h = 0; h < C / 16; ++h) {
    const int4 v = transpose_bytes(__ldg(reinterpret_cast<const int4*>(src) + h));
    dst[(4 * h) * ps] = v.x;
    dst[(4 * h + 1) * ps] = v.y;
    dst[(4 * h + 2) * ps] = v.z;
    dst[(4 * h + 3) * ps] = v.w;
  }
}

template <int C>
__device__ __forceinline__ void planes_to(int8_t* dst, const int* src, int ps) {
#pragma unroll
  for (int h = 0; h < C / 16; ++h)
    reinterpret_cast<int4*>(dst)[h] = transpose_bytes(
        make_int4(src[(4 * h) * ps], src[(4 * h + 1) * ps], src[(4 * h + 2) * ps],
                  src[(4 * h + 3) * ps]));
}

// K2's shortcut, C / 2 planes of int16 pairs (plane 4 m + b: channels 8 m +
// b and 8 m + b + 4) from / to C int16 in order.
template <int C>
__device__ __forceinline__ void pairs_from(int* dst, int ps, const int16_t* src) {
#pragma unroll
  for (int m = 0; m < C / 8; ++m) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(src) + m);
    dst[(4 * m) * ps] = __byte_perm(v.x, v.z, 0x5410);
    dst[(4 * m + 1) * ps] = __byte_perm(v.x, v.z, 0x7632);
    dst[(4 * m + 2) * ps] = __byte_perm(v.y, v.w, 0x5410);
    dst[(4 * m + 3) * ps] = __byte_perm(v.y, v.w, 0x7632);
  }
}

template <int C>
__device__ __forceinline__ void pairs_to(int16_t* dst, const int* src, int ps) {
#pragma unroll
  for (int m = 0; m < C / 8; ++m) {
    const int p0 = src[(4 * m) * ps], p1 = src[(4 * m + 1) * ps];
    const int p2 = src[(4 * m + 2) * ps], p3 = src[(4 * m + 3) * ps];
    reinterpret_cast<int4*>(dst)[m] =
        make_int4(__byte_perm(p0, p1, 0x5410), __byte_perm(p2, p3, 0x5410),
                  __byte_perm(p0, p1, 0x7632), __byte_perm(p2, p3, 0x7632));
  }
}

// The group's last conv of the network: conv_form's general forms, a split
// one at a PE count off 4 staged a pass at a time (K1).
template <int DP, int OCL, int C, bool WIDE>
__device__ __forceinline__ void group_last(const int* __restrict__ in, int in_ps, const int* w,
                                           int* w_alt, const int* __restrict__ wg, int npass,
                                           const Tile& t, int layer, const int* __restrict__ prm,
                                           const int* __restrict__ gprm, int* __restrict__ sc,
                                           int sc_ps, int sc_w, int sc_h, int8_t* __restrict__ out,
                                           int frame) {
  if constexpr (DP == REFERENCE) {
    if (pe_split(prm, layer) && npass != 4) {
      if (npass % 4 == 0)
        conv_layer<DP, WORDS, true, true, WIDE, 5, LAST, OCL, C, true>(
            in, in_ps, w, npass, t.th, t.tw, t, layer, false, prm, gprm, nullptr, 0, sc, sc_ps,
            0, sc_w, sc_h, out, frame, w_alt, wg);
      else
        conv_layer<DP, MASKED, true, true, WIDE, 5, LAST, OCL, C, true>(
            in, in_ps, w, npass, t.th, t.tw, t, layer, false, prm, gprm, nullptr, 0, sc, sc_ps,
            0, sc_w, sc_h, out, frame, w_alt, wg);
      return;
    }
  }
  conv_form<DP, true, 5, LAST, OCL, C, WIDE>(in, in_ps, w, npass, t.th, t.tw, t, layer, false, prm,
                                             gprm, nullptr, 0, sc, sc_ps, 0, sc_w, sc_h, out,
                                             frame);
}

// One group of n convs (flags fl) over one tile: net_tile's steps, from the
// group's input (the image, or the activation the group before wrote) to
// its output (the network's, or the activation of the next group), the
// shortcut written (G_FIRST before the last group) or read (G_LAST past the
// first) in device memory. PAIR: the two-conv group (n = 2, G_FIRST |
// G_LAST), its first conv in conv_layer's PAIR form, no shortcut.
template <int DP, int OCL, int C, bool WIDE, bool PAIR = false>
__device__ __forceinline__ void group_tile(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                           const int* __restrict__ weights,
                                           const int* __restrict__ params,
                                           void* __restrict__ scg, int H, int W, int n, int fl,
                                           int in_ch, int th, int tw, int split, int pe) {
  extern __shared__ int4 smem4[];
  constexpr int OCW = -OCL;
  const bool first = fl & G_FIRST, last = fl & G_LAST;
  const Smem plan = group_plan(DP, split, pe, n, fl, in_ch, OCW, th, tw, C, PAIR);
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
  // the words of layer j's B to stage: a staged last conv's first pass
  auto words_of = [&](const int* p, int j) {
    const int kind = group_kind(j, n, fl);
    const bool sp = DP == REFERENCE && pe_split(p, j);
    const int lw = layer_words(sp, kind, 3, in_ch, OCW, pe, C);
    return kind == 2 && sp && pe != 4 ? lw / pe : lw;
  };

  stage_async(wbuf, weights + params[p_at(0, R_WOFF, C)], words_of(params, 0));
  for (int i = threadIdx.x; i < net_words(group_records(n, fl), C); i += blockDim.x)
    prm[i] = params[i];

  const int r0 = group_ring(0, n, fl);
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
  const int r_sc = group_sc_ring(fl);
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
  // computes (one buffer: after its barrier)
  auto stage_next = [&](int j) {
    stage_async(wbuf + (single ? 0 : ((j + 1) & 1) * plan.w_words),
                weights + prm[p_at(j + 1, R_WOFF, C)], words_of(prm, j + 1));
  };
  auto after = [&](int j) {
    wait_staged();
    __syncthreads();
    if (single && j + 1 < n) {
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
    const int r1 = group_ring(1, n, fl);
    conv_form<DP, true, 5, FIRST, C, C, WIDE, PAIR>(buf_b, 0, wbuf, min(in_ch, pe), th + 2 * r1,
                                                    tw + 2 * r1, t, 0, PAIR, prm, params, buf_a,
                                                    plane_stride(group_extent(1, n, fl, th, tw)),
                                                    sc, sc_ps, r1 - r_sc, sc_w, sc_h, nullptr,
                                                    frame);
    after(0);
    cur = buf_a;
    nxt = buf_b;
    j = 1;
  }
  for (; !PAIR && j < n - (last ? 1 : 0); ++j) {
    if (!single && j + 1 < n) stage_next(j);
    const int r = group_ring(j + 1, n, fl);
    conv_form<DP, true, 3, MID, C, C, WIDE>(
        cur, plane_stride(group_extent(j, n, fl, th, tw)),
        wbuf + (single ? 0 : (j & 1) * plan.w_words), pe, th + 2 * r, tw + 2 * r, t, j,
        last && j == n - 2, prm, params, nxt, plane_stride(group_extent(j + 1, n, fl, th, tw)), sc,
        sc_ps, 0, sc_w, sc_h, nullptr, frame);
    after(j);
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (PAIR || last) {
    const int jl = n - 1;
    int* w_last = wbuf + (single ? 0 : (jl & 1) * plan.w_words);
    int* w_alt = single ? w_last : wbuf + ((jl + 1) & 1) * plan.w_words;
    group_last<DP, OCL, C, WIDE>(cur, plane_stride(group_extent(jl, n, fl, th, tw)), w_last, w_alt,
                                 weights + prm[p_at(jl, R_WOFF, C)], pe, t, jl, prm, params, sc,
                                 sc_ps, sc_w, sc_h, out, frame);
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

template <int DP, int OCL, int C, bool WIDE>
__global__ void __launch_bounds__(kThreads, 2)
sesr_net_group_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                      const int* __restrict__ weights, const int* __restrict__ params, void* sc,
                      int H, int W, int n, int fl, int in_ch, int th, int tw, int split, int pe) {
  group_tile<DP, OCL, C, WIDE>(x, out, weights, params, sc, H, W, n, fl, in_ch, th, tw, split, pe);
}

// The two-conv group, its wide form (every sum a plain int32).
template <int DP, int OCL, int C>
__global__ void __launch_bounds__(kThreads, 2)
sesr_net_pair_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                     const int* __restrict__ weights, const int* __restrict__ params, int H, int W,
                     int in_ch, int th, int tw, int split, int pe) {
  group_tile<DP, OCL, C, true, true>(x, out, weights, params, nullptr, H, W, 2,
                                     G_FIRST | G_LAST, in_ch, th, tw, split, pe);
}

bool group_takes(int n, int fl, int in_ch, int out_ch, int th, int tw, int split, int pe,
                 int gen, int width) {
  return n >= 2 && n <= kMaxL && fl >= 0 && fl <= 3 && in_ch >= 1 && in_ch <= 4 && out_ch >= 1 &&
         out_ch <= kMaxOut && th >= 1 && tw >= 1 && th <= 1024 && tw <= 1024 && pe >= 1 &&
         pe <= kMaxPE && (split >> n) == 0 && (gen == 1 || gen == 2) &&
         (width == 16 || width == kMaxC);
}

template <int DP, int OCL, int C, bool WIDE>
cudaError_t launch_group(const int8_t* x, int8_t* out, const int* w, const int* prm, void* sc,
                         int nb, int h, int wd, int n, int fl, int in_ch, int th, int tw,
                         int split, int pe, cudaStream_t stream) {
  const size_t bytes = group_bytes(DP, split, pe, n, fl, in_ch, -OCL, th, tw, C);
  const dim3 grid((wd + tw - 1) / tw, (h + th - 1) / th, nb);
  if (pair_group(n, fl)) {
    const auto kernel = &sesr_net_pair_kernel<DP, OCL, C>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(bytes));
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, bytes, stream>>>(x, out, w, prm, h, wd, in_ch, th, tw, split, pe);
    return cudaGetLastError();
  }
  const auto kernel = &sesr_net_group_kernel<DP, OCL, C, WIDE>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(x, out, w, prm, sc, h, wd, n, fl, in_ch, th, tw, split,
                                            pe);
  return cudaGetLastError();
}

// the last conv's padded columns (out_cols), as in sesr_net.cu's general
// instantiations
template <int DP, int C, bool WIDE>
cudaError_t launch_cols(const int8_t* x, int8_t* out, const int* w, const int* prm, void* sc,
                        int nb, int h, int wd, int n, int fl, int in_ch, int out_ch, int th,
                        int tw, int split, int pe, cudaStream_t s) {
  switch (out_cols(out_ch)) {
    case 8: return launch_group<DP, -8, C, WIDE>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, th, tw, split, pe, s);
    case 16: return launch_group<DP, -16, C, WIDE>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, th, tw, split, pe, s);
    case 32: return launch_group<DP, -32, C, WIDE>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, th, tw, split, pe, s);
    default: return launch_group<DP, -48, C, WIDE>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, th, tw, split, pe, s);
  }
}

template <int DP>
int launch_dp(const void* x, void* out, const void* weights, const void* params, void* sc, int nb,
              int h, int w, int n, int fl, int in_ch, int out_ch, int th, int tw, int split,
              int pe, int gen, int width, void* stream) {
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* oi = static_cast<int8_t*>(out);
  const int* wi = static_cast<const int*>(weights);
  const int* pi = static_cast<const int*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (width == 16)
    err = gen == 2 ? launch_cols<DP, 16, true>(xi, oi, wi, pi, sc, nb, h, w, n, fl, in_ch, out_ch,
                                               th, tw, split, pe, s)
                   : launch_cols<DP, 16, false>(xi, oi, wi, pi, sc, nb, h, w, n, fl, in_ch,
                                                out_ch, th, tw, split, pe, s);
  else
    err = gen == 2 ? launch_cols<DP, kMaxC, true>(xi, oi, wi, pi, sc, nb, h, w, n, fl, in_ch,
                                                  out_ch, th, tw, split, pe, s)
                   : launch_cols<DP, kMaxC, false>(xi, oi, wi, pi, sc, nb, h, w, n, fl, in_ch,
                                                   out_ch, th, tw, split, pe, s);
  return static_cast<int>(err);
}

}  // namespace

#ifndef SESR_NET_GROUP_BODY_ONLY
// (sesr_net_ksize.cu includes this file for its bodies alone: the entry
// points below are this library's.)

extern "C" {

// One group's launch. x: the group's input, int8 (nb, h, w, in_ch) (G_FIRST)
// or (nb, h, w, width); out: its output, int8 (nb, h, w, out_ch) (G_LAST) or
// (nb, h, w, width); sc: the shortcut, (nb, h, w, width) int8 (K1) or int16
// (K2), written by the first group, read by the last, unused by a group that
// is both; params: the group's block (convert.py group_constants), weights
// the network's; n: the group's convs; flags: G_FIRST | G_LAST; split: the
// group's split bits; general: 1, or 2 the wide form; width 16 or 32.
int sesr_net_group(int exact, const void* x, void* out, const void* weights, const void* params,
                   void* sc, int nb, int h, int w, int n, int flags, int in_ch, int out_ch,
                   int tile_h, int tile_w, int split, int pe, int general, int width,
                   void* stream) {
  if (!group_takes(n, flags, in_ch, out_ch, tile_h, tile_w, split, pe, general, width) ||
      (!exact && split != 0) || (flags != (G_FIRST | G_LAST) && sc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return exact ? launch_dp<REFERENCE>(x, out, weights, params, sc, nb, h, w, n, flags, in_ch,
                                      out_ch, tile_h, tile_w, split, pe, general, width, stream)
               : launch_dp<FAST>(x, out, weights, params, sc, nb, h, w, n, flags, in_ch, out_ch,
                                 tile_h, tile_w, split, pe, general, width, stream);
}

// Shared memory of one block of a group in bytes, or 0 where the entry
// point refuses the arguments.
int sesr_net_group_smem(int exact, int n, int flags, int in_ch, int out_ch, int tile_h,
                        int tile_w, int split, int pe, int width) {
  if (!group_takes(n, flags, in_ch, out_ch, tile_h, tile_w, split, pe, 1, width)) return 0;
  return static_cast<int>(group_bytes(exact ? REFERENCE : FAST, split, pe, n, flags, in_ch,
                                      out_cols(out_ch), tile_h, tile_w, width));
}

const char* sesr_net_group_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#endif  // SESR_NET_GROUP_BODY_ONLY
