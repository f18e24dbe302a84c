// The layer-group form of the corrected kernel (sesr_corrected.cu) and its
// counting form on Hopper (sm_90a): a network that no single launch runs
// (more than 16 convs) goes as a chain of launches, one per group of
// consecutive convs (convert.py layer_groups), each a persistent launch of
// sesr_corrected_group_kernel (or, counting, sesr_corrected_group_audit_
// kernel) over the whole batch.
//
// Replaces, with sesr_corrected.cu, the XLA lowering of the JAX package's
// corrected modes and the audit's jitted interpreter, which loop over any
// number of convs:
//   sesr_corrected_group       <- sesr_tpu/ops/packed.py _packed_exact_impl(corrected=True)
//   sesr_corrected_group_audit <- integer_forward(corrected=True, collect_dumps=True)
//                                 behind sesr_tpu/quant/audit.py:96
// Its plain version, group by group, is sesr_tpu_torch/quant/integer.py
// group_forward; the chain's is integer_forward(corrected=True).
//
// A group runs its convs over each tile as sesr_corrected_kernel runs a
// whole network (conv_form, conv_layer, conv_pieces and Form of
// sesr_corrected.cu, the general instantiation's forms, with GRP: the
// layer that adds the shortcut and the shortcut's offset are the group's),
// its extents from its own kernel sizes (group_ring). What crosses a
// boundary is the plain interpreter's: the int8 activation input.{e + 1},
// (n, H, W, C) in device memory with the channels in order (a plane's 16
// bytes, as in shared memory), each tile writing its core and the next
// group reading its halo ring (z_eff outside the image); the residual
// shortcut round(s) as int16, (n, H, W, C), written by the first group and
// read by the last. The counting form adds each group's per-layer counts
// at the group's own layers of the one count array (the wrapper passes it
// offset by the group's first conv).
//
// What bounds it on this card: operations, as sesr_corrected.cu; a group's
// tile recomputes only its own ring.
//
// Instantiations: <G, C, WS> served and counting, G 4 / 8 / 16 PE groups,
// width 16 or 32, wide sums or not: 24, each general; at G = 16 and width
// 32 with the piece forms (B in pieces where the plan needs them). The
// tail groups run in instantiations of their own, so that the others keep
// their code: a last group whose last conv has 17 to 48 output channels
// (RGB x3 / x4 past 16 convs), which runs that conv as
// sesr_corrected_wideout_kernel does (32 or 48 columns a PE group in chunks
// of whole groups, its bias and zero rows past the block's records, B
// staged at 8 PE groups too, the piece forms at every G), and the two-conv
// group (num_lblocks 0: n = 2, G_FIRST | G_LAST), whose first conv is also
// the one before the last (Form's PAIR: its epilogue writes the last conv's
// domain-in, the residual add of its ReLU output to itself, and no
// shortcut is kept): sesr_corrected_tail_kernel<G, C> and its counting form
// sesr_corrected_tail_audit_kernel<G, C>, 12, each the wide form (a plain
// int32 sum, exact for every sum the other form holds too), which no
// shipped network runs. The entry points take them where tail_group says.
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (sesr_tpu_torch/ops/_build.py), beside sesr_corrected.cu's
// library. Each entry point returns cudaGetLastError() after its launch.

#define SESR_CORRECTED_BODY_ONLY
#include "sesr_corrected.cu"

namespace {

// The count region and counters of a launch of the counting form; counts
// null: the served kernel.
struct GroupCount {
  unsigned long long* counts;
  int y0, y1, x0, x1;
};

// Layer j of a group as the layer of a three-conv network of its kind
// (group_kind), for the per-layer sizes of sesr_corrected.cu.
__host__ __device__ inline int group_b_bytes(int j, int n, int fl, int in_ch, int ocl, int split,
                                             int pe, int C) {
  const int kl = group_kind(j, n, fl);
  return layer_b_bytes(kl, 3, in_ch, ocl, ((split >> j) & 1) << kl, pe, C);
}

__host__ __device__ inline int2 group_pieces(int j, int n, int fl, int in_ch, int ocl, int split,
                                             int pe, int C) {
  const int kl = group_kind(j, n, fl);
  return layer_pieces(kl, 3, in_ch, ocl, ((split >> j) & 1) << kl, pe, C);
}

// Pixels of a plane of layer j's input that its GEMM reads (layer_cap).
__host__ __device__ inline int group_cap(int j, int n, int fl, int th, int tw, int C) {
  const int r = group_ring(j, n, fl), ih = th + 2 * r, iw = tw + 2 * r;
  const int kl = group_kind(j, n, fl);
  const int K = kl == 1 ? 3 : 5, wide = kl == 0;
  return round_up((ih - K + 1) * iw, kRows) + half_off(steps_of(K, wide, C) - 1, 1, K, iw, wide, C);
}

// Bytes between the two planes of layer j's input at width 32 (in_plane);
// j == n: the group's output (before the last conv), the tile's pixels.
__host__ __device__ inline int group_plane(int j, int n, int fl, int th, int tw, int C) {
  if (C != 32 || (j == 0 && (fl & G_FIRST))) return 0;
  return round_up((j < n ? group_cap(j, n, fl, th, tw, C) : th * tw) * kPix, kAlign);
}

// Bytes of layer j's input buffer (j == n: the group's output).
__host__ __device__ inline int group_buf(int j, int n, int fl, int th, int tw, int C) {
  if (C == 32 && !(j == 0 && (fl & G_FIRST))) return 2 * group_plane(j, n, fl, th, tw, C);
  return (j < n ? group_cap(j, n, fl, th, tw, C) : th * tw) * kPix;
}

// Whether a group runs in the tail instantiations: the last group of a
// last conv past 16 output channels, and the two-conv group.
__host__ __device__ constexpr bool tail_group(int n, int fl, int out_ch) {
  return (fl & G_LAST) && (out_cols(out_ch) > 16 || (n == 2 && fl == (G_FIRST | G_LAST)));
}

// Shared memory of one block of a group of n convs (flags fl): smem_plan
// with the group's extents and records (group_records), the input of a
// group past conv 0 as C-byte pixels, the output of one before the last
// conv, and the shortcut where the group writes (the tile) or reads it (the
// last conv's input extent). pf: the instantiation has piece forms; tail:
// a tail instantiation (tail_group), whose block holds the last conv's own
// rows past C channels (out_rows) and whose B is staged at 8 PE groups too
// (staged_b's OW), and whose two-conv group keeps no shortcut (kernels.py
// corrected_group_plan mirrors it).
__host__ __device__ inline Plan group_plan(int G, bool pf, int split, int pe, int n, int fl,
                                           int in_ch, int ocl, int th, int tw, int C,
                                           bool tail = false) {
  Plan p;
  const int words = param_words(group_records(n, fl), C, pe) + (tail ? out_rows(ocl, C, pe) : 0);
  p.w_at = round_up(words * 4, kAlign);
  const bool staged = staged_b(G, C, tail);
  int all = 0, even = 0, odd = 0, unit = 0;
  for (int j = 0; j < n; ++j) {
    const int b = group_b_bytes(j, n, fl, in_ch, ocl, split, pe, C);
    int& big = (j % 2) ? odd : even;
    all += b;
    big = big > b ? big : b;
    if (pf && staged) {
      const int u = group_pieces(j, n, fl, in_ch, ocl, split, pe, C).y;
      unit = unit > u ? unit : u;
    }
  }
  int x = 0, y = (fl & G_FIRST) ? group_extent(0, n, fl, th, tw) * 4 : 0;
  for (int j = 0; j <= n - ((fl & G_LAST) ? 1 : 0); ++j) {
    const int b = group_buf(j, n, fl, th, tw, C);
    int& dst = (j % 2) ? y : x;
    dst = dst > b ? dst : b;
  }
  const int rs = group_sc_ring(fl);
  const bool pair = tail && n == 2 && fl == (G_FIRST | G_LAST);
  const int sc_bytes = fl && !pair ? (th + 2 * rs) * (tw + 2 * rs) * 2 * C : 0;
  const bool in_pieces = pf && staged;
  p.w_bufs = staged ? 2 : 0;
  p.w_odd = staged ? round_up(even, kAlign) : 0;
  p.w_bytes = staged ? p.w_odd + odd : all;
  p.pieces = false;
  for (;;) {
    p.x_at = round_up(p.w_at + p.w_bytes, kAlign);
    p.y_at = round_up(p.x_at + x, kAlign);
    p.sc_at = round_up(p.y_at + y, kAlign);
    p.scratch_at = p.sc_at + sc_bytes;
    p.bytes = p.scratch_at + kScratch;
    if (!staged || p.bytes <= kSmemLimit || (p.w_bufs == 1 && (p.pieces || !in_pieces)))
      return p;
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

// One group of n convs (flags fl) over every tile: run_tiles' steps from the
// group's input (the image, or the activation the group before wrote) to
// its output (the network's, or the next group's activation). TAIL: a tail
// instantiation (tail_group): the last conv's forms of 8 to 48 columns a
// PE group, the piece forms at every G, and the two-conv group's first conv
// in its PAIR form.
template <int G, int C, bool COUNT, bool WIDE_SUM, bool TAIL = false>
__device__ __forceinline__ void run_group(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                          const int* __restrict__ weights,
                                          const int* __restrict__ params, int16_t* scg, int nb,
                                          int H, int W, int n, int fl, int in_ch, int out_ch,
                                          int th, int tw, int split, int pe,
                                          unsigned long long* counts, int cy0, int cy1, int cx0,
                                          int cx1) {
  constexpr bool PF = TAIL || (G == 16 && C == 32);
  extern __shared__ __align__(128) uint8_t smem[];
  const bool first = fl & G_FIRST, last = fl & G_LAST;
  const Plan pl = group_plan(G, PF, split, pe, n, fl, in_ch, out_ch, th, tw, C, TAIL);
  const int R = group_records(n, fl);
  int* prm = reinterpret_cast<int*>(smem);
  uint8_t* wsm = smem + pl.w_at;
  uint8_t* bx = smem + pl.x_at;
  uint8_t* by = smem + pl.y_at;

  constexpr bool kStaged = staged_b(G, C, TAIL);
  constexpr bool kPieces = PF && kStaged;
  const int words = param_words(R, C, pe) + (TAIL ? out_rows(out_ch, C, pe) : 0);
  for (int i = threadIdx.x; i < words; i += kThreads) prm[i] = __ldg(params + i);
  // resident B: the group's layers' B, from its first layer's
  const int woff0 = __ldg(params + p_at(0, R_WOFF, C));
  if constexpr (!kStaged) {
    const int4* w4 = reinterpret_cast<const int4*>(weights + woff0);
    for (int i = threadIdx.x; i < pl.w_bytes / 16; i += kThreads)
      reinterpret_cast<int4*>(wsm)[i] = __ldg(w4 + i);
    fence_proxy_async();
  }
  __syncthreads();
  auto b_region = [&](int j) { return wsm + (j % 2) * pl.w_odd; };
  auto stage_layer = [&](int j) {
    stage_b(b_region(j), weights + prm[p_at(j, R_WOFF, C)],
            group_b_bytes(j, n, fl, in_ch, out_ch, split, pe, C));
  };
  auto in_pieces = [&](int j) {
    return kPieces && pl.pieces && group_pieces(j, n, fl, in_ch, out_ch, split, pe, C).x > 1;
  };

  const int r0 = group_ring(0, n, fl), r_sc = group_sc_ring(fl);
  const int ih0 = th + 2 * r0, iw0 = tw + 2 * r0, n0 = ih0 * iw0;
  const int cap0 = group_cap(0, n, fl, th, tw, C);
  const int plane0 = group_plane(0, n, fl, th, tw, C);
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
  net.sc_off = group_ring(1, n, fl) - r_sc;

  for (int tile = blockIdx.x; tile < nb * per_frame; tile += gridDim.x) {
    net.frame = tile / per_frame;
    const int rem = tile - net.frame * per_frame;
    net.t.oy0 = (rem / tiles_x) * th;
    net.t.ox0 = (rem % tiles_x) * tw;
    // (conv_pieces stages a layer in pieces: its whole B fits no region)
    if constexpr (kStaged) {
      if (!in_pieces(0)) stage_layer(0);
    }
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
    if constexpr (kStaged) b_wait();
    fence_proxy_async();
    __syncthreads();

    uint8_t* cur = bx;
    uint8_t* nxt = by;
    for (int j = 0; j < n; ++j) {
      if (kStaged && pl.w_bufs == 2 && j + 1 < n && !in_pieces(j) && !in_pieces(j + 1))
        stage_layer(j + 1);
      Layer ly;
      const int r = group_ring(j, n, fl);
      ly.in = cur;
      ly.ih = th + 2 * r;
      ly.iw = tw + 2 * r;
      ly.plane = group_plane(j, n, fl, th, tw, C);
      ly.w = kStaged ? b_region(j) : wsm + 4 * (prm[p_at(j, R_WOFF, C)] - woff0);
      ly.next = reinterpret_cast<int*>(nxt);
      ly.next_plane = group_plane(j + 1, n, fl, th, tw, C) / 4;
      ly.layer = j;
      ly.pieces = in_pieces(j);
      ly.wg = weights + prm[p_at(j, R_WOFF, C)];
      ly.regions = wsm;
      ly.w_odd = pl.w_odd;
      ly.w_bufs = pl.w_bufs;
      const int kind = group_kind(j, n, fl);
      if constexpr (TAIL) {
        constexpr bool W = WIDE_SUM;
        if (kind == 0 && n == 2 && last)
          conv_form<FIRST, 5, C, G, true, C, COUNT, W, PF, true, true>(ly, net, in_ch);
        else if (kind == 0)
          conv_form<FIRST, 5, C, G, true, C, COUNT, W, PF, true>(ly, net, in_ch);
        else if (kind == 1)
          conv_form<MID, 3, C, G, true, C, COUNT, W, PF, true>(ly, net, in_ch);
        else if (out_ch <= 8)
          conv_form<LAST, 5, 8, G, true, C, COUNT, W, PF, true>(ly, net, in_ch);
        else if (out_ch <= 16)
          conv_form<LAST, 5, 16, G, true, C, COUNT, W, PF, true>(ly, net, in_ch);
        else if (out_ch <= 32)
          conv_form<LAST, 5, 32, G, true, C, COUNT, W, PF, true>(ly, net, in_ch);
        else
          conv_form<LAST, 5, 48, G, true, C, COUNT, W, PF, true>(ly, net, in_ch);
      } else if (kind == 0) {
        conv_form<FIRST, 5, C, G, true, C, COUNT, WIDE_SUM, PF, true>(ly, net, in_ch);
      } else if (kind == 1) {
        conv_form<MID, 3, C, G, true, C, COUNT, WIDE_SUM, PF, true>(ly, net, in_ch);
      } else if (out_ch <= 8) {
        conv_form<LAST, 5, 8, G, true, C, COUNT, WIDE_SUM, PF, true>(ly, net, in_ch);
      } else {
        conv_form<LAST, 5, 16, G, true, C, COUNT, WIDE_SUM, PF, true>(ly, net, in_ch);
      }
      if constexpr (kStaged) b_wait();
      fence_proxy_async();
      __syncthreads();
      if (kStaged && j + 1 < n && !in_pieces(j + 1) && (pl.w_bufs == 1 || in_pieces(j))) {
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
      const int pn = group_plane(n, n, fl, th, tw, C);
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

template <int G, int C, bool WS>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_group_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                            const int* __restrict__ weights, const int* __restrict__ params,
                            int16_t* sc, int nb, int H, int W, int n, int fl, int in_ch,
                            int out_ch, int th, int tw, int split, int pe) {
  run_group<G, C, false, WS>(x, out, weights, params, sc, nb, H, W, n, fl, in_ch, out_ch, th, tw,
                             split, pe, nullptr, 0, 0, 0, 0);
}

template <int G, int C, bool WS>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_group_audit_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                  const int* __restrict__ weights,
                                  const int* __restrict__ params, int16_t* sc, int nb, int H,
                                  int W, int n, int fl, int in_ch, int out_ch, int th, int tw,
                                  int split, int pe, unsigned long long* counts, int cy0, int cy1,
                                  int cx0, int cx1) {
  run_group<G, C, true, WS>(x, out, weights, params, sc, nb, H, W, n, fl, in_ch, out_ch, th, tw,
                            split, pe, counts, cy0, cy1, cx0, cx1);
}

// The tail instantiations, served and counting (tail_group), each the wide
// form.
template <int G, int C>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_tail_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                           const int* __restrict__ weights, const int* __restrict__ params,
                           int16_t* sc, int nb, int H, int W, int n, int fl, int in_ch,
                           int out_ch, int th, int tw, int split, int pe) {
  run_group<G, C, false, true, true>(x, out, weights, params, sc, nb, H, W, n, fl, in_ch, out_ch,
                                     th, tw, split, pe, nullptr, 0, 0, 0, 0);
}

template <int G, int C>
__global__ void __launch_bounds__(kThreads, 1)
sesr_corrected_tail_audit_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                                 const int* __restrict__ weights, const int* __restrict__ params,
                                 int16_t* sc, int nb, int H, int W, int n, int fl, int in_ch,
                                 int out_ch, int th, int tw, int split, int pe,
                                 unsigned long long* counts, int cy0, int cy1, int cx0, int cx1) {
  run_group<G, C, true, true, true>(x, out, weights, params, sc, nb, H, W, n, fl, in_ch, out_ch,
                                    th, tw, split, pe, counts, cy0, cy1, cx0, cx1);
}

// The plan of the instantiation a group runs in.
__host__ __device__ inline Plan launch_plan(int split, int pe, int n, int fl, int in_ch,
                                            int out_ch, int th, int tw, int C) {
  const int G = pe_groups(pe);
  const bool tail = tail_group(n, fl, out_ch);
  return group_plan(G, tail || (G == 16 && C == 32), split, pe, n, fl, in_ch, out_ch, th, tw, C,
                    tail);
}

bool group_takes(int n, int fl, int in_ch, int out_ch, int th, int tw, int split, int pe,
                 int general, int width) {
  if (!(n >= 2 && n <= kMaxL && fl >= 0 && fl <= 3 && in_ch >= 1 && in_ch <= 4 && out_ch >= 1 &&
        out_ch <= kMaxOut && th >= 1 && tw >= 1 && th <= 1024 && tw <= 1024 &&
        (split >> n) == 0 && pe >= 1 && pe <= kMaxPE && (general == 1 || general == 2) &&
        (width == 16 || width == kMaxC)))
    return false;
  return launch_plan(split, pe, n, fl, in_ch, out_ch, th, tw, width).bytes <= kSmemLimit;
}

template <int G, int C, bool WS>
cudaError_t launch_group(const int8_t* x, int8_t* out, const int* w, const int* prm, int16_t* sc,
                         int nb, int h, int wd, int n, int fl, int in_ch, int out_ch, int th,
                         int tw, int split, int pe, const GroupCount& cnt, cudaStream_t stream) {
  const int bytes = launch_plan(split, pe, n, fl, in_ch, out_ch, th, tw, C).bytes;
  const bool tail = tail_group(n, fl, out_ch);
  const void* fn =
      tail ? (cnt.counts ? reinterpret_cast<const void*>(&sesr_corrected_tail_audit_kernel<G, C>)
                         : reinterpret_cast<const void*>(&sesr_corrected_tail_kernel<G, C>))
           : (cnt.counts ? reinterpret_cast<const void*>(&sesr_corrected_group_audit_kernel<G, C, WS>)
                         : reinterpret_cast<const void*>(&sesr_corrected_group_kernel<G, C, WS>));
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
  if (tail && cnt.counts)
    sesr_corrected_tail_audit_kernel<G, C><<<grid, kThreads, bytes, stream>>>(
        x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, out_ch, th, tw, split, pe, cnt.counts,
        cnt.y0, cnt.y1, cnt.x0, cnt.x1);
  else if (tail)
    sesr_corrected_tail_kernel<G, C><<<grid, kThreads, bytes, stream>>>(
        x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, out_ch, th, tw, split, pe);
  else if (cnt.counts)
    sesr_corrected_group_audit_kernel<G, C, WS><<<grid, kThreads, bytes, stream>>>(
        x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, out_ch, th, tw, split, pe, cnt.counts,
        cnt.y0, cnt.y1, cnt.x0, cnt.x1);
  else
    sesr_corrected_group_kernel<G, C, WS><<<grid, kThreads, bytes, stream>>>(
        x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, out_ch, th, tw, split, pe);
  return cudaGetLastError();
}

template <int C, bool WS>
cudaError_t launch_pe(const int8_t* x, int8_t* out, const int* w, const int* prm, int16_t* sc,
                      int nb, int h, int wd, int n, int fl, int in_ch, int out_ch, int th, int tw,
                      int split, int pe, const GroupCount& cnt, cudaStream_t s) {
  switch (pe_groups(pe)) {
    case 4: return launch_group<4, C, WS>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, out_ch, th, tw, split, pe, cnt, s);
    case 8: return launch_group<8, C, WS>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, out_ch, th, tw, split, pe, cnt, s);
    default: return launch_group<16, C, WS>(x, out, w, prm, sc, nb, h, wd, n, fl, in_ch, out_ch, th, tw, split, pe, cnt, s);
  }
}

}  // namespace

#ifndef SESR_CORRECTED_GROUP_BODY_ONLY
// (sesr_corrected_ksize.cu includes this file for its bodies alone: the
// launcher and the entry points below are this library's, so that no other
// library compiles its kernels.)

namespace {

int launch_chain_group(const void* x, void* out, const void* weights, const void* params, void* sc,
                       int nb, int h, int w, int n, int fl, int in_ch, int out_ch, int th, int tw,
                       int split, int pe, int general, int width, const GroupCount& cnt,
                       void* stream) {
  if (!group_takes(n, fl, in_ch, out_ch, th, tw, split, pe, general, width) ||
      (reinterpret_cast<uintptr_t>(weights) & 15) || (fl != (G_FIRST | G_LAST) && sc == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* oi = static_cast<int8_t*>(out);
  const int* wi = static_cast<const int*>(weights);
  const int* pi = static_cast<const int*>(params);
  int16_t* si = static_cast<int16_t*>(sc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (width == 16)
    err = general == 2 ? launch_pe<16, true>(xi, oi, wi, pi, si, nb, h, w, n, fl, in_ch, out_ch,
                                             th, tw, split, pe, cnt, s)
                       : launch_pe<16, false>(xi, oi, wi, pi, si, nb, h, w, n, fl, in_ch, out_ch,
                                              th, tw, split, pe, cnt, s);
  else
    err = general == 2 ? launch_pe<kMaxC, true>(xi, oi, wi, pi, si, nb, h, w, n, fl, in_ch,
                                                out_ch, th, tw, split, pe, cnt, s)
                       : launch_pe<kMaxC, false>(xi, oi, wi, pi, si, nb, h, w, n, fl, in_ch,
                                                 out_ch, th, tw, split, pe, cnt, s);
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// One group's launch. x: the group's input, int8 (nb, h, w, in_ch) (G_FIRST)
// or (nb, h, w, width); out: its output, int8 (nb, h, w, out_ch) (G_LAST) or
// (nb, h, w, width); sc: the shortcut round(s), int16 (nb, h, w, width),
// written by the first group, read by the last, unused by a group that is
// both; params: the group's block (convert.py group_constants), weights the
// network's (16-byte aligned); n: the group's convs; flags: G_FIRST |
// G_LAST; split: the group's split bits; general: 1, or 2 the wide form;
// width 16 or 32.
int sesr_corrected_group(const void* x, void* out, const void* weights, const void* params,
                         void* sc, int nb, int h, int w, int n, int flags, int in_ch, int out_ch,
                         int tile_h, int tile_w, int split, int pe, int general, int width,
                         void* stream) {
  return launch_chain_group(x, out, weights, params, sc, nb, h, w, n, flags, in_ch, out_ch,
                            tile_h, tile_w, split, pe, general, width,
                            GroupCount{nullptr, 0, 0, 0, 0}, stream);
}

// The counting form of a group (the same arguments, then the counters and
// the count region): counts[j] (the network's array offset by the group's
// first conv) increased by the PE partials that the 18-bit clamp changed
// on the group's split layer j at the outputs in the region of every frame.
int sesr_corrected_group_audit(const void* x, void* out, const void* weights, const void* params,
                               void* sc, int nb, int h, int w, int n, int flags, int in_ch,
                               int out_ch, int tile_h, int tile_w, int split, int pe, int general,
                               int width, void* counts, int y0, int y1, int x0, int x1,
                               void* stream) {
  if (counts == nullptr || (reinterpret_cast<uintptr_t>(counts) & 7))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_chain_group(x, out, weights, params, sc, nb, h, w, n, flags, in_ch, out_ch,
                            tile_h, tile_w, split, pe, general, width,
                            GroupCount{static_cast<unsigned long long*>(counts), y0, y1, x0, x1},
                            stream);
}

// Shared memory of one block of a group in bytes, or 0 where the entry
// point refuses it.
int sesr_corrected_group_smem(int n, int flags, int in_ch, int out_ch, int tile_h, int tile_w,
                              int split, int pe, int width) {
  if (!group_takes(n, flags, in_ch, out_ch, tile_h, tile_w, split, pe, 1, width)) return 0;
  return launch_plan(split, pe, n, flags, in_ch, out_ch, tile_h, tile_w, width).bytes;
}

const char* sesr_corrected_group_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

#endif  // SESR_CORRECTED_GROUP_BODY_ONLY
