// Fused whole-network SESR inference on Hopper (sm_90a): one thread block
// runs every conv of the collapsed network over one output tile of one
// frame, with all intermediates in shared memory. Device memory sees one
// int8 read of the input tile (with its halo) and one int8 write of the
// output tile.
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   sesr_pe_exact_net  <- sesr_tpu/ops/pallas_pipeline.py build_pallas_forward
//                         (the reference-exact 4-PE datapath, K1)
//   sesr_fast_net      <- sesr_tpu/ops/pallas_packed.py build_pallas_packed_forward
//                         (the certified fast deployment datapath, K2)
// Their plain version is sesr_tpu_torch/quant/integer.py integer_forward
// (corrected=False / compute="fast" with corrected=True).
//
// What bounds it on this card: operations. sr_x2 needs 12,912 int8 MACs per
// input pixel against 15 bytes of device traffic, far above the H100's
// ratio of int8 tensor-core rate to memory rate, so the floor is the int8
// rate. This first version runs on the CUDA cores (__dp4a, 4 MACs per
// instruction; no tensor cores), so it sits far above that floor; a later
// version moves the convs onto wgmma. What the design does about the bound:
//   - activations stay int8 from layer to layer: each layer's epilogue
//     applies the next layer's domain-in (round, zero add, int8 clamp) so
//     the next conv reads raw q packed four channels to a 32-bit word, the
//     operand form of __dp4a;
//   - the zero shift q - z_eff is never materialized: positions outside
//     the image hold z_eff instead of 0, so conv(q, pads = z_eff) equals
//     conv(q - z_eff) + z_eff * sum(W). Per PE that sum is exactly the
//     reference's zero-restored partial (K1); the fast datapath subtracts
//     z_eff * sum(W) before its 20-bit clamp (K2). This needs
//     -128 <= z_eff <= 127, which the host checks;
//   - the words of a 16-channel pixel group channels by PE (word p holds
//     channels p, p+4, p+8, p+12), so one __dp4a per tap and output
//     channel yields one PE's partial: K1's per-PE 18-bit clamp is one
//     clamp per pass, not a separate accumulation;
//   - extents shrink by k/2 per layer (no recomputed ring beyond the
//     receptive field); buffers are planar (one plane per word) so the
//     consecutive pixels of a warp hit consecutive banks; every weight
//     read is a warp-wide broadcast; each thread computes two pixels of a
//     row so a weight read feeds two MAC chains.
//
// Numerics: requantization is (y * m) * 2^-n as two separately rounded
// float32 multiplies (__fmul_rn; built with -fmad=false), rounding is
// half-to-even (rintf), and every float add of the datapath is __fadd_rn,
// in the order of the plain version.
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (sesr_tpu_torch/ops/_build.py). Each entry point
// returns cudaGetLastError() after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 16;          // hidden width of the network
constexpr int kMaxL = 8;        // deepest supported network (nrdm_6)
constexpr int kThreads = 256;
constexpr int kP = 2;           // pixels per thread per work item

// Layout of the int32 parameter block (kept in sync with
// sesr_tpu_torch/convert.py PARAM_LAYOUT).
constexpr int P_WOFF = 0;                 // [kMaxL] weight word offset per layer
constexpr int P_ZEFF = 8;                 // [kMaxL] pad value (z_eff) of conv i's input
constexpr int P_ZIN = 16;                 // [kMaxL] f32 bits: domain-in zero of conv i
constexpr int P_RQM = 24;                 // [kMaxL] f32 bits: requant mantissa of conv i
constexpr int P_RQP = 32;                 // [kMaxL] f32 bits: 2^-n of conv i
constexpr int P_RESM = 40;                // f32 bits: residual requant mantissa
constexpr int P_RESP = 41;                // f32 bits: residual 2^-n
constexpr int P_ZOUT = 42;                // f32 bits: zero of the output domain
constexpr int P_ACC_HI = 43;              // per-PE accumulator max (18 bits)
constexpr int P_ADD_HI = 44;              // PE adder max (20 bits)
constexpr int P_BIAS = 48;                // [kMaxL][kC] bias added after the adder clamp
constexpr int P_ZC = P_BIAS + kMaxL * kC; // [kMaxL][kC] z_eff * sum(W), subtracted before it
constexpr int P_WORDS = P_ZC + kMaxL * kC;

constexpr int kMaxLayerWords = 4 * 25 * kC;   // 4 passes x 5x5 taps x 16 oc

enum Kind { FIRST = 0, MID = 1, LAST = 2 };

struct Tile {
  int oy0, ox0;       // image coordinates of the output tile's origin
  int th, tw;         // output tile extent
  int H, W;           // frame extent
};

__device__ __forceinline__ float clamp_q(float v) {
  return fminf(fmaxf(v, -128.f), 127.f);
}

__device__ __forceinline__ int pad_word(int z) {
  unsigned b = static_cast<unsigned>(z) & 0xffu;
  return static_cast<int>(b | (b << 8) | (b << 16) | (b << 24));
}

__device__ __forceinline__ float as_f32(int bits) { return __int_as_float(bits); }

// (y * m) * 2^-n with float32 rounding after each multiply.
__device__ __forceinline__ float requant(int y, float m, float p) {
  return __fmul_rn(__fmul_rn(__int2float_rn(y), m), p);
}

// One conv layer over the output extent eh x ew (both in this layer's
// output frame, which is the next layer's input frame). `in` holds NW
// planes of (eh + K - 1) x (ew + K - 1) packed words; `w` holds npass x
// K*K x OCP weight words. The epilogue writes the next layer's input
// planes (FIRST, MID), the shortcut terms (FIRST) or the int8 output
// (LAST).
template <bool EXACT, int K, int NW, int OC, Kind KIND>
__device__ __forceinline__ void conv_layer(
    const int* __restrict__ in, const int* __restrict__ w, int npass,
    int eh, int ew, const Tile& t, int layer, bool prelast,
    const int* __restrict__ prm, int* __restrict__ next, float* __restrict__ sc,
    int sc_off, int sc_w, int sc_h, int8_t* __restrict__ out, int frame) {
  constexpr int OCP = (OC + 3) & ~3;
  const int iw = ew + K - 1;
  const int plane = (eh + K - 1) * iw;
  const int half = ew / kP;            // ew is even: pixel x and x + half
  const int items = eh * half;
  const int r_out = (eh - t.th) / 2;   // ring of this output frame
  const int acc_hi = prm[P_ACC_HI];
  const int add_hi = prm[P_ADD_HI];
  const int* bias = prm + P_BIAS + layer * kC;
  const int* zc = prm + P_ZC + layer * kC;
  const float rq_m = as_f32(prm[P_RQM + layer]);
  const float rq_p = as_f32(prm[P_RQP + layer]);

  for (int it = threadIdx.x; it < items; it += blockDim.x) {
    const int y = it / half;
    const int xa = it - y * half;
    int tot[kP][OC];
#pragma unroll
    for (int q = 0; q < kP; ++q)
#pragma unroll
      for (int o = 0; o < OC; ++o) tot[q][o] = 0;

    for (int pass = 0; pass < npass; ++pass) {
      int acc[kP][OC];
#pragma unroll
      for (int q = 0; q < kP; ++q)
#pragma unroll
        for (int o = 0; o < OC; ++o) acc[q][o] = 0;
      const int* src = in + (NW == 4 ? pass : 0) * plane;
      const int* wp = w + pass * K * K * OCP;
#pragma unroll
      for (int dy = 0; dy < K; ++dy) {
        const int* row = src + (y + dy) * iw + xa;
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          int a[kP];
#pragma unroll
          for (int q = 0; q < kP; ++q) a[q] = row[dx + q * half];
          const int4* wv = reinterpret_cast<const int4*>(wp + (dy * K + dx) * OCP);
#pragma unroll
          for (int o4 = 0; o4 < OCP / 4; ++o4) {
            const int4 w4 = wv[o4];
            const int ws[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (o4 * 4 + e < OC) {
#pragma unroll
                for (int q = 0; q < kP; ++q)
                  acc[q][o4 * 4 + e] = __dp4a(a[q], ws[e], acc[q][o4 * 4 + e]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kP; ++q)
#pragma unroll
        for (int o = 0; o < OC; ++o)
          tot[q][o] += EXACT ? min(max(acc[q][o], -acc_hi - 1), acc_hi) : acc[q][o];
    }

    // ---- epilogue -------------------------------------------------------
#pragma unroll
    for (int q = 0; q < kP; ++q) {
      const int x = xa + q * half;
      const int gy = t.oy0 - r_out + y;
      const int gx = t.ox0 - r_out + x;
      const bool inside = gy >= 0 && gy < t.H && gx >= 0 && gx < t.W;
      if (KIND == LAST) {
        if (!inside || y >= t.th || x >= t.tw) continue;
        const float z_out = as_f32(prm[P_ZOUT]);
        int8_t* dst = out + ((static_cast<size_t>(frame) * t.H + gy) * t.W + gx) * OC;
        int packed[OCP / 4];
#pragma unroll
        for (int o4 = 0; o4 < OCP / 4; ++o4) packed[o4] = 0;
#pragma unroll
        for (int o = 0; o < OC; ++o) {
          const int yi = min(max(tot[q][o] - zc[o], -add_hi - 1), add_hi) + bias[o];
          const float v = clamp_q(rintf(__fadd_rn(requant(yi, rq_m, rq_p), z_out)));
          packed[o / 4] |= (static_cast<int>(v) & 0xff) << (8 * (o % 4));
        }
        if (OC % 4 == 0) {
#pragma unroll
          for (int o4 = 0; o4 < OCP / 4; ++o4)
            reinterpret_cast<int*>(dst)[o4] = packed[o4];
        } else {
#pragma unroll
          for (int o = 0; o < OC; ++o)
            dst[o] = static_cast<int8_t>((packed[o / 4] >> (8 * (o % 4))) & 0xff);
        }
        continue;
      }
      // FIRST / MID: the next conv's input, channel o -> word o % 4, byte o / 4
      const int pix = y * ew + x;
      const int nplane = eh * ew;
      if (!inside) {
        const int pw = pad_word(prm[P_ZEFF + layer + 1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) next[j * nplane + pix] = pw;
        continue;
      }
      const float z_next = as_f32(prm[P_ZIN + layer + 1]);
      const float res_m = as_f32(prm[P_RESM]);
      const float res_p = as_f32(prm[P_RESP]);
      const int sy = y - sc_off, sx = x - sc_off;
      const bool in_sc = sy >= 0 && sy < sc_h && sx >= 0 && sx < sc_w;
      int words[4] = {0, 0, 0, 0};
#pragma unroll
      for (int o = 0; o < OC; ++o) {
        const int yi = min(max(tot[q][o] - zc[o], -add_hi - 1), add_hi) + bias[o];
        const float h = fmaxf(requant(yi, rq_m, rq_p), 0.f);      // ReLU
        float v;
        if (KIND == FIRST && in_sc) {
          // the residual shortcut, as the last conv's domain-in consumes it:
          // reference: clip(round(s - 128)); corrected: round(s)
          sc[o * sc_h * sc_w + sy * sc_w + sx] =
              EXACT ? clamp_q(rintf(__fsub_rn(h, 128.f))) : rintf(h);
        }
        if (KIND == MID && prelast) {
          // the last conv's domain-in: the integer residual add, rescaled
          // by s_1 / s_{L-1}, into domain L-1 (this frame is the shortcut's)
          const float s = sc[o * sc_h * sc_w + pix];
          const float tr = EXACT
              ? __fadd_rn(__fadd_rn(s, clamp_q(rintf(__fsub_rn(h, 128.f)))), 256.f)
              : __fadd_rn(s, rintf(h));
          v = clamp_q(rintf(__fadd_rn(__fmul_rn(__fmul_rn(tr, res_m), res_p), z_next)));
        } else {
          v = clamp_q(rintf(__fadd_rn(h, z_next)));
        }
        words[o % 4] |= (static_cast<int>(v) & 0xff) << (8 * (o / 4));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) next[j * nplane + pix] = words[j];
    }
  }
}

__device__ __forceinline__ void stage_weights(int* dst, const int* __restrict__ src, int words) {
  const int4* s4 = reinterpret_cast<const int4*>(src);
  int4* d4 = reinterpret_cast<int4*>(dst);
  for (int i = threadIdx.x; i < words / 4; i += blockDim.x) d4[i] = s4[i];
}

struct Smem {
  int a_words, b_words, sc_words;
};

__host__ __device__ inline int ring(int layer, int L) {
  // sum of k/2 over convs layer..L-1 for kernel sizes (5, 3, ..., 3, 5)
  if (layer >= L) return 0;
  if (layer == 0) return L + 2;
  return L + 1 - layer;
}

__host__ __device__ inline int extent(int layer, int L, int th, int tw) {
  const int r = ring(layer, L);
  return (th + 2 * r) * (tw + 2 * r);
}

__host__ __device__ inline Smem smem_plan(int L, int th, int tw) {
  Smem s;
  s.a_words = 4 * extent(1, L, th, tw);
  const int b0 = extent(0, L, th, tw);
  const int b2 = 4 * extent(2, L, th, tw);
  s.b_words = ((b0 > b2 ? b0 : b2) + 3) & ~3;
  s.sc_words = kC * extent(L - 1, L, th, tw);
  return s;
}

template <bool EXACT, int OCL>
__global__ void __launch_bounds__(kThreads, 2)
sesr_net_kernel(const int8_t* __restrict__ x, int8_t* __restrict__ out,
                const int* __restrict__ weights, const int* __restrict__ params,
                int H, int W, int L, int in_ch, int th, int tw) {
  extern __shared__ int4 smem4[];
  const Smem plan = smem_plan(L, th, tw);
  int* prm = reinterpret_cast<int*>(smem4);
  int* wsm = prm + P_WORDS;
  int* buf_a = wsm + kMaxLayerWords;
  int* buf_b = buf_a + plan.a_words;
  float* sc = reinterpret_cast<float*>(buf_b + plan.b_words);

  Tile t;
  t.oy0 = blockIdx.y * th;
  t.ox0 = blockIdx.x * tw;
  t.th = th;
  t.tw = tw;
  t.H = H;
  t.W = W;
  const int frame = blockIdx.z;

  for (int i = threadIdx.x; i < P_WORDS; i += blockDim.x) prm[i] = params[i];

  // layer-0 input: one word per pixel, channel c in byte c; z_eff outside
  const int r0 = ring(0, L);
  const int ih0 = th + 2 * r0, iw0 = tw + 2 * r0;
  const int pad0 = pad_word(params[P_ZEFF]);
  for (int i = threadIdx.x; i < ih0 * iw0; i += blockDim.x) {
    const int yy = i / iw0, xx = i - yy * iw0;
    const int gy = t.oy0 - r0 + yy, gx = t.ox0 - r0 + xx;
    int v = pad0;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int8_t* p = x + ((static_cast<size_t>(frame) * H + gy) * W + gx) * in_ch;
      v = 0;
      for (int c = 0; c < in_ch; ++c)
        v |= (static_cast<int>(p[c]) & 0xff) << (8 * c);
    }
    buf_b[i] = v;
  }
  const int npass0 = EXACT ? in_ch : 1;
  stage_weights(wsm, weights + params[P_WOFF], npass0 * 25 * kC);
  __syncthreads();

  const int r_sc = ring(L - 1, L);
  const int sc_h = th + 2 * r_sc, sc_w = tw + 2 * r_sc;
  {
    const int r1 = ring(1, L);
    conv_layer<EXACT, 5, 1, kC, FIRST>(buf_b, wsm, npass0, th + 2 * r1, tw + 2 * r1, t, 0,
                                       false, prm, buf_a, sc, r1 - r_sc, sc_w, sc_h,
                                       nullptr, frame);
  }
  __syncthreads();

  int* cur = buf_a;
  int* nxt = buf_b;
  for (int i = 1; i <= L - 2; ++i) {
    stage_weights(wsm, weights + prm[P_WOFF + i], 4 * 9 * kC);
    __syncthreads();
    const int r = ring(i + 1, L);
    conv_layer<EXACT, 3, 4, kC, MID>(cur, wsm, 4, th + 2 * r, tw + 2 * r, t, i,
                                     i == L - 2, prm, nxt, sc, 0, sc_w, sc_h,
                                     nullptr, frame);
    __syncthreads();
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  constexpr int OCLP = (OCL + 3) & ~3;
  stage_weights(wsm, weights + prm[P_WOFF + L - 1], 4 * 25 * OCLP);
  __syncthreads();
  conv_layer<EXACT, 5, 4, OCL, LAST>(cur, wsm, 4, th, tw, t, L - 1, false, prm,
                                     nullptr, sc, 0, sc_w, sc_h, out, frame);
}

template <bool EXACT, int OCL>
cudaError_t launch_one(const int8_t* x, int8_t* out, const int* w, const int* prm,
                       int n, int h, int wd, int L, int in_ch, int th, int tw,
                       cudaStream_t stream) {
  const Smem plan = smem_plan(L, th, tw);
  const size_t bytes = sizeof(int) * (static_cast<size_t>(P_WORDS) + kMaxLayerWords +
                                      plan.a_words + plan.b_words + plan.sc_words);
  cudaError_t err = cudaFuncSetAttribute(sesr_net_kernel<EXACT, OCL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid((wd + tw - 1) / tw, (h + th - 1) / th, n);
  sesr_net_kernel<EXACT, OCL><<<grid, kThreads, bytes, stream>>>(
      x, out, w, prm, h, wd, L, in_ch, th, tw);
  return cudaGetLastError();
}

template <bool EXACT>
int launch(const void* x, void* out, const void* weights, const void* params, int n,
           int h, int w, int L, int in_ch, int out_ch, int th, int tw, void* stream) {
  if (L < 3 || L > kMaxL || in_ch < 1 || in_ch > 4 || th < 1 || tw < 2 || tw % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int8_t* xi = static_cast<const int8_t*>(x);
  int8_t* oi = static_cast<int8_t*>(out);
  const int* wi = static_cast<const int*>(weights);
  const int* pi = static_cast<const int*>(params);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_ch) {
    case 3: return static_cast<int>(launch_one<EXACT, 3>(xi, oi, wi, pi, n, h, w, L, in_ch, th, tw, s));
    case 12: return static_cast<int>(launch_one<EXACT, 12>(xi, oi, wi, pi, n, h, w, L, in_ch, th, tw, s));
    case 16: return static_cast<int>(launch_one<EXACT, 16>(xi, oi, wi, pi, n, h, w, L, in_ch, th, tw, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// x: int8 (n, h, w, in_ch) quantized input; out: int8 (n, h, w, out_ch);
// weights / params: int32 device arrays built by sesr_tpu_torch/convert.py.
int sesr_pe_exact_net(const void* x, void* out, const void* weights, const void* params,
                      int n, int h, int w, int num_layers, int in_ch, int out_ch,
                      int tile_h, int tile_w, void* stream) {
  return launch<true>(x, out, weights, params, n, h, w, num_layers, in_ch, out_ch,
                      tile_h, tile_w, stream);
}

int sesr_fast_net(const void* x, void* out, const void* weights, const void* params,
                  int n, int h, int w, int num_layers, int in_ch, int out_ch,
                  int tile_h, int tile_w, void* stream) {
  return launch<false>(x, out, weights, params, n, h, w, num_layers, in_ch, out_ch,
                       tile_h, tile_w, stream);
}

const char* sesr_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
