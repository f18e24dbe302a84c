// What the fused whole-network kernels share: the network's limits, the
// layout of the int32 parameter block that sesr_tpu_torch/convert.py builds
// (PARAM_LAYOUT), the exact int <-> float32 conversions through kMagic, the
// byte packing of int8 activations, and the geometry of a tile's extents.
// Included by sesr_net.cu (K1, K2) and sesr_corrected.cu (the corrected
// kernel); each source is its own library, and ops/_build.py hashes this
// header into both libraries' names.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxC = 32;       // the widest hidden width: 16 or 32 (a narrower network is padded to the next)
constexpr int kMaxL = 16;       // deepest supported network
constexpr int kMaxPE = 16;      // most PEs of a datapath
constexpr int kMaxOut = 48;     // most output channels of the last conv (3 x 4^2: RGB at scale 4)

// Layout of the int32 parameter block (kept in sync with
// sesr_tpu_torch/convert.py param_at): a head of kHead words, then one
// record per conv of rec_words(C) words, C the kernel's hidden width (16 or
// 32), then (the corrected kernel only) z_eff * sum(W_p) per layer, PE and
// channel, then, for a last conv of more output channels than C, its own
// rows (out_rows: its bias, z_eff * sum(W) and each PE's z_eff * sum(W_p),
// OC words each; its record's R_ROWS word is the first one's offset). The
// block of an L-conv network holds L records and no more, so that the
// kernels copy only what the network uses into shared memory.
constexpr int P_RESM = 0;                 // f32 bits: residual requant mantissa
constexpr int P_RESP = 1;                 // f32 bits: residual 2^-n
constexpr int P_ZOUT = 2;                 // f32 bits: zero of the output domain
constexpr int P_ACC_HI = 3;               // per-PE accumulator max (pe_acc_bits; 18 shipped)
constexpr int P_ADD_HI = 4;               // PE adder max (pe_add_bits; 20 shipped)
constexpr int P_SPLIT = 5;                // bit i: conv i runs one pass per PE
constexpr int P_CLAMP = 6;                // bit i: conv i's adder clamp can fire
constexpr int P_QUANT = 7;                // the activations' half range 2^(quan_bits - 1)
                                          // (128 shipped; read by the general forms)
constexpr int kHead = 8;
// fields of a conv's record
constexpr int R_WOFF = 0;                 // weight word offset of the layer
constexpr int R_ZEFF = 1;                 // pad value (z_eff) of the conv's input
constexpr int R_ZIN = 2;                  // f32 bits: domain-in zero of the conv
constexpr int R_RQM = 3;                  // f32 bits: requant mantissa
constexpr int R_RQP = 4;                  // f32 bits: 2^-n
constexpr int R_ROWS = 5;                 // the last conv past C output channels: its rows' offset
constexpr int R_OUT = 6;                  // the last conv: its output channels
constexpr int R_K = 7;                    // the conv's size k (k x k, odd, 1 to 9; read by the
                                          // forms of other conv sizes)
constexpr int R_BIAS = 8;                 // [C] bias added after the adder clamp; then
                                          // [C] z_eff * sum(W), subtracted before it
__host__ __device__ constexpr int rec_words(int C) { return R_BIAS + 2 * C; }
// word `field` of conv `layer`'s record
__host__ __device__ constexpr int p_at(int layer, int field, int C) { return kHead + layer * rec_words(C) + field; }
// the words K1 and K2 read (a multiple of 8: their weights follow in shared memory)
__host__ __device__ constexpr int net_words(int L, int C) { return kHead + L * rec_words(C); }
// z_eff * sum(W_p) of conv `layer`'s PE p, C words (the corrected kernel)
__host__ __device__ constexpr int zcp_at(int L, int C, int pe, int layer, int p) { return net_words(L, C) + (layer * pe + p) * C; }
// Words of the head, the records and the per-PE rows (convert.py param_words).
__host__ __device__ constexpr int param_words(int L, int C, int pe) { return net_words(L, C) + L * pe * C; }
// Words of the last conv's own rows, past param_words (convert.py out_rows).
__host__ __device__ constexpr int out_rows(int oc, int C, int pe) { return oc > C ? (2 + pe) * oc : 0; }
// The last conv's padded columns (convert.py out_columns): n-tiles of 8 for
// mma.sync, a wgmma N.
__host__ __device__ constexpr int out_cols(int oc) { return oc <= 8 ? 8 : oc <= 16 ? 16 : oc <= 32 ? 32 : 48; }

enum Kind { FIRST = 0, MID = 1, LAST = 2 };

struct Tile {
  int oy0, ox0;       // image coordinates of the output tile's origin
  int th, tw;         // output tile extent
  int H, W;           // frame extent
};

__device__ __forceinline__ int pad_word(int z) {
  unsigned b = static_cast<unsigned>(z) & 0xffu;
  return static_cast<int>(b | (b << 8) | (b << 16) | (b << 24));
}

__device__ __forceinline__ float as_f32(int bits) { return __int_as_float(bits); }

// Exact int <-> float32 conversions on the full-rate pipes (the conversion
// instructions run at a quarter of the rate): kMagic = 1.5 * 2^23 has ulp 1,
// so for |v| < 2^22 the bits of kMagic + v are kMagicBits + v, and a float
// add of kMagic rounds to an integer, half to even, as rintf does. Where a
// sum may pass 2^22 (the wide kernels, convert.py KernelConstants.wide) it
// stays a plain int32 and is converted once by __int2float_rn, which
// rounds past 2^24 as the plain version's cast does.
constexpr float kMagic = 12582912.f;
constexpr int kMagicBits = 0x4B400000;

// The float of (v - kMagicBits), for the int v - kMagicBits in (-2^22, 2^22).
__device__ __forceinline__ float magic_to_f32(int v) {
  return __fsub_rn(__int_as_float(v), kMagic);
}

// clip(rintf(v), -half, half - 1) in the low byte of the result, for any
// finite v, with lo = kMagic - half and hi = kMagic + half - 1 (int8's
// [-128, 127] at half = 128; quant_half): rounding is monotone, so clamping
// kMagic + v to [lo, hi] clamps the rounded value.
__device__ __forceinline__ int qn_bits(float v, float lo, float hi) {
  return __float_as_int(fminf(fmaxf(__fadd_rn(v, kMagic), lo), hi));
}

// The activations' half range 2^(quan_bits - 1), from the parameter block.
__device__ __forceinline__ float quant_half(const int* prm) {
  return static_cast<float>(prm[P_QUANT]);
}

// Bytes 0 of four words into one word.
__device__ __forceinline__ int pack_bytes(int b0, int b1, int b2, int b3) {
  return static_cast<int>(__byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                                      0x5410));
}

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

// The layer-group form (sesr_net_group.cu, sesr_corrected_group.cu): a
// network that no single launch runs goes as a chain of launches, one per
// group of n consecutive convs, the int8 activation crossing each boundary
// through device memory. A group's flags: G_FIRST, it starts at conv 0 (its
// layer 0 reads the input image, 5x5) and writes the residual shortcut;
// G_LAST, it ends at the last conv (5x5, the output) and reads the
// shortcut; a group between holds 3x3 convs only. Its parameter block
// holds its convs' records and, before the last group, the next conv's
// (the zero and pad of the activation it writes): group_records. Layer j of
// a group is its conv j; the kernels' layer indices, split and clamp bits
// are the group's own (convert.py group_constants).
constexpr int G_FIRST = 1;
constexpr int G_LAST = 2;
__host__ __device__ constexpr int group_records(int n, int fl) { return n + ((fl & G_LAST) == 0); }
// Layer j's kind as the layer of a three-conv network: 0 FIRST, 1 MID, 2 LAST.
__host__ __device__ constexpr int group_kind(int j, int n, int fl) { return (j == 0 && (fl & G_FIRST)) ? 0 : (j == n - 1 && (fl & G_LAST)) ? 2 : 1; }
// Sum of k/2 over layers j..n-1 of the group (ring's, for a whole network).
__host__ __device__ constexpr int group_ring(int j, int n, int fl) { return j >= n ? 0 : n - j + (j == 0 && (fl & G_FIRST)) + ((fl & G_LAST) != 0); }
__host__ __device__ inline int group_extent(int j, int n, int fl, int th, int tw) {
  const int r = group_ring(j, n, fl);
  return (th + 2 * r) * (tw + 2 * r);
}
// The shortcut's ring around the tile: the last conv's input extent where
// the group reads it (G_LAST), the tile where the first group writes it for
// a later group.
__host__ __device__ constexpr int group_sc_ring(int fl) { return (fl & G_LAST) ? 2 : 0; }

// The forms of other conv sizes (sesr_net_ksize.cu, sesr_corrected_ksize.cu):
// a network whose convs are not 5x5 / 3x3 ... / 5x5 (any odd size from 1 to
// 9 at each position) runs in the layer-group form, each conv's size read
// from its record (R_K) and, on the host, from the group's sizes packed
// four bits a conv, conv j in bits 4 j .. 4 j + 3 (ks).
__host__ __device__ constexpr int ks_at(long long ks, int j) { return static_cast<int>((ks >> (4 * j)) & 15); }
// Sum of k/2 over layers j..n-1 of a group of sizes ks (group_ring's).
__host__ __device__ inline int ks_ring(int j, int n, long long ks) {
  int r = 0;
  for (int i = j; i < n; ++i) r += ks_at(ks, i) / 2;
  return r;
}
// The shortcut's ring around the tile (group_sc_ring's): the last conv's
// k/2 where the group reads it (G_LAST).
__host__ __device__ inline int ks_sc_ring(int n, int fl, long long ks) { return (fl & G_LAST) ? ks_at(ks, n - 1) / 2 : 0; }

// Four int8 words a..d -> word b of the result holds byte b of a, b, c, d:
// a 4 x 4 byte transpose, its own inverse. K1 / K2 hold a pixel's channels
// c, c + 4, c + 8, c + 12 in word c % 4 (of each 16 channels); device memory
// holds them in order (channels 4 w .. 4 w + 3 in word w).
__device__ __forceinline__ int4 transpose_bytes(int4 v) {
  const int t0 = __byte_perm(v.x, v.y, 0x5140), t1 = __byte_perm(v.z, v.w, 0x5140);
  const int t2 = __byte_perm(v.x, v.y, 0x7362), t3 = __byte_perm(v.z, v.w, 0x7362);
  return make_int4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                   __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
}

}  // namespace
