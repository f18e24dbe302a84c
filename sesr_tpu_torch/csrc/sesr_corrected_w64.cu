// The corrected kernel (sesr_corrected.cu) at hidden width 64 on Hopper
// (sm_90a): a network of 33 to 64 hidden channels (a narrower one padded
// with zero channels, convert.py _padded) runs in the forms of other conv
// sizes (sesr_corrected_ksize.cu), whatever its conv sizes: a chain of
// persistent launches of sesr_corrected_ksize_kernel<G, 64>, one a layer
// group (convert.py layer_groups). This source holds those instantiations
// and their entry points alone (the counting form's are in
// sesr_corrected_w64_audit.cu), so that no earlier library's code changes.
//
// Replaces, with sesr_corrected.cu, the XLA lowering of the JAX package's
// corrected modes, whose convs take any width:
//   sesr_corrected_w64 <- sesr_tpu/ops/packed.py _packed_exact_impl(corrected=True)
// Its plain version, group by group, is sesr_tpu_torch/quant/integer.py
// group_forward; the chain's is integer_forward(corrected=True).
//
// At width 64 a hidden layer's input is four planes of 16 bytes a pixel
// (channels 16 w .. 16 w + 15 in plane w) and each tap two k32 steps, step
// s tap s / 2 over planes 2 (s % 2) and 2 (s % 2) + 1, A's LBO the planes'
// distance (FormKS::issue_run with w64_half_off); a PE group is 64 columns,
// so a split layer runs in chunks of two groups (kMaxN), its B whole where
// it fits (3x3: 36,864 B a group) or in pieces of piece_span steps
// (conv_pieces_ks); the epilogue writes the four planes and the shortcut's
// 64 int16 a pixel.
//
// What bounds it on this card: operations, as sesr_corrected.cu.
//
// Instantiations: sesr_corrected_ksize_kernel<G, 64>, G 4 / 8 / 16 PE
// groups: 3, each the general instantiation's wide form.
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (sesr_tpu_torch/ops/_build.py), its own nvcc process.
// Each entry point returns cudaGetLastError() after its launch.

#define SESR_CORRECTED_KSIZE_BODY_ONLY
#include "sesr_corrected_ksize.cu"

extern "C" {

// One group's launch: sesr_corrected_ksize's arguments; width must be 64.
int sesr_corrected_w64(const void* x, void* out, const void* weights, const void* params, void* sc,
                       int nb, int h, int w, int n, int flags, int in_ch, int out_ch, int tile_h,
                       int tile_w, int split, int pe, int general, int width, long long ks,
                       void* stream) {
  if (width != 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch_ksize_group<64, false>(x, out, weights, params, sc, nb, h, w, n, flags, in_ch,
                                       out_ch, tile_h, tile_w, split, pe, general, ks,
                                       GroupCount{nullptr, 0, 0, 0, 0}, stream);
}

// Shared memory of one block of a group in bytes, or 0 where the entry
// point refuses it (the counting form's is the same).
int sesr_corrected_w64_smem(int n, int flags, int in_ch, int out_ch, int tile_h, int tile_w,
                            int split, int pe, int width, long long ks) {
  if (width != 64) return 0;
  return ksize_smem(n, flags, in_ch, out_ch, tile_h, tile_w, split, pe, width, ks);
}

const char* sesr_corrected_w64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
