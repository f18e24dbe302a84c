// K1 and K2 (sesr_net.cu) at hidden width 64 on Hopper (sm_90a): a network
// of 33 to 64 hidden channels (a narrower one padded with zero channels,
// convert.py _padded) runs in the forms of other conv sizes
// (sesr_net_ksize.cu), whatever its conv sizes: a chain of launches of the
// layer-group form (convert.py layer_groups: one group where its plan fits
// a block), each a launch of sesr_net_ksize_kernel<DP, OCL, 64> (or, for a
// two-conv network, sesr_net_ksize_pair_kernel<DP, OCL, 64>) over the whole
// batch. This source holds those instantiations and their entry points
// alone, so that no earlier library's code changes.
//
// Replaces, with sesr_net.cu, the same two Pallas TPU kernels of the JAX
// package, whose convs take any width:
//   sesr_net_w64(exact = 1) <- sesr_tpu/ops/pallas_pipeline.py build_pallas_forward (K1)
//   sesr_net_w64(exact = 0) <- sesr_tpu/ops/pallas_packed.py build_pallas_packed_forward (K2)
// Its plain version, group by group, is sesr_tpu_torch/quant/integer.py
// group_forward; the chain's is integer_forward.
//
// At width 64 a pixel is 16 activation words in 16 planes (word w: channels
// w % 4 + 16 (w / 4) + 4 j), a one-pass conv reads all 16 words of a tap,
// two k32 chunks a tap (conv_layer_ks, WPT 16), and a hidden conv's B
// fragments are 8 n-tiles, 16 registers a (pass, chunk) (load_frag_ks). A
// split conv at 4, 8, 12 or 16 PEs reads its PE's 4 words a tap. The
// kernels take one block an SM (__launch_bounds__(256, 1)): a 64-channel
// accumulator set and layer 0's four unrolled PE passes need the registers.
//
// What bounds it on this card: operations, as sesr_net.cu.
//
// Instantiations: sesr_net_ksize_kernel<DP, OCL, 64> and
// sesr_net_ksize_pair_kernel<DP, OCL, 64>, DP K1 / K2, OCL -8, -16, -32,
// -48: 16, each the general instantiation's wide form.
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (sesr_tpu_torch/ops/_build.py), its own nvcc process.
// Each entry point returns cudaGetLastError() after its launch.

#define SESR_NET_KSIZE_BODY_ONLY
#include "sesr_net_ksize.cu"

extern "C" {

// One group's launch: sesr_net_ksize's arguments; width must be 64.
int sesr_net_w64(int exact, const void* x, void* out, const void* weights, const void* params,
                 void* sc, int nb, int h, int w, int n, int flags, int in_ch, int out_ch,
                 int tile_h, int tile_w, int split, int pe, int general, int width, long long ks,
                 void* stream) {
  if (width != 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch_ksize_width<64>(exact, x, out, weights, params, sc, nb, h, w, n, flags, in_ch,
                                out_ch, tile_h, tile_w, split, pe, general, ks, stream);
}

// Shared memory of one block of a group in bytes, or 0 where the entry
// point refuses the arguments.
int sesr_net_w64_smem(int exact, int n, int flags, int in_ch, int out_ch, int tile_h, int tile_w,
                      int split, int pe, int width, long long ks) {
  if (width != 64) return 0;
  return ksize_smem(exact, n, flags, in_ch, out_ch, tile_h, tile_w, split, pe, width, ks);
}

const char* sesr_net_w64_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
