// The counting form of the corrected kernel at hidden width 64
// (sesr_corrected_w64.cu), in a library of its own:
// sesr_corrected_ksize_audit_kernel<G, 64>, G 4 / 8 / 16 PE groups (3),
// built by an nvcc process of its own beside the served kernels'.
//
// Replaces, with sesr_corrected.cu's counting form, the audit's jitted
// interpreter, whose convs take any width:
//   sesr_corrected_w64_audit <- integer_forward(corrected=True, collect_dumps=True)
//                               behind sesr_tpu/quant/audit.py:96
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (sesr_tpu_torch/ops/_build.py). Each entry point
// returns cudaGetLastError() after its launch.

#define SESR_CORRECTED_KSIZE_BODY_ONLY
#include "sesr_corrected_ksize.cu"

extern "C" {

// The counting form of a group: sesr_corrected_ksize_audit's arguments;
// width must be 64.
int sesr_corrected_w64_audit(const void* x, void* out, const void* weights, const void* params,
                             void* sc, int nb, int h, int w, int n, int flags, int in_ch,
                             int out_ch, int tile_h, int tile_w, int split, int pe, int general,
                             int width, long long ks, void* counts, int y0, int y1, int x0,
                             int x1, void* stream) {
  if (width != 64) return static_cast<int>(cudaErrorInvalidValue);
  return launch_ksize_group<64, true>(
      x, out, weights, params, sc, nb, h, w, n, flags, in_ch, out_ch, tile_h, tile_w, split, pe,
      general, ks, GroupCount{static_cast<unsigned long long*>(counts), y0, y1, x0, x1}, stream);
}

const char* sesr_corrected_w64_audit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
