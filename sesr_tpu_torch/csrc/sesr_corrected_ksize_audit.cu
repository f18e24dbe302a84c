// The counting form of the corrected kernel for networks of other conv
// sizes (sesr_corrected_ksize.cu) at widths 16 and 32, in a library of its
// own: sesr_corrected_ksize_audit_kernel<G, C>, G 4 / 8 / 16 PE groups,
// width 16 or 32 (6), built beside the served kernels' library by an nvcc
// process of its own, so that the two libraries' builds run side by side.
//
// Replaces, with sesr_corrected.cu's counting form, the audit's jitted
// interpreter, whose convs take any size:
//   sesr_corrected_ksize_audit <- integer_forward(corrected=True, collect_dumps=True)
//                                 behind sesr_tpu/quant/audit.py:96
//
// Built with route (b): nvcc into a shared library with a plain C interface,
// loaded with ctypes (sesr_tpu_torch/ops/_build.py). Each entry point
// returns cudaGetLastError() after its launch.

#define SESR_CORRECTED_KSIZE_BODY_ONLY
#include "sesr_corrected_ksize.cu"

extern "C" {

// The counting form of a group: sesr_corrected_ksize's arguments but the
// stream, then the counters and the count region, then the stream, as
// sesr_corrected_group_audit counts.
int sesr_corrected_ksize_audit(const void* x, void* out, const void* weights, const void* params,
                               void* sc, int nb, int h, int w, int n, int flags, int in_ch,
                               int out_ch, int tile_h, int tile_w, int split, int pe, int general,
                               int width, long long ks, void* counts, int y0, int y1, int x0,
                               int x1, void* stream) {
  const GroupCount cnt{static_cast<unsigned long long*>(counts), y0, y1, x0, x1};
  if (width == 16)
    return launch_ksize_group<16, true>(x, out, weights, params, sc, nb, h, w, n, flags, in_ch,
                                        out_ch, tile_h, tile_w, split, pe, general, ks, cnt,
                                        stream);
  if (width == kMaxC)
    return launch_ksize_group<kMaxC, true>(x, out, weights, params, sc, nb, h, w, n, flags, in_ch,
                                           out_ch, tile_h, tile_w, split, pe, general, ks, cnt,
                                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* sesr_corrected_ksize_audit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
