// eind_panel_df: E_ind = -T.mu at f64 grade, in native double (the kernel
// is eind_panel.cuh instantiated for double).
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:359 eind_panel_df
// (_eind_df_kernel :292), which emulates f64 with pairs of f32 because its
// compiler has no f64.  All of x, alpha_eff, mu and L are double, and the
// minimum image rounds in double, as the f64 column-chunk path does.
//
// Bound on the H100: FP64 CUDA-core arithmetic, 45 flops per pair (the f32
// twin's count) over the 34 TFLOP/s FP64 peak: 0.20 ms at 12,288 x 12,288.
// The double rsqrt and exp are multi-instruction sequences, so the kernel
// sits well above that bound.
#include "eind_panel.cuh"

extern "C" int lidp_eind_panel_df(const double* xr, const double* ar,
                                  int nrows, int row0, const double* xc,
                                  const double* ac, const double* muc,
                                  int npad, const double* L, double pd,
                                  int damping_type, double* out,
                                  void* stream) {
  return lidp::launch_eind<double>(xr, ar, nrows, row0, xc, ac, muc, npad, L,
                                   pd, damping_type, out, stream);
}
