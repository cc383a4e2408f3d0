// eind_panel_df: E_ind = -T.mu at f64 grade, in native double (the kernels
// are eind_panel.cuh instantiated for double).
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:359 eind_panel_df
// (_eind_df_kernel :292), which emulates f64 with pairs of f32 because its
// compiler has no f64.  All of x, alpha_eff, mu and L are double, and the
// minimum image rounds in double, as the f64 column-chunk path does.
//
// Bound on the H100: FP64 CUDA-core arithmetic, the f32 twin's count (59
// flops per unordered pair of polarizable atoms, 12 more where the damping
// differs from 1, here to u = pd*r = 47) over the 34 TFLOP/s FP64 peak:
// 0.084 ms on chip_smoke.py's 12,288-row panel (the CostEstimate's 45
// flops per ordered pair: 0.20 ms).  The double rsqrt and exp stay at full
// accuracy and are long DFMA sequences, so the design's gains are the
// float32 kernel's: each unordered pair once for both atoms, and above all
// the exact skip of the exponential, which at double precision pays beyond
// u = pd*r = 49 (about 23 A at the fluid's polar_damp).
#include "eind_panel.cuh"

extern "C" int lidp_eind_panel_df(const double* xr, const double* ar,
                                  int nrows, int row0, const double* xc,
                                  const double* ac, const double* muc,
                                  int npad, const double* L, double pd,
                                  int damping_type, double skip_u,
                                  double* out, unsigned long long* stats,
                                  void* stream) {
  return lidp::launch_eind_strip<double>(xr, ar, nrows, row0, xc, ac, muc,
                                         npad, L, pd, damping_type, skip_u,
                                         out, stats, stream);
}

extern "C" int lidp_eind_panel_df_whole(const double* x, const double* a,
                                        const double* mu, int n,
                                        const double* L, double pd,
                                        int damping_type, double skip_u,
                                        int nT, double* part, double* out,
                                        unsigned long long* stats,
                                        void* stream) {
  return lidp::launch_eind_whole<double>(x, a, mu, n, L, pd, damping_type,
                                         skip_u, nT, part, out, stats,
                                         stream);
}
