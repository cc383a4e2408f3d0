// pair_panel_df: dense LJ + coul/long pair forces at f64 grade, in native
// double (the kernel is pair_panel.cuh instantiated for double).  With
// molecule ids (molr, molc, e0 not null) it also returns the unscaled Wolf
// static field from the same geometry pass.
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:640 pair_panel_df
// (_pair_df_kernel :491), which emulates f64 with pairs of f32.  The type
// tables are double in shared memory (5 x 16 x 16 x 8 B = 10 KB) and the
// erfc is the A&S polynomial evaluated in double.
//
// Bound on the H100: FP64 CUDA-core arithmetic, 70 flops per pair without
// the field and 100 with it (the f32 twins' counts) over the 34 TFLOP/s
// FP64 peak: 0.31 / 0.44 ms at 12,288 x 12,288.  The double division,
// rsqrt and exp are multi-instruction sequences, so the kernel sits well
// above that bound.
#include "pair_panel.cuh"

extern "C" int lidp_pair_panel_df(
    const double* xr, const double* qr, const double* tr, const double* molr,
    const int* sp, int S, int nrows, int row0, const double* xc,
    const double* qc, const double* tc, const double* molc, const double* mc,
    int npad, const double* tabs, int t1, const double* L, double cut_coulsq,
    double qqrd2e, double g_ewald, double* f, double* e0, double* partials,
    double* acc, void* stream) {
  if (e0 != nullptr)
    return lidp::launch_pair<double, true, true>(
        xr, qr, tr, molr, sp, S, nrows, row0, xc, qc, tc, molc, mc, npad,
        tabs, t1, L, cut_coulsq, qqrd2e, g_ewald, f, e0, partials, acc,
        stream);
  return lidp::launch_pair<double, true, false>(
      xr, qr, tr, nullptr, sp, S, nrows, row0, xc, qc, tc, nullptr, mc, npad,
      tabs, t1, L, cut_coulsq, qqrd2e, g_ewald, f, nullptr, partials, acc,
      stream);
}
