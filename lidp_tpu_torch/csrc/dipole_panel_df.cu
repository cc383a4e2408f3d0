// dipole_panel_df: charge-dipole + dipole-dipole forces at f64 grade, in
// native double (the kernel is dipole_panel.cuh instantiated for double).
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:892 dipole_panel_df
// (_dipole_df_kernel :731), which emulates f64 with pairs of f32.
//
// Bound on the H100: FP64 CUDA-core arithmetic, 140 flops per pair (the f32
// twin's count) over the 34 TFLOP/s FP64 peak: 0.62 ms at 12,288 x 12,288.
// Column staging takes 10 x 256 x 8 B = 20 KB of static shared memory.
#include "dipole_panel.cuh"

extern "C" int lidp_dipole_panel_df(
    const double* xr, const double* qr, const double* molr, const double* ar,
    const double* mur, int nrows, int row0, const double* xc,
    const double* qc, const double* molc, const double* ac,
    const double* muc, const double* mc, int npad, const double* L,
    double pd, double cut_coulsq, double sqrt_q, int damping_type, double* f,
    double* partials, double* acc, void* stream) {
  return lidp::launch_dipole<double>(xr, qr, molr, ar, mur, nrows, row0, xc,
                                     qc, molc, ac, muc, mc, npad, L, pd,
                                     cut_coulsq, sqrt_q, damping_type, f,
                                     partials, acc, stream);
}
