// dipole_panel_df: charge-dipole + dipole-dipole forces at f64 grade, in
// native double (the kernels are dipole_panel.cuh instantiated for double).
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:892 dipole_panel_df
// (_dipole_df_kernel :731), which emulates f64 with pairs of f32.
//
// Bound on the H100: FP64 CUDA-core arithmetic, the f32 twin's count of
// the function's least arithmetic (each unordered pair in which a block
// can act once, the charge-dipole block only inside cut_coul) over the 34
// TFLOP/s FP64 peak: 0.142 ms on chip_smoke.py's 12,288-row panel (the
// CostEstimate's 140 flops per ordered pair: 0.62 ms).  The double rsqrt
// and exp stay at full accuracy and are long DFMA sequences, so computing
// each unordered pair once halves the costliest part; the tile is 64 atoms
// (2 rows per lane), where the float kernel takes 128, to hold the double
// registers, and 8 CTAs per SM bound them to 128.
#include "dipole_panel.cuh"

// the row strip (cols=, row0=)
extern "C" int lidp_dipole_panel_df(
    const double* xr, const double* qr, const double* molr, const double* ar,
    const double* mur, int nrows, int row0, const double* xc,
    const double* qc, const double* molc, const double* ac,
    const double* muc, const double* mc, int npad, const double* L,
    double pd, double cut_coulsq, double sqrt_q, int damping_type, double* f,
    double* partials, double* acc, void* stream) {
  return lidp::launch_dipole_strip<double>(xr, qr, molr, ar, mur, nrows,
                                           row0, xc, qc, molc, ac, muc, mc,
                                           npad, L, pd, cut_coulsq, sqrt_q,
                                           damping_type, f, partials, acc,
                                           stream);
}

// the whole panel (cols is None)
extern "C" int lidp_dipole_panel_df_whole(
    const double* x, const double* q, const double* mol, const double* a,
    const double* mu, const double* m, int n, const double* L, double pd,
    double cut_coulsq, double sqrt_q, int damping_type, int skip, int nT,
    double* part, double* partials, double* f, double* acc,
    unsigned long long* stats, void* stream) {
  return lidp::launch_dipole_whole<double>(x, q, mol, a, mu, m, n, L, pd,
                                           cut_coulsq, sqrt_q, damping_type,
                                           skip, nT, part, partials, f, acc,
                                           stats, stream);
}

// atoms per tile of the whole panel, which sizes its scratch: part (nT, nT +
// 1, 3, tile) and partials (nT (nT + 1) / 2, 8), nT = ceil(n / tile)
extern "C" int lidp_dipole_panel_df_whole_tile() {
  return lidp::DipoleTile<double>::BT;
}
