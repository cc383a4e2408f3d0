// dipole_panel: charge-dipole + dipole-dipole forces in float32 (the
// kernels are in dipole_panel.cuh).
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:1140 dipole_panel
// (_dipole_kernel :1037), once per step after the SCF.
//
// Bound on the H100: FP32 CUDA-core arithmetic.  The function needs its
// geometry (17 flops) once for each unordered pair in which a block can act
// (an unmasked atom on one side, and alpha_i, alpha_j != 0 or, between
// different molecules, a charge facing a dipole), 30 more where one acts
// (the two mu.d, the force applied to both atoms, the virial), the
// dipole-dipole block where alpha_i, alpha_j != 0 (34 flops, 21 more for
// the damping), the charge-dipole block only inside cut_coul (38), and 3
// to add the two where both act: 0.072 ms at the 67 TFLOP/s FP32 peak on
// chip_smoke.py's 12,288-row panel of 10,125 atoms (chip_smoke.py
// dipole_bound_ms; the Pallas CostEstimate's 140 flops per ordered pair of
// all 12,288 rows: 0.32 ms), against under 1 MB of operands.  The
// whole-panel kernel therefore computes each unordered pair once for both
// atoms (geometry, rsqrt, exponential and the two blocks once), reads the
// columns as packed 16-byte vectors, and skips by warp vote the
// charge-dipole block where no pair of a vote is inside the cutoff, and
// the dipole-dipole block where no pair is polarizable.
#include "dipole_panel.cuh"

// the row strip (cols=, row0=)
extern "C" int lidp_dipole_panel(
    const float* xr, const float* qr, const float* molr, const float* ar,
    const float* mur, int nrows, int row0, const float* xc, const float* qc,
    const float* molc, const float* ac, const float* muc, const float* mc,
    int npad, const float* L, float pd, float cut_coulsq, float sqrt_q,
    int damping_type, float* f, float* partials, float* acc, void* stream) {
  return lidp::launch_dipole_strip<float>(xr, qr, molr, ar, mur, nrows, row0,
                                          xc, qc, molc, ac, muc, mc, npad, L,
                                          pd, cut_coulsq, sqrt_q,
                                          damping_type, f, partials, acc,
                                          stream);
}

// the whole panel (cols is None)
extern "C" int lidp_dipole_panel_whole(
    const float* x, const float* q, const float* mol, const float* a,
    const float* mu, const float* m, int n, const float* L, float pd,
    float cut_coulsq, float sqrt_q, int damping_type, int skip, int nT,
    float* part, float* partials, float* f, float* acc,
    unsigned long long* stats, void* stream) {
  return lidp::launch_dipole_whole<float>(x, q, mol, a, mu, m, n, L, pd,
                                          cut_coulsq, sqrt_q, damping_type,
                                          skip, nT, part, partials, f, acc,
                                          stats, stream);
}

// atoms per tile of the whole panel, which sizes its scratch: part (nT, nT +
// 1, 3, tile) and partials (nT (nT + 1) / 2, 8), nT = ceil(n / tile)
extern "C" int lidp_dipole_panel_whole_tile() {
  return lidp::DipoleTile<float>::BT;
}
