// eind_panel: E_ind = -T.mu in float32 (the kernels are in eind_panel.cuh).
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:194 eind_panel
// (_eind_kernel :144), the SCF matvec, once per CG iteration.
//
// Bound on the H100: FP32 CUDA-core arithmetic.  T is symmetric, so the
// function needs 59 flops per unordered pair of polarizable atoms, and 12
// more where the damping differs from 1 (plus the SFU's rsqrt and exp):
// 0.041 ms at the 67 TFLOP/s FP32 peak on chip_smoke.py's 12,288-row
// panel of 10,125 atoms, against 0.3 MB of operands (the Pallas
// CostEstimate's 45 flops per ordered pair of all 12,288 rows: 0.10 ms).
// The kernel is bound by issued instructions, so its design cuts them:
// the whole panel computes each unordered pair once for both atoms
// (geometry, rsqrt, damping and the two c's once, then two FMAs per
// component and side), reads the columns as packed 16-byte vectors, takes
// a one-instruction rsqrt (its inputs are never subnormal), and skips the
// exponential where a warp's pairs all lie beyond the range where the
// damping differs from 1 (u = pd*r = 27, about 12.7 A at the fluid's
// polar_damp).
#include "eind_panel.cuh"

extern "C" int lidp_eind_panel(const float* xr, const float* ar, int nrows,
                               int row0, const float* xc, const float* ac,
                               const float* muc, int npad, const float* L,
                               float pd, int damping_type, float skip_u,
                               float* out, unsigned long long* stats,
                               void* stream) {
  return lidp::launch_eind_strip<float>(xr, ar, nrows, row0, xc, ac, muc,
                                        npad, L, pd, damping_type, skip_u,
                                        out, stats, stream);
}

extern "C" int lidp_eind_panel_whole(const float* x, const float* a,
                                     const float* mu, int n, const float* L,
                                     float pd, int damping_type, float skip_u,
                                     int nT, float* part, float* out,
                                     unsigned long long* stats, void* stream) {
  return lidp::launch_eind_whole<float>(x, a, mu, n, L, pd, damping_type,
                                        skip_u, nT, part, out, stats, stream);
}
