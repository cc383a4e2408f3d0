// dipole_panel: charge-dipole + dipole-dipole forces in float32 (the kernel
// is in dipole_panel.cuh).
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:1140 dipole_panel
// (_dipole_kernel :1037).
//
// Bound on the H100: FP32 CUDA-core arithmetic.  The Pallas CostEstimate
// counts 140 flops per pair (plus one exp and one rsqrt); at the slice's
// 12,288 x 12,288 panel that is 21.1 GFLOP, 0.32 ms at the 67 TFLOP/s FP32
// peak, against under 1 MB of operands.
#include "dipole_panel.cuh"

extern "C" int lidp_dipole_panel(
    const float* xr, const float* qr, const float* molr, const float* ar,
    const float* mur, int nrows, int row0, const float* xc, const float* qc,
    const float* molc, const float* ac, const float* muc, const float* mc,
    int npad, const float* L, float pd, float cut_coulsq, float sqrt_q,
    int damping_type, float* f, float* partials, float* acc, void* stream) {
  return lidp::launch_dipole<float>(xr, qr, molr, ar, mur, nrows, row0, xc,
                                    qc, molc, ac, muc, mc, npad, L, pd,
                                    cut_coulsq, sqrt_q, damping_type, f,
                                    partials, acc, stream);
}
