// eind_panel: E_ind = -T.mu in float32 (the kernel is in eind_panel.cuh).
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:194 eind_panel
// (_eind_kernel :144).
//
// Bound on the H100: FP32 CUDA-core arithmetic.  The Pallas CostEstimate
// counts 45 flops per pair (plus one exp and one rsqrt on the SFU); at the
// slice's 12,288 x 12,288 panel that is 6.8 GFLOP, 0.10 ms at the 67 TFLOP/s
// FP32 peak, against 0.3 MB of operands.
#include "eind_panel.cuh"

extern "C" int lidp_eind_panel(const float* xr, const float* ar, int nrows,
                               int row0, const float* xc, const float* ac,
                               const float* muc, int npad, const float* L,
                               float pd, int damping_type, float* out,
                               void* stream) {
  return lidp::launch_eind<float>(xr, ar, nrows, row0, xc, ac, muc, npad, L,
                                  pd, damping_type, out, stream);
}
