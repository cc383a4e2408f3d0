// pair_wolf_panel: dense LJ + coul/long pair forces fused with the unscaled
// Wolf static field E0, in float32 (the kernel is in pair_panel.cuh).
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:1386 pair_wolf_panel
// (_pair_wolf_kernel :1293).
//
// Bound on the H100: FP32 CUDA-core arithmetic.  The Pallas CostEstimate
// counts 100 flops per pair (plus one exp, one rsqrt, two reciprocals); at
// the slice's 12,288 x 12,288 panel that is 15.1 GFLOP, 0.23 ms at the
// 67 TFLOP/s FP32 peak, against under 1 MB of operands.
#include "pair_panel.cuh"

extern "C" int lidp_pair_wolf_panel(
    const float* xr, const float* qr, const float* tr, const float* molr,
    const int* sp, int S, int nrows, int row0, const float* xc,
    const float* qc, const float* tc, const float* molc, const float* mc,
    int npad, const float* tabs, int t1, const float* L, float cut_coulsq,
    float qqrd2e, float g_ewald, float* f, float* e0, float* partials,
    float* acc, void* stream) {
  return lidp::launch_pair<float, true, true>(
      xr, qr, tr, molr, sp, S, nrows, row0, xc, qc, tc, molc, mc, npad, tabs,
      t1, L, cut_coulsq, qqrd2e, g_ewald, f, e0, partials, acc, stream);
}
