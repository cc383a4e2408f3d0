// pair_panel: dense LJ (+ coul/long) pair forces without the Wolf field, in
// float32 (the kernel is in pair_panel.cuh); coul == 0 compiles the erfc
// branch out and leaves LJ only.
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:1458 pair_panel
// (_pair_kernel :1200).
//
// Bound on the H100: FP32 CUDA-core arithmetic, 70 flops per pair by the
// Pallas CostEstimate: 10.6 GFLOP at 12,288 x 12,288, 0.16 ms at the
// 67 TFLOP/s FP32 peak, against under 1 MB of operands.
#include "pair_panel.cuh"

extern "C" int lidp_pair_panel(
    const float* xr, const float* qr, const float* tr, const int* sp, int S,
    int nrows, int row0, const float* xc, const float* qc, const float* tc,
    const float* mc, int npad, const float* tabs, int t1, const float* L,
    float cut_coulsq, float qqrd2e, float g_ewald, int coul, float* f,
    float* partials, float* acc, void* stream) {
  if (coul)
    return lidp::launch_pair<float, true, false>(
        xr, qr, tr, nullptr, sp, S, nrows, row0, xc, qc, tc, nullptr, mc,
        npad, tabs, t1, L, cut_coulsq, qqrd2e, g_ewald, f, nullptr, partials,
        acc, stream);
  return lidp::launch_pair<float, false, false>(
      xr, qr, tr, nullptr, sp, S, nrows, row0, xc, qc, tc, nullptr, mc, npad,
      tabs, t1, L, cut_coulsq, qqrd2e, g_ewald, f, nullptr, partials, acc,
      stream);
}
