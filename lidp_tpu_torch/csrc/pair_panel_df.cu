// pair_panel_df: dense LJ + coul/long pair forces at f64 grade, in native
// double (the kernels are pair_panel.cuh instantiated for double).  With
// molecule ids (mol, e0 not null) it also returns the unscaled Wolf static
// field from the same geometry pass.
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:640 pair_panel_df
// (_pair_df_kernel :491), which emulates f64 with pairs of f32.  The type
// tables are double in shared memory and the erfc is the A&S polynomial
// evaluated in double.
//
// Bound on the H100: FP64 CUDA-core arithmetic, the f32 twins' count of
// the function's least arithmetic (chip_smoke.py pair_bound_ms: the
// geometry of each unordered pair with an unmasked atom, the blocks only
// inside their cutoffs) over the 34 TFLOP/s FP64 peak (the CostEstimate's
// 70 / 100 flops per ordered pair: 0.31 / 0.44 ms at 12,288 x 12,288).
// The double division, rsqrt and exp are multi-instruction sequences, so
// the whole-panel kernel runs them only in the warp votes that find a pair
// in range; the tile is 64 atoms (2 rows per lane) where the float kernel
// takes 128, to hold the double registers.
#include "pair_panel.cuh"

// the row strip (cols=, row0=)
extern "C" int lidp_pair_panel_df(
    const double* xr, const double* qr, const double* tr, const double* molr,
    const int* sp, int S, int nrows, int row0, const double* xc,
    const double* qc, const double* tc, const double* molc, const double* mc,
    int npad, const double* tabs, int t1, const double* L, double cut_coulsq,
    double qqrd2e, double g_ewald, double* f, double* e0, double* partials,
    double* acc, void* stream) {
  if (e0 != nullptr)
    return lidp::launch_pair_strip<double, true, true>(
        xr, qr, tr, molr, sp, S, nrows, row0, xc, qc, tc, molc, mc, npad,
        tabs, t1, L, cut_coulsq, qqrd2e, g_ewald, f, e0, partials, acc,
        stream);
  return lidp::launch_pair_strip<double, true, false>(
      xr, qr, tr, nullptr, sp, S, nrows, row0, xc, qc, tc, nullptr, mc, npad,
      tabs, t1, L, cut_coulsq, qqrd2e, g_ewald, f, nullptr, partials, acc,
      stream);
}

// the whole panel (cols is None); with mol and e0 the fused field; coul
// is 1
extern "C" int lidp_pair_panel_df_whole(
    const double* x, const double* q, const double* typ, const double* mol,
    const double* m, const int* sp, int S, int n, const double* tabs, int t1,
    const double* L, double cut_coulsq, double qqrd2e, double g_ewald,
    int coul, int skip, int cull, int nT, double* boxes, double* part,
    double* partials, unsigned char* kept, int* list, double* f,
    double* e0, double* acc, unsigned long long* stats, void* stream) {
  if (!coul || (mol == nullptr) != (e0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (e0 != nullptr)
    return lidp::launch_pair_whole<double, true, true>(
        x, q, typ, mol, m, sp, S, n, tabs, t1, L, cut_coulsq, qqrd2e,
        g_ewald, skip, cull, nT, boxes, part, partials, kept, list, f, e0, acc,
        stats, stream);
  return lidp::launch_pair_whole<double, true, false>(
      x, q, typ, nullptr, m, sp, S, n, tabs, t1, L, cut_coulsq, qqrd2e,
      g_ewald, skip, cull, nT, boxes, part, partials, kept, list, f, nullptr,
      acc, stats, stream);
}

// atoms per tile of the whole panel, which sizes its scratch: boxes (nT,
// 8), part (nT, nT + 1, 3 or 6, tile), partials (nT (nT + 1) / 2, 8),
// kept (nT (nT + 1) / 2 bytes) and list (nT (nT + 1) / 2 + 2 ints), nT =
// ceil(n / tile)
extern "C" int lidp_pair_panel_df_whole_tile() {
  return lidp::PairTile<double>::BT;
}
