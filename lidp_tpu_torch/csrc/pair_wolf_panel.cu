// pair_wolf_panel: dense LJ + coul/long pair forces with half-weight
// evdwl/ecoul tallies and the 6-term virial, fused with the unscaled Wolf
// static field E0 from the same geometry.
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:1386 pair_wolf_panel
// (_pair_wolf_kernel :1293).  Per pair (i != j, mask_j != 0):
//   LJ for rsq < min(cutsq_u, cut_ljsq[ti,tj]) unless j is one of i's
//   special neighbours (excluded in-pass, _excl_mask :112);
//   coulomb prefactor*(erfc + EWALD_F g r e^{-g^2 r^2}) / r^2 for
//   rsq < cut_coulsq, erfc by the reference's A&S polynomial;
//   E0 += q_j (1/r^2 - 1/rc^2)/r d for rsq <= cut_coulsq between
//   different molecules (or mol_i == 0).  The caller scales E0 by
//   sqrt(qqrd2e).
// The TPU gathers per-row type tables outside the kernel and forms
// per-pair values with a one-hot MXU matmul; here the (T1 x T1) tables sit
// in shared memory and are indexed by (t_i, t_j).  The outer cutoff is the
// single cutsq_u = max(tabs[4]).
//
// Bound on the H100: FP32 CUDA-core arithmetic.  The Pallas CostEstimate
// counts 100 flops per pair (plus one exp, one rsqrt, two reciprocals); at
// the slice's 12,288 x 12,288 panel that is 15.1 GFLOP, 0.23 ms at the
// 67 TFLOP/s FP32 peak, against under 1 MB of operands.  The design is the
// one of eind_panel.cu: shared-memory column tiles, 8 lanes per row,
// branchless selects, the row's special list held in registers.
#include "panel_common.cuh"

namespace lidp {

constexpr int MAX_T1 = 16;   // type-table edge (types 0..15)

// A&S erfc constants (pair_lj_cut_coul_long_polarization.cpp:43-49)
constexpr float EWALD_F = 1.12837917f;
constexpr float EWALD_P = 0.3275911f;
constexpr float A1 = 0.254829592f;
constexpr float A2 = -0.284496736f;
constexpr float A3 = 1.421413741f;
constexpr float A4 = -1.453152027f;
constexpr float A5 = 1.061405429f;

template <int MAXS>
__global__ void __launch_bounds__(THREADS)
pair_wolf_kernel(const float* __restrict__ xr, const float* __restrict__ qr,
                 const float* __restrict__ tr, const float* __restrict__ molr,
                 const int* __restrict__ sp, int S, int nrows, int row0,
                 const float* __restrict__ xc, const float* __restrict__ qc,
                 const float* __restrict__ tc, const float* __restrict__ molc,
                 const float* __restrict__ mc, int npad,
                 const float* __restrict__ tabs, int t1,
                 const float* __restrict__ Lp, float cut_coulsq,
                 float qqrd2e, float g_ewald, float* __restrict__ f,
                 float* __restrict__ e0, float* __restrict__ partials) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], sq[TILE], smol[TILE];
  __shared__ float smask[TILE];
  __shared__ int st[TILE];
  __shared__ float tab[5][MAX_T1 * MAX_T1];
  const int nt2 = t1 * t1;
  for (int k = threadIdx.x; k < 5 * nt2; k += THREADS)
    tab[k / nt2][k % nt2] = tabs[k];

  const int lane = threadIdx.x % LANES;
  const int i = blockIdx.x * ROWS + threadIdx.x / LANES;
  const bool valid = i < nrows;
  const int ic = valid ? i : nrows - 1;
  const float Lx = Lp[0], Ly = Lp[1], Lz = Lp[2];
  const float Lix = 1.f / Lx, Liy = 1.f / Ly, Liz = 1.f / Lz;
  const float xi = xr[3 * ic], yi = xr[3 * ic + 1], zi = xr[3 * ic + 2];
  const float qi = qr[ic], moli = molr[ic];
  const int ti = __float2int_rn(tr[ic]);
  const int gi = row0 + i;
  int spi[MAXS > 0 ? MAXS : 1];
#pragma unroll
  for (int s = 0; s < MAXS; ++s) spi[s] = s < S ? sp[ic * S + s] : -1;
  const float f_shift = -1.f / cut_coulsq;
  const float qq_i = qqrd2e * qi;

  __syncthreads();
  float cutsq_u = 0.f;
  for (int k = 0; k < nt2; ++k) cutsq_u = fmaxf(cutsq_u, tab[4][k]);
  const float* lj3r = &tab[0][ti * t1];
  const float* lj4r = &tab[1][ti * t1];
  const float* offr = &tab[2][ti * t1];
  const float* cljr = &tab[3][ti * t1];

  float fx = 0.f, fy = 0.f, fz = 0.f, ex = 0.f, ey = 0.f, ez = 0.f;
  float acc[NACC] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  for (int j0 = 0; j0 < npad; j0 += TILE) {
    const int nt = min(TILE, npad - j0);
    __syncthreads();
    if (threadIdx.x < nt) {
      const int j = j0 + threadIdx.x;
      sx[threadIdx.x] = xc[3 * j];
      sy[threadIdx.x] = xc[3 * j + 1];
      sz[threadIdx.x] = xc[3 * j + 2];
      sq[threadIdx.x] = qc[j];
      smol[threadIdx.x] = molc[j];
      smask[threadIdx.x] = mc[j];
      st[threadIdx.x] = __float2int_rn(tc[j]);
    }
    __syncthreads();
    for (int t = lane; t < nt; t += LANES) {
      const int gj = j0 + t;
      const float dx = mi(xi - sx[t], Lx, Lix);
      const float dy = mi(yi - sy[t], Ly, Liy);
      const float dz = mi(zi - sz[t], Lz, Liz);
      const bool pm = (gi != gj) && (smask[t] != 0.f);
      const float rsq = pm ? dx * dx + dy * dy + dz * dz : 1.f;
      const bool in_range = pm && (rsq < cutsq_u);
      const int tj = st[t];
      bool lj_mask = in_range && (rsq < cljr[tj]);
#pragma unroll
      for (int s = 0; s < MAXS; ++s) lj_mask = lj_mask && (spi[s] != gj);
      const float r2inv = 1.f / rsq;
      const float r6inv = r2inv * r2inv * r2inv;
      const float lj3 = lj3r[tj], lj4 = lj4r[tj];
      const float forcelj =
          lj_mask ? r6inv * (12.f * lj3 * r6inv - 6.f * lj4) : 0.f;
      const float evdwl = lj_mask ? r6inv * (lj3 * r6inv - lj4) - offr[tj]
                                  : 0.f;
      const bool coul_mask = in_range && (rsq < cut_coulsq);
      const float rinv = rsqrtf(rsq);
      const float r = rsq * rinv;
      const float grij = g_ewald * r;
      const float expm2 = expf(-grij * grij);
      const float tt = 1.f / (1.f + EWALD_P * grij);
      const float erfc =
          tt * (A1 + tt * (A2 + tt * (A3 + tt * (A4 + tt * A5)))) * expm2;
      const float prefactor = qq_i * sq[t] * rinv;
      const float forcecoul =
          coul_mask ? prefactor * (erfc + EWALD_F * grij * expm2) : 0.f;
      const float ecoul = coul_mask ? prefactor * erfc : 0.f;
      const float fpair = (forcecoul + forcelj) * r2inv;
      const float px = fpair * dx, py = fpair * dy, pz = fpair * dz;
      fx += px;
      fy += py;
      fz += pz;
      acc[0] += evdwl;
      acc[1] += ecoul;
      acc[2] += px * dx;
      acc[3] += py * dy;
      acc[4] += pz * dz;
      acc[5] += px * dy;
      acc[6] += px * dz;
      acc[7] += py * dz;
      const float molj = smol[t];
      const bool winc = pm && (rsq <= cut_coulsq) &&
                        ((moli != molj) || (moli == 0.f));
      const float efq = (winc ? (r2inv + f_shift) * rinv : 0.f) * sq[t];
      ex += efq * dx;
      ey += efq * dy;
      ez += efq * dz;
    }
  }
  fx = row_sum(fx);
  fy = row_sum(fy);
  fz = row_sum(fz);
  ex = row_sum(ex);
  ey = row_sum(ey);
  ez = row_sum(ez);
  if (valid && lane == 0) {
    f[3 * i] = fx;
    f[3 * i + 1] = fy;
    f[3 * i + 2] = fz;
    e0[3 * i] = ex;
    e0[3 * i + 1] = ey;
    e0[3 * i + 2] = ez;
  }
  if (!valid) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  }
  block_partials(acc, partials);
}

}  // namespace lidp

// Rows: xr (nrows,3), qr, tr (types as f32), molr (nrows); sp (nrows,S)
// int32 special-neighbour indices or null with S = 0.  Columns: xc (npad,3),
// qc, tc, molc, mc (npad).  tabs (5,t1,t1) = [lj3 lj4 offset cut_ljsq cutsq].
// Outputs f, e0 (nrows,3); partials (nblocks,8) scratch; acc (8,) =
// [evdwl ecoul vxx vyy vzz vxy vxz vyz], each half-weight.
extern "C" int lidp_pair_wolf_panel(
    const float* xr, const float* qr, const float* tr, const float* molr,
    const int* sp, int S, int nrows, int row0, const float* xc,
    const float* qc, const float* tc, const float* molc, const float* mc,
    int npad, const float* tabs, int t1, const float* L, float cut_coulsq,
    float qqrd2e, float g_ewald, float* f, float* e0, float* partials,
    float* acc, void* stream) {
  const int nb = lidp::nblocks_for(nrows);
  const dim3 grid(nb), block(lidp::THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LIDP_PAIR_WOLF(MAXS)                                               \
  lidp::pair_wolf_kernel<MAXS><<<grid, block, 0, s>>>(                     \
      xr, qr, tr, molr, sp, S, nrows, row0, xc, qc, tc, molc, mc, npad,    \
      tabs, t1, L, cut_coulsq, qqrd2e, g_ewald, f, e0, partials)
  if (S == 0)
    LIDP_PAIR_WOLF(0);
  else if (S <= 8)
    LIDP_PAIR_WOLF(8);
  else
    LIDP_PAIR_WOLF(16);
#undef LIDP_PAIR_WOLF
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  lidp::reduce_partials<<<1, 32, 0, s>>>(partials, nb, 0.5f, 0.5f, acc);
  return static_cast<int>(cudaGetLastError());
}
