// The pair panel: dense LJ (+ coul/long) pair forces with half-weight
// evdwl/ecoul tallies and the 6-term virial, optionally fused with the
// unscaled Wolf static field E0 from the same geometry.  One kernel
// template serves pair_wolf_panel.cu (float, COUL, WOLF), pair_panel.cu
// (float, COUL or LJ only, no field) and pair_panel_df.cu (double, COUL,
// with or without the field).
//
// Per pair (i != j, mask_j != 0):
//   LJ for rsq < min(cutsq_u, cut_ljsq[ti,tj]) unless j is one of i's
//   special neighbours (excluded in-pass, _excl_mask pallas_panel.py:112);
//   COUL: prefactor*(erfc + EWALD_F g r e^{-g^2 r^2}) / r^2 for
//   rsq < cut_coulsq, erfc by the reference's A&S polynomial (also in the
//   double kernel, never the library erfc);
//   WOLF: E0 += q_j (1/r^2 - 1/rc^2)/r d for rsq <= cut_coulsq between
//   different molecules (or mol_i == 0).  The caller scales E0 by
//   sqrt(qqrd2e).
// The TPU gathers per-row type tables outside the kernel and forms
// per-pair values with a one-hot MXU matmul; here the (T1 x T1) tables sit
// in shared memory and are indexed by (t_i, t_j).  The outer cutoff is the
// single cutsq_u = max(tabs[4]).
//
// The design is the one of eind_panel.cuh: shared-memory column tiles, 8
// lanes per row, branchless selects, the row's special list held in
// registers.
#pragma once

#include "panel_common.cuh"

namespace lidp {

constexpr int MAX_T1 = 16;   // type-table edge (types 0..15)

template <typename T, int MAXS, bool COUL, bool WOLF>
__global__ void __launch_bounds__(THREADS)
pair_kernel(const T* __restrict__ xr, const T* __restrict__ qr,
            const T* __restrict__ tr, const T* __restrict__ molr,
            const int* __restrict__ sp, int S, int nrows, int row0,
            const T* __restrict__ xc, const T* __restrict__ qc,
            const T* __restrict__ tc, const T* __restrict__ molc,
            const T* __restrict__ mc, int npad, const T* __restrict__ tabs,
            int t1, const T* __restrict__ Lp, T cut_coulsq, T qqrd2e,
            T g_ewald, T* __restrict__ f, T* __restrict__ e0,
            T* __restrict__ partials) {
  // A&S erfc constants (pair_lj_cut_coul_long_polarization.cpp:43-49)
  const T EWALD_F = T(1.12837917), EWALD_P = T(0.3275911);
  const T A1 = T(0.254829592), A2 = T(-0.284496736), A3 = T(1.421413741);
  const T A4 = T(-1.453152027), A5 = T(1.061405429);
  __shared__ T sx[TILE], sy[TILE], sz[TILE], sq[TILE], smol[TILE];
  __shared__ T smask[TILE];
  __shared__ int st[TILE];
  __shared__ T tab[5][MAX_T1 * MAX_T1];
  const int nt2 = t1 * t1;
  for (int k = threadIdx.x; k < 5 * nt2; k += THREADS)
    tab[k / nt2][k % nt2] = tabs[k];

  const int lane = threadIdx.x % LANES;
  const int i = blockIdx.x * ROWS + threadIdx.x / LANES;
  const bool valid = i < nrows;
  const int ic = valid ? i : nrows - 1;
  const T Lx = Lp[0], Ly = Lp[1], Lz = Lp[2];
  const T Lix = T(1) / Lx, Liy = T(1) / Ly, Liz = T(1) / Lz;
  const T xi = xr[3 * ic], yi = xr[3 * ic + 1], zi = xr[3 * ic + 2];
  const T qi = qr[ic];
  T moli = T(0);
  if (WOLF) moli = molr[ic];
  const int ti = to_int(tr[ic]);
  const int gi = row0 + i;
  int spi[MAXS > 0 ? MAXS : 1];
#pragma unroll
  for (int s = 0; s < MAXS; ++s) spi[s] = s < S ? sp[ic * S + s] : -1;
  const T f_shift = T(-1) / cut_coulsq;
  const T qq_i = qqrd2e * qi;

  __syncthreads();
  T cutsq_u = T(0);
  for (int k = 0; k < nt2; ++k) cutsq_u = max_(cutsq_u, tab[4][k]);
  const T* lj3r = &tab[0][ti * t1];
  const T* lj4r = &tab[1][ti * t1];
  const T* offr = &tab[2][ti * t1];
  const T* cljr = &tab[3][ti * t1];

  T fx = T(0), fy = T(0), fz = T(0), ex = T(0), ey = T(0), ez = T(0);
  T acc[NACC] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};

  for (int j0 = 0; j0 < npad; j0 += TILE) {
    const int nt = min(TILE, npad - j0);
    __syncthreads();
    if (threadIdx.x < nt) {
      const int j = j0 + threadIdx.x;
      sx[threadIdx.x] = xc[3 * j];
      sy[threadIdx.x] = xc[3 * j + 1];
      sz[threadIdx.x] = xc[3 * j + 2];
      sq[threadIdx.x] = qc[j];
      if (WOLF) smol[threadIdx.x] = molc[j];
      smask[threadIdx.x] = mc[j];
      st[threadIdx.x] = to_int(tc[j]);
    }
    __syncthreads();
    for (int t = lane; t < nt; t += LANES) {
      const int gj = j0 + t;
      const T dx = mi(xi - sx[t], Lx, Lix);
      const T dy = mi(yi - sy[t], Ly, Liy);
      const T dz = mi(zi - sz[t], Lz, Liz);
      const bool pm = (gi != gj) && (smask[t] != T(0));
      const T rsq = pm ? dx * dx + dy * dy + dz * dz : T(1);
      const bool in_range = pm && (rsq < cutsq_u);
      const int tj = st[t];
      bool lj_mask = in_range && (rsq < cljr[tj]);
#pragma unroll
      for (int s = 0; s < MAXS; ++s) lj_mask = lj_mask && (spi[s] != gj);
      const T r2inv = T(1) / rsq;
      const T r6inv = r2inv * r2inv * r2inv;
      const T lj3 = lj3r[tj], lj4 = lj4r[tj];
      const T forcelj =
          lj_mask ? r6inv * (T(12) * lj3 * r6inv - T(6) * lj4) : T(0);
      const T evdwl = lj_mask ? r6inv * (lj3 * r6inv - lj4) - offr[tj] : T(0);
      T rinv = T(0), forcecoul = T(0), ecoul = T(0);
      if (COUL || WOLF) rinv = rsqrt_(rsq);
      if (COUL) {
        const bool coul_mask = in_range && (rsq < cut_coulsq);
        const T r = rsq * rinv;
        const T grij = g_ewald * r;
        const T expm2 = exp_(-grij * grij);
        const T tt = T(1) / (T(1) + EWALD_P * grij);
        const T erfc =
            tt * (A1 + tt * (A2 + tt * (A3 + tt * (A4 + tt * A5)))) * expm2;
        const T prefactor = qq_i * sq[t] * rinv;
        forcecoul =
            coul_mask ? prefactor * (erfc + EWALD_F * grij * expm2) : T(0);
        ecoul = coul_mask ? prefactor * erfc : T(0);
      }
      const T fpair = (forcecoul + forcelj) * r2inv;
      const T px = fpair * dx, py = fpair * dy, pz = fpair * dz;
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
      if (WOLF) {
        const T molj = smol[t];
        const bool winc = pm && (rsq <= cut_coulsq) &&
                          ((moli != molj) || (moli == T(0)));
        const T efq = (winc ? (r2inv + f_shift) * rinv : T(0)) * sq[t];
        ex += efq * dx;
        ey += efq * dy;
        ez += efq * dz;
      }
    }
  }
  fx = row_sum(fx);
  fy = row_sum(fy);
  fz = row_sum(fz);
  if (WOLF) {
    ex = row_sum(ex);
    ey = row_sum(ey);
    ez = row_sum(ez);
  }
  if (valid && lane == 0) {
    f[3 * i] = fx;
    f[3 * i + 1] = fy;
    f[3 * i + 2] = fz;
    if (WOLF) {
      e0[3 * i] = ex;
      e0[3 * i + 1] = ey;
      e0[3 * i + 2] = ez;
    }
  }
  if (!valid) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = T(0);
  }
  block_partials(acc, partials);
}

// Rows: xr (nrows,3), qr, tr (types in T), molr (nrows, WOLF only); sp
// (nrows,S) int32 special-neighbour indices or null with S = 0.  Columns:
// xc (npad,3), qc, tc, molc (WOLF only), mc (npad).  tabs (5,t1,t1) =
// [lj3 lj4 offset cut_ljsq cutsq].  Outputs f, e0 (WOLF only) (nrows,3);
// partials (nblocks,8) scratch; acc (8,) = [evdwl ecoul vxx vyy vzz vxy vxz
// vyz], each half-weight.
template <typename T, bool COUL, bool WOLF>
int launch_pair(const T* xr, const T* qr, const T* tr, const T* molr,
                const int* sp, int S, int nrows, int row0, const T* xc,
                const T* qc, const T* tc, const T* molc, const T* mc,
                int npad, const T* tabs, int t1, const T* L, T cut_coulsq,
                T qqrd2e, T g_ewald, T* f, T* e0, T* partials, T* acc,
                void* stream) {
  const int nb = nblocks_for(nrows);
  const dim3 grid(nb), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LIDP_PAIR(MAXS)                                                    \
  pair_kernel<T, MAXS, COUL, WOLF><<<grid, block, 0, s>>>(                 \
      xr, qr, tr, molr, sp, S, nrows, row0, xc, qc, tc, molc, mc, npad,    \
      tabs, t1, L, cut_coulsq, qqrd2e, g_ewald, f, e0, partials)
  if (S == 0)
    LIDP_PAIR(0);
  else if (S <= 8)
    LIDP_PAIR(8);
  else
    LIDP_PAIR(16);
#undef LIDP_PAIR
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_partials<T><<<1, REDUCE_THREADS, 0, s>>>(partials, nb, T(0.5),
                                                  T(0.5), acc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lidp
