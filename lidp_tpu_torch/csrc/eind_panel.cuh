// The eind panel: E_ind = -T.mu with Thole exponential damping, for
// T = float (eind_panel.cu) and T = double (eind_panel_df.cu).
//
// Per pair (i != j, alpha_i != 0, alpha_j != 0):
//   E_i -= -3 l2 r^-5 (mu_j . d) d + l1 r^-3 mu_j,   d = mi(x_i - x_j).
// The rows' dipoles are never read (the contraction consumes column
// dipoles only), so the row operand is x and alpha_eff alone.
//
// The design keeps every per-pair value in registers, reads each column
// from L2 once per CTA through a shared-memory tile, and gives each row 8
// lanes so many warps per SM are resident to hide the SFU and FMA
// latencies.  Masks are selects, not branches, exactly as the TPU kernel
// applies them.
#pragma once

#include "panel_common.cuh"

namespace lidp {

template <typename T, int DAMP>
__global__ void __launch_bounds__(THREADS)
eind_kernel(const T* __restrict__ xr, const T* __restrict__ ar, int nrows,
            int row0, const T* __restrict__ xc, const T* __restrict__ ac,
            const T* __restrict__ muc, int npad, const T* __restrict__ Lp,
            T pd, T* __restrict__ out) {
  __shared__ T sx[TILE], sy[TILE], sz[TILE], sa[TILE];
  __shared__ T smx[TILE], smy[TILE], smz[TILE];
  const int lane = threadIdx.x % LANES;
  const int i = blockIdx.x * ROWS + threadIdx.x / LANES;
  const int ic = i < nrows ? i : nrows - 1;
  const T Lx = Lp[0], Ly = Lp[1], Lz = Lp[2];
  const T Lix = T(1) / Lx, Liy = T(1) / Ly, Liz = T(1) / Lz;
  const T xi = xr[3 * ic], yi = xr[3 * ic + 1], zi = xr[3 * ic + 2];
  const T ai = ar[ic];
  const int gi = row0 + i;
  const T pd2h = T(0.5) * pd * pd, pd3_6 = pd * pd * pd / T(6);
  T ex = T(0), ey = T(0), ez = T(0);

  for (int j0 = 0; j0 < npad; j0 += TILE) {
    const int nt = min(TILE, npad - j0);
    __syncthreads();
    if (threadIdx.x < nt) {
      const int j = j0 + threadIdx.x;
      sx[threadIdx.x] = xc[3 * j];
      sy[threadIdx.x] = xc[3 * j + 1];
      sz[threadIdx.x] = xc[3 * j + 2];
      sa[threadIdx.x] = ac[j];
      smx[threadIdx.x] = muc[3 * j];
      smy[threadIdx.x] = muc[3 * j + 1];
      smz[threadIdx.x] = muc[3 * j + 2];
    }
    __syncthreads();
    for (int t = lane; t < nt; t += LANES) {
      const T dx = mi(xi - sx[t], Lx, Lix);
      const T dy = mi(yi - sy[t], Ly, Liy);
      const T dz = mi(zi - sz[t], Lz, Liz);
      const bool pm = (gi != j0 + t) && (sa[t] != T(0)) && (ai != T(0));
      const T rsq = pm ? dx * dx + dy * dy + dz * dz : T(1);
      const T rinv = rsqrt_(rsq);
      const T r = rsq * rinv;
      const T r2inv = rinv * rinv;
      const T r3inv = r2inv * rinv;
      const T r5inv = r3inv * r2inv;
      T l1 = T(1), l2 = T(1);
      if (DAMP == 1) {
        const T t1 = exp_(-pd * r);
        const T t2 = T(1) + pd * r + pd2h * rsq;
        l1 = T(1) - t1 * t2;
        l2 = T(1) - t1 * (t2 + pd3_6 * rsq * r);
      }
      const T mjx = smx[t], mjy = smy[t], mjz = smz[t];
      const T mdotd = mjx * dx + mjy * dy + mjz * dz;
      const T a1 = pm ? T(-3) * (l2 * r5inv) * mdotd : T(0);
      const T a2 = pm ? l1 * r3inv : T(0);
      ex += a1 * dx + a2 * mjx;
      ey += a1 * dy + a2 * mjy;
      ez += a1 * dz + a2 * mjz;
    }
  }
  ex = row_sum(ex);
  ey = row_sum(ey);
  ez = row_sum(ez);
  if (i < nrows && lane == 0) {
    out[3 * i] = -ex;
    out[3 * i + 1] = -ey;
    out[3 * i + 2] = -ez;
  }
}

// xr (nrows,3), ar (nrows): the row strip; xc (npad,3), ac (npad),
// muc (npad,3): the columns; L (3,) on the device; out (nrows,3).
template <typename T>
int launch_eind(const T* xr, const T* ar, int nrows, int row0, const T* xc,
                const T* ac, const T* muc, int npad, const T* L, T pd,
                int damping_type, T* out, void* stream) {
  const dim3 grid(nblocks_for(nrows)), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (damping_type == 1)
    eind_kernel<T, 1><<<grid, block, 0, s>>>(xr, ar, nrows, row0, xc, ac, muc,
                                             npad, L, pd, out);
  else
    eind_kernel<T, 0><<<grid, block, 0, s>>>(xr, ar, nrows, row0, xc, ac, muc,
                                             npad, L, pd, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lidp
