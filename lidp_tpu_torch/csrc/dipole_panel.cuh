// The dipole panel: charge-dipole + damped dipole-dipole forces, u_ef, u_dd
// and the pairwise virial rows, for T = float (dipole_panel.cu) and
// T = double (dipole_panel_df.cu).
//
// Per pair (i != j, mask_j != 0):
//   charge-dipole through the shifted-force tensor M for rsq < cut_coulsq
//   between different molecules (or mol_i == 0), folded by sqrt(qqrd2e);
//   dipole-dipole with Thole exponential damping when alpha_i, alpha_j != 0
//   (no cutoff, no molecule exclusion).
// Padded rows drop out only because their q, alpha_eff and mu are zero, as
// on the TPU.  The design is the one of eind_panel.cuh; the row's dipole
// and charge stay in registers.
#pragma once

#include "panel_common.cuh"

namespace lidp {

template <typename T, int DAMP>
__global__ void __launch_bounds__(THREADS)
dipole_kernel(const T* __restrict__ xr, const T* __restrict__ qr,
              const T* __restrict__ molr, const T* __restrict__ ar,
              const T* __restrict__ mur, int nrows, int row0,
              const T* __restrict__ xc, const T* __restrict__ qc,
              const T* __restrict__ molc, const T* __restrict__ ac,
              const T* __restrict__ muc, const T* __restrict__ mc,
              int npad, const T* __restrict__ Lp, T pd,
              T cut_coulsq, T sqrt_q, T* __restrict__ f,
              T* __restrict__ partials) {
  __shared__ T sx[TILE], sy[TILE], sz[TILE], sq[TILE], smol[TILE];
  __shared__ T sa[TILE], smx[TILE], smy[TILE], smz[TILE], smask[TILE];
  const int lane = threadIdx.x % LANES;
  const int i = blockIdx.x * ROWS + threadIdx.x / LANES;
  const bool valid = i < nrows;
  const int ic = valid ? i : nrows - 1;
  const T Lx = Lp[0], Ly = Lp[1], Lz = Lp[2];
  const T Lix = T(1) / Lx, Liy = T(1) / Ly, Liz = T(1) / Lz;
  const T xi = xr[3 * ic], yi = xr[3 * ic + 1], zi = xr[3 * ic + 2];
  const T qi = qr[ic], moli = molr[ic], ai = ar[ic];
  const T mlx = mur[3 * ic], mly = mur[3 * ic + 1], mlz = mur[3 * ic + 2];
  const int gi = row0 + i;
  const T f_shift = T(-1) / cut_coulsq;
  const T pd2 = pd * pd, pd3 = pd * pd * pd;
  const T pd2h = T(0.5) * pd * pd, pd3_6 = pd * pd * pd / T(6);

  T fx = T(0), fy = T(0), fz = T(0);
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
      smol[threadIdx.x] = molc[j];
      sa[threadIdx.x] = ac[j];
      smx[threadIdx.x] = muc[3 * j];
      smy[threadIdx.x] = muc[3 * j + 1];
      smz[threadIdx.x] = muc[3 * j + 2];
      smask[threadIdx.x] = mc[j];
    }
    __syncthreads();
    for (int t = lane; t < nt; t += LANES) {
      const T dx = mi(xi - sx[t], Lx, Lix);
      const T dy = mi(yi - sy[t], Ly, Liy);
      const T dz = mi(zi - sz[t], Lz, Liz);
      const bool pm = (gi != j0 + t) && (smask[t] != T(0));
      const T rsq = pm ? dx * dx + dy * dy + dz * dz : T(1);
      const T rinv = rsqrt_(rsq);
      const T r = rsq * rinv;
      const T r2inv = rinv * rinv;
      const T r3inv = r2inv * rinv;
      const T xsq = dx * dx, ysq = dy * dy, zsq = dz * dz;
      const T qj = sq[t], molj = smol[t];
      const bool cd = pm && (rsq < cut_coulsq) &&
                      ((moli != molj) || (moli == T(0)));
      const T mxx = (T(-2) * xsq + ysq + zsq) * r2inv + f_shift * (ysq + zsq);
      const T myy = (T(-2) * ysq + xsq + zsq) * r2inv + f_shift * (xsq + zsq);
      const T mzz = (T(-2) * zsq + xsq + ysq) * r2inv + f_shift * (xsq + ysq);
      const T mxy = T(-3) * dx * dy * r2inv - f_shift * dx * dy;
      const T mxz = T(-3) * dx * dz * r2inv - f_shift * dx * dz;
      const T myz = T(-3) * dy * dz * r2inv - f_shift * dy * dz;
      const T mcx = smx[t], mcy = smy[t], mcz = smz[t];
      const T cf_j = cd ? qj * sqrt_q * r3inv : T(0);
      const T cf_i = cd ? qi * sqrt_q * r3inv : T(0);
      const T fcdx = cf_j * (mxx * mlx + mxy * mly + mxz * mlz) -
                         cf_i * (mxx * mcx + mxy * mcy + mxz * mcz);
      const T fcdy = cf_j * (mxy * mlx + myy * mly + myz * mlz) -
                         cf_i * (mxy * mcx + myy * mcy + myz * mcz);
      const T fcdz = cf_j * (mxz * mlx + myz * mly + mzz * mlz) -
                         cf_i * (mxz * mcx + myz * mcy + mzz * mcz);
      const T ef_t = (cd ? (r2inv + f_shift) * rinv * sqrt_q : T(0)) * qj;
      acc[0] -= mlx * ef_t * dx + mly * ef_t * dy + mlz * ef_t * dz;

      const bool dd = pm && (ai != T(0)) && (sa[t] != T(0));
      const T r5inv = r3inv * r2inv;
      const T r7inv = r5inv * r2inv;
      const T pdotp = mlx * mcx + mly * mcy + mlz * mcz;
      const T pidotr = mlx * dx + mly * dy + mlz * dz;
      const T pjdotr = mcx * dx + mcy * dy + mcz * dz;
      T pre1, pre2, pre3, u_pair;
      if (DAMP == 1) {
        const T t1 = exp_(-pd * r);
        const T t2 = T(1) + pd * r + pd2h * rsq;
        const T t3 = t2 + pd3_6 * rsq * r;
        pre1 = T(3) * r5inv * pdotp * (T(1) - t1 * t2) -
               T(15) * r7inv * pidotr * pjdotr * (T(1) - t1 * t3);
        pre2 = T(3) * r5inv * pjdotr * (T(1) - t1 * t3);
        pre3 = T(3) * r5inv * pidotr * (T(1) - t1 * t3);
        const T pre4 =
            -pdotp * r3inv * (-t1 * (pd * rinv + pd2) + t1 * pd * t2 * rinv);
        const T pre5 = T(3) * pidotr * pjdotr * r5inv *
                           (-t1 * (pd * rinv + pd2 + T(0.5) * r * pd3) +
                            t1 * pd * t3 * rinv);
        u_pair = r3inv * pdotp * (T(1) - t1 * t2) -
                 T(3) * r5inv * pidotr * pjdotr * (T(1) - t1 * t3);
        pre1 += pre4 + pre5;
      } else {
        pre1 = T(3) * r5inv * pdotp - T(15) * r7inv * pidotr * pjdotr;
        pre2 = T(3) * r5inv * pjdotr;
        pre3 = T(3) * r5inv * pidotr;
        u_pair = r3inv * pdotp - T(3) * r5inv * pidotr * pjdotr;
      }
      pre1 = dd ? pre1 : T(0);
      pre2 = dd ? pre2 : T(0);
      pre3 = dd ? pre3 : T(0);
      const T fpx = fcdx + pre1 * dx + pre2 * mlx + pre3 * mcx;
      const T fpy = fcdy + pre1 * dy + pre2 * mly + pre3 * mcy;
      const T fpz = fcdz + pre1 * dz + pre2 * mlz + pre3 * mcz;
      acc[1] += dd ? u_pair : T(0);
      fx += fpx;
      fy += fpy;
      fz += fpz;
      acc[2] += dx * fpx;
      acc[3] += dy * fpy;
      acc[4] += dz * fpz;
      acc[5] += dx * fpy;
      acc[6] += dx * fpz;
      acc[7] += dy * fpz;
    }
  }
  fx = row_sum(fx);
  fy = row_sum(fy);
  fz = row_sum(fz);
  if (valid && lane == 0) {
    f[3 * i] = fx;
    f[3 * i + 1] = fy;
    f[3 * i + 2] = fz;
  }
  if (!valid) {
#pragma unroll
    for (int k = 0; k < NACC; ++k) acc[k] = T(0);
  }
  block_partials(acc, partials);
}


// Rows: xr (nrows,3), qr, molr, ar (alpha_eff), mur (nrows,3).  Columns:
// xc (npad,3), qc, molc, ac, muc (npad,3), mc (mask).  Outputs f (nrows,3);
// partials (nblocks,8) scratch; acc (8,) = [u_ef u_dd vxx vyy vzz vxy vxz
// vyz] with u_dd and the virial rows half-weight.
template <typename T>
int launch_dipole(const T* xr, const T* qr, const T* molr, const T* ar,
                  const T* mur, int nrows, int row0, const T* xc, const T* qc,
                  const T* molc, const T* ac, const T* muc, const T* mc,
                  int npad, const T* L, T pd, T cut_coulsq, T sqrt_q,
                  int damping_type, T* f, T* partials, T* acc, void* stream) {
  const int nb = nblocks_for(nrows);
  const dim3 grid(nb), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (damping_type == 1)
    dipole_kernel<T, 1><<<grid, block, 0, s>>>(
        xr, qr, molr, ar, mur, nrows, row0, xc, qc, molc, ac, muc, mc, npad,
        L, pd, cut_coulsq, sqrt_q, f, partials);
  else
    dipole_kernel<T, 0><<<grid, block, 0, s>>>(
        xr, qr, molr, ar, mur, nrows, row0, xc, qc, molc, ac, muc, mc, npad,
        L, pd, cut_coulsq, sqrt_q, f, partials);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_partials<T><<<1, REDUCE_THREADS, 0, s>>>(partials, nb, T(1),
                                                  T(0.5), acc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lidp
