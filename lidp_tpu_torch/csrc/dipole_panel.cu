// dipole_panel: charge-dipole + damped dipole-dipole forces, u_ef, u_dd and
// the pairwise virial rows.
//
// Replaces the TPU kernel lidp_tpu/ops/pallas_panel.py:1140 dipole_panel
// (_dipole_kernel :1037).  Per pair (i != j, mask_j != 0):
//   charge-dipole through the shifted-force tensor M for rsq < cut_coulsq
//   between different molecules (or mol_i == 0), folded by sqrt(qqrd2e);
//   dipole-dipole with Thole exponential damping when alpha_i, alpha_j != 0
//   (no cutoff, no molecule exclusion).
// Padded rows drop out only because their q, alpha_eff and mu are zero, as
// on the TPU.
//
// Bound on the H100: FP32 CUDA-core arithmetic.  The Pallas CostEstimate
// counts 140 flops per pair (plus one exp and one rsqrt); at the slice's
// 12,288 x 12,288 panel that is 21.1 GFLOP, 0.32 ms at the 67 TFLOP/s FP32
// peak, against under 1 MB of operands.  The design is the one of
// eind_panel.cu; the row's dipole and charge stay in registers.
#include "panel_common.cuh"

namespace lidp {

template <int DAMP>
__global__ void __launch_bounds__(THREADS)
dipole_kernel(const float* __restrict__ xr, const float* __restrict__ qr,
              const float* __restrict__ molr, const float* __restrict__ ar,
              const float* __restrict__ mur, int nrows, int row0,
              const float* __restrict__ xc, const float* __restrict__ qc,
              const float* __restrict__ molc, const float* __restrict__ ac,
              const float* __restrict__ muc, const float* __restrict__ mc,
              int npad, const float* __restrict__ Lp, float pd,
              float cut_coulsq, float sqrt_q, float* __restrict__ f,
              float* __restrict__ partials) {
  __shared__ float sx[TILE], sy[TILE], sz[TILE], sq[TILE], smol[TILE];
  __shared__ float sa[TILE], smx[TILE], smy[TILE], smz[TILE], smask[TILE];
  const int lane = threadIdx.x % LANES;
  const int i = blockIdx.x * ROWS + threadIdx.x / LANES;
  const bool valid = i < nrows;
  const int ic = valid ? i : nrows - 1;
  const float Lx = Lp[0], Ly = Lp[1], Lz = Lp[2];
  const float Lix = 1.f / Lx, Liy = 1.f / Ly, Liz = 1.f / Lz;
  const float xi = xr[3 * ic], yi = xr[3 * ic + 1], zi = xr[3 * ic + 2];
  const float qi = qr[ic], moli = molr[ic], ai = ar[ic];
  const float mlx = mur[3 * ic], mly = mur[3 * ic + 1], mlz = mur[3 * ic + 2];
  const int gi = row0 + i;
  const float f_shift = -1.f / cut_coulsq;
  const float pd2 = pd * pd, pd3 = pd * pd * pd;
  const float pd2h = 0.5f * pd * pd, pd3_6 = pd * pd * pd / 6.f;

  float fx = 0.f, fy = 0.f, fz = 0.f;
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
      sa[threadIdx.x] = ac[j];
      smx[threadIdx.x] = muc[3 * j];
      smy[threadIdx.x] = muc[3 * j + 1];
      smz[threadIdx.x] = muc[3 * j + 2];
      smask[threadIdx.x] = mc[j];
    }
    __syncthreads();
    for (int t = lane; t < nt; t += LANES) {
      const float dx = mi(xi - sx[t], Lx, Lix);
      const float dy = mi(yi - sy[t], Ly, Liy);
      const float dz = mi(zi - sz[t], Lz, Liz);
      const bool pm = (gi != j0 + t) && (smask[t] != 0.f);
      const float rsq = pm ? dx * dx + dy * dy + dz * dz : 1.f;
      const float rinv = rsqrtf(rsq);
      const float r = rsq * rinv;
      const float r2inv = rinv * rinv;
      const float r3inv = r2inv * rinv;
      const float xsq = dx * dx, ysq = dy * dy, zsq = dz * dz;
      const float qj = sq[t], molj = smol[t];
      const bool cd = pm && (rsq < cut_coulsq) &&
                      ((moli != molj) || (moli == 0.f));
      const float mxx = (-2.f * xsq + ysq + zsq) * r2inv + f_shift * (ysq + zsq);
      const float myy = (-2.f * ysq + xsq + zsq) * r2inv + f_shift * (xsq + zsq);
      const float mzz = (-2.f * zsq + xsq + ysq) * r2inv + f_shift * (xsq + ysq);
      const float mxy = -3.f * dx * dy * r2inv - f_shift * dx * dy;
      const float mxz = -3.f * dx * dz * r2inv - f_shift * dx * dz;
      const float myz = -3.f * dy * dz * r2inv - f_shift * dy * dz;
      const float mcx = smx[t], mcy = smy[t], mcz = smz[t];
      const float cf_j = cd ? qj * sqrt_q * r3inv : 0.f;
      const float cf_i = cd ? qi * sqrt_q * r3inv : 0.f;
      const float fcdx = cf_j * (mxx * mlx + mxy * mly + mxz * mlz) -
                         cf_i * (mxx * mcx + mxy * mcy + mxz * mcz);
      const float fcdy = cf_j * (mxy * mlx + myy * mly + myz * mlz) -
                         cf_i * (mxy * mcx + myy * mcy + myz * mcz);
      const float fcdz = cf_j * (mxz * mlx + myz * mly + mzz * mlz) -
                         cf_i * (mxz * mcx + myz * mcy + mzz * mcz);
      const float ef_t = (cd ? (r2inv + f_shift) * rinv * sqrt_q : 0.f) * qj;
      acc[0] -= mlx * ef_t * dx + mly * ef_t * dy + mlz * ef_t * dz;

      const bool dd = pm && (ai != 0.f) && (sa[t] != 0.f);
      const float r5inv = r3inv * r2inv;
      const float r7inv = r5inv * r2inv;
      const float pdotp = mlx * mcx + mly * mcy + mlz * mcz;
      const float pidotr = mlx * dx + mly * dy + mlz * dz;
      const float pjdotr = mcx * dx + mcy * dy + mcz * dz;
      float pre1, pre2, pre3, u_pair;
      if (DAMP == 1) {
        const float t1 = expf(-pd * r);
        const float t2 = 1.f + pd * r + pd2h * rsq;
        const float t3 = t2 + pd3_6 * rsq * r;
        pre1 = 3.f * r5inv * pdotp * (1.f - t1 * t2) -
               15.f * r7inv * pidotr * pjdotr * (1.f - t1 * t3);
        pre2 = 3.f * r5inv * pjdotr * (1.f - t1 * t3);
        pre3 = 3.f * r5inv * pidotr * (1.f - t1 * t3);
        const float pre4 =
            -pdotp * r3inv * (-t1 * (pd * rinv + pd2) + t1 * pd * t2 * rinv);
        const float pre5 = 3.f * pidotr * pjdotr * r5inv *
                           (-t1 * (pd * rinv + pd2 + 0.5f * r * pd3) +
                            t1 * pd * t3 * rinv);
        u_pair = r3inv * pdotp * (1.f - t1 * t2) -
                 3.f * r5inv * pidotr * pjdotr * (1.f - t1 * t3);
        pre1 += pre4 + pre5;
      } else {
        pre1 = 3.f * r5inv * pdotp - 15.f * r7inv * pidotr * pjdotr;
        pre2 = 3.f * r5inv * pjdotr;
        pre3 = 3.f * r5inv * pidotr;
        u_pair = r3inv * pdotp - 3.f * r5inv * pidotr * pjdotr;
      }
      pre1 = dd ? pre1 : 0.f;
      pre2 = dd ? pre2 : 0.f;
      pre3 = dd ? pre3 : 0.f;
      const float fpx = fcdx + pre1 * dx + pre2 * mlx + pre3 * mcx;
      const float fpy = fcdy + pre1 * dy + pre2 * mly + pre3 * mcy;
      const float fpz = fcdz + pre1 * dz + pre2 * mlz + pre3 * mcz;
      acc[1] += dd ? u_pair : 0.f;
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
    for (int k = 0; k < NACC; ++k) acc[k] = 0.f;
  }
  block_partials(acc, partials);
}

}  // namespace lidp

// Rows: xr (nrows,3), qr, molr, ar (alpha_eff), mur (nrows,3).  Columns:
// xc (npad,3), qc, molc, ac, muc (npad,3), mc (mask).  Outputs f (nrows,3);
// partials (nblocks,8) scratch; acc (8,) = [u_ef u_dd vxx vyy vzz vxy vxz
// vyz] with u_dd and the virial rows half-weight.
extern "C" int lidp_dipole_panel(
    const float* xr, const float* qr, const float* molr, const float* ar,
    const float* mur, int nrows, int row0, const float* xc, const float* qc,
    const float* molc, const float* ac, const float* muc, const float* mc,
    int npad, const float* L, float pd, float cut_coulsq, float sqrt_q,
    int damping_type, float* f, float* partials, float* acc, void* stream) {
  const int nb = lidp::nblocks_for(nrows);
  const dim3 grid(nb), block(lidp::THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (damping_type == 1)
    lidp::dipole_kernel<1><<<grid, block, 0, s>>>(
        xr, qr, molr, ar, mur, nrows, row0, xc, qc, molc, ac, muc, mc, npad,
        L, pd, cut_coulsq, sqrt_q, f, partials);
  else
    lidp::dipole_kernel<0><<<grid, block, 0, s>>>(
        xr, qr, molr, ar, mur, nrows, row0, xc, qc, molc, ac, muc, mc, npad,
        L, pd, cut_coulsq, sqrt_q, f, partials);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  lidp::reduce_partials<<<1, 32, 0, s>>>(partials, nb, 1.f, 0.5f, acc);
  return static_cast<int>(cudaGetLastError());
}
