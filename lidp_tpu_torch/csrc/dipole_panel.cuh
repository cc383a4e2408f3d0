// The dipole panel: charge-dipole + damped dipole-dipole forces, u_ef, u_dd
// and the pairwise virial rows, for T = float (dipole_panel.cu) and
// T = double (dipole_panel_df.cu).
//
// The function, row by row as the TPU kernel states it (i != j, mask_j):
//   charge-dipole through the shifted-force tensor M for rsq < cut_coulsq
//   between different molecules (or mol_i == 0), folded by sqrt(qqrd2e);
//   dipole-dipole with Thole exponential damping when alpha_i, alpha_j != 0
//   (no cutoff, no molecule exclusion).
// Padded rows drop out only because their q, alpha_eff and mu are zero.
// rsq is formed unfused (rsq_rn) in both kernels, so that kernel and plain
// version put every pair on the same side of cut_coulsq.
//
// Two kernels:
//  * dipole_whole_kernel, the whole square panel (cols is None): each
//    unordered pair once, applied to both atoms, on the tile-pair schedule,
//    slots and slot-order sum of eind_whole_kernel (panel_common.cuh).
//    With d = mi(x_i - x_j) (and mi(x_j - x_i) = -d exactly, see
//    eind_panel.cuh), one evaluation gives
//      F_cd = sqrt_q r^-3 [h (q_j mu_i - q_i mu_j)
//                          - e (q_j mu_i.d - q_i mu_j.d) d],
//        w = r^-2 + f_shift, h = rsq w, e = 3 r^-2 + f_shift
//        (M = h 1 - e d d^T, the TPU kernel's M term by term),
//      F_dd = pre1 d + pre2 mu_i + pre3 mu_j, with
//        pre1 = 3 r^-2 (v1 - 5 v3) + t1 (pd^4/2 (mu_i.d)(mu_j.d) r^-3
//               - pd^3/2 (mu_i.mu_j) r^-2),
//        v1 = r^-3 l1 mu_i.mu_j, v3 = r^-5 l3 (mu_i.d)(mu_j.d),
//        pre2 = 3 r^-5 l3 mu_j.d, pre3 = 3 r^-5 l3 mu_i.d,
//        l1 = 1 - t1 t2, l3 = 1 - t1 t3 (the TPU kernel's pre4 + pre5
//        reduce to the t1 term: pd t2/r - pd/r - pd^2 = pd^3 r/2 and
//        pd t3/r - pd/r - pd^2 - pd^3 r/2 = pd^4 rsq/6),
//        u = v1 - 3 v3;
//    and the force on j is -(F_cd + F_dd): M, r^-3 and pre1 are even in
//    d, and pre2, pre3 swap with a sign.  The masks are not symmetric and
//    stay so: side i takes F_cd where cd and mask_j, side j where cd and
//    mask_i (cd: the cutoff and the molecule test, symmetric in i and j),
//    and likewise F_dd with dd (alpha_i, alpha_j != 0), so a masked atom
//    with a charge still receives charge-dipole force from unmasked atoms
//    and gives none, as in the row form.  u_ef takes both sides'
//    -mu.d q g terms (g = w sqrt_q / r, d negated for side j), u_dd
//    u once for each side that takes F_dd, and the virial d (x) (F_i -
//    F_j), so each pair's two sides enter one term and reduce_partials
//    keeps the row form's half weight for u_dd and the virial (s1 = 0.5).
//    The WT warps share the BT rows of tile I (RW per lane, in registers)
//    and each takes 32 columns of tile J, packed as 16-byte vectors
//    (float4 (x, y, z, q), (mu, mol); double2 (x, y), (z, q), (mu_x,
//    mu_y), (mu_z, mol)) and a flag word (mask, alpha != 0); lane l meets
//    column (l + t) & 31 at step t and the column's sum travels with it,
//    as in eind_whole_kernel.
//  * dipole_strip_kernel, a row strip against all columns (cols=, row0=):
//    the one-sided row form, 8 lanes per row, the columns staged per CTA
//    in shared memory.  At the whole shape it is the yardstick of the
//    whole-panel kernel.
//
// Exact skips in the whole kernel: a warp votes once per step on each
// group of DG rows (32 x DG pairs).  Where no pair of the group takes the
// charge-dipole block on either side, the warp skips M, F_cd and the u_ef
// terms, and where none takes the dipole-dipole block, the exponential
// and F_dd: every one of those terms would enter through a select as an
// exact zero, so the results are bit for bit those of computing them
// (chip_smoke.py holds this with the skip off).  The fluid's atoms are
// ordered in space, so most tile pairs hold no pair within cut_coul, and
// the padding tiles take neither block.  No damping skip: the t1 term of
// pre1 does not vanish where l1 and l3 round to 1 (eind_panel.cuh's
// skip), and t1 itself underflows only beyond pd*r ~ 104 in float32 (745
// in float64), which the 60 A fluid barely reaches.  `stats`, when not
// null, gains the count of votes and of the votes that skipped each block
// (integer atomics, for measurement only).
//
// No float atomics anywhere: the row sums of the WT warps are added in
// warp order, each atom's slots in slot order, and the CTAs' scalar
// partials by reduce_partials in a fixed order, so results repeat bit for
// bit and do not depend on block order.
#pragma once

#include "panel_common.cuh"

namespace lidp {

// atoms per tile of the whole-panel kernel (and threads per CTA: 32
// columns per warp, BT / 32 warps, BT / 32 rows per lane; the launchers
// export it as lidp_<name>_whole_tile) and the CTAs per SM its register
// budget must allow, by dtype.  Measured on an H100 80GB
// HBM3 at 700 W (scripts/profile_torch_polar.py --path dipole, 12,288
// rows): tiles of 64 took 5-11% longer in float32 (80-93 registers);
// tiles of 128 took 7-12% longer in float64 (218 registers, or 128 with
// 368 bytes spilled); 8 CTAs per SM (at most 128 registers, 60 bytes
// spilled) took 3.4-3.8% less in float64 than the unbounded 160-165
// registers.  In float32 5 CTAs per SM (at most 102 registers; 96, 28
// bytes spilled) took 0-5% less than the kernel bounded to 4 (124
// registers), unbounded (128) or bounded to 1 (134) in three calls.
template <typename T>
struct DipoleTile;
template <>
struct DipoleTile<float> {
  static constexpr int BT = 128, MIN_CTAS = 5;
};
template <>
struct DipoleTile<double> {
  static constexpr int BT = 64, MIN_CTAS = 8;
};
// rows per warp vote: over 1 row x 32 columns the kernel took 1.2% longer
// in float32 and 0.4% in float64
constexpr int DG = 2;

constexpr int FL_MASK = 1, FL_POLAR = 2;  // the flag word's bits

template <typename T>
struct DCol {
  T x, y, z, q, mx, my, mz, mol;
  int fl;
};

template <typename T>
__device__ __forceinline__ DCol<T> load_dcol(
    const T* __restrict__ x, const T* __restrict__ q,
    const T* __restrict__ mol, const T* __restrict__ a,
    const T* __restrict__ mu, const T* __restrict__ m, int j, int n) {
  if (j >= n) return DCol<T>{};  // a padded atom: masked, no charge
  return DCol<T>{x[3 * j],      x[3 * j + 1],  x[3 * j + 2],
                 q[j],          mu[3 * j],     mu[3 * j + 1],
                 mu[3 * j + 2], mol[j],
                 (m[j] != T(0) ? FL_MASK : 0) | (a[j] != T(0) ? FL_POLAR : 0)};
}

template <int W>
__device__ __forceinline__ void put_dcol(float4 (*s)[W], int* fl, int c,
                                         const DCol<float>& v) {
  s[0][c] = make_float4(v.x, v.y, v.z, v.q);
  s[1][c] = make_float4(v.mx, v.my, v.mz, v.mol);
  fl[c] = v.fl;
}
template <int W>
__device__ __forceinline__ void put_dcol(double2 (*s)[W], int* fl, int c,
                                         const DCol<double>& v) {
  s[0][c] = make_double2(v.x, v.y);
  s[1][c] = make_double2(v.z, v.q);
  s[2][c] = make_double2(v.mx, v.my);
  s[3][c] = make_double2(v.mz, v.mol);
  fl[c] = v.fl;
}
template <int W>
__device__ __forceinline__ DCol<float> get_dcol(float4 (*s)[W],
                                                const int* fl, int c) {
  const float4 p = s[0][c], m = s[1][c];
  return DCol<float>{p.x, p.y, p.z, p.w, m.x, m.y, m.z, m.w, fl[c]};
}
template <int W>
__device__ __forceinline__ DCol<double> get_dcol(double2 (*s)[W],
                                                 const int* fl, int c) {
  const double2 p = s[0][c], q = s[1][c], m = s[2][c], n = s[3][c];
  return DCol<double>{p.x, p.y, q.x, q.y, m.x, m.y, n.x, n.y, fl[c]};
}

// Block b takes the tile pair tile_pair(b, nT).  x, q, mol, a (alpha_eff),
// mu, m (mask) of the n atoms (n <= nT * BT; atoms past n are padding);
// part (nT, nT + 1, 3, BT) and partials (nT (nT + 1) / 2, NACC) scratch.
template <typename T, int DAMP>
__global__ void __launch_bounds__(DipoleTile<T>::BT, DipoleTile<T>::MIN_CTAS)
dipole_whole_kernel(const T* __restrict__ x, const T* __restrict__ q,
                    const T* __restrict__ mol, const T* __restrict__ a,
                    const T* __restrict__ mu, const T* __restrict__ m, int n,
                    const T* __restrict__ Lp, T pd, T cut_coulsq, T sqrt_q,
                    int skip, int nT, T* __restrict__ part,
                    T* __restrict__ partials, unsigned long long* stats) {
  constexpr int BT = DipoleTile<T>::BT, WT = BT / 32, RW = BT / 32;
  static_assert(BT % 32 == 0 && RW % DG == 0, "a tile of whole vote groups");
  using V = typename Vec<T>::type;
  __shared__ V scol[WT][Vec<T>::n][32];
  __shared__ int sfl[WT][32];
  __shared__ T srow[WT][3][BT];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const TilePair tp = tile_pair(blockIdx.x, nT);
  const int I = tp.I, J = tp.J, k = tp.k;
  const int c0 = 32 * w;  // this warp's columns within tile J
  put_dcol(scol[w], sfl[w], lane,
           load_dcol(x, q, mol, a, mu, m, J * BT + c0 + lane, n));

  const T Lx = Lp[0], Ly = Lp[1], Lz = Lp[2];
  const T Lix = T(1) / Lx, Liy = T(1) / Ly, Liz = T(1) / Lz;
  const T f_shift = T(-1) / cut_coulsq;
  const T pd2h = T(0.5) * pd * pd, pd3_6 = pd * pd * pd / T(6);
  const T p3h = T(0.5) * pd * pd * pd, p4h = p3h * pd;
  T xi[RW], yi[RW], zi[RW], qi[RW], moli[RW], mxi[RW], myi[RW], mzi[RW];
  int fli[RW];
  T ex[RW], ey[RW], ez[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const DCol<T> ci =
        load_dcol(x, q, mol, a, mu, m, I * BT + lane + 32 * r, n);
    xi[r] = ci.x, yi[r] = ci.y, zi[r] = ci.z, qi[r] = ci.q;
    moli[r] = ci.mol, mxi[r] = ci.mx, myi[r] = ci.my, mzi[r] = ci.mz;
    fli[r] = ci.fl;
    ex[r] = ey[r] = ez[r] = T(0);
  }
  __syncwarp();

  const bool diag = k == 0;
  unsigned nvote = 0, ncd_skip = 0, ndd_skip = 0;
  T acc[NACC] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  T cx = T(0), cy = T(0), cz = T(0);  // the sum of column c0 + (lane+t)&31
  for (int t = 0; t < 32; ++t) {
    const int c = (lane + t) & 31;
    const DCol<T> cj = get_dcol(scol[w], sfl[w], c);
    const bool mj = cj.fl & FL_MASK, aj = cj.fl & FL_POLAR;
#pragma unroll
    for (int g = 0; g < RW; g += DG) {
      T dx[DG], dy[DG], dz[DG], rsq[DG];
      bool cdi[DG], cdj[DG], ddi[DG], ddj[DG];
      bool any_cd = false, any_dd = false;
#pragma unroll
      for (int h = 0; h < DG; ++h) {
        const int r = g + h;
        dx[h] = mi(xi[r] - cj.x, Lx, Lix);
        dy[h] = mi(yi[r] - cj.y, Ly, Liy);
        dz[h] = mi(zi[r] - cj.z, Lz, Liz);
        rsq[h] = rsq_rn(dx[h], dy[h], dz[h]);
        const bool ok = !diag || lane + 32 * r < c0 + c;
        const bool mrow = fli[r] & FL_MASK;
        const bool cd = ok && rsq[h] < cut_coulsq &&
                        (moli[r] != cj.mol || moli[r] == T(0));
        const bool dd = ok && (fli[r] & FL_POLAR) && aj;
        cdi[h] = cd && mj, cdj[h] = cd && mrow;
        ddi[h] = dd && mj, ddj[h] = dd && mrow;
        any_cd = any_cd || cdi[h] || cdj[h];
        any_dd = any_dd || ddi[h] || ddj[h];
      }
      if (skip) {
        any_cd = __any_sync(FULL, any_cd);
        any_dd = __any_sync(FULL, any_dd);
        ++nvote;
        ncd_skip += !any_cd;
        ndd_skip += !any_dd;
      } else {
        any_cd = any_dd = true;
      }
      if (!any_cd && !any_dd) continue;
#pragma unroll
      for (int h = 0; h < DG; ++h) {
        const int r = g + h;
        const T rinv = rsqrt_normal(rsq[h]);
        const T r2inv = rinv * rinv;
        const T r3inv = r2inv * rinv;
        const T pidotr = mxi[r] * dx[h] + myi[r] * dy[h] + mzi[r] * dz[h];
        const T pjdotr = cj.mx * dx[h] + cj.my * dy[h] + cj.mz * dz[h];
        // side i's force (fi) and side j's negated (gj)
        T fix = T(0), fiy = T(0), fiz = T(0);
        T gjx = T(0), gjy = T(0), gjz = T(0);
        if (any_cd) {
          const T wf = r2inv + f_shift;
          const T hh = rsq[h] * wf;
          const T e = T(3) * r2inv + f_shift;
          const T gq = wf * rinv * sqrt_q;
          const T cq = sqrt_q * r3inv;
          const T Ax = cj.q * mxi[r] - qi[r] * cj.mx;
          const T Ay = cj.q * myi[r] - qi[r] * cj.my;
          const T Az = cj.q * mzi[r] - qi[r] * cj.mz;
          const T eB = e * (cj.q * pidotr - qi[r] * pjdotr);
          const T fx = cq * (hh * Ax - eB * dx[h]);
          const T fy = cq * (hh * Ay - eB * dy[h]);
          const T fz = cq * (hh * Az - eB * dz[h]);
          fix = cdi[h] ? fx : T(0), fiy = cdi[h] ? fy : T(0);
          fiz = cdi[h] ? fz : T(0);
          gjx = cdj[h] ? fx : T(0), gjy = cdj[h] ? fy : T(0);
          gjz = cdj[h] ? fz : T(0);
          // selected after the product: gq is not finite where a masked
          // pair has rsq = 0
          const T gqi = gq * qi[r], gqj = gq * cj.q;
          acc[0] += (cdj[h] ? gqi * pjdotr : T(0)) -
                    (cdi[h] ? gqj * pidotr : T(0));
        }
        if (any_dd) {
          const T r5inv = r3inv * r2inv;
          const T pdotp = mxi[r] * cj.mx + myi[r] * cj.my + mzi[r] * cj.mz;
          const T pp = pidotr * pjdotr;
          T v1, v3, pre1;
          if (DAMP == 1) {
            const T rr = rsq[h] * rinv;
            const T u = pd * rr;
            const T t1 = exp_(-u);
            const T t2 = T(1) + u + pd2h * rsq[h];
            const T t3 = t2 + pd3_6 * rsq[h] * rr;
            v1 = r3inv * (T(1) - t1 * t2) * pdotp;
            v3 = r5inv * (T(1) - t1 * t3);
            pre1 = t1 * (p4h * pp * r3inv - p3h * pdotp * r2inv);
          } else {
            v1 = r3inv * pdotp;
            v3 = r5inv;
            pre1 = T(0);
          }
          const T b3 = T(3) * v3;
          v3 *= pp;
          pre1 += T(3) * r2inv * (v1 - T(5) * v3);
          const T pre2 = b3 * pjdotr, pre3 = b3 * pidotr;
          const T ux = v1 - T(3) * v3;
          const T fx = pre1 * dx[h] + pre2 * mxi[r] + pre3 * cj.mx;
          const T fy = pre1 * dy[h] + pre2 * myi[r] + pre3 * cj.my;
          const T fz = pre1 * dz[h] + pre2 * mzi[r] + pre3 * cj.mz;
          fix += ddi[h] ? fx : T(0), fiy += ddi[h] ? fy : T(0);
          fiz += ddi[h] ? fz : T(0);
          gjx += ddj[h] ? fx : T(0), gjy += ddj[h] ? fy : T(0);
          gjz += ddj[h] ? fz : T(0);
          acc[1] += (ddi[h] ? ux : T(0)) + (ddj[h] ? ux : T(0));
        }
        ex[r] += fix, ey[r] += fiy, ez[r] += fiz;
        cx -= gjx, cy -= gjy, cz -= gjz;
        const T Dx = fix + gjx, Dy = fiy + gjy, Dz = fiz + gjz;
        acc[2] += dx[h] * Dx;
        acc[3] += dy[h] * Dy;
        acc[4] += dz[h] * Dz;
        acc[5] += dx[h] * Dy;
        acc[6] += dx[h] * Dz;
        acc[7] += dy[h] * Dz;
      }
    }
    // column c's sum goes to the lane that meets it at step t + 1
    const int src = (lane + 1) & 31;
    cx = __shfl_sync(FULL, cx, src);
    cy = __shfl_sync(FULL, cy, src);
    cz = __shfl_sync(FULL, cz, src);
  }

  T* pc = slot_ptr<BT>(part, J, col_slot(k, nT), nT) + c0 + lane;
  pc[0] = cx;
  pc[BT] = cy;
  pc[2 * BT] = cz;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    srow[w][0][lane + 32 * r] = ex[r];
    srow[w][1][lane + 32 * r] = ey[r];
    srow[w][2][lane + 32 * r] = ez[r];
  }
  if (stats != nullptr && lane == 0) {
    atomicAdd(&stats[0], (unsigned long long)nvote);
    atomicAdd(&stats[1], (unsigned long long)ncd_skip);
    atomicAdd(&stats[2], (unsigned long long)ndd_skip);
  }
  __syncthreads();
  T* pr = slot_ptr<BT>(part, I, k, nT);
  for (int e = threadIdx.x; e < 3 * BT; e += 32 * WT) {
    const int comp = e / BT, row = e % BT;
    T s = srow[0][comp][row];
#pragma unroll
    for (int v = 1; v < WT; ++v) s += srow[v][comp][row];
    pr[e] = s;
  }
  block_partials<T, 32 * WT>(acc, partials);
}

// The whole panel of n atoms: x (n,3), q, mol, a, mu (n,3), m (n), L (3,)
// on the device; part (nT, nT + 1, 3, BT) and partials (nT (nT + 1) / 2,
// 8) scratch with nT = ceil(n / BT); f (n,3); acc (8,) = [u_ef u_dd vxx
// vyy vzz vxy vxz vyz].
template <typename T>
int launch_dipole_whole(const T* x, const T* q, const T* mol, const T* a,
                        const T* mu, const T* m, int n, const T* L, T pd,
                        T cut_coulsq, T sqrt_q, int damping_type, int skip,
                        int nT, T* part, T* partials, T* f, T* acc,
                        unsigned long long* stats, void* stream) {
  constexpr int BT = DipoleTile<T>::BT;
  if (nT != (n + BT - 1) / BT) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npairs = tile_pair_count(nT);
  if (damping_type == 1)
    dipole_whole_kernel<T, 1><<<npairs, BT, 0, s>>>(
        x, q, mol, a, mu, m, n, L, pd, cut_coulsq, sqrt_q, skip, nT, part,
        partials, stats);
  else
    dipole_whole_kernel<T, 0><<<npairs, BT, 0, s>>>(
        x, q, mol, a, mu, m, n, L, pd, cut_coulsq, sqrt_q, skip, nT, part,
        partials, stats);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  slot_sum_kernel<T, BT, false><<<dim3(nT, 3), BT, 0, s>>>(part, n, nT, f,
                                                          nullptr, nullptr);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_partials<T><<<1, REDUCE_THREADS, 0, s>>>(partials, npairs, T(1),
                                                  T(0.5), acc);
  return static_cast<int>(cudaGetLastError());
}

// The strip form (the row form of the TPU kernel): LANES threads per row,
// ROWS rows per CTA, the CTA loops over all columns in TILE-wide tiles of
// ten shared-memory arrays.
template <typename T, int DAMP>
__global__ void __launch_bounds__(THREADS)
dipole_strip_kernel(const T* __restrict__ xr, const T* __restrict__ qr,
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
      const T rsq = pm ? rsq_rn(dx, dy, dz) : T(1);
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
int launch_dipole_strip(const T* xr, const T* qr, const T* molr, const T* ar,
                        const T* mur, int nrows, int row0, const T* xc,
                        const T* qc, const T* molc, const T* ac, const T* muc,
                        const T* mc, int npad, const T* L, T pd, T cut_coulsq,
                        T sqrt_q, int damping_type, T* f, T* partials, T* acc,
                        void* stream) {
  const int nb = nblocks_for(nrows);
  const dim3 grid(nb), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (damping_type == 1)
    dipole_strip_kernel<T, 1><<<grid, block, 0, s>>>(
        xr, qr, molr, ar, mur, nrows, row0, xc, qc, molc, ac, muc, mc, npad,
        L, pd, cut_coulsq, sqrt_q, f, partials);
  else
    dipole_strip_kernel<T, 0><<<grid, block, 0, s>>>(
        xr, qr, molr, ar, mur, nrows, row0, xc, qc, molc, ac, muc, mc, npad,
        L, pd, cut_coulsq, sqrt_q, f, partials);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  reduce_partials<T><<<1, REDUCE_THREADS, 0, s>>>(partials, nb, T(1),
                                                  T(0.5), acc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lidp
