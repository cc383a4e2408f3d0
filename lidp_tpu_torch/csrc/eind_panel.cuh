// The eind panel: E_ind = -T.mu with Thole exponential damping, for
// T = float (eind_panel.cu) and T = double (eind_panel_df.cu).
//
// Per pair (i != j, alpha_i != 0, alpha_j != 0), d = mi(x_i - x_j):
//   E_i -= c1 (mu_j . d) d + c2 mu_j,   c1 = -3 l2 r^-5,   c2 = l1 r^-3.
// T_ij is symmetric and even in d, and mi(x_j - x_i) = -mi(x_i - x_j)
// exactly (the subtraction, the rounding to an integer and the fused
// d - L*rint(d/L) all round sign-symmetrically), so d, c1 and c2 computed
// once serve both atoms: E_j -= c1 (mu_i . d) d + c2 mu_i.
//
// Two kernels:
//  * eind_whole_kernel, the whole square panel (cols is None): each
//    unordered pair once, applied to both atoms (half the geometry, rsqrt,
//    exp and damping of a row-by-row sweep).  The atoms fall into tiles of
//    BT; a CTA takes one unordered tile pair (I, J = I + k mod nT), the
//    diagonal tile (k = 0) only its pairs i < j.
//    Its WT warps share the BT rows of tile I (RW per lane, in registers)
//    and each takes 32 columns of tile J, packed (x, y, z, alpha) and
//    (mu, 0) in shared memory.  Lane l meets column (l + t) & 31 at step t,
//    so the 32 lanes read 32 different columns (conflict-free 16-byte
//    loads) and each column's own sum travels with it: after each step it
//    moves one lane down (3 shuffles per step), and after 32 steps lane l
//    holds column l's sum over the tile's rows.  (All lanes reading one
//    column, its sum reduced by a 5-level shuffle tree per step, took 5.6%
//    longer in float32 and 5.8% in float64 on an H100 80GB HBM3 at 700 W:
//    scripts/profile_torch_polar.py --path eind times each design choice
//    named here against the kept one.)  No float atomics: the row
//    sums of the WT warps are added in warp order through shared memory,
//    and both sides go to a partial buffer, one slot per (tile, other
//    tile): tile I's rows to slot k, tile J's columns to slot nT - k (nT
//    for the diagonal).  slot_sum_kernel adds each atom's nT + 1 slots in
//    slot order and negates.  The schedule, the slots and the sum are
//    panel_common.cuh's, shared with dipole_whole_kernel.  Results do not
//    depend on block order, and repeat bit for bit.
//  * eind_strip_kernel, a row strip against all columns (cols=, row0=):
//    one-sided, 8 lanes per row, the columns staged per CTA, with the
//    packed columns, pair_terms and the skip below.  At the whole shape it
//    is the yardstick of the whole-panel kernel.
//
// Exact damping skip: beyond u = pd*r = skip_u, 1 - t1*t2 and
// 1 - t1*(t2 + ...) round to exactly 1 (ops/panel.py EIND_SKIP_U, held by
// tests/test_torch_eind_symmetric.py, with and without the contraction to
// an FMA), so where every pair of a warp's step lies beyond it (or is
// masked) the warp sets l1 = l2 = 1 without the exponential: bit for bit
// the result of computing it.  A huge skip_u turns the skip off.  The
// count of warp votes and of skipped ones goes to `stats` when it is not
// null (integer atomics, for measurement only).
//
// The minimum image keeps rintf/rint (FRND): the two-add form
// (v + 1.5*2^23) - 1.5*2^23, bit-identical in range, puts 40 more
// instructions into the whole kernel's SASS in float32 and took the same
// time there (0.2% less, within the spread), 2.4% longer in float64.  The
// masked pairs' rsq is not replaced by 1: the selects on c1 and c2 discard
// whatever a zero rsq gives.  Bounding the whole kernel to 4 CTAs per SM
// (128 registers) took 3.0% longer in float32; in float64 it took 0.8%
// less but spilled 208 bytes.
//
// Masks are selects, not branches, exactly as the TPU kernel applies them.
#pragma once

#include "panel_common.cuh"

namespace lidp {

constexpr int BT = 128;       // atoms per tile of the whole-panel kernel
constexpr int WT = 4;         // warps per tile pair, 32 columns each
constexpr int RW = BT / 32;   // tile rows per lane

// one column's operands; packed in shared memory as Vec<T>::n 16-byte
// vectors: float4 (x, y, z, alpha), (mu, 0); double2 (x, y), (z, alpha),
// (mu_x, mu_y), (mu_z, 0)
template <typename T>
struct Col {
  T x, y, z, a, mx, my, mz;
};

template <typename T>
__device__ __forceinline__ Col<T> load_col(const T* __restrict__ x,
                                           const T* __restrict__ a,
                                           const T* __restrict__ mu, int j,
                                           int n) {
  if (j >= n) return Col<T>{};  // a padded column: alpha 0 masks it
  return Col<T>{x[3 * j], x[3 * j + 1], x[3 * j + 2], a[j],
                mu[3 * j], mu[3 * j + 1], mu[3 * j + 2]};
}

template <int W>
__device__ __forceinline__ void put_col(float4 (*s)[W], int c,
                                        const Col<float>& v) {
  s[0][c] = make_float4(v.x, v.y, v.z, v.a);
  s[1][c] = make_float4(v.mx, v.my, v.mz, 0.f);
}
template <int W>
__device__ __forceinline__ void put_col(double2 (*s)[W], int c,
                                        const Col<double>& v) {
  s[0][c] = make_double2(v.x, v.y);
  s[1][c] = make_double2(v.z, v.a);
  s[2][c] = make_double2(v.mx, v.my);
  s[3][c] = make_double2(v.mz, 0.0);
}
template <int W>
__device__ __forceinline__ Col<float> get_col(float4 (*s)[W], int c) {
  const float4 p = s[0][c], m = s[1][c];
  return Col<float>{p.x, p.y, p.z, p.w, m.x, m.y, m.z};
}
template <int W>
__device__ __forceinline__ Col<double> get_col(double2 (*s)[W], int c) {
  const double2 p = s[0][c], q = s[1][c], m = s[2][c], n = s[3][c];
  return Col<double>{p.x, p.y, q.x, q.y, m.x, m.y, n.x};
}

// rows per warp vote in the whole kernel: over 1 row x 32 columns (more
// votes and branches) the kernel took 6.7% longer in float32 and 1.7% in
// float64, over 4 rows (fewer votes skip) 1.1% and 0.5%, on the
// 12,288-row test panel
constexpr int G = 2;

// The pair terms c1, c2 of N pairs (rsq, pm) against one column; with DAMP
// the warp votes once on all N.  Every lane of the warp must call it.
template <typename T, int DAMP, int N>
__device__ __forceinline__ void pair_terms(const T* rsq, const bool* pm,
                                           T pd, T pd2h, T pd3_6, T skip_u,
                                           T* c1, T* c2, unsigned& nskip) {
  T rinv[N], r[N];
  bool far = true;
#pragma unroll
  for (int g = 0; g < N; ++g) {
    rinv[g] = rsqrt_normal(rsq[g]);
    r[g] = rsq[g] * rinv[g];
    far = far && (!pm[g] || pd * r[g] > skip_u);
  }
  if (DAMP == 1 && !__all_sync(FULL, far)) {
#pragma unroll
    for (int g = 0; g < N; ++g) {
      const T r2inv = rinv[g] * rinv[g];
      const T r3inv = r2inv * rinv[g];
      const T r5inv = r3inv * r2inv;
      const T u = pd * r[g];
      const T t1 = exp_(-u);
      const T t2 = T(1) + u + pd2h * rsq[g];
      const T l1 = T(1) - t1 * t2;
      const T l2 = T(1) - t1 * (t2 + pd3_6 * rsq[g] * r[g]);
      c1[g] = pm[g] ? T(-3) * (l2 * r5inv) : T(0);
      c2[g] = pm[g] ? l1 * r3inv : T(0);
    }
  } else {
    if (DAMP == 1) ++nskip;
#pragma unroll
    for (int g = 0; g < N; ++g) {  // l1 = l2 = 1
      const T r2inv = rinv[g] * rinv[g];
      const T r3inv = r2inv * rinv[g];
      const T r5inv = r3inv * r2inv;
      c1[g] = pm[g] ? T(-3) * r5inv : T(0);
      c2[g] = pm[g] ? r3inv : T(0);
    }
  }
}

// Block b takes the tile pair tile_pair(b, nT) (panel_common.cuh).  part
// (nT, nT + 1, 3, BT); x, a, mu of the n atoms (n <= nT * BT; rows and
// columns past n are masked).
template <typename T, int DAMP>
__global__ void __launch_bounds__(32 * WT)
eind_whole_kernel(const T* __restrict__ x, const T* __restrict__ a,
                  const T* __restrict__ mu, int n, const T* __restrict__ Lp,
                  T pd, T skip_u, int nT, T* __restrict__ part,
                  unsigned long long* stats) {
  using V = typename Vec<T>::type;
  __shared__ V scol[WT][Vec<T>::n][32];
  __shared__ T srow[WT][3][BT];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const TilePair tp = tile_pair(blockIdx.x, nT);
  const int I = tp.I, J = tp.J, k = tp.k;
  const int c0 = 32 * w;  // this warp's columns within tile J
  put_col(scol[w], lane, load_col(x, a, mu, J * BT + c0 + lane, n));

  const T Lx = Lp[0], Ly = Lp[1], Lz = Lp[2];
  const T Lix = T(1) / Lx, Liy = T(1) / Ly, Liz = T(1) / Lz;
  const T pd2h = T(0.5) * pd * pd, pd3_6 = pd * pd * pd / T(6);
  T xi[RW], yi[RW], zi[RW], mxi[RW], myi[RW], mzi[RW];
  T ex[RW], ey[RW], ez[RW];
  bool oki[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    const Col<T> ci = load_col(x, a, mu, I * BT + lane + 32 * r, n);
    xi[r] = ci.x, yi[r] = ci.y, zi[r] = ci.z;
    mxi[r] = ci.mx, myi[r] = ci.my, mzi[r] = ci.mz;
    oki[r] = ci.a != T(0);
    ex[r] = ey[r] = ez[r] = T(0);
  }
  __syncwarp();

  const bool diag = k == 0;
  unsigned nskip = 0;
  T cx = T(0), cy = T(0), cz = T(0);  // the sum of column c0 + (lane+t)&31
#pragma unroll 2
  for (int t = 0; t < 32; ++t) {
    const int c = (lane + t) & 31;
    const Col<T> cj = get_col(scol[w], c);
    const bool okj = cj.a != T(0);
    T dx[RW], dy[RW], dz[RW], rsq[RW], c1[RW], c2[RW];
    bool pm[RW];
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      dx[r] = mi(xi[r] - cj.x, Lx, Lix);
      dy[r] = mi(yi[r] - cj.y, Ly, Liy);
      dz[r] = mi(zi[r] - cj.z, Lz, Liz);
      rsq[r] = dx[r] * dx[r] + dy[r] * dy[r] + dz[r] * dz[r];
      pm[r] = oki[r] && okj && (!diag || lane + 32 * r < c0 + c);
    }
#pragma unroll
    for (int g = 0; g < RW; g += G)
      pair_terms<T, DAMP, G>(rsq + g, pm + g, pd, pd2h, pd3_6, skip_u,
                             c1 + g, c2 + g, nskip);
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      // two += per component, two FMAs: e += s*d + c2*mu in one statement
      // compiles to an FMUL, an FFMA and an FADD, and took 5.8% (float32)
      // and 4.9% (float64) longer
      const T sj = c1[r] * (cj.mx * dx[r] + cj.my * dy[r] + cj.mz * dz[r]);
      ex[r] += sj * dx[r];
      ex[r] += c2[r] * cj.mx;
      ey[r] += sj * dy[r];
      ey[r] += c2[r] * cj.my;
      ez[r] += sj * dz[r];
      ez[r] += c2[r] * cj.mz;
      const T si = c1[r] * (mxi[r] * dx[r] + myi[r] * dy[r] + mzi[r] * dz[r]);
      cx += si * dx[r];
      cx += c2[r] * mxi[r];
      cy += si * dy[r];
      cy += c2[r] * myi[r];
      cz += si * dz[r];
      cz += c2[r] * mzi[r];
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
  if (DAMP == 1 && stats != nullptr && lane == 0) {
    atomicAdd(&stats[0], 32ull * (RW / G));
    atomicAdd(&stats[1], (unsigned long long)nskip);
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
}

// The whole panel of n atoms: x (n,3), a (n), mu (n,3), L (3,) on the
// device; part (nT, nT + 1, 3, BT) scratch with nT = ceil(n / BT); out
// (n,3).
template <typename T>
int launch_eind_whole(const T* x, const T* a, const T* mu, int n, const T* L,
                      T pd, int damping_type, T skip_u, int nT, T* part,
                      T* out, unsigned long long* stats, void* stream) {
  if (nT != (n + BT - 1) / BT) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int npairs = tile_pair_count(nT);
  if (damping_type == 1)
    eind_whole_kernel<T, 1><<<npairs, 32 * WT, 0, s>>>(
        x, a, mu, n, L, pd, skip_u, nT, part, stats);
  else
    eind_whole_kernel<T, 0><<<npairs, 32 * WT, 0, s>>>(
        x, a, mu, n, L, pd, skip_u, nT, part, stats);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // out = -(the sum of each atom's slots in slot order)
  slot_sum_kernel<T, BT, true><<<dim3(nT, 3), BT, 0, s>>>(part, n, nT, out,
                                                         nullptr, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The strip form: LANES threads per row, ROWS rows per CTA, the CTA loops
// over all columns in TILE-wide tiles staged in shared memory.
template <typename T, int DAMP>
__global__ void __launch_bounds__(THREADS)
eind_strip_kernel(const T* __restrict__ xr, const T* __restrict__ ar,
                  int nrows, int row0, const T* __restrict__ xc,
                  const T* __restrict__ ac, const T* __restrict__ muc,
                  int npad, const T* __restrict__ Lp, T pd, T skip_u,
                  T* __restrict__ out, unsigned long long* stats) {
  using V = typename Vec<T>::type;
  __shared__ V scol[Vec<T>::n][TILE];
  const int lane = threadIdx.x % LANES;
  const int i = blockIdx.x * ROWS + threadIdx.x / LANES;
  const int ic = i < nrows ? i : nrows - 1;
  const T Lx = Lp[0], Ly = Lp[1], Lz = Lp[2];
  const T Lix = T(1) / Lx, Liy = T(1) / Ly, Liz = T(1) / Lz;
  const T xi = xr[3 * ic], yi = xr[3 * ic + 1], zi = xr[3 * ic + 2];
  const bool oki = ar[ic] != T(0);
  const int gi = row0 + i;
  const T pd2h = T(0.5) * pd * pd, pd3_6 = pd * pd * pd / T(6);
  T ex = T(0), ey = T(0), ez = T(0);
  unsigned nskip = 0, nsteps = 0;

  for (int j0 = 0; j0 < npad; j0 += TILE) {
    const int nt = min(TILE, npad - j0);
    __syncthreads();
    put_col(scol, threadIdx.x, load_col(xc, ac, muc, j0 + threadIdx.x, npad));
    __syncthreads();
    // every lane runs the same steps (the vote is warp-wide); columns past
    // nt are staged with alpha 0
    for (int t0 = 0; t0 < nt; t0 += LANES) {
      const int t = t0 + lane;
      const Col<T> cj = get_col(scol, t);
      const T dx = mi(xi - cj.x, Lx, Lix);
      const T dy = mi(yi - cj.y, Ly, Liy);
      const T dz = mi(zi - cj.z, Lz, Liz);
      const T rsq = dx * dx + dy * dy + dz * dz;
      const bool pm = (gi != j0 + t) && (cj.a != T(0)) && oki;
      T c1, c2;
      pair_terms<T, DAMP, 1>(&rsq, &pm, pd, pd2h, pd3_6, skip_u, &c1, &c2,
                             nskip);
      const T sj = c1 * (cj.mx * dx + cj.my * dy + cj.mz * dz);
      ex += sj * dx;
      ex += c2 * cj.mx;
      ey += sj * dy;
      ey += c2 * cj.my;
      ez += sj * dz;
      ez += c2 * cj.mz;
      ++nsteps;
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
  if (DAMP == 1 && stats != nullptr && (threadIdx.x & 31) == 0) {
    atomicAdd(&stats[0], (unsigned long long)nsteps);
    atomicAdd(&stats[1], (unsigned long long)nskip);
  }
}

// xr (nrows,3), ar (nrows): the row strip; xc (npad,3), ac (npad),
// muc (npad,3): the columns; L (3,) on the device; out (nrows,3).
template <typename T>
int launch_eind_strip(const T* xr, const T* ar, int nrows, int row0,
                      const T* xc, const T* ac, const T* muc, int npad,
                      const T* L, T pd, int damping_type, T skip_u, T* out,
                      unsigned long long* stats, void* stream) {
  const dim3 grid(nblocks_for(nrows)), block(THREADS);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (damping_type == 1)
    eind_strip_kernel<T, 1><<<grid, block, 0, s>>>(
        xr, ar, nrows, row0, xc, ac, muc, npad, L, pd, skip_u, out, stats);
  else
    eind_strip_kernel<T, 0><<<grid, block, 0, s>>>(
        xr, ar, nrows, row0, xc, ac, muc, npad, L, pd, skip_u, out, stats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lidp
